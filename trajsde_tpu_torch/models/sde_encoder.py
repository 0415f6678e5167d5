"""Latent-SDE local encoder (``trajsde_tpu/models/sde_encoder.py``).

* AA attention over the A actors plus one receive-only query row: the
  focal agent's "twin", whose displacement features are perturbed by
  ``2 * twin_noise``;
* a 21-step SDE-GRU ODE-RNN run newest -> oldest with per-row dual
  diffusion nets;
* each actor's state gathered at its end-of-sequence iteration
  (``eos = ref_time - argmax(bos)``) plus the agent/twin diffusion taps;
* AA-free ``forward_ood``: ``eval_iter`` stochastic re-runs from zeros,
  OOD score = per-actor std of the final embeddings.

Noise is explicit: ``sde_noise [Th, B, A+1, D]`` (iteration order, entry 0
= newest step) and ``twin_noise [B, 1, Th, 2]``, or drawn from the
caller's ``torch.Generator`` (twin first, then the SDE draws, then the
dropout masks of AA and AL attention in training mode).  With a bf16
``dtype`` the ODE-RNN state, its draws and the embeddings are bf16, and
every output is cast back to f32, as in the JAX module.

``adaptive=True`` integrates each segment by bounded step doubling
(``SDEGRUStep``), with ``rtol`` / ``atol``.  Its noise is one depth-8
Brownian tree per segment, whose 256 node normals (f32, the state's shape)
are pinned as ``sde_nodes [Th, 256, B, A+1, D]`` (iteration order) or drawn
from the generator: the twin first, then the AA dropout masks (training
mode), then each segment's nodes in iteration order, just before the
segment runs, then the AL dropout masks.  Only one segment's nodes are
alive at a time.  ``sde_noise`` with ``adaptive`` raises, as in JAX.  The
error that sizes the steps is one RMS over the whole batch, so every row
of a batch, padding rows included, shares its steps.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from trajsde_tpu_torch.data.scene import SceneBatch
from trajsde_tpu_torch.models import graph
from trajsde_tpu_torch.models.layers import compute_dtype
from trajsde_tpu_torch.models.local_encoder import AAEncoder, ALEncoder
from trajsde_tpu_torch.models.remat import call_block
from trajsde_tpu_torch.models.sde import (ADAPTIVE_DEPTH, NOISE_NEEDS_FIXED_GRID, SDEGRUStep,
                                          encoder_time_grid)

REAL_LABEL = 0.0
FAKE_LABEL = 1.0


def gather_actor(arr: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """One per-scene actor slot, kept as a size-1 ``axis``: arr [B, ..., A, ...] x idx [B]."""
    shape = [1] * arr.ndim
    shape[0] = arr.shape[0]
    sizes = list(arr.shape)
    sizes[axis] = 1
    index = idx.reshape(shape).expand(sizes)
    return torch.gather(arr, axis, index)


def gather_agent(arr: torch.Tensor, agent_index: torch.Tensor, axis: int) -> torch.Tensor:
    """Select the focal-agent slot per scene along ``axis`` (dropping it)."""
    return gather_actor(arr, agent_index, axis).squeeze(axis)


def gather_eos_outputs(ys, gs, bos_q, ref_time: int, agent_index, num_actors: int):
    """ys [Th, B, A+1, D], gs [Th, B, A+1] (iteration order), bos_q
    [B, A+1, Th] -> (out [B, A, D], diff_in [B], diff_out [B]).  The
    diffusion taps are the agent row and its twin (slot ``num_actors``),
    both at the AGENT's eos iteration."""
    A = num_actors
    eos = ref_time - torch.argmax(bos_q.to(torch.int32), dim=-1)    # [B, A+1]
    ys_bn = ys.permute(1, 2, 0, 3)                                   # [B, A+1, Th, D]
    idx = eos[:, :, None, None].expand(-1, -1, 1, ys_bn.shape[-1])
    out = torch.gather(ys_bn, 2, idx)[:, :A, 0, :]

    gs_bn = gs.permute(1, 2, 0)                                      # [B, A+1, Th]
    agent_eos = torch.gather(eos[:, :A], 1, agent_index[:, None])    # [B, 1]
    g_agent = gather_actor(gs_bn, agent_index, axis=1)[:, 0]         # [B, Th]
    g_twin = gs_bn[:, A]
    diff_in = torch.gather(g_agent, 1, agent_eos)[:, 0]
    diff_out = torch.gather(g_twin, 1, agent_eos)[:, 0]
    return out, diff_in, diff_out


class LocalEncoderSDESep(nn.Module):
    """Registry name ``LocalEncoderSDESepPara2`` (config-compatible kwargs).

    Euler only (fixed grid, one step per segment, or ``adaptive`` step
    doubling), no adjoint, backwards ODE-RNN; anything else raises.
    ``fused=True`` runs the pair chain of both AA calls (the twin forward
    and ``forward_ood``) through kernel K3 (K3b in bf16); the registry
    drops the JAX package's tiling knobs of that kernel (``rows_fwd``,
    ``rows_bwd``) and passes ``ln_mm`` on to the :class:`AAEncoder`.
    ``remat=True`` rematerializes both AA calls and both AL calls in a
    training backward (:func:`~trajsde_tpu_torch.models.remat.call_block`),
    as JAX's ``nn.remat`` of both blocks; the ODE-RNN, and the adaptive
    tree's nodes drawn in it, stay outside.
    """

    def __init__(
        self,
        historical_steps: int,
        embed_dim: int,
        num_heads: int = 8,
        dropout: float = 0.1,
        local_radius: float = 50.0,
        ref_time: int = 20,
        max_past_t: float = 2.0,
        minimum_step: float = 0.1,
        run_backwards: bool = True,
        sde_layers: int = 2,
        eval_iter: int = 10,
        node_dim: int = 2,
        edge_dim: int = 2,
        input_diff: bool = True,
        adjoint: bool = False,
        method: str = "euler",
        adaptive: bool = False,
        rtol: float = 1e-3,
        atol: float = 1e-3,
        remat: bool = False,
        dtype=None,
        fused: bool = False,
        ood_chunk: int = 0,
        neighbor_cap: int = 0,
        ln_mm: bool = True,
    ):
        super().__init__()
        if method != "euler":
            raise NotImplementedError(f"SDE method {method!r} is not supported (euler only)")
        if adjoint:
            raise NotImplementedError(
                "adjoint SDE gradients are not supported (the shipped configs "
                "backprop through the unrolled Euler scheme)"
            )
        if ref_time != historical_steps - 1:
            raise ValueError(
                f"ref_time ({ref_time}) must equal historical_steps - 1 "
                f"({historical_steps - 1}): the eos gather rule assumes the "
                "reference step is the final historical slot"
            )
        if not input_diff:
            raise NotImplementedError(
                "input_diff=false is not supported for the SDE encoder: its "
                "AA encoder always substitutes the bos token"
            )
        if not run_backwards:
            raise NotImplementedError(
                "run_backwards=false is a dead branch in the reference (its "
                "descending time grid is rejected by the solver); only the "
                "backwards ODE-RNN is implemented"
            )
        seg = max_past_t / max(1, historical_steps - 1)
        if minimum_step < seg - 1e-9:
            raise NotImplementedError(
                f"minimum_step ({minimum_step}) below the observation spacing "
                f"({seg:g}) would take several Euler substeps per segment; "
                "this encoder integrates one step per segment"
            )
        self.remat = remat
        self.compute_dtype = compute_dtype(dtype)
        self.historical_steps = historical_steps
        self.embed_dim = embed_dim
        self.local_radius = float(local_radius)
        self.ref_time = ref_time
        self.max_past_t = float(max_past_t)
        self.eval_iter = eval_iter
        self.ood_chunk = ood_chunk
        self.aa_encoder = AAEncoder(historical_steps, embed_dim, num_heads, node_dim,
                                    edge_dim, dropout, fused=fused, neighbor_cap=neighbor_cap,
                                    dtype=dtype, ln_mm=ln_mm)
        self.al_encoder = ALEncoder(embed_dim, num_heads, node_dim, edge_dim, dropout, dtype)
        self.adaptive = adaptive
        self.sde_rnn = SDEGRUStep(embed_dim, sde_layers, adaptive=adaptive, dtype=dtype,
                                  rtol=rtol, atol=atol)
        self.hidden = nn.Parameter(torch.zeros(embed_dim))

    # ------------------------------------------------------------------
    def _aa_with_twin(self, scene: SceneBatch, twin_noise: torch.Tensor, generator=None):
        """AA attention over A actors + 1 twin query row -> (aa_out
        [B, Th, A+1, D], bos_q [B, A+1, Th], valid_q [B, A+1, Th],
        nus_row [B, A+1])."""
        B, A, Th = scene.x.shape[0], scene.x.shape[1], self.historical_steps
        rot = scene.rotate_mat()
        ai = scene.agent_index
        mask = graph.aa_masks(scene, self.local_radius)
        edge_vec = graph.aa_edge_vectors(scene)
        x_t = scene.x.permute(0, 2, 1, 3)

        x_twin = gather_actor(scene.x, ai, 1) + 2.0 * twin_noise.to(scene.x.dtype)
        x_q = torch.cat([x_t, x_twin.permute(0, 2, 1, 3)], dim=2)
        rot_q = torch.cat([rot, gather_actor(rot, ai, 1)], dim=1)
        bos_q = torch.cat([scene.bos_mask, gather_actor(scene.bos_mask, ai, 1)], dim=1)
        mask_q = torch.cat([mask, gather_actor(mask, ai, 2)], dim=2)
        edge_q = torch.cat([edge_vec, gather_actor(edge_vec, ai, 2)], dim=2)

        aa_out = call_block(self.aa_encoder, x_q, x_t, rot_q, bos_q, mask_q, edge_q,
                            generator=generator, remat=self.remat)

        pad = scene.padding_mask[:, :, :Th]
        valid_q = ~torch.cat([pad, gather_actor(pad, ai, 1)], dim=1)
        nus_row = (scene.source == 0)[:, None].expand(B, A + 1)
        return aa_out, bos_q, valid_q, nus_row

    def _run_rnn(self, h, aa_out, valid_q, nus_row, sde_noise=None, sde_nodes=None,
                 generator=None):
        """Run the ODE-RNN newest -> oldest (iteration k consumes time step
        Th-1-k); returns iteration-ordered ys [Th, B, N, D], gs [Th, B, N].
        The fixed grid takes ``sde_noise [Th, B, N, D]``; the adaptive step
        takes ``sde_nodes [Th, 256, B, N, D]`` or draws each segment's nodes
        from ``generator`` just before the segment."""
        Th = self.historical_steps
        t0s, dts = encoder_time_grid(Th, self.max_past_t, device=h.device)
        ys, gs = [], []
        for k in range(Th):
            t = Th - 1 - k
            step = (h, nus_row, aa_out[:, t], valid_q[:, :, t], t0s[k], dts[k])
            if self.adaptive:
                h, g = self.sde_rnn(*step, nodes=self._nodes(h, sde_nodes, k, generator))
            else:
                h, g = self.sde_rnn(*step, eps=sde_noise[k])
            ys.append(h)
            gs.append(g)
        return torch.stack(ys), torch.stack(gs)

    @staticmethod
    def _nodes(h, sde_nodes, k: int, generator) -> torch.Tensor:
        """Segment ``k``'s tree nodes, [256, *h.shape] in f32."""
        if sde_nodes is not None:
            return sde_nodes[k]
        return torch.randn((2 ** ADAPTIVE_DEPTH,) + tuple(h.shape), generator=generator,
                           device=h.device, dtype=torch.float32)

    # ------------------------------------------------------------------
    def forward(
        self,
        scene: SceneBatch,
        sde_noise: Optional[torch.Tensor] = None,
        twin_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        sde_nodes: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """(local_embed [B, A, D], diff_in [B], diff_out [B], label_in [B],
        label_out [B]).  ``sde_nodes`` pins the adaptive step's trees."""
        B, A = scene.x.shape[0], scene.x.shape[1]
        Th, D = self.historical_steps, self.embed_dim
        dev, dt = scene.x.device, scene.x.dtype
        state_dt = self.compute_dtype or dt
        self._check_noise(sde_noise, sde_nodes)
        if twin_noise is None:
            twin_noise = torch.randn((B, 1, Th, 2), generator=generator, device=dev, dtype=dt)
        if sde_noise is None and not self.adaptive:
            sde_noise = torch.randn((Th, B, A + 1, D), generator=generator, device=dev,
                                    dtype=state_dt)

        aa_out, bos_q, valid_q, nus_row = self._aa_with_twin(scene, twin_noise, generator)
        h0 = self.hidden.expand(B, A + 1, D).to(state_dt)
        ys, gs = self._run_rnn(h0, aa_out, valid_q, nus_row, sde_noise, sde_nodes, generator)
        out, diff_in, diff_out = gather_eos_outputs(
            ys, gs, bos_q, self.ref_time, scene.agent_index, A
        )

        al_mask, al_vec = graph.al_edges(scene, self.ref_time, self.local_radius)
        out = call_block(self.al_encoder, out, graph.lane_features(scene), al_vec, al_mask,
                         scene.rotate_mat(), generator=generator, remat=self.remat)
        label_in = torch.full((B,), REAL_LABEL, device=dev)
        label_out = torch.full((B,), FAKE_LABEL, device=dev)
        return out.float(), diff_in.float(), diff_out.float(), label_in, label_out

    # ------------------------------------------------------------------
    def _check_noise(self, sde_noise, sde_nodes) -> None:
        if self.adaptive and sde_noise is not None:
            raise NotImplementedError(NOISE_NEEDS_FIXED_GRID + " (pin it with sde_nodes)")
        if sde_nodes is not None and not self.adaptive:
            raise ValueError("sde_nodes pins the adaptive step's Brownian trees; this encoder "
                             "integrates on the fixed grid (pin sde_noise instead)")

    # ------------------------------------------------------------------
    def forward_ood(
        self, scene: SceneBatch, generator: Optional[torch.Generator] = None,
        sde_nodes: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """OOD scoring -> (local_embed [B, A, D], actors_std [B, A]): the
        ensemble of ``eval_iter`` re-runs is folded into the batch (member
        ``e``'s rows at ``e * B``), at most ``ood_chunk`` members at a time
        (0 = all).  The adaptive step's nodes are pinned as ``sde_nodes
        [Th, 256, eval_iter * B, A, D]`` or drawn per chunk and segment."""
        self._check_noise(None, sde_nodes)
        B, A = scene.x.shape[0], scene.x.shape[1]
        Th, D = self.historical_steps, self.embed_dim
        rot = scene.rotate_mat()
        x_t = scene.x.permute(0, 2, 1, 3)
        aa_out = call_block(self.aa_encoder, x_t, x_t, rot, scene.bos_mask,
                            graph.aa_masks(scene, self.local_radius),
                            graph.aa_edge_vectors(scene), remat=self.remat)
        valid = ~scene.padding_mask[:, :, :Th]
        nus_row = (scene.source == 0)[:, None].expand(B, A)
        eos = self.ref_time - torch.argmax(scene.bos_mask.to(torch.int32), dim=-1)

        E = self.eval_iter
        chunk = self.ood_chunk if self.ood_chunk > 0 else E
        if E % chunk:
            raise ValueError(f"ood_chunk {chunk} must divide eval_iter {E}")
        tile = lambda a: torch.cat([a] * chunk, dim=0)  # noqa: E731
        picked = []
        for c in range(E // chunk):
            h0 = torch.zeros((chunk * B, A, D), device=scene.x.device,
                             dtype=self.compute_dtype or scene.x.dtype)
            noise = nodes = None
            if not self.adaptive:
                noise = torch.randn((Th,) + h0.shape, generator=generator,
                                    device=h0.device, dtype=h0.dtype)
            elif sde_nodes is not None:
                rows = slice(c * chunk * B, (c + 1) * chunk * B)
                nodes = sde_nodes[:, :, rows]
            ys, _ = self._run_rnn(h0, tile(aa_out), tile(valid), tile(nus_row), noise, nodes,
                                  generator)
            ys_bn = ys.permute(1, 2, 0, 3)                       # [chunk*B, A, Th, D]
            idx = tile(eos)[:, :, None, None].expand(-1, -1, 1, D)
            picked.append(torch.gather(ys_bn, 2, idx)[:, :, 0, :])
        stacked = torch.cat(picked, dim=0).reshape(E, B, A, D)
        actors_std = stacked.std(dim=0, unbiased=False).mean(-1)
        out = stacked.mean(0)

        al_mask, al_vec = graph.al_edges(scene, self.ref_time, self.local_radius)
        out = call_block(self.al_encoder, out, graph.lane_features(scene), al_vec, al_mask, rot,
                         remat=self.remat)
        return out.float(), actors_std.float()
