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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from trajsde_tpu_torch.data.scene import SceneBatch
from trajsde_tpu_torch.models import graph
from trajsde_tpu_torch.models.layers import compute_dtype
from trajsde_tpu_torch.models.local_encoder import REMAT_NOT_PORTED, AAEncoder, ALEncoder
from trajsde_tpu_torch.models.sde import SDEGRUStep, encoder_time_grid

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

    Only the shipped combination (fixed-grid Euler, no adjoint, backwards
    ODE-RNN, one step per segment) is implemented; anything else raises.
    ``fused=True`` runs the pair chain of both AA calls (the twin forward
    and ``forward_ood``) through kernel K3; the registry drops the JAX
    package's knobs of that kernel (``rows_fwd``, ``rows_bwd``, ``ln_mm``).
    ``remat=True`` raises (not ported), and so does a bf16 ``dtype`` with
    ``fused=True``.
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
        remat: bool = False,
        dtype=None,
        fused: bool = False,
        ood_chunk: int = 0,
        neighbor_cap: int = 0,
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
        if remat:
            raise NotImplementedError(REMAT_NOT_PORTED)
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
                                    dtype=dtype)
        self.al_encoder = ALEncoder(embed_dim, num_heads, node_dim, edge_dim, dropout, dtype)
        self.sde_rnn = SDEGRUStep(embed_dim, sde_layers, adaptive=adaptive, dtype=dtype)
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

        aa_out = self.aa_encoder(x_q, x_t, rot_q, bos_q, mask_q, edge_q, generator)

        pad = scene.padding_mask[:, :, :Th]
        valid_q = ~torch.cat([pad, gather_actor(pad, ai, 1)], dim=1)
        nus_row = (scene.source == 0)[:, None].expand(B, A + 1)
        return aa_out, bos_q, valid_q, nus_row

    def _run_rnn(self, h, aa_out, valid_q, nus_row, sde_noise):
        """Run the ODE-RNN newest -> oldest (iteration k consumes time step
        Th-1-k); returns iteration-ordered ys [Th, B, N, D], gs [Th, B, N]."""
        Th = self.historical_steps
        t0s, dts = encoder_time_grid(Th, self.max_past_t, device=h.device)
        ys, gs = [], []
        for k in range(Th):
            t = Th - 1 - k
            h, g = self.sde_rnn(h, nus_row, aa_out[:, t], valid_q[:, :, t],
                                t0s[k], dts[k], sde_noise[k])
            ys.append(h)
            gs.append(g)
        return torch.stack(ys), torch.stack(gs)

    # ------------------------------------------------------------------
    def forward(
        self,
        scene: SceneBatch,
        sde_noise: Optional[torch.Tensor] = None,
        twin_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """(local_embed [B, A, D], diff_in [B], diff_out [B], label_in [B],
        label_out [B])."""
        B, A = scene.x.shape[0], scene.x.shape[1]
        Th, D = self.historical_steps, self.embed_dim
        dev, dt = scene.x.device, scene.x.dtype
        state_dt = self.compute_dtype or dt
        if twin_noise is None:
            twin_noise = torch.randn((B, 1, Th, 2), generator=generator, device=dev, dtype=dt)
        if sde_noise is None:
            sde_noise = torch.randn((Th, B, A + 1, D), generator=generator, device=dev,
                                    dtype=state_dt)

        aa_out, bos_q, valid_q, nus_row = self._aa_with_twin(scene, twin_noise, generator)
        h0 = self.hidden.expand(B, A + 1, D).to(state_dt)
        ys, gs = self._run_rnn(h0, aa_out, valid_q, nus_row, sde_noise)
        out, diff_in, diff_out = gather_eos_outputs(
            ys, gs, bos_q, self.ref_time, scene.agent_index, A
        )

        al_mask, al_vec = graph.al_edges(scene, self.ref_time, self.local_radius)
        out = self.al_encoder(out, graph.lane_features(scene), al_vec, al_mask,
                              scene.rotate_mat(), generator)
        label_in = torch.full((B,), REAL_LABEL, device=dev)
        label_out = torch.full((B,), FAKE_LABEL, device=dev)
        return out.float(), diff_in.float(), diff_out.float(), label_in, label_out

    # ------------------------------------------------------------------
    def forward_ood(
        self, scene: SceneBatch, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """OOD scoring -> (local_embed [B, A, D], actors_std [B, A]): the
        ensemble of ``eval_iter`` re-runs is folded into the batch, at most
        ``ood_chunk`` members at a time (0 = all)."""
        B, A = scene.x.shape[0], scene.x.shape[1]
        Th, D = self.historical_steps, self.embed_dim
        rot = scene.rotate_mat()
        x_t = scene.x.permute(0, 2, 1, 3)
        aa_out = self.aa_encoder(x_t, x_t, rot, scene.bos_mask,
                                 graph.aa_masks(scene, self.local_radius),
                                 graph.aa_edge_vectors(scene))
        valid = ~scene.padding_mask[:, :, :Th]
        nus_row = (scene.source == 0)[:, None].expand(B, A)
        eos = self.ref_time - torch.argmax(scene.bos_mask.to(torch.int32), dim=-1)

        E = self.eval_iter
        chunk = self.ood_chunk if self.ood_chunk > 0 else E
        if E % chunk:
            raise ValueError(f"ood_chunk {chunk} must divide eval_iter {E}")
        tile = lambda a: torch.cat([a] * chunk, dim=0)  # noqa: E731
        picked = []
        for _ in range(E // chunk):
            h0 = torch.zeros((chunk * B, A, D), device=scene.x.device,
                             dtype=self.compute_dtype or scene.x.dtype)
            noise = torch.randn((Th,) + h0.shape, generator=generator,
                                device=h0.device, dtype=h0.dtype)
            ys, _ = self._run_rnn(h0, tile(aa_out), tile(valid), tile(nus_row), noise)
            ys_bn = ys.permute(1, 2, 0, 3)                       # [chunk*B, A, Th, D]
            idx = tile(eos)[:, :, None, None].expand(-1, -1, 1, D)
            picked.append(torch.gather(ys_bn, 2, idx)[:, :, 0, :])
        stacked = torch.cat(picked, dim=0).reshape(E, B, A, D)
        actors_std = stacked.std(dim=0, unbiased=False).mean(-1)
        out = stacked.mean(0)

        al_mask, al_vec = graph.al_edges(scene, self.ref_time, self.local_radius)
        out = self.al_encoder(out, graph.lane_features(scene), al_vec, al_mask, rot)
        return out.float(), actors_std.float()
