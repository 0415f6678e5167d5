"""Serving forwards (``trajsde_tpu/serving.py``, and the engines of
``trajsde_tpu/server.py``).

:func:`make_serving_fn`, the ``kernel`` engine: encoder -> aggregator ->
``SDEDecoder.fuse`` -> kernel K1 on the ``[B*F*A, D]`` f32 rows, in
(B, F, A) order -> ``SDEDecoder.decode``.  The encoder and heads run as
plain PyTorch; the 60-step rollout, the serving hot loop, is one kernel
launch.  :func:`make_scan_fn`, the ``scan`` engine: the model's own
forward in eval mode, for any model (the baseline has no rollout for a
kernel to take).
"""
from __future__ import annotations

from typing import Optional

import torch

from trajsde_tpu_torch.data.scene import SceneBatch
from trajsde_tpu_torch.device import resolve_device
from trajsde_tpu_torch.models.decoders import SDEDecoder
from trajsde_tpu_torch.ops.sde_rollout import rollout_params_from_module, sde_rollout


def make_serving_fn(model, device="cuda", increments: str = "rademacher", ood: bool = False):
    """Move ``model`` to ``device`` and return
    ``serve(scene, seed, generator=None, noise=None, sde_noise=None,
    twin_noise=None) -> output dict``.

    ``seed`` seeds the kernel's increments (``'rademacher'`` +-1 by
    default, or ``'gaussian'``); ``generator`` drives the encoder's draws.
    Tests pin the draws instead: ``noise [Tf, B*F*A, D]`` for the rollout,
    ``sde_noise [Th, B, A+1, D]`` and ``twin_noise [B, 1, Th, 2]`` for the
    encoder.  ``ood=True`` decodes from the encoder's ensemble-mean
    embedding and attaches ``stds [B, A]``.

    The model is put in eval mode here, so dropout never reaches a served
    answer; ``serve`` raises if the model was switched back to training.
    """
    dev = resolve_device(device)
    decoder = model.decoder
    if not isinstance(decoder, SDEDecoder):
        raise NotImplementedError(
            f"the kernel serving path requires SDEDecoder (model has "
            f"{type(decoder).__name__}); serve it with the scan engine"
        )
    _check_ood(model, ood)
    model.to(dev).eval()
    kp = rollout_params_from_module(decoder.sde_rollout)
    t0s, dts = decoder.time_grid(device=dev)
    Tf = decoder.future_steps

    @torch.inference_mode()
    def serve(scene: SceneBatch, seed: int, generator: Optional[torch.Generator] = None,
              noise=None, sde_noise=None, twin_noise=None):
        if model.training:
            raise RuntimeError("the served model was switched to train mode: call "
                               "model.eval() (dropout must not reach a served answer)")
        if ood:
            local, stds = model.encoder.forward_ood(scene, generator=generator)
        else:
            local = model.encoder(scene, sde_noise=sde_noise, twin_noise=twin_noise,
                                  generator=generator)[0]
        glob = model.aggregator(scene, local)
        y0 = decoder.fuse(scene, local, glob)
        B, F, A, D = y0.shape
        ys = sde_rollout(y0.reshape(-1, D).float().contiguous(), kp, t0s, dts, seed, Tf,
                         noise=noise, increments=increments)
        sol = ys.reshape(Tf, B, F, A, D).permute(1, 2, 3, 0, 4)
        out = decoder.decode(scene, sol, local, glob)
        out["y"] = model.rotated_y(scene)
        if ood:
            out["stds"] = stds
        return out

    return serve


def _check_ood(model, ood: bool) -> None:
    if ood and not hasattr(model.encoder, "forward_ood"):
        raise NotImplementedError(
            f"ood=True needs an encoder with forward_ood (OOD ensemble scoring); "
            f"{type(model.encoder).__name__} has none"
        )


def make_scan_fn(model, device="cuda", ood: bool = False):
    """Move ``model`` to ``device`` and return ``serve(scene, seed,
    generator=None) -> output dict``: the model's own forward in eval mode,
    ``generator`` driving its draws (an SDE model's noise) and ``seed``
    going to a fused SDE decoder's rollout kernel.  ``ood=True`` (SDE family
    only) scores through the encoder's ensemble and attaches ``stds``.
    ``serve`` raises if the model was switched back to training."""
    dev = resolve_device(device)
    _check_ood(model, ood)
    model.to(dev).eval()
    kwargs = {"ood": True} if ood else {}

    @torch.inference_mode()
    def serve(scene: SceneBatch, seed: int, generator: Optional[torch.Generator] = None):
        if model.training:
            raise RuntimeError("the served model was switched to train mode: call "
                               "model.eval() (dropout must not reach a served answer)")
        return model(scene, generator=generator, rollout_seed=seed, **kwargs)

    return serve
