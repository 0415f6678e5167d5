"""Training losses (``trajsde_tpu/losses.py``) over the dense output dict:

  loc      [B, F, A, Tf, 2|4]   (2 loc dims [+ 2 scale dims])
  y        [B, A, Tf, 2]        targets rotated into agent frames
  reg_mask [B, A, Tf] bool

Best-mode ties resolve to the first mode, as ``jnp.argmin`` does.

Under data parallelism each rank holds a slice of the global batch, and
the mean of per-rank means is not the global batch's mean (the ranks hold
different numbers of valid cells).  So each loss takes ``counts``, the
global batch's normalizers (:func:`batch_counts` summed over the ranks):
a rank's loss is then its share of the global loss, and the ranks'
gradients sum to the global batch's gradient.  With ``counts`` equal to
the local ones (a world of one) every loss gives the bits it gives
without.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

_EPS = 1e-6


def _best_mode_l2(loc: torch.Tensor, y: torch.Tensor, reg_mask: torch.Tensor):
    """Winner-take-all by masked ADE: (l2 [B, F, A, Tf], best [B, A])."""
    l2 = torch.linalg.norm(y[:, None] - loc[..., :2], dim=-1)
    ade = (l2 * reg_mask[:, None]).sum(-1)
    return l2, torch.argmin(ade, dim=1)


def _take_best(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """x [B, F, A, ...] at mode best [B, A] -> [B, A, ...]."""
    idx = best.reshape(best.shape[:1] + (1,) + best.shape[1:] + (1,) * (x.ndim - 3))
    return torch.gather(x, 1, idx.expand(x.shape[:1] + (1,) + x.shape[2:]))[:, 0]


def batch_counts(scene) -> torch.Tensor:
    """``[scenes, valid cells]`` of a training ``SceneBatch`` (f32, on its
    device): the rows of the diffusion taps and the valid (actor, future
    step) cells of ``reg_mask`` (the decoders' ``~padding_mask[:, :,
    -Tf:]``, Tf the targets' steps), the normalizers the losses divide by."""
    valid = (~scene.padding_mask[:, :, -scene.y.shape[2]:]).sum(dtype=torch.float32)
    return torch.stack([torch.full_like(valid, scene.x.shape[0]), valid])


def l2_loss(scene_y: torch.Tensor, output: Dict[str, torch.Tensor],
            counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean best-mode L2 over valid (actor, step) cells; 0 if none is
    valid.  ``counts`` (:func:`batch_counts` of the global batch) divides
    by the global batch's valid cells."""
    loc, reg_mask = output["loc"], output["reg_mask"]
    l2, best = _best_mode_l2(loc, scene_y, reg_mask)
    m = reg_mask.to(l2.dtype)
    cells = m.sum() if counts is None else counts[1]
    return (_take_best(l2, best) * m).sum() / cells.clamp_min(1.0)


def diff_bce_loss(scene_y: torch.Tensor, output: Dict[str, torch.Tensor],
                  counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``BCE(diff_in, label_in) + BCE(diff_out, label_out)`` on the
    encoder's real / perturbed diffusion taps, probabilities clipped to
    [1e-6, 1 - 1e-6].  ``counts`` (global) scales the local means by this
    batch's share of the global batch's scenes."""
    p_in = output["diff_in"].clamp(_EPS, 1.0 - _EPS)
    p_out = output["diff_out"].clamp(_EPS, 1.0 - _EPS)
    label_in, label_out = output["label_in"], output["label_out"]
    loss_in = -(label_in * torch.log(p_in) + (1.0 - label_in) * torch.log(1.0 - p_in))
    loss_out = -(label_out * torch.log(p_out) + (1.0 - label_out) * torch.log(1.0 - p_out))
    if counts is None:
        return loss_in.mean() + loss_out.mean()
    share = torch.full_like(counts[0], p_in.shape[0]) / counts[0]
    return (loss_in.mean() + loss_out.mean()) * share


def laplace_nll_loss(scene_y: torch.Tensor, output: Dict[str, torch.Tensor],
                     counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Best-mode Laplace NLL on the scale channels; the mean runs over valid
    cells times both coordinate channels (``trajsde_tpu/losses.py:74-78``),
    of the global batch with ``counts``."""
    loc_scale, reg_mask = output["loc"], output["reg_mask"]
    if loc_scale.shape[-1] < 4:
        raise ValueError(
            "LaplaceNLLLoss needs a 4-channel head (2 loc + 2 scale); the decoder "
            f"emits {loc_scale.shape[-1]} channels"
        )
    loc, scale = loc_scale[..., :2], loc_scale[..., 2:]
    _, best = _best_mode_l2(loc, scene_y, reg_mask)
    loc_b = _take_best(loc, best)
    scale_b = _take_best(scale, best).clamp_min(_EPS)
    nll = torch.log(2.0 * scale_b) + torch.abs(scene_y - loc_b) / scale_b
    m = reg_mask[..., None].to(nll.dtype)
    cells = m.sum() if counts is None else counts[1]
    return (nll * m).sum() / (cells * nll.shape[-1]).clamp_min(1.0)


LOSS_REGISTRY = {
    "L2": l2_loss,
    "DiffBCE": diff_bce_loss,
    "LaplaceNLLLoss": laplace_nll_loss,
}
