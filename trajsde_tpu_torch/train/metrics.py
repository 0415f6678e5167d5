"""Transfer-aware evaluation metrics (``trajsde_tpu/train/metrics.py``) as
(sum, count) tensor pairs.

Inputs are focal-agent slices:
  pred     [B, K, Tf, 2]   target [B, Tf, 2]
  reg_mask [B, Tf] bool    source [B] int (0 = nuScenes, 1 = Argoverse)

``end_idcs[source[b]]`` is each scene's evaluation end index on the shared
grid (59 for 6 s nuScenes, 29 for 3 s Argoverse), selected per row, so the
batch need not be sorted by source.  Best-mode ties resolve to the first
mode, as ``jnp.argmin`` does.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import torch


def _end_idx(source: torch.Tensor, end_idcs: Sequence[int]) -> torch.Tensor:
    return torch.as_tensor(list(end_idcs), dtype=torch.int64, device=source.device)[source]


def _l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(pred - target[:, None], dim=-1)          # [B, K, Tf]


def _at_end(pred, target, reg_mask, e):
    """(l2 [B, K], valid [B]) at each row's end index ``e [B]``."""
    B, K = pred.shape[:2]
    pred_e = torch.gather(pred, 2, e[:, None, None, None].expand(B, K, 1, 2))[:, :, 0]
    targ_e = torch.gather(target, 1, e[:, None, None].expand(B, 1, 2))[:, 0]
    valid = torch.gather(reg_mask, 1, e[:, None])[:, 0]
    return torch.linalg.norm(pred_e - targ_e[:, None], dim=-1), valid


def ade_t_update(pred, target, reg_mask, source, *, dataset: str,
                 end_idcs: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """minADE with the per-dataset best-mode rule: nuScenes eval picks the
    mode by min ADE, Argoverse eval by min FDE at the end index.

    Deliberate parity note: the FDE selection indexes the MASK-ZEROED l2
    (a row invalid at its end step ties argmin to mode 0 yet still counts),
    as the reference and the JAX package do."""
    l2 = _l2(pred, target) * reg_mask[:, None]
    valid = reg_mask.any(-1)
    steps = reg_mask.sum(-1).clamp_min(1)[:, None]
    ade = l2.sum(-1) / steps                                          # [B, K]
    if dataset == "nuScenes":
        best = torch.argmin(ade, dim=-1)
    elif dataset == "Argoverse":
        e = _end_idx(source, end_idcs)
        fde = torch.gather(l2, 2, e[:, None, None].expand(l2.shape[0], l2.shape[1], 1))[..., 0]
        best = torch.argmin(fde, dim=-1)
    else:
        raise NotImplementedError(dataset)
    ade_best = torch.gather(ade, 1, best[:, None])[:, 0]
    return (ade_best * valid).sum(), valid.sum().to(ade.dtype)


def fde_t_update(pred, target, reg_mask, source, *, dataset: str,
                 end_idcs: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """minFDE at the per-source end index."""
    l2, valid = _at_end(pred, target, reg_mask, _end_idx(source, end_idcs))
    return (l2.amin(-1) * valid).sum(), valid.sum().to(l2.dtype)


def mr_t_update(pred, target, reg_mask, source, *, dataset: str, end_idcs: Sequence[int],
                miss_threshold: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Miss rate at ``miss_threshold``: nuScenes eval uses the largest valid
    step error of the best mode, Argoverse eval the best FDE at the end
    index."""
    if dataset == "nuScenes":
        l2 = _l2(pred, target) * reg_mask[:, None]
        valid = reg_mask.any(-1)
        missed = l2.amax(-1).amin(-1) > miss_threshold
    elif dataset == "Argoverse":
        l2, valid = _at_end(pred, target, reg_mask, _end_idx(source, end_idcs))
        missed = l2.amin(-1) > miss_threshold
    else:
        raise NotImplementedError(dataset)
    return (missed & valid).sum().to(pred.dtype), valid.sum().to(pred.dtype)


_UPDATE_FNS = {"ADE_T": ade_t_update, "FDE_T": fde_t_update, "MR_T": mr_t_update}


class TransferMetric:
    """(sum, count) accumulator around an update function.

    ``update(pred, target, reg_mask, source)`` adds on the device without
    a host sync; ``compute()`` reads the pair once (NaN when nothing was
    counted).  ``source_filter`` restricts it to one domain (0 =
    nuScenes, 1 = Argoverse) and names it ``<name>_src<k>``.
    """

    def __init__(self, name: str, dataset: str, end_idcs: Sequence[int],
                 source_filter: Optional[int] = None, **kwargs):
        extra = {}
        if name == "MR_T" and "miss_threshold" in kwargs:
            extra["miss_threshold"] = kwargs["miss_threshold"]
        self.base_fn = partial(_UPDATE_FNS[name], dataset=dataset, end_idcs=tuple(end_idcs),
                               **extra)
        self.source_filter = source_filter
        self.name = name if source_filter is None else f"{name}_src{source_filter}"
        self.reset()

    def update_fn(self, pred, target, reg_mask, source):
        if self.source_filter is not None:
            reg_mask = reg_mask & (source == self.source_filter)[:, None]
        return self.base_fn(pred, target, reg_mask, source)

    def reset(self) -> None:
        self._sum = 0.0
        self._count = 0.0

    def accumulate(self, contribution) -> None:
        s, c = contribution
        self._sum = self._sum + s
        self._count = self._count + c

    def update(self, pred, target, reg_mask, source) -> None:
        self.accumulate(self.update_fn(pred, target, reg_mask, source))

    def compute(self) -> float:
        count = float(self._count)
        return float("nan") if count == 0.0 else float(self._sum) / count


def all_reduce_metrics(metrics: Sequence[TransferMetric], device) -> None:
    """Sum every metric's (sum, count) over the process group's ranks in one
    all-reduce (the JAX package's ``psum`` under a sharded eval), so each
    rank's ``compute`` gives the whole eval's value."""
    from trajsde_tpu_torch.parallel.mesh import all_reduce_

    pairs = [torch.as_tensor(v, dtype=torch.float32, device=device).clone()
             for m in metrics for v in (m._sum, m._count)]
    all_reduce_(pairs)
    for i, m in enumerate(metrics):
        m._sum, m._count = pairs[2 * i], pairs[2 * i + 1]


def make_metrics(names, metric_args) -> list:
    """Metric accumulators; ``per_source: true`` in an args dict adds the
    per-domain variants (``<name>_src0`` / ``<name>_src1``) beside the
    aggregate."""
    metrics = []
    for name, args in zip(names, metric_args):
        kwargs = {k: v for k, v in args.items() if k not in ("sources", "per_source")}
        metrics.append(TransferMetric(name, **kwargs))
        if args.get("per_source"):
            for sf in args.get("sources", [0, 1]):
                metrics.append(TransferMetric(name, source_filter=sf, **kwargs))
    return metrics
