"""Optimizer and learning-rate schedule (``trajsde_tpu/train/optim.py``).

AdamW (beta 0.9 / 0.999, eps 1e-8) with a per-step cosine decay from
``lr`` to ``eta_min`` over ``T_max`` epochs, written in closed form,
``lr * ((1 - a) * (1 + cos(pi * min(k, K) / K)) / 2 + a)`` with
``a = eta_min / lr``: the curve of ``optax.cosine_decay_schedule``.
(``CosineAnnealingLR`` computes it recursively and drifts from it.)

:class:`DeviceAdamW` is the same update and schedule computed on the
device from a device count of finite updates, for the chained train step,
which reads nothing on the host between its updates.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

NO_DECAY_LEAVES = ("bias",)
NO_DECAY_SCOPES = ("norm", "ln", "bos_token", "cls_token", "padding_token",
                   "pos_embed", "hidden", "gru")


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """HiVT-style weight-decay mask by parameter name: no decay on biases,
    norms, tokens or the GRU gates.  The port's names are the flax paths
    (:mod:`trajsde_tpu_torch.bridge`), so this picks the same leaves as
    the JAX package's mask."""
    mask = {}
    for name, _ in model.named_parameters():
        keys = name.lower().split(".")
        mask[name] = keys[-1] not in NO_DECAY_LEAVES and not any(
            s in k for k in keys for s in NO_DECAY_SCOPES)
    return mask


def cosine_factor(k: int, decay_steps: int, alpha: float) -> float:
    """The schedule's multiplier of ``lr`` at update ``k`` (0-based)."""
    cosine = 0.5 * (1.0 + math.cos(math.pi * min(k, decay_steps) / decay_steps))
    return (1.0 - alpha) * cosine + alpha


def cosine_factor_tensor(k: torch.Tensor, decay_steps: int, alpha: float) -> torch.Tensor:
    """:func:`cosine_factor` of an f64 count ``k`` on its device, in the
    same operations and order."""
    cosine = 0.5 * (1.0 + torch.cos(math.pi * k.clamp(max=decay_steps) / decay_steps))
    return (1.0 - alpha) * cosine + alpha


def cosine_adamw(model: nn.Module, lr: float, weight_decay: float, t_max_epochs: int,
                 steps_per_epoch: int, eta_min: float = 0.0, nodecay: bool = False,
                 zero1: bool = False
                 ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over ``model``'s parameters and its per-step cosine schedule;
    call ``scheduler.step()`` after each ``optimizer.step()``.
    ``nodecay=True`` puts the :func:`decay_mask` leaves in a group without
    weight decay.  ``zero1=True`` partitions the moments over the process
    group's ranks (ZeRO-1, :func:`trajsde_tpu_torch.parallel.mesh.zero1_adamw`)."""
    params = dict(model.named_parameters())
    if nodecay:
        mask = decay_mask(model)
        groups = [{"params": [p for n, p in params.items() if mask[n]],
                   "weight_decay": weight_decay},
                  {"params": [p for n, p in params.items() if not mask[n]],
                   "weight_decay": 0.0}]
    else:
        groups = [{"params": list(params.values()), "weight_decay": weight_decay}]
    if zero1:
        from trajsde_tpu_torch.parallel.mesh import zero1_adamw

        optimizer = zero1_adamw(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    else:
        optimizer = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    decay_steps = max(1, t_max_epochs * steps_per_epoch)
    alpha = eta_min / lr if lr else 0.0
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda k: cosine_factor(k, decay_steps, alpha))
    scheduler.cosine = (decay_steps, alpha)   # the curve, for DeviceAdamW
    return optimizer, scheduler


class DeviceAdamW:
    """``optimizer.step(); scheduler.step()`` of :func:`cosine_adamw`, with
    the NaN guard, computed on the device: nothing is read on the host.

    ``count`` (an f64 scalar on ``device``) is the number of finite updates,
    the schedule's position; each update takes its learning rate from it by
    :func:`cosine_factor_tensor` and AdamW's bias corrections from
    ``count + 1``, in f64, then rounds each scalar to f32 where the eager
    step's foreach kernels round the host's (optax keeps one count too).
    The state is ``optimizer``'s own, ``exp_avg``, ``exp_avg_sq`` and
    ``step`` of each parameter, so a checkpoint does not depend on which
    path wrote it.  A parameter without a gradient is left alone, as AdamW
    leaves it.

    :meth:`step` takes the update's finite flag (a 0-d bool on the device):
    where it is False the parameters, the moments, the step counts and
    ``count`` keep their values (a snapshot and a masked copy, the JAX
    package's guarded update).  :meth:`begin` sets ``count`` from the
    schedule before a run of updates, :meth:`finish` moves the schedule and
    the groups' ``lr`` to a count read back on the host.

    torch's ``AdamW(capturable=True)`` refuses CPU tensors, and the chained
    step is one function on the CPU and on the card; this class writes
    AdamW's arithmetic in foreach operations that run on both, in eager
    AdamW's order on the CPU (so a chained update there is the eager
    step's bits).  Eager AdamW on a card orders its last operations
    otherwise, so there a weight may come out an ulp apart, and from the
    next update on the runs part as :func:`chain_eager_bound` bounds.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, scheduler, device):
        if type(optimizer) is not torch.optim.AdamW or any(
                g["amsgrad"] or g["maximize"] for g in optimizer.param_groups):
            raise NotImplementedError("DeviceAdamW runs the plain AdamW of cosine_adamw "
                                      f"(got {type(optimizer).__name__})")
        self.optimizer, self.scheduler = optimizer, scheduler
        self.decay_steps, self.alpha = scheduler.cosine
        self.count = torch.zeros((), dtype=torch.float64, device=device)
        # one snapshot buffer per state tensor, kept for the optimizer's life
        # (a CUDA graph that captured a copy into it replays into it)
        self._snapshots: Dict[int, torch.Tensor] = {}

    def begin(self) -> None:
        """``count`` from the schedule's position, and every ``step`` on its
        parameter's device (eager AdamW keeps it on the host)."""
        self.count.fill_(float(self.scheduler.last_epoch))
        for p, st in self.optimizer.state.items():
            if "step" in st and st["step"].device != p.device:
                st["step"] = st["step"].to(p.device)

    def finish(self, count: int) -> None:
        """The schedule at ``count`` finite updates (read from ``count``),
        with each group's ``lr`` the eager scheduler's after as many steps."""
        sched = self.scheduler
        sched._step_count += int(count) - sched.last_epoch
        sched.last_epoch = int(count)
        lrs = [base * lam(sched.last_epoch) for base, lam in zip(sched.base_lrs, sched.lr_lambdas)]
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        sched._last_lr = lrs

    def _state(self, p: torch.Tensor) -> dict:
        st = self.optimizer.state[p]
        if not st:   # AdamW's lazy init
            st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return st

    def _snapshot(self, live: List[torch.Tensor]) -> List[torch.Tensor]:
        for t in live:
            if id(t) not in self._snapshots:
                self._snapshots[id(t)] = torch.empty_like(t)
        return [self._snapshots[id(t)] for t in live]

    @torch.no_grad()
    def step(self, finite: torch.Tensor) -> None:
        groups = []
        for group, base_lr in zip(self.optimizer.param_groups, self.scheduler.base_lrs):
            ps = [p for p in group["params"] if p.grad is not None]
            states = [self._state(p) for p in ps]
            if ps:
                groups.append((group, base_lr, ps, [p.grad for p in ps],
                               [st["exp_avg"] for st in states],
                               [st["exp_avg_sq"] for st in states],
                               [st["step"] for st in states]))
        live = [t for g in groups for t in g[2] + g[4] + g[5] + g[6]]
        snap = self._snapshot(live)
        torch._foreach_copy_(snap, live)
        factor = cosine_factor_tensor(self.count, self.decay_steps, self.alpha)
        k = self.count + 1.0
        for group, base_lr, ps, gs, ms, vs, steps in groups:
            beta1, beta2 = group["betas"]
            lr = base_lr * factor
            torch._foreach_add_(steps, 1.0)
            if group["weight_decay"] != 0:
                torch._foreach_mul_(ps, (1.0 - lr * group["weight_decay"]).float())
            torch._foreach_lerp_(ms, gs, 1.0 - beta1)
            torch._foreach_mul_(vs, beta2)
            torch._foreach_addcmul_(vs, gs, gs, 1.0 - beta2)
            step_size = ((lr / (1.0 - beta1 ** k)) * -1.0).float()
            denom = torch._foreach_sqrt(vs)
            torch._foreach_div_(denom, torch.sqrt(1.0 - beta2 ** k).float())
            torch._foreach_add_(denom, group["eps"])
            # eager AdamW's order on the CPU, p + (s * m) / d, on every device
            torch._foreach_addcdiv_(ps, torch._foreach_mul(ms, step_size), denom)
        for t, old in zip(live, snap):
            torch.where(finite, t, old, out=t)
        self.count.add_(finite.to(self.count.dtype))


# The key-bias entries of every softmax attention: a shift common to a
# query's keys, which the softmax does not see, so their exact gradient is
# 0 and what the backward computes is rounding.  EdgeAttention's
# ``lin_k.bias`` and ``lin_k_edge.bias`` are whole leaves;
# MultiheadSelfAttention packs q, k and v into one ``in_proj``, whose key
# bias is rows D:2D of ``in_proj.bias`` (the rest is the q and v biases,
# which the output sees).  In f32 these entries read max|g| 3e-12 to 2e-10
# on FLAGSHIP_H100 at batch 128 on an H100, where every other leaf reads
# 7e-5 or more (scripts/chain_gap_torch.py), below NOISE_GRAD; in bf16 the
# rounding of the backward is far larger.  At Adam's eps of 1e-8, Adam
# turns such noise into steps of up to about lr, and two runs that round
# apart draw different noise, so those entries part by up to that much;
# the model's outputs do not see them.
NOISE_GRAD = 1e-6
KEY_BIAS = r"\.lin_k(_edge)?\.bias$"
PACKED_QKV_BIAS = r"\.in_proj\.bias$"


def noise_entries(params: Mapping[str, torch.Tensor]) -> Dict[str, slice]:
    """The key-bias entries of ``params`` (a model's named parameters, a
    state dict or a gradient dict, by the port's names): ``{name: the slice
    of its first axis}``, the whole leaf for ``lin_k.bias`` /
    ``lin_k_edge.bias`` and rows D:2D for a packed ``in_proj.bias`` [3D]."""
    out = {}
    for name, p in params.items():
        if re.search(KEY_BIAS, name):
            out[name] = slice(None)
        elif re.search(PACKED_QKV_BIAS, name):
            d = p.shape[0] // 3
            out[name] = slice(d, 2 * d)
    return dict(sorted(out.items()))


def _entries(t: torch.Tensor, sl: Optional[slice], inside: bool) -> torch.Tensor:
    """``t``'s entries in the slice ``sl`` of its first axis (``inside``), or
    the others (None: every entry)."""
    if sl is None:   # no entry named: every entry is outside
        return t.reshape(-1)[:0] if inside else t
    if sl == slice(None):   # the whole leaf
        return t if inside else t.reshape(-1)[:0]
    if not inside:
        keep = torch.ones(t.shape[0], dtype=torch.bool, device=t.device)
        keep[sl] = False
        return t[keep]
    return t[sl]


def largest_gap(got: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor],
                skip: Mapping[str, slice] = {}, inside: bool = False) -> Tuple[float, str]:
    """The largest ``|got - want|`` over the floating leaves of ``want``
    outside the entries ``skip`` names (:func:`noise_entries`' form), and
    its leaf; with ``inside=True`` over those entries only."""
    gaps = []
    for k, w in want.items():
        if not w.is_floating_point() or (inside and k not in skip):
            continue
        d = _entries((got[k].double() - w.double()).abs(), skip.get(k), inside)
        if d.numel():
            gaps.append((d.max().item(), k))
    return max(gaps)


def leaf_rel_gaps(got: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor],
                  start: Mapping[str, torch.Tensor],
                  skip: Mapping[str, slice] = {}) -> List[Tuple[float, str]]:
    """``||got - want||_2 / ||want - start||_2`` of each floating leaf of
    ``want`` that moved from ``start``, outside the entries ``skip`` names,
    largest first: how far a chain's leaf lies from the eager steps', in
    units of how far those steps moved it."""
    gaps = []
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        moved = _entries(w.double() - start[k].double(), skip.get(k), False)
        off = _entries(got[k].double() - w.double(), skip.get(k), False)
        den = float(moved.norm()) if moved.numel() else 0.0
        if den > 0.0:
            gaps.append((float(off.norm()) / den, k))
    return sorted(gaps, reverse=True)


def grad_split(grads: Mapping[str, Optional[torch.Tensor]],
               entries: Mapping[str, slice]) -> Tuple[float, float, str]:
    """(the largest |g| on ``entries``, the smallest max|g| of a leaf outside
    them whose gradient is not 0, and that leaf): in f32 the first reads
    below :data:`NOISE_GRAD` and the second above it, which is what makes
    ``entries`` the rounding noise."""
    noise, rest = 0.0, []
    for k, g in grads.items():
        if g is None:
            continue
        g = torch.as_tensor(g).abs()
        if k in entries:
            inner = _entries(g, entries[k], True)
            noise = max(noise, float(inner.max()) if inner.numel() else 0.0)
        outer = _entries(g, entries.get(k), False)
        if outer.numel() and float(outer.max()) > 0.0:
            rest.append((float(outer.max()), k))
    least = min(rest)
    return noise, least[0], least[1]


def chain_eager_gap(got: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor],
                    start: Mapping[str, torch.Tensor], dtype: str = "float32"
                    ) -> Tuple[float, str]:
    """The distance that :func:`chain_eager_bound` bounds, of a chain's
    weights ``got`` from the eager steps' ``want`` (both trained from
    ``start``), outside the :func:`noise_entries`, and its leaf: in f32 the
    largest ``|got - want|``; in bf16 the largest :func:`leaf_rel_gaps`."""
    noise = noise_entries(want)
    if dtype == "float32":
        return largest_gap(got, want, noise)
    return leaf_rel_gaps(got, want, start, noise)[0]


def chain_eager_bound(lr: float, updates: int, dtype: str = "float32") -> float:
    """How far a chain's weights may lie from the eager steps' after
    ``updates`` chained updates on the card, by :func:`chain_eager_gap`,
    for chains of up to 4 updates.  Update 1 sees the same weights and
    draws as the eager step; the two AdamWs round their last operations
    apart, and from update 2 on the gradients, and so the weights, part
    further with each update.

    f32: 0.2 lr.  Read on an H100 on FLAGSHIP_H100 at lr 1e-3 after 4
    updates: 1.50e-5 (0.015 lr) on synthetic batches of 128, 8.60e-5
    (0.086 lr) over an epoch of the command line on npz files
    (``chip_smoke.py`` phases U3 and U5); 2.16e-4 after 8 and 3.11e-4 after
    12 on the batches of 128 (``scripts/chain_gap_torch.py``), so longer
    chains would need a bound of their own.  A leaf the eager steps train
    lies 1.2e-3 to 4.0e-3 from where it started, and an update of the wrong
    sign 8.0e-3 away: a chain that left one unchanged, or stepped the wrong
    way, fails it.

    bf16: no distance in lr separates.  Each weight is cast to bf16 at
    every use, so once two runs' weights part by an ulp a cast can round
    the other way, and an entry whose gradient lies near 0 then takes
    Adam's step of about lr in the other direction: after 2 updates of
    FLAGSHIP_BF16_FUSED at batch 64 one entry lies 1.59e-3 off at lr 1e-3,
    above the 1.44e-3 that the least-moving trained leaf moved.  Such
    entries are few, so the bar is on each leaf's L2 distance over how far
    the eager steps moved it (:func:`leaf_rel_gaps`): 0.1, which a leaf left
    unchanged (1) and the wrong sign (2) fail.  Read by
    ``scripts/chain_gap_torch.py`` on an H100 at lr 1e-3, the largest leaf
    after 2 / 4 updates: FLAGSHIP_BF16_FUSED at batch 64 0.015 / 0.024,
    FLAGSHIP_BF16_CAPPED at 128 9.0e-6 / 0.0060, FLAGSHIP_BF16 at 64 0.040 /
    0.033 (and after 8: 0.039, 0.016); FLAGSHIP_H100 in f32 3.1e-4 after 4."""
    if updates > 4:
        raise ValueError(f"chain_eager_bound is read for chains of up to 4 updates, "
                         f"not {updates}")
    return 0.2 * lr if dtype == "float32" else 0.1


def build_optimizer(model: nn.Module, training_cfg: dict, steps_per_epoch: int,
                    zero1: bool = False):
    """``(optimizer, scheduler)`` from a config's ``training_specific``."""
    return cosine_adamw(
        model,
        lr=training_cfg.get("lr", 1e-3),
        weight_decay=training_cfg.get("weight_decay", 0.0),
        t_max_epochs=training_cfg.get("T_max", training_cfg.get("max_epochs", 100)),
        steps_per_epoch=steps_per_epoch,
        nodecay=bool(training_cfg.get("nodecay", False)),
        zero1=zero1,
    )
