"""Optimizer and learning-rate schedule (``trajsde_tpu/train/optim.py``).

AdamW (beta 0.9 / 0.999, eps 1e-8) with a per-step cosine decay from
``lr`` to ``eta_min`` over ``T_max`` epochs, written in closed form,
``lr * ((1 - a) * (1 + cos(pi * min(k, K) / K)) / 2 + a)`` with
``a = eta_min / lr``: the curve of ``optax.cosine_decay_schedule``.
(``CosineAnnealingLR`` computes it recursively and drifts from it.)
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

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
    return optimizer, scheduler


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
