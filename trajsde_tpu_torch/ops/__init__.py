"""The hand-written kernels and their wrappers.

Each wrapper counts its kernel's launches in attributes of its own
(``sde_rollout.launches``, ``fused_pair_attention.bf16_launches``, ...),
registered here by :func:`counted` when its module is imported, so that a
caller that replays captured launches (a CUDA graph) adds what they
recorded without knowing which kernels there are.
"""
import re
from collections import Counter
from typing import Any, Callable, Dict, Iterable, List, Sequence, Tuple

# (wrapper, attribute) of every launch count, in the order of registration
COUNTERS: List[Tuple[Any, str]] = []


def counted(fn: Callable, *names: str) -> Callable:
    """Give ``fn`` the launch counts ``names`` (each 0) and register them."""
    for name in names:
        setattr(fn, name, 0)
        COUNTERS.append((fn, name))
    return fn


def read_counts() -> List[int]:
    """Every registered count, in :data:`COUNTERS`' order."""
    return [getattr(fn, name) for fn, name in COUNTERS]


def add_counts(counts: Sequence[int]) -> None:
    """Add ``counts`` (as :func:`read_counts` orders them) to the counts."""
    for (fn, name), n in zip(COUNTERS, counts):
        setattr(fn, name, getattr(fn, name) + n)


def zero_counts() -> None:
    """Every registered count to 0."""
    for fn, name in COUNTERS:
        setattr(fn, name, 0)


# Each kernel's __global__ name as torch.profiler's trace prints it, by the
# name its launch count goes by: K1-K6; K5b, the BF = true form of K5's
# template (``aa_attention_kernel<heads, BF>``); K3b and K4b, kernels of
# their own (``aa_fused_bf16_kernel<heads>``, K3 ``aa_fused_kernel<heads>``;
# ``aa_fused_bwd_bf16_kernel<heads>``, K4 ``aa_fused_bwd_kernel<heads>``)
TRACE_NAMES: Dict[str, str] = {
    "sde_rollout": r"\brollout_kernel\b",
    "sde_rollout_bwd": r"\brollout_bwd_kernel\b",
    "aa_fused": r"\baa_fused_kernel<\d+>",
    "aa_fused_bwd": r"\baa_fused_bwd_kernel<\d+>",
    "aa_attention": r"\baa_attention_kernel<\d+, false>",
    "vpu_probe": r"\bchained_tanh_(f32|bf16)\b",
    "aa_fused_bf16": r"\baa_fused_bf16_kernel<\d+>",
    "aa_fused_bwd_bf16": r"\baa_fused_bwd_bf16_kernel<\d+>",
    "aa_attention_bf16": r"\baa_attention_kernel<\d+, true>",
}


def traced_launches(names: Iterable[str]) -> Dict[str, int]:
    """How often each kernel of :data:`TRACE_NAMES` ran, from the names of
    a trace's device events."""
    counts = Counter(names)
    return {k: sum(c for n, c in counts.items() if re.search(rx, n))
            for k, rx in TRACE_NAMES.items()}
