"""The hand-written kernels and their wrappers.

Each wrapper counts its kernel's launches in attributes of its own
(``sde_rollout.launches``, ``fused_pair_attention.bf16_launches``, ...),
registered here by :func:`counted` when its module is imported, so that a
caller that replays captured launches (a CUDA graph) adds what they
recorded without knowing which kernels there are.
"""
from typing import Any, Callable, List, Sequence, Tuple

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
