"""Pinned host-to-card staging of scene batches, shared by the training
feed (``train/loop.py``'s ``device_prefetch``) and the serving engine
(``server.py``).  It needs no model code, so an engine that serves an
exported artifact imports none."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from trajsde_tpu_torch.data.scene import SceneBatch


class PinnedStager:
    """Copies CPU batches to the card on a stream of its own, through
    pinned host buffers allocated once: a ring of ``slots`` per batch
    layout (field names, shapes and dtypes).  A slot is written again only
    after the event recorded behind its last copy has completed, so no
    copy in flight reads a buffer being refilled."""

    def __init__(self, device: torch.device, slots: int):
        self.device, self.slots = device, slots
        self.stream = torch.cuda.Stream(device)
        self.rings: Dict[tuple, list] = {}
        self.turn: Dict[tuple, int] = {}

    def __call__(self, batch: SceneBatch) -> Tuple[SceneBatch, torch.cuda.Event]:
        present = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)
                   if getattr(batch, f.name) is not None}
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in present.items())
        if key not in self.rings:
            self.rings[key] = [[{k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                                 for k, v in present.items()}, None]
                               for _ in range(self.slots)]
            self.turn[key] = 0
        slot = self.rings[key][self.turn[key]]
        self.turn[key] = (self.turn[key] + 1) % self.slots
        pinned, last_copy = slot
        if last_copy is not None:
            last_copy.synchronize()
        out = {}
        with torch.cuda.stream(self.stream):
            for k, v in present.items():
                pinned[k].copy_(v)
                out[k] = pinned[k].to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        slot[1] = done
        return dataclasses.replace(batch, **out), done


def wait_for_copy(batch: SceneBatch, copied: torch.cuda.Event, device) -> SceneBatch:
    """``batch`` from a :class:`PinnedStager`, made safe to use on the
    current stream: the stream waits on the event behind the copy, and
    every tensor is marked as used on it, so the caching allocator does not
    hand its memory to the copy stream early."""
    compute = torch.cuda.current_stream(device)
    compute.wait_event(copied)
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if v is not None:
            v.record_stream(compute)
    return batch
