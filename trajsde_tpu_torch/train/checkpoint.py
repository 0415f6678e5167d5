"""Checkpoints of a ``TrainState`` with a best-k leaderboard
(``trajsde_tpu/train/checkpoint.py``).

Each save is ``step_XXXXXXXX/state.pt``: ``torch.save`` of the model,
optimizer and scheduler state dicts, the step and the seed, written into a
temporary directory that is renamed into place, so a crash never leaves a
half-written checkpoint under its final name.  ``leaderboard.json`` keeps
the entries; pruning keeps the ``save_top_k`` best by the monitored metric
(``mode`` min or max) and, with ``keep_last``, the newest.

``async_save=True`` overlaps the file write with training: ``save`` copies
the state to host memory (``state_dict()`` hands out the live tensors,
which the next ``optimizer.step()`` changes in place) and returns, and a
writer thread writes and renames the directory.  Its board entry lands
only once the write has: the next save, ``wait()``, ``best()``,
``latest()`` and the restores land it first, so the board never lists a
directory still being written and ``_prune`` never deletes one.  A save
with ``wait=True`` (the trainer's preemption save) is synchronous.

In a process group every rank calls ``save``: a ZeRO-1 optimizer first
gathers its partitioned moments on rank 0 (``consolidate_state_dict``, a
collective), then rank 0 alone writes the directory and the board (and
runs the writer thread).  The checkpoint holds the plain AdamW layout, so
it restores on any number of ranks, with ZeRO-1 or without.  Every rank
restores.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import torch

from trajsde_tpu_torch.parallel import mesh

STATE_FILE = "state.pt"


def host_copy(obj: Any) -> Any:
    """``obj`` with every tensor copied to host memory (a new tensor even
    when it is on the CPU already), dicts, lists and tuples rebuilt."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


def save_weights(state_dict: dict, path: str) -> str:
    """A weights-only step directory: ``path/state.pt`` holding
    ``{"model": state_dict}``, which ``CheckpointManager.restore_params``
    reads (``test_torch.py --ckpt``, ``train_torch.py --wonly``).  Written as
    ``save`` writes a step, through a temporary directory renamed into
    place; no leaderboard entry.  Returns the absolute path."""
    path = os.path.abspath(path)
    CheckpointManager._write(host_copy({"model": state_dict}), path)
    return path


class CheckpointManager:
    """Rank 0 of a process group (or the single process) writes; another
    rank only joins ``save``'s collective and reads."""

    def __init__(self, directory: str, save_top_k: int = 5, mode: str = "min",
                 keep_last: bool = True, async_save: bool = False):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = os.path.abspath(directory)
        self.primary = mesh.is_primary()
        if self.primary:
            os.makedirs(self.directory, exist_ok=True)
        self.save_top_k = save_top_k
        self.mode = mode
        self.keep_last = keep_last
        self.async_save = async_save
        # (writer thread, board entry, [the writer's error]) of the save in flight
        self._pending: Optional[tuple] = None
        self._board_path = os.path.join(self.directory, "leaderboard.json")
        self._board = self._load_board()
        # an interrupted prune (rmtree before the board rewrite) can leave
        # entries whose directory is gone: drop them, so latest() and
        # restore() never pick a checkpoint that is not on disk
        live = [e for e in self._board if os.path.exists(e["path"])]
        if len(live) != len(self._board):
            self._board = live
            if self.primary:
                self._write_board()

    def _load_board(self):
        if os.path.exists(self._board_path):
            with open(self._board_path) as f:
                return json.load(f)
        return []

    def _write_board(self):
        tmp = f"{self._board_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self._board, f, indent=2)
        os.replace(tmp, self._board_path)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, state, metric: Optional[float], step: int, wait: bool = False) -> str:
        """Write ``state`` (a ``TrainState``) as step ``step`` with its
        monitored ``metric`` (None: unscored), then prune; with
        ``async_save`` and not ``wait``, the write and the board entry
        follow on the writer thread (see the module's docstring).  Every
        rank of a process group calls it; only the primary writes."""
        self._flush_pending()
        path = self._path(step)
        consolidate = getattr(state.optimizer, "consolidate_state_dict", None)
        if consolidate is not None:   # ZeRO-1: the moments gather on rank 0
            consolidate(to=0)
        if not self.primary:
            return path
        payload = host_copy({
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "step": int(state.step),
            "seed": int(state.seed),
        })
        entry = {"step": int(step), "metric": metric, "path": path}
        if wait or not self.async_save:
            self._write(payload, path)
            self._land(entry)
            return path
        error: list = []

        def writer():
            try:
                self._write(payload, path)
            except BaseException as e:  # re-raised where the save lands
                error.append(e)

        thread = threading.Thread(target=writer, name="checkpoint-writer")
        thread.start()
        self._pending = (thread, entry, error)
        return path

    @staticmethod
    def _write(payload: dict, path: str) -> None:
        tmp = f"{path}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if os.path.exists(path):
            # re-reaching a step (a resumed run) replaces the stale save
            shutil.rmtree(path)
        os.rename(tmp, path)

    def _land(self, entry: dict) -> None:
        # a stale entry of the same directory goes: its metric belongs to
        # other weights
        self._board = [e for e in self._board if e["path"] != entry["path"]]
        self._board.append(entry)
        self._prune()
        self._write_board()

    def _flush_pending(self) -> None:
        if self._pending is None:
            return
        thread, entry, error = self._pending
        thread.join()
        self._pending = None
        if error:
            raise error[0]
        self._land(entry)

    def wait(self) -> None:
        """Block until an asynchronous save has landed, board entry included."""
        self._flush_pending()

    def _prune(self) -> None:
        scored = [e for e in self._board if e["metric"] is not None]
        scored.sort(key=lambda e: e["metric"], reverse=self.mode == "max")
        keep = {e["path"] for e in scored[: self.save_top_k]}
        if self.keep_last and self._board:
            keep.add(self._board[-1]["path"])
        for entry in list(self._board):
            if entry["path"] not in keep:
                self._board.remove(entry)
                shutil.rmtree(entry["path"], ignore_errors=True)

    def best(self) -> Optional[dict]:
        self._flush_pending()
        scored = [e for e in self._board if e["metric"] is not None]
        if not scored:
            return None
        return (min if self.mode == "min" else max)(scored, key=lambda e: e["metric"])

    def latest(self) -> Optional[dict]:
        self._flush_pending()
        return self._board[-1] if self._board else None

    @staticmethod
    def _read(path: str, device) -> dict:
        file = os.path.join(path, STATE_FILE)
        if not os.path.exists(file):
            raise FileNotFoundError(f"no checkpoint at {path}")
        return torch.load(file, map_location=device, weights_only=True)

    def restore(self, state, path: Optional[str] = None):
        """Full resume: model, optimizer, scheduler, step and seed of the
        checkpoint at ``path`` (default: the latest) into ``state``."""
        self._flush_pending()   # the save of this path may be in flight
        if path is None:
            entry = self.latest()
            if entry is None:
                return state
            path = entry["path"]
        dev = next(state.model.parameters()).device
        saved = self._read(path, dev)
        state.model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        state.scheduler.load_state_dict(saved["scheduler"])
        state.step = saved["step"]
        state.seed = saved["seed"]
        return state

    def restore_params(self, model: torch.nn.Module, path: str) -> torch.nn.Module:
        """Weights-only warm start: the checkpoint's model weights into
        ``model``; a leaf of another shape raises instead of being
        reinterpreted."""
        self._flush_pending()
        weights = self._read(path, next(model.parameters()).device)["model"]
        own = model.state_dict()
        for name, value in weights.items():
            if name in own and tuple(own[name].shape) != tuple(value.shape):
                raise ValueError(
                    f"checkpoint leaf {name!r} has shape {tuple(value.shape)} but the "
                    f"model expects {tuple(own[name].shape)}"
                )
        model.load_state_dict(weights)
        return model
