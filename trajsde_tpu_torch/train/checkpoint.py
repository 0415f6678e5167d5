"""Checkpoints of a ``TrainState`` with a best-k leaderboard
(``trajsde_tpu/train/checkpoint.py``).

Each save is ``step_XXXXXXXX/state.pt``: ``torch.save`` of the model,
optimizer and scheduler state dicts, the step and the seed, written into a
temporary directory that is renamed into place, so a crash never leaves a
half-written checkpoint under its final name.  ``leaderboard.json`` keeps
the entries; pruning keeps the ``save_top_k`` best by the monitored metric
(``mode`` min or max) and, with ``keep_last``, the newest.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, save_top_k: int = 5, mode: str = "min",
                 keep_last: bool = True):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_top_k = save_top_k
        self.mode = mode
        self.keep_last = keep_last
        self._board_path = os.path.join(self.directory, "leaderboard.json")
        self._board = self._load_board()
        # an interrupted prune (rmtree before the board rewrite) can leave
        # entries whose directory is gone: drop them, so latest() and
        # restore() never pick a checkpoint that is not on disk
        live = [e for e in self._board if os.path.exists(e["path"])]
        if len(live) != len(self._board):
            self._board = live
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

    def save(self, state, metric: Optional[float], step: int) -> str:
        """Write ``state`` (a ``TrainState``) as step ``step`` with its
        monitored ``metric`` (None: unscored), then prune."""
        path = self._path(step)
        tmp = f"{path}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "step": int(state.step),
            "seed": int(state.seed),
        }, os.path.join(tmp, STATE_FILE))
        if os.path.exists(path):
            # re-reaching a step (a resumed run) replaces the stale save and
            # its entry: its metric belongs to other weights
            shutil.rmtree(path)
            self._board = [e for e in self._board if e["path"] != path]
        os.rename(tmp, path)
        self._board.append({"step": int(step), "metric": metric, "path": path})
        self._prune()
        self._write_board()
        return path

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
        scored = [e for e in self._board if e["metric"] is not None]
        if not scored:
            return None
        return (min if self.mode == "min" else max)(scored, key=lambda e: e["metric"])

    def latest(self) -> Optional[dict]:
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
