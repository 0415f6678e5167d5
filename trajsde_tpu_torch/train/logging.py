"""Run logging: scalars, a snapshot of the sources, a profiler window
(``trajsde_tpu/train/logging.py``).

* :class:`ExperimentLogger` appends one JSON record per log call to
  ``metrics.jsonl`` (``step``, ``time``, then the scalars by name) and writes the
  same scalars to TensorBoard where ``torch.utils.tensorboard`` imports.
* :func:`snapshot_sources` copies the package into the run directory.
* :class:`ProfilerHook` traces a window of steps with ``torch.profiler``
  and writes a Chrome trace under ``<run_dir>/profile/``.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
import traceback
from typing import Dict, Optional

import torch


def _tensorboard_writer(log_dir: str):
    """A ``SummaryWriter`` when the ``tensorboard`` package is present,
    else None."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:  # no tensorboard package: metrics.jsonl alone
        return None
    return SummaryWriter(log_dir)


class ExperimentLogger:
    """Scalars to ``metrics.jsonl`` and, where it imports, TensorBoard.

    :meth:`log_scalars_async` takes values that may still be device
    tensors: one worker thread reads them (``float``, which waits for the
    device) and writes the records in submit order, so the training loop
    does not wait for a log line.
    """

    def __init__(self, log_dir: str):
        self.log_dir = os.path.abspath(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        self._tb = _tensorboard_writer(self.log_dir)
        self._q: Optional[queue.Queue] = None   # the async worker starts on first use
        self._worker: Optional[threading.Thread] = None

    def _write(self, step: int, scalars: Dict[str, object], t: float) -> None:
        record = {"step": step, "time": t}
        for k in sorted(scalars):   # the JAX logger's order (its device_get sorts the keys)
            v = float(scalars[k])
            record[k] = v
            if self._tb is not None:
                self._tb.add_scalar(k, v, step)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def log_scalars(self, step: int, scalars: Dict[str, object]) -> None:
        self.flush()   # after every queued async record
        self._write(step, scalars, time.time())

    def log_scalars_async(self, step: int, scalars: Dict[str, object]) -> None:
        """Queue a record whose values may be device tensors; the worker
        thread reads them."""
        if self._q is None:
            self._q = queue.Queue(maxsize=64)

            def drain():
                while True:
                    item = self._q.get()
                    if item is None:
                        self._q.task_done()
                        return
                    try:
                        self._write(*item)
                    except Exception:  # a log line never ends a training run
                        traceback.print_exc()
                    finally:
                        self._q.task_done()

            self._worker = threading.Thread(target=drain, daemon=True)
            self._worker.start()
        self._q.put((step, dict(scalars), time.time()))

    def flush(self) -> None:
        """Wait until every queued record is on disk."""
        if self._q is not None:
            self._q.join()

    def close(self) -> None:
        if self._q is not None:
            self.flush()
            self._q.put(None)
            self._worker.join(timeout=10)
            self._q = None
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def snapshot_sources(log_dir: str, package_root: Optional[str] = None) -> str:
    """Copy the package's sources (default: ``trajsde_tpu_torch``) into
    ``<log_dir>/source_snapshot/``, without built kernels and caches, so a
    run keeps the code that produced it.  Returns the snapshot directory."""
    if package_root is None:
        package_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dest = os.path.join(log_dir, "source_snapshot")
    if os.path.exists(dest):
        shutil.rmtree(dest)
    shutil.copytree(package_root, os.path.join(dest, os.path.basename(package_root)),
                    ignore=shutil.ignore_patterns("_build", "__pycache__", "*.pyc", "*.so"))
    return dest


class ProfilerHook:
    """A ``torch.profiler`` trace of steps ``[start_step, start_step +
    num_steps)``, CPU and (where a card is present) CUDA activities.

    ``on_step(n)`` runs before step ``n``; a run resumed past
    ``start_step`` but inside the window still traces.  :meth:`stop` ends
    the window early (``Trainer.fit`` calls it on the way out, so a short
    run still leaves its trace) and writes ``profile/trace_step<N>.json``,
    N the window's first step.
    """

    def __init__(self, log_dir: str, start_step: int, num_steps: int = 5):
        self.trace_dir = os.path.join(log_dir, "profile")
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None
        self._first = None

    def on_step(self, step: int) -> None:
        if self.start_step <= step < self.stop_step and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self._first = step
        elif step >= self.stop_step and self._prof is not None:
            self.stop()

    def stop(self) -> None:
        """Close an open window and write its trace."""
        if self._prof is None:
            return
        self._prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(self.trace_dir, f"trace_step{self._first}.json"))
        self._prof = None
