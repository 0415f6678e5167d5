"""Serving engine (``trajsde_tpu/server.py``): bucketed micro-batching
over a serving forward on one card.

``engine="kernel"`` serves through the rollout kernel
(:func:`~trajsde_tpu_torch.serving.make_serving_fn`, SDE decoders only);
``engine="scan"`` through the model's own forward in eval mode
(:func:`~trajsde_tpu_torch.serving.make_scan_fn`, any model: the HiVT
baseline serves so); ``"auto"`` picks ``kernel`` for an ``SDEDecoder`` and
``scan`` otherwise.  ``scan`` is never a fallback: an explicit ``kernel``
that fails raises.

``engine="exported"`` serves a :mod:`~trajsde_tpu_torch.deploy` artifact
(:meth:`ServingEngine.from_export`): the scan engine's forward and the
postprocess as one exported program per bucket, drawing from the same
``(seed, counter)`` stream; ``ood`` and ``slim`` need the live model.

``ServingEngine.predict(raw_scenes)`` grid-aligns preprocessor-output
scene dicts, packs them into padded batch buckets (the last scene repeats
to fill a bucket), runs the kernel serving forward and projects the
focal agent's modes back into the world frame.  ``pipeline=True`` (the
default) keeps one batch in flight: batch ``i + 1`` is aligned, packed,
copied and launched before batch ``i`` is collected, so the host's stages
overlap the card's compute.  Concurrent producers call
``submit(raw_scene) -> Future``; a worker thread groups what is queued,
up to ``max_batch`` scenes or ``max_wait_ms``, into one batch.
``warmup``, ``stats`` / ``reset_stats`` and ``close`` are the JAX
engine's.

On the card a packed batch goes in through pinned buffers on a copy
stream (a ring of two per bucket layout, ``data/staging.py``'s
``PinnedStager``), and the results come back into pinned host tensors
with non-blocking copies behind an event; nothing calls
``torch.cuda.synchronize()``.  Every batch's randomness derives on the
host from ``(seed, counter)``: the encoder draws from a
``torch.Generator`` seeded with ``mix_seed(seed, counter)``, and the
rollout kernel's seed is the same value, so the pipelined, serial and
submitted paths give one stream.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trajsde_tpu_torch.data.grid import NUS_SCALE, align_to_grid
from trajsde_tpu_torch.data.pack import pack_scenes, pick_bucket
from trajsde_tpu_torch.data.staging import PinnedStager, wait_for_copy
from trajsde_tpu_torch.device import resolve_device
from trajsde_tpu_torch.ops.sde_rollout import mix_seed

# The model code is imported where a live model is served: an engine over
# an exported artifact (engine="exported") imports none of it.

__all__ = ["EngineClosed", "ServingEngine", "align_scene", "make_postprocess", "mix_seed"]

# how long close() waits for the worker: a batch in flight may be the first
# of its kernels, which nvcc builds at first use
CLOSE_TIMEOUT_S = 600.0


class EngineClosed(RuntimeError):
    """The engine was closed before it could serve the request."""


def _set_future(f: Future, result=None, exc=None) -> None:
    """Resolve a future, tolerating one that was cancelled or already
    failed by ``close``: an ``InvalidStateError`` here must never escape
    into (and kill) the worker thread."""
    try:
        if exc is not None:
            f.set_exception(exc)
        else:
            f.set_result(result)
    except Exception:  # cancelled or already resolved: the caller is gone
        pass


def _start(f: Future) -> bool:
    """``set_running_or_notify_cancel``, False for a future that ``close``
    already failed as well as for a cancelled one."""
    try:
        return f.set_running_or_notify_cancel()
    except RuntimeError:
        return False


def make_postprocess(is_gtabs: bool, ref_time: int, slim: bool = False):
    """Focal-agent world-frame projection: agent modes rotated out of the
    agent frame and offset by its reference-time position, plus softmax
    mode scores.  Delta-target outputs (``is_gtabs=False``) are cumsummed
    and nuScenes rows scaled back to metres first.  ``slim=True`` drops the
    dense per-actor grids from the result."""

    from trajsde_tpu_torch.models.sde_encoder import gather_agent

    def postprocess(scene, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loc = out["loc"][..., :2]
        if not is_gtabs:
            loc = torch.cumsum(loc, dim=-2)
            scale = torch.where(scene.source == 0, NUS_SCALE, 1.0).to(loc.dtype)
            loc_m = loc * scale.reshape(scale.shape + (1,) * (loc.ndim - 1))
        else:
            loc_m = loc
        idx = scene.agent_index
        agent_loc = gather_agent(loc_m, idx, axis=2)                # [B, K, Tf, 2]
        ang = gather_agent(scene.rotate_angles, idx, axis=1)
        c, s = torch.cos(ang), torch.sin(ang)
        rot_t = torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)
        origin = gather_agent(scene.positions[:, :, ref_time], idx, axis=1)
        world = torch.einsum("bktj,bji->bkti", agent_loc, rot_t) + origin[:, None, None]
        pi = torch.softmax(gather_agent(out["pi"], idx, axis=1), dim=-1)
        res = {"agent_world": world, "agent_pi": pi}
        if not slim:
            res["loc"] = loc
            res["pi_all"] = out["pi"]
        if "stds" in out:
            res["stds"] = out["stds"].float()
            res["agent_std"] = gather_agent(res["stds"], idx, axis=1)
        return res

    return postprocess


def align_scene(raw: Dict[str, np.ndarray], is_gtabs: bool = True) -> Tuple[Dict, int]:
    """Grid-align one raw scene -> ``(aligned, seq_id)`` (seq_id -1 when
    the scene carries no identity)."""
    sid = int(np.asarray(raw["seq_id"])) if "seq_id" in raw else -1
    aligned = align_to_grid(dict(raw, source=raw.get("source", np.int32(0))),
                            is_gtabs=is_gtabs)
    return aligned, sid


class ServingEngine:
    """Bucketed serving of a model on ``device`` through ``engine``:
    ``predict`` for a caller's list of scenes, ``submit`` for concurrent
    producers.  With ``engine="exported"``, ``model`` is a loaded
    :class:`~trajsde_tpu_torch.deploy.ExportedServing` and ``device`` is
    its own (see :meth:`from_export`)."""

    def __init__(
        self,
        model,
        *,
        num_actors: int,
        num_lanes: int,
        device="cuda",
        engine: str = "auto",
        increments: str = "rademacher",
        batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128),
        max_batch=None,
        max_wait_ms: float = 5.0,
        is_gtabs: bool = True,
        ref_time: int = 20,
        seed: int = 0,
        ood: bool = False,
        slim: bool = False,
    ) -> None:
        if engine == "auto":
            from trajsde_tpu_torch.models.decoders import SDEDecoder

            # other decoders have no latent rollout for the kernel to take
            engine = "kernel" if isinstance(model.decoder, SDEDecoder) else "scan"
        if engine not in ("kernel", "scan", "exported"):
            raise ValueError(f"unknown serving engine {engine!r}: auto, kernel, scan or "
                             "exported")
        if engine == "exported":
            if not hasattr(model, "manifest"):
                raise ValueError("engine='exported' serves a loaded artifact "
                                 "(deploy.load_serving / ServingEngine.from_export), "
                                 f"not a {type(model).__name__}")
            if ood:
                raise ValueError(
                    "ood=True needs the live model (the OOD ensemble is not part "
                    "of an exported pipeline); use the 'scan'/'kernel' engines")
            if slim:
                raise ValueError(
                    "slim=True cannot shrink a deserialized export artifact's "
                    "outputs (the exported pipeline is frozen with the full "
                    "result set); use the 'scan'/'kernel' engines")
        self.engine = engine
        self.device = model.device if engine == "exported" else resolve_device(device)
        self.buckets = tuple(b for b in sorted(batch_buckets)
                             if max_batch is None or b <= max_batch)
        if not self.buckets:
            raise ValueError(f"max_batch={max_batch} excludes every batch bucket "
                             f"{tuple(sorted(batch_buckets))}")
        self.max_batch = self.buckets[-1]
        self.max_wait_ms = max_wait_ms
        self.num_actors = num_actors
        self.num_lanes = num_lanes
        self.is_gtabs = is_gtabs
        self.ood = ood
        self.slim = slim
        self._seed = int(seed)
        self._counter = 0
        self._lock = threading.Lock()
        if engine == "exported":
            # the artifact's program ends with the postprocess
            self._serve, self._post = model, lambda scene, out: out
        else:
            from trajsde_tpu_torch.serving import make_scan_fn, make_serving_fn

            self._serve = (make_serving_fn(model, self.device, increments=increments, ood=ood)
                           if engine == "kernel" else make_scan_fn(model, self.device, ood=ood))
            self._post = make_postprocess(is_gtabs, ref_time, slim=slim)
        self._stage = PinnedStager(self.device, 2) if self.device.type == "cuda" else None
        self._stage_lock = threading.Lock()

        # bounded windows: a long-running daemon must not grow without bound
        self._latencies = collections.deque(maxlen=100_000)
        self._batch_sizes = collections.deque(maxlen=100_000)
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._served = 0

        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._submit_lock = threading.Lock()
        self._held: List[Future] = []   # the worker's batch, from the queue to its results
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ API
    @classmethod
    def from_export(cls, path: str, *, device="cuda", max_batch=None,
                    max_wait_ms: float = 5.0, seed: int = 0) -> "ServingEngine":
        """Serve from a :mod:`trajsde_tpu_torch.deploy` artifact directory:
        the buckets, the packing dimensions and the whole pipeline come
        from the artifact, with no config, checkpoint or model code."""
        from trajsde_tpu_torch.deploy import load_serving

        exp = load_serving(path, device)
        return cls(exp, num_actors=exp.num_actors, num_lanes=exp.num_lanes, device=device,
                   engine="exported", batch_buckets=exp.buckets, max_batch=max_batch,
                   max_wait_ms=max_wait_ms, is_gtabs=exp.is_gtabs, ref_time=exp.ref_time,
                   seed=seed)

    def predict(self, raw_scenes: List[Dict[str, np.ndarray]],
                pipeline: bool = True) -> List[Dict]:
        """Batched prediction, ``max_batch`` scenes at a time, each batch
        padded to the bucket that covers it.  ``pipeline=True`` launches
        batch ``i + 1`` before it collects batch ``i``; the chunks, the
        buckets and the ``(seed, counter)`` stream are those of
        ``pipeline=False``, so the answers are the same."""
        out: List[Dict] = []
        pending = None   # (aligned scenes, batch in flight)
        for i in range(0, len(raw_scenes), self.max_batch):
            aligned = [self._align_scene(s) for s in raw_scenes[i: i + self.max_batch]]
            if not pipeline:
                out.extend(self._run_batch(aligned))
                continue
            handle = self._dispatch_batch(aligned)
            if pending is not None:
                out.extend(self._collect_batch(*pending))
            pending = (aligned, handle)
        if pending is not None:
            out.extend(self._collect_batch(*pending))
        return out

    def submit(self, raw_scene: Dict[str, np.ndarray]) -> Future:
        """Queue one scene; the worker groups concurrent requests.  The
        scene is validated and aligned here, so a malformed one raises to
        its own caller instead of failing the batch it would join."""
        aligned = self._align_scene(raw_scene)
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise EngineClosed("engine is closed")
            self._q.put((aligned, fut, time.perf_counter()))
        return fut

    def warmup(self, raw_scene: Dict[str, np.ndarray],
               buckets: Optional[Sequence[int]] = None) -> None:
        """Run each bucket once, unrecorded: the kernels build at first use,
        and the allocator and cuBLAS warm up."""
        aligned = self._align_scene(raw_scene)
        for b in buckets or self.buckets:
            self._run_batch([aligned] * b, record=False)

    def stats(self) -> Dict[str, Optional[float]]:
        with self._lock:
            lat = np.asarray(self._latencies, np.float64) * 1e3
            # first dispatch to last collect: every served batch's whole time
            span = (self._t_last - self._t_first
                    if self._served > 0 and self._t_last and self._t_first else None)
            return {
                "served": self._served,
                "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
                "p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
                "mean_batch": float(np.mean(self._batch_sizes)) if self._batch_sizes else None,
                "scenes_per_sec": self._served / span if span else None,
            }

    def reset_stats(self) -> None:
        """Zero the latency and occupancy windows (between benchmark phases)."""
        with self._lock:
            self._latencies.clear()
            self._batch_sizes.clear()
            self._t_first = self._t_last = None
            self._served = 0

    def close(self, timeout: float = CLOSE_TIMEOUT_S) -> None:
        """Refuse new requests, let the worker finish what it holds, and
        fail whatever is still queued with :class:`EngineClosed`.  If the
        worker has not finished within ``timeout`` seconds, the batch it
        holds fails too, and the worker exits when its call returns: no
        future is left pending."""
        with self._submit_lock:
            self._closed = True
        self._q.put(None)
        self._worker.join(timeout=timeout)
        stuck = self._worker.is_alive()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _set_future(item[1], exc=EngineClosed("engine closed"))
        if stuck:
            with self._lock:
                held = list(self._held)
            for f in held:
                _set_future(f, exc=EngineClosed(
                    f"engine closed: its worker did not finish this batch in {timeout:g} s"))
            self._q.put(None)   # the sentinel stays for the worker

    # ---------------------------------------------------------------- internals
    def _next_counter(self) -> int:
        with self._lock:
            self._counter += 1
            return self._counter

    def _align_scene(self, raw: Dict[str, np.ndarray]) -> Tuple[Dict, int]:
        return align_scene(raw, self.is_gtabs)

    def _run_batch(self, aligned_scenes: List[Tuple[Dict, int]], record: bool = True
                   ) -> List[Dict]:
        return self._collect_batch(aligned_scenes, self._dispatch_batch(aligned_scenes, record),
                                   record)

    def _dispatch_batch(self, aligned_scenes: List[Tuple[Dict, int]], record: bool = True):
        """Pack one batch, copy it in, launch its forward and the copies of
        its results to pinned host tensors, and return without waiting:
        ``(host tensors, event behind their copies)``, the event None on
        the CPU."""
        if record:
            # the throughput span starts at the first batch's dispatch
            now = time.perf_counter()
            with self._lock:
                if self._t_first is None:
                    self._t_first = now
        n = len(aligned_scenes)
        bucket = pick_bucket(n, self.buckets)
        aligned = [a for a, _ in aligned_scenes]
        padded = aligned + [aligned[-1]] * (bucket - n)   # already aligned: duplicate
        scene = pack_scenes(padded, self.num_actors, self.num_lanes)
        seed = mix_seed(self._seed, self._next_counter())
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            if self._stage is None:
                return self._post(scene, self._serve(scene, seed, generator=gen)), None
            with self._stage_lock:
                staged = self._stage(scene)
            scene = wait_for_copy(*staged, self.device)
            post = self._post(scene, self._serve(scene, seed, generator=gen))
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in post.items()}
            for k, v in post.items():
                host[k].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return host, done

    def _collect_batch(self, aligned_scenes: List[Tuple[Dict, int]], in_flight,
                       record: bool = True) -> List[Dict]:
        host, done = in_flight
        if done is not None:
            done.synchronize()
            # out of the pinned tensors, so results a caller keeps hold no
            # page-locked memory
            post = {k: v.numpy().copy() for k, v in host.items()}
        else:
            post = {k: v.numpy() for k, v in host.items()}
        n = len(aligned_scenes)
        if record:
            now = time.perf_counter()
            with self._lock:
                self._batch_sizes.append(n)
                self._served += n
                self._t_last = now   # t_first stamped at dispatch
        results = []
        for i in range(n):
            r = {
                "agent_world": post["agent_world"][i],
                "agent_pi": post["agent_pi"][i],
                "seq_id": np.int32(aligned_scenes[i][1]),
            }
            if not self.slim:
                r["loc"] = post["loc"][i]
                r["pi"] = post["pi_all"][i]
            if self.ood:
                r["ood_std"] = post["stds"][i]          # [A] per-actor score
                r["agent_std"] = post["agent_std"][i]   # the focal agent's
            results.append(r)
        return results

    def _run(self) -> None:
        """The micro-batcher: the first queued scene opens a batch, which
        takes what else arrives within ``max_wait_ms``, up to
        ``max_batch``.  ``torch.inference_mode`` is per thread, so it is
        entered here."""
        with torch.inference_mode():
            while True:
                item = self._q.get()
                if item is None:
                    return
                batch = [item]
                with self._lock:
                    self._held = [item[1]]
                deadline = time.perf_counter() + self.max_wait_ms / 1e3
                while len(batch) < self.max_batch:
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=left)
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._q.put(None)   # the sentinel again, for the outer loop
                        break
                    batch.append(nxt)
                    with self._lock:
                        self._held.append(nxt[1])
                # RUNNING from here on, so a caller's cancel() can no longer
                # race set_result; futures cancelled while queued drop out
                batch = [b for b in batch if _start(b[1])]
                if batch:
                    self._serve_queued(batch)
                with self._lock:
                    self._held = []

    def _serve_queued(self, batch) -> None:
        futs = [b[1] for b in batch]
        try:
            results = self._run_batch([b[0] for b in batch])
        except Exception as e:   # every waiting caller hears of it
            for f in futs:
                _set_future(f, exc=e)
            return
        done = time.perf_counter()
        with self._lock:
            self._latencies.extend(done - b[2] for b in batch)
        for f, r in zip(futs, results):
            _set_future(f, result=r)
