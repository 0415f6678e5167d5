"""The port's serving engine beyond ``predict`` on the CPU, held against
the JAX engine (``trajsde_tpu/server.py``) where its behaviour is the
contract: the pipelined ``predict``, ``submit`` and the micro-batcher,
``warmup``, ``stats`` / ``reset_stats`` and ``close``.

Every ``Future.result``, join and wait has a timeout, so a hang fails the
test instead of the lane.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from trajsde_tpu.server import ServingEngine as JaxEngine
from trajsde_tpu_torch.data.synthetic import make_raw_scene
from trajsde_tpu_torch.server import EngineClosed, ServingEngine

from _torch_helpers import model_pair, scene_pair, small_cfg

torch.set_num_threads(1)
A, L = 5, 6
WAIT_S = 60


@pytest.fixture(scope="module")
def models():
    js, _ = scene_pair(1, 2, A, L)
    jm, params, tm = model_pair(small_cfg(), js)
    return dict(jm=jm, params=params, tm=tm)


def _scenes(n, seed=0):
    rng = np.random.default_rng(seed)
    return [make_raw_scene(rng, s % 2, num_actors=4, num_lanes=5) for s in range(n)]


def _engine(models, **kw):
    kw = dict(dict(device="cpu", num_actors=A, num_lanes=L, batch_buckets=(1, 2, 4)), **kw)
    return ServingEngine(models["tm"], **kw)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_pipelined_predict_is_bit_equal_to_serial(models):
    """Five scenes at max_batch 2: three batches (2, 2, 1), each launched
    before the one before it is collected; the same chunks, buckets and
    (seed, counter) stream as the serial path."""
    scenes = _scenes(5)
    piped, serial = _engine(models, seed=5, max_batch=2), _engine(models, seed=5, max_batch=2)
    try:
        _assert_same(piped.predict(scenes), serial.predict(scenes, pipeline=False))
        assert piped._counter == serial._counter == 3
        assert piped.stats()["served"] == serial.stats()["served"] == 5
        assert piped.stats()["mean_batch"] == serial.stats()["mean_batch"] == 5 / 3
    finally:
        piped.close()
        serial.close()


def test_submit_equals_predict_of_one_scene(models):
    scene = _scenes(1, seed=3)[0]
    a, b = _engine(models, seed=7), _engine(models, seed=7)
    try:
        _assert_same([a.submit(scene).result(timeout=WAIT_S)], b.predict([scene]))
    finally:
        a.close()
        b.close()


def test_micro_batcher_groups_concurrent_submits(models):
    """A long window groups what eight threads submit at once; every
    future resolves, and the latency window has its quantiles."""
    eng = _engine(models, max_wait_ms=300.0)
    scenes = _scenes(8, seed=1)
    futs = [None] * len(scenes)

    def send(i):
        futs[i] = eng.submit(scenes[i])

    try:
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(scenes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        results = [f.result(timeout=WAIT_S) for f in futs]
        assert all(np.isfinite(r["agent_world"]).all() for r in results)
        st = eng.stats()
        assert st["served"] == 8 and st["mean_batch"] > 1.0
        assert st["p50_ms"] > 0 and st["p99_ms"] >= st["p50_ms"]
    finally:
        eng.close()
    with pytest.raises(EngineClosed):
        eng.submit(scenes[0])


def test_cancelled_future_does_not_kill_worker(models):
    """As JAX's ``test_cancelled_future_does_not_kill_worker``: cancels
    race the worker from both queue states, and a later submission still
    resolves."""
    eng = _engine(models, max_wait_ms=1.0)
    scene = _scenes(1)[0]
    eng.warmup(scene)
    try:
        for _ in range(10):
            eng.submit(scene).cancel()
        r = eng.submit(scene).result(timeout=WAIT_S)
        assert np.isfinite(r["agent_world"]).all()
        assert eng._worker.is_alive()
    finally:
        eng.close()


def test_errors_reach_their_callers(models):
    """A malformed scene raises to its own caller at submit, and the scene
    queued beside it is served (seq_id -1: it carries none).  A batch that
    fails fails every future in it, and the worker goes on serving."""
    eng = _engine(models, max_wait_ms=200.0)
    good = eng.submit(_scenes(1)[0])
    with pytest.raises(Exception):
        eng.submit({"not": np.zeros(1)})
    r = good.result(timeout=WAIT_S)
    assert np.isfinite(r["agent_world"]).all() and int(r["seq_id"]) == -1

    serve = eng._serve
    eng._serve = lambda *a, **k: (_ for _ in ()).throw(ValueError("device fault"))
    try:
        futs = [eng.submit(s) for s in _scenes(3, seed=2)]
        for f in futs:
            with pytest.raises(ValueError, match="device fault"):
                f.result(timeout=WAIT_S)
        assert eng.stats()["mean_batch"] == 1.0   # the failed batch is not recorded
        eng._serve = serve
        assert np.isfinite(eng.submit(_scenes(1)[0]).result(timeout=WAIT_S)["agent_pi"]).all()
    finally:
        eng._serve = serve
        eng.close()


def test_close_serves_what_it_holds_and_fails_nothing_else(models):
    eng = _engine(models, max_wait_ms=50.0)
    futs = [eng.submit(s) for s in _scenes(3, seed=4)]
    eng.close()
    assert all(np.isfinite(f.result(timeout=WAIT_S)["loc"]).all() for f in futs)
    assert not eng._worker.is_alive()
    with pytest.raises(EngineClosed):
        eng.submit(_scenes(1)[0])


def test_close_with_a_stuck_worker_leaves_no_future_pending(models):
    """The worker holds a batch whose serve call waits on an event; close()
    with a short join budget fails that batch and everything queued behind
    it with EngineClosed (the JAX engine returns and leaves them pending).
    When the call returns, the worker exits and the futures stay failed."""
    eng = _engine(models, max_wait_ms=1.0)
    started, release = threading.Event(), threading.Event()
    serve = eng._serve

    def held(*a, **k):
        started.set()
        release.wait(WAIT_S)
        return serve(*a, **k)

    eng._serve = held
    scenes = _scenes(4, seed=5)
    first = eng.submit(scenes[0])
    assert started.wait(WAIT_S)
    queued = [eng.submit(s) for s in scenes[1:]]
    t0 = time.perf_counter()
    eng.close(timeout=0.2)
    assert time.perf_counter() - t0 < WAIT_S
    for f in [first, *queued]:
        assert f.done()
        with pytest.raises(EngineClosed):
            f.result(timeout=0)
    with pytest.raises(EngineClosed):
        eng.submit(scenes[0])
    release.set()
    eng._worker.join(timeout=WAIT_S)
    assert not eng._worker.is_alive()
    with pytest.raises(EngineClosed):
        first.result(timeout=0)


def test_concurrent_submit_and_predict_lose_no_update(models):
    """Stress, with a short switch interval: 24 threads submit 3 scenes each
    while two threads call ``predict``; every future resolves, and the
    counter, the served count and the batch sizes agree (a lost update of
    any of them breaks the sums)."""
    eng = _engine(models, max_wait_ms=2.0, max_batch=4)
    scenes = _scenes(6, seed=9)
    futs, predicted, lock = [], [], threading.Lock()

    def submit():
        for s in scenes[:3]:
            f = eng.submit(s)
            with lock:
                futs.append(f)

    def predict():
        out = eng.predict(scenes)
        with lock:
            predicted.extend(out)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = ([threading.Thread(target=submit) for _ in range(24)]
                   + [threading.Thread(target=predict) for _ in range(2)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
        results = [f.result(timeout=WAIT_S) for f in futs]
    finally:
        sys.setswitchinterval(interval)
        eng.close()
    assert len(results) == 72 and len(predicted) == 12
    st = eng.stats()
    assert st["served"] == 84 == sum(eng._batch_sizes)
    assert eng._counter == len(eng._batch_sizes)
    assert all(np.isfinite(r["agent_world"]).all() for r in results + predicted)


def _jax_engine(models, **kw):
    return JaxEngine(models["jm"], models["params"]["params"], engine="scan", num_actors=A,
                     num_lanes=L, batch_buckets=(1, 2, 4), **kw)


def test_stats_and_reset_have_the_jax_engines_keys_and_counts(models):
    """The same scenes through ``predict`` (recorded, no latencies), then
    ``submit`` (latencies), then ``reset_stats``: the same keys, the same
    counts and the same presence of each figure as JAX's scan engine."""
    scenes = _scenes(5, seed=6)
    ours, theirs = _engine(models, max_batch=2), _jax_engine(models, max_batch=2)
    try:
        for eng in (ours, theirs):
            eng.predict(scenes)
        a, b = ours.stats(), theirs.stats()
        assert set(a) == set(b) == {"served", "p50_ms", "p99_ms", "mean_batch", "scenes_per_sec"}
        assert a["served"] == b["served"] == 5 and a["mean_batch"] == b["mean_batch"]
        assert a["p50_ms"] is b["p50_ms"] is None and a["scenes_per_sec"] > 0
        for eng in (ours, theirs):
            eng.submit(scenes[0]).result(timeout=WAIT_S)
        a, b = ours.stats(), theirs.stats()
        assert a["served"] == b["served"] == 6
        assert all(isinstance(s[k], float) for s in (a, b) for k in ("p50_ms", "p99_ms"))
        for eng in (ours, theirs):
            eng.reset_stats()
        assert ours.stats() == theirs.stats() == {
            "served": 0, "p50_ms": None, "p99_ms": None, "mean_batch": None,
            "scenes_per_sec": None}
    finally:
        ours.close()
        theirs.close()


def test_warmup_records_nothing(models):
    """Each bucket once, unrecorded, as JAX's warmup: the stats stay empty,
    and the counter moves once per bucket (the JAX engine's does too)."""
    scene = _scenes(1, seed=7)[0]
    ours, theirs = _engine(models), _jax_engine(models)
    try:
        ours.warmup(scene)
        theirs.warmup(scene)
        assert ours.stats() == theirs.stats() == {
            "served": 0, "p50_ms": None, "p99_ms": None, "mean_batch": None,
            "scenes_per_sec": None}
        assert ours._counter == theirs._counter == len(ours.buckets)
        ours.warmup(scene, buckets=(2,))
        assert ours._counter == len(ours.buckets) + 1 and ours.stats()["served"] == 0
    finally:
        ours.close()
        theirs.close()
