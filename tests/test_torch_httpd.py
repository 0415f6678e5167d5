"""The port's HTTP front-end (``trajsde_tpu_torch/httpd.py``) on the CPU,
held against ``trajsde_tpu/httpd.py``'s endpoints and replies, with three
of the JAX front-end's faults repaired: a closed engine answers 503, an
``Accept`` range with ``q=0`` does not select npz, and f64 stays f64.

Every HTTP call has a timeout.
"""
import io
import json
import urllib.error
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest
import torch

from trajsde_tpu import httpd as jax_httpd
from trajsde_tpu_torch import httpd
from trajsde_tpu_torch.data.synthetic import make_raw_scene
from trajsde_tpu_torch.server import EngineClosed, ServingEngine

from _torch_helpers import small_cfg, torch_build_model

torch.set_num_threads(1)
A, L, K, TF = 5, 6, 3, 12
WAIT_S = 60


@pytest.fixture(scope="module")
def model():
    return torch_build_model(small_cfg(), device="cpu", seed=2)


@pytest.fixture
def served(model):
    eng = ServingEngine(model, device="cpu", num_actors=A, num_lanes=L, batch_buckets=(1, 2, 4),
                        max_wait_ms=300.0)
    server, port = httpd.run_http_server(eng, "127.0.0.1", 0)
    try:
        yield eng, f"http://127.0.0.1:{port}"
    finally:
        server.shutdown()
        server.server_close()
        eng.close()


def _npz_bytes(seed=0):
    buf = io.BytesIO()
    np.savez(buf, **make_raw_scene(np.random.default_rng(seed), seed % 2, num_actors=4,
                                   num_lanes=5))
    return buf.getvalue()


def _post(base, data, headers):
    req = urllib.request.Request(f"{base}/predict", data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return r.headers["Content-Type"], r.read()


def _status(base, data, headers=None, path="/predict") -> int:
    req = urllib.request.Request(f"{base}{path}", data=data, headers=headers or {})
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=WAIT_S)
    return err.value.code


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=WAIT_S) as r:
        return r.status, json.loads(r.read())


def _check_result(res):
    world = np.asarray(res["agent_world"])
    assert world.shape == (K, TF, 2) and np.isfinite(world).all()
    np.testing.assert_allclose(np.sum(res["agent_pi"]), 1.0, rtol=1e-5)
    assert np.shape(res["loc"]) == (K, A, TF, 2) and np.shape(res["pi"]) == (A, K)


def test_health_stats_and_concurrent_json_and_npz_replies(served, tmp_path):
    eng, base = served
    assert _get(base, "/healthz") == (200, {"status": "ok"})
    path = tmp_path / "scene.npz"
    path.write_bytes(_npz_bytes(9))

    def post(i):
        if i == 0:   # JSON body naming a file
            return _post(base, json.dumps({"npz": str(path)}).encode(),
                         {"Content-Type": "application/json"})
        accept = {"Accept": "application/x-npz"} if i % 2 else {}
        return _post(base, _npz_bytes(i), {"Content-Type": "application/octet-stream", **accept})

    with ThreadPoolExecutor(6) as ex:
        replies = list(ex.map(post, range(6)))
    for i, (ctype, body) in enumerate(replies):
        if i % 2:
            assert ctype == "application/x-npz"
            with np.load(io.BytesIO(body)) as z:
                res = {k: z[k] for k in z.files}
            assert res["agent_world"].dtype == np.float32
        else:
            assert ctype == "application/json"
            res = json.loads(body)
        _check_result(res)
    code, st = _get(base, "/stats")
    assert code == 200 and set(st) == {"served", "p50_ms", "p99_ms", "mean_batch",
                                       "scenes_per_sec"}
    assert st["served"] == 6 and st["mean_batch"] > 1.0   # the window grouped them


def test_error_codes_and_503_after_close(served):
    eng, base = served
    octet = {"Content-Type": "application/octet-stream"}
    assert _status(base, b"junk", octet) == 400
    buf = io.BytesIO()
    np.savez(buf, not_a_scene=np.zeros(3))
    assert _status(base, buf.getvalue(), octet) == 400            # a valid npz, not a scene
    assert _status(base, json.dumps({"npz": "/nonexistent.npz"}).encode(),
                   {"Content-Type": "application/json"}) == 400
    assert _status(base, b"x", {"Content-Length": str(httpd.MAX_BODY_BYTES + 1)}) == 413
    assert _status(base, None, path="/nope") == 404
    assert _status(base, b"", path="/nope") == 404
    _check_result(json.loads(_post(base, _npz_bytes(1), octet)[1]))   # still serving
    eng.close()
    assert _status(base, _npz_bytes(2), octet) == 503
    assert _get(base, "/healthz")[0] == 200


@pytest.mark.parametrize("accept,npz", [
    (None, False), ("application/x-npz", True), ("application/x-npz;q=0", False),
    ("application/x-npz; q=0.0, application/json", False),
    ("application/json, application/x-npz;q=0.5", False),
    ("application/json;q=0.5, application/x-npz", True),
    ("application/x-npz, application/json", True), ("*/*", False), ("application/*", False),
    ("text/html, application/x-npz;q=0.1", True), ("application/x-npz;q=bad", False)])
def test_accept_media_ranges(accept, npz):
    assert httpd.wants_npz(accept) is npz


def test_q0_is_answered_as_json(served):
    _, base = served
    ctype, body = _post(base, _npz_bytes(3), {"Content-Type": "application/octet-stream",
                                              "Accept": "application/x-npz;q=0"})
    assert ctype == "application/json"
    _check_result(json.loads(body))


class _OneResult:
    """An engine stub whose every request gets ``result``."""

    def __init__(self, result):
        self.result = result

    def submit(self, scene):
        f = Future()
        f.set_result(self.result)
        return f

    def stats(self):
        return {}


def test_f64_fields_stay_f64_and_half_precision_widens():
    assert httpd._cast(np.float64(1) / 3).dtype == np.float64
    assert httpd._cast(np.ones(2, np.float16)).dtype == np.float32
    assert httpd._cast(np.ones(2, np.float32)).dtype == np.float32
    assert httpd._cast(np.int32(4)).dtype == np.int32
    third = np.full((2,), 1.0, np.float64) / 3
    server, port = httpd.run_http_server(_OneResult({"x": third, "seq_id": np.int32(4)}),
                                         "127.0.0.1", 0)
    base = f"http://127.0.0.1:{port}"
    try:
        octet = {"Content-Type": "application/octet-stream"}
        _, body = _post(base, _npz_bytes(0), {**octet, "Accept": "application/x-npz"})
        with np.load(io.BytesIO(body)) as z:
            assert z["x"].dtype == np.float64 and np.array_equal(z["x"], third)
        assert json.loads(_post(base, _npz_bytes(0), octet)[1]) == {"x": third.tolist(),
                                                                     "seq_id": 4}
    finally:
        server.shutdown()
        server.server_close()


def test_json_ready_agrees_with_jax_on_an_f32_result(model):
    eng = ServingEngine(model, device="cpu", num_actors=A, num_lanes=L, batch_buckets=(1,),
                        ood=True)
    try:
        (result,) = eng.predict([make_raw_scene(np.random.default_rng(5), 0, num_actors=4,
                                                num_lanes=5)])
    finally:
        eng.close()
    assert {np.asarray(v).dtype for v in result.values()} == {np.dtype(np.float32),
                                                              np.dtype(np.int32)}
    assert httpd._json_ready(result) == jax_httpd._json_ready(result)


def test_a_request_queued_at_close_answers_503(model):
    """A request that waits in the engine's queue when it closes gets 503."""

    class _Closing:
        def submit(self, scene):
            f = Future()
            f.set_exception(EngineClosed("engine closed"))
            return f

        def stats(self):
            return {}

    server, port = httpd.run_http_server(_Closing(), "127.0.0.1", 0)
    try:
        assert _status(f"http://127.0.0.1:{port}", _npz_bytes(0),
                       {"Content-Type": "application/octet-stream"}) == 503
    finally:
        server.shutdown()
        server.server_close()
