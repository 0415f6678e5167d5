"""HTTP front-end for the serving engine (``trajsde_tpu/httpd.py``),
standard library only.

:class:`trajsde_tpu_torch.server.ServingEngine` behind a
``ThreadingHTTPServer``: one thread per request, each parked on
``engine.submit``'s future, so concurrent requests share the engine's
micro-batches.

Endpoints:

- ``POST /predict``: the body is a raw ``.npz`` scene (the preprocessor's
  schema; ``Content-Type: application/octet-stream``) or JSON
  ``{"npz": "/local/path.npz"}``.  The reply is JSON with the engine's
  fields (``agent_world``, ``agent_pi``, ``seq_id``; ``loc`` and ``pi``
  unless the engine is slim; ``ood_std`` and ``agent_std`` with OOD
  scoring), or the same fields as ``.npz`` bytes when the request's
  ``Accept`` prefers ``application/x-npz``.  400 for a body or scene that
  is malformed, 413 for a body over ``MAX_BODY_BYTES``, 503 once the engine
  is closed, 500 when serving fails.
- ``GET /stats``: the engine's latency and occupancy counters.
- ``GET /healthz``: 200 while the server is up.

Start it with ``serve_torch.py --http PORT`` or embed it with
:func:`make_http_server` / :func:`run_http_server`.

Unlike the JAX front-end, a closed engine answers 503 (not 400), an
``Accept`` range with ``q=0`` does not select npz, and only half-precision
arrays are widened to f32 on the way out (f32 and f64 pass unchanged).
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Tuple

import numpy as np

from trajsde_tpu_torch.data.loader import load_scene_npz
from trajsde_tpu_torch.server import EngineClosed

# one scene at production capacity is under 2 MiB; checked before the body
# is read, since the read allocates what Content-Length says
MAX_BODY_BYTES = 64 * 2**20
NPZ = "application/x-npz"
JSON = "application/json"


def _cast(v) -> np.ndarray:
    """The value as an array JSON and ``np.savez`` both carry: half
    precision (f16, bf16) widened to f32, every other dtype unchanged."""
    a = np.asarray(v)
    if a.dtype == np.float16 or a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    return a


def _json_ready(result: Dict) -> Dict:
    out = {}
    for k, v in result.items():
        a = _cast(v)
        out[k] = a.tolist() if a.ndim else a.item()
    return out


def _media_ranges(accept: str) -> Dict[str, float]:
    """``Accept`` -> {media range: q}, q 1 where it is not given (RFC 9110
    section 12.5.1); a range given twice keeps its highest q."""
    out: Dict[str, float] = {}
    for part in accept.split(","):
        fields = [f.strip() for f in part.split(";")]
        media = fields[0].lower()
        if not media:
            continue
        q = 1.0
        for param in fields[1:]:
            name, _, value = param.partition("=")
            if name.strip().lower() == "q":
                try:
                    q = float(value)
                except ValueError:
                    q = 0.0
        out[media] = max(q, out.get(media, 0.0))
    return out


def _quality(ranges: Dict[str, float], media: str) -> Tuple[float, bool]:
    """(q of ``media`` by its most specific range, whether it is named)."""
    if media in ranges:
        return ranges[media], True
    major = media.split("/")[0] + "/*"
    return ranges.get(major, ranges.get("*/*", 0.0)), False


def wants_npz(accept: str) -> bool:
    """Whether a reply to ``Accept: accept`` is npz: ``application/x-npz``
    named with q > 0 and at least JSON's q; else JSON, the default."""
    ranges = _media_ranges(accept or "")
    npz_q, named = _quality(ranges, NPZ)
    json_q, _ = _quality(ranges, JSON)
    return named and npz_q > 0 and npz_q >= json_q


def make_http_server(engine, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) a server fronting ``engine``.  ``port=0`` binds an
    ephemeral port (``server.server_address[1]``).  ``shutdown()`` stops it
    and leaves the engine open: its caller owns the engine."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: A003 - one line a request would swamp the log
            pass

        def _reply(self, code: int, payload: dict) -> None:
            self._send(code, JSON, json.dumps(payload).encode())

        def _send(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/stats":
                self._reply(200, engine.stats())
            else:
                self._reply(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._reply(404, {"error": f"unknown path {self.path!r}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = -1
            if n < 0:   # rfile.read(-1) would read to EOF, past the bound below
                self._reply(400, {"error": "bad Content-Length"})
                return
            if n > MAX_BODY_BYTES:
                self._reply(413, {"error": f"body of {n} bytes exceeds the {MAX_BODY_BYTES}-byte "
                                           "limit (one scene per request)"})
                return
            try:
                body = self.rfile.read(n)
                ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
                if ctype == JSON:
                    scene = load_scene_npz(json.loads(body)["npz"])
                else:   # raw .npz bytes
                    with np.load(io.BytesIO(body), allow_pickle=False) as z:
                        scene = {k: z[k] for k in z.files}
            except Exception as e:   # a malformed body is the client's error
                self._reply(400, {"error": f"bad request: {e!r}"})
                return
            try:
                # submit() validates and aligns the scene on this thread
                fut = engine.submit(scene)
            except EngineClosed as e:
                self._reply(503, {"error": repr(e)})
                return
            except Exception as e:
                self._reply(400, {"error": f"bad scene: {e!r}"})
                return
            try:
                result = fut.result()
            except EngineClosed as e:
                self._reply(503, {"error": repr(e)})
                return
            except Exception as e:
                self._reply(500, {"error": repr(e)})
                return
            if wants_npz(self.headers.get("Accept")):
                buf = io.BytesIO()
                np.savez(buf, **{k: _cast(v) for k, v in result.items()})
                self._send(200, NPZ, buf.getvalue())
            else:
                self._reply(200, _json_ready(result))

    return ThreadingHTTPServer((host, port), Handler)


def run_http_server(engine, host: str, port: int):
    """Start the server on a daemon thread; returns (server, bound port)."""
    server = make_http_server(engine, host, port)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]
