#!/usr/bin/env python3
"""Serving CLI of the PyTorch/CUDA port (``trajsde_tpu_torch``), with
``serve.py``'s flags and meaning: predict a directory of scenes, answer
JSON lines on stdin, or serve over HTTP.

    # batch mode: one prediction npz per scene, then a stats line
    python serve_torch.py -c configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_h100.yml \\
        --ckpt logs/my_run/checkpoints/step_00000004 --input-dir scenes/ --output-dir preds/

    # daemon mode: {"id": "r1", "npz": "scenes/s0.npz"} -> {"id": "r1", "out": ...}
    echo '{"id": "r1", "npz": "scenes/s0.npz"}' | python serve_torch.py \\
        -c configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_h100.yml \\
        --ckpt logs/my_run/checkpoints/step_00000004 --output-dir preds/ --daemon

    # HTTP: POST /predict (npz bytes or {"npz": path}), GET /stats, GET /healthz
    python serve_torch.py -c configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_h100.yml \\
        --ckpt logs/my_run/checkpoints/step_00000004 --http 8080 --warmup

Inputs are preprocessor-output ``.npz`` scenes (the shard schema); the
engine aligns them as training does.  Per scene: ``loc`` (every actor's
agent-frame modes, [K, A, Tf, 2]), ``pi`` (mode logits per actor),
``agent_world`` (the focal agent's modes in the scene frame, [K, Tf, 2])
and ``agent_pi`` (their probabilities); ``--slim`` keeps only the focal
agent's fields; ``--ood`` adds ``ood_std`` ([A]) and ``agent_std`` (the
focal scalar, also inlined in daemon replies).  The weights are restored
from a checkpoint of the port's ``CheckpointManager``
(``train_torch.py``).  The engine runs on the card unless ``--device
cpu``.  Configs are YAML, or JSON (``*.json``).

``--export DIR`` writes a deployment artifact instead of serving: the
serving pipeline (the model's forward and the world-frame projection, the
weights inside) exported with ``torch.export`` once per batch bucket of
the engine, and a ``manifest.json`` (``trajsde_tpu_torch/deploy.py``);
``--export-platforms cpu,cuda`` lists where it may be loaded (default the
``--device``).  ``--from-export DIR`` serves such an artifact in any of the
three modes, with no ``-c`` / ``--ckpt`` and no model code.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Optional, Sequence

# serve.py flags that the port does not have yet, and the ROADMAP.md
# Queue 1 item that ports each
NOT_PORTED = {
    "shard": "item 10b (the engine's shard=True)",
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-c", "--config", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--input-dir", default=None)
    p.add_argument("--output-dir", default=None,
                   help="prediction npz output dir (batch and daemon modes)")
    p.add_argument("--daemon", action="store_true", help="JSON-lines request loop on stdin")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve over HTTP (POST /predict, GET /stats, GET /healthz); "
                        "concurrent requests share batches through the micro-batcher")
    p.add_argument("--host", default="127.0.0.1", help="bind address for --http")
    p.add_argument("--engine", choices=["auto", "kernel", "scan"], default="auto",
                   help="kernel: the rollout kernel (SDE decoders); scan: the model's own "
                        "forward (any model, the baseline's only engine); auto: kernel for "
                        "an SDE decoder, else scan")
    p.add_argument("--increments", choices=["rademacher", "gaussian"], default="rademacher",
                   help="the rollout kernel's increments (kernel engine)")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--num-actors", type=int, default=None)
    p.add_argument("--num-lanes", type=int, default=None)
    p.add_argument("--warmup", action="store_true",
                   help="run every batch bucket once before serving")
    p.add_argument("--ood", action="store_true",
                   help="attach OOD scores (the encoder ensemble's per-actor stds) to every "
                        "prediction, decoded from the ensemble mean")
    p.add_argument("--slim", action="store_true",
                   help="serve only the focal agent's fields (no per-actor grids)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--shard", action="store_true",
                   help=f"not ported: ROADMAP.md Queue 1 {NOT_PORTED['shard']}")
    p.add_argument("--export", default=None, metavar="DIR",
                   help="export the serving pipeline (torch.export per batch bucket, weights "
                        "inside) and exit")
    p.add_argument("--export-platforms", default=None,
                   help="comma list (cpu,cuda) of the devices the artifact may be loaded on; "
                        "default the --device")
    p.add_argument("--from-export", default=None, metavar="DIR",
                   help="serve from an --export artifact: no config, checkpoint or model "
                        "code needed")
    args = p.parse_args(argv)
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported to trajsde_tpu_torch "
                             f"yet: ROADMAP.md Queue 1 {item}")
    modes = [args.daemon, args.input_dir is not None, args.http is not None]
    if sum(map(bool, modes)) > 1:
        p.error("--input-dir, --daemon and --http are mutually exclusive")
    if not any(modes) and args.export is None:
        p.error("one of --input-dir, --daemon, --http or --export is required")
    if args.output_dir is None and args.http is None and any(modes[:2]):
        p.error("--output-dir is required in batch and daemon modes")
    if args.from_export is None and (args.config is None or args.ckpt is None):
        p.error("-c/--config and --ckpt are required unless --from-export")
    if args.from_export and args.export:
        p.error("--export needs the real model; it cannot re-export an artifact")
    if args.ood and (args.from_export or args.export):
        p.error("--ood needs the live model (the OOD ensemble is not part of an exported "
                "pipeline)")
    if args.slim and (args.from_export or args.export):
        p.error("--slim cannot shrink an exported pipeline's outputs (the artifact is "
                "frozen with the full result set); use the scan or kernel engines")
    return args


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    """Serve; returns the engine's stats, which it also prints last (with
    ``--export``, the line that names the artifact)."""
    args = parse_args(argv)

    import numpy as np

    from trajsde_tpu_torch.data.loader import load_scene_npz
    from trajsde_tpu_torch.device import resolve_device
    from trajsde_tpu_torch.server import ServingEngine

    def load_raw(path: str) -> dict:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return load_scene_npz(path)

    device = resolve_device(args.device)
    if args.input_dir:
        paths = sorted(glob.glob(os.path.join(args.input_dir, "*.npz")))
        if not paths:
            raise SystemExit(f"no .npz scenes under {args.input_dir}")
        example_raw = load_raw(paths[0])
    elif args.daemon:
        first_line = sys.stdin.readline()
        if not first_line.strip():
            raise SystemExit("daemon mode: no request on stdin")
        first_req = json.loads(first_line)
        example_raw = load_raw(first_req["npz"])
    else:   # --http / --export alone: a synthetic scene for --warmup and the template
        from trajsde_tpu_torch.data.synthetic import make_raw_scene

        example_raw = make_raw_scene(np.random.default_rng(0), 0, num_actors=4, num_lanes=4)

    if args.from_export:
        engine = ServingEngine.from_export(args.from_export, device=device,
                                           max_batch=args.max_batch,
                                           max_wait_ms=args.max_wait_ms)
    else:
        from trajsde_tpu_torch.config import build_model, load_config
        from trajsde_tpu_torch.train.checkpoint import CheckpointManager

        cfg = load_config(args.config)
        dm = cfg.get("datamodule_specific", {}).get("kwargs", {})
        model_kwargs = cfg.get("model_specific", {}).get("kwargs", {})
        model = build_model(cfg, device=device)
        # weights only: whatever optimizer trained the checkpoint
        CheckpointManager(os.path.dirname(os.path.abspath(args.ckpt))).restore_params(
            model, args.ckpt)
        engine = ServingEngine(
            model,
            num_actors=args.num_actors or int(dm.get("num_actors", 48)),
            num_lanes=args.num_lanes or int(dm.get("num_lanes", 192)),
            device=device, engine=args.engine, increments=args.increments,
            max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms,
            is_gtabs=(dm.get("test_dataset_args") or {}).get("is_gtabs", True),
            ref_time=int(model_kwargs.get("ref_time", 20)), ood=args.ood, slim=args.slim,
        )
    if args.export:
        from trajsde_tpu_torch.data.pack import pack_scenes
        from trajsde_tpu_torch.deploy import export_serving
        from trajsde_tpu_torch.server import align_scene

        # the template goes through the engine's own alignment and packer
        example = pack_scenes([align_scene(example_raw, engine.is_gtabs)[0]],
                              engine.num_actors, engine.num_lanes)
        engine.close()
        manifest = export_serving(
            model, example, args.export, buckets=engine.buckets, is_gtabs=engine.is_gtabs,
            ref_time=int(model_kwargs.get("ref_time", 20)),
            platforms=args.export_platforms.split(",") if args.export_platforms else None)
        done = {"exported": os.path.abspath(args.export), "buckets": manifest["buckets"],
                "platforms": manifest["platforms"]}
        print(json.dumps(done), flush=True)
        return done
    if args.warmup:
        engine.warmup(example_raw)

    if args.http is not None:
        import threading

        from trajsde_tpu_torch.httpd import run_http_server

        server, port = run_http_server(engine, args.host, args.http)
        print(json.dumps({"http": f"{args.host}:{port}"}), flush=True)
        try:
            threading.Event().wait()   # serve until interrupted
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            stats = engine.stats()
            engine.close()
            print(json.dumps(stats), flush=True)
        return stats

    os.makedirs(args.output_dir, exist_ok=True)

    def write(result: dict, stem: str) -> str:
        out_path = os.path.join(args.output_dir, f"{stem}_pred.npz")
        np.savez(out_path, **result)
        return out_path

    if args.daemon:
        import queue
        import threading

        # a writer thread answers each request as soon as its future lands,
        # so a client that waits for its reply before it sends the next line
        # does not deadlock; output stems carry the request id, since two
        # requests may name files of the same basename
        out_q: "queue.Queue" = queue.Queue()

        def writer():
            while True:
                item = out_q.get()
                if item is None:
                    return
                rid, path, fut = item
                stem = os.path.splitext(os.path.basename(path))[0]
                try:
                    result = fut.result()
                    resp = {"id": rid, "out": write(result, f"{stem}_{rid}")}
                    if "agent_std" in result:   # --ood: the focal score inline
                        resp["agent_std"] = float(result["agent_std"])
                    print(json.dumps(resp), flush=True)
                except Exception as e:
                    print(json.dumps({"id": rid, "error": repr(e)}), flush=True)

        wt = threading.Thread(target=writer)
        wt.start()

        def raw_lines():
            yield json.dumps(first_req)
            yield from sys.stdin

        # a malformed request gets an error object and the daemon goes on
        for line in raw_lines():
            if not line.strip():
                continue
            rid = None
            try:
                req = json.loads(line)
                rid = req.get("id")
                fut = engine.submit(load_raw(req["npz"]))
            except Exception as e:
                print(json.dumps({"id": rid, "error": repr(e)}), flush=True)
                continue
            out_q.put((rid, req["npz"], fut))
        out_q.put(None)
        wt.join()
    else:
        from collections import deque

        # a bounded window of submissions in flight: the whole directory is
        # never held in memory, and the first write comes after one window
        window = max(1, engine.max_batch) * 4
        pending: deque = deque()

        def drain_one():
            p, f = pending.popleft()
            write(f.result(), os.path.splitext(os.path.basename(p))[0])

        for p in paths:
            pending.append((p, engine.submit(load_raw(p))))
            if len(pending) >= window:
                drain_one()
        while pending:
            drain_one()
    stats = engine.stats()
    engine.close()
    print(json.dumps(stats), flush=True)
    return stats


if __name__ == "__main__":
    main()
