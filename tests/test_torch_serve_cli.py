"""``serve_torch.py`` on the CPU (JAX's counterpart:
``tests/test_server.py::test_serve_cli_batch_and_daemon``): batch and
daemon modes on a checkpoint written by the port's ``CheckpointManager``,
``--export`` and ``--from-export`` (batch, daemon and HTTP modes, and
``serve.py``'s argument rules), the refusal to start without a card, the
flag that is not ported yet, and the usage lines of its docstring.
"""
import json
import os
import re
import shlex
import subprocess
import sys

import numpy as np
import pytest
import torch

from trajsde_tpu_torch.data.loader import load_scene_npz
from trajsde_tpu_torch.data.synthetic import make_raw_scene
from trajsde_tpu_torch.server import ServingEngine
from trajsde_tpu_torch.train.checkpoint import CheckpointManager
from trajsde_tpu_torch.train.loop import create_train_state

import serve_torch
from _torch_helpers import small_cfg, torch_build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
A, L, K, TF, N = 6, 8, 3, 12, 5
WAIT_S = 300


def _cfg():
    cfg = small_cfg()
    cfg["datamodule_specific"]["kwargs"].update(num_actors=A, num_lanes=L)
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A JSON config, a checkpoint of seeded weights and N npz scenes."""
    root = tmp_path_factory.mktemp("serve")
    cfg = root / "cfg.json"
    cfg.write_text(json.dumps(_cfg()))
    model = torch_build_model(_cfg(), device="cpu", seed=11)
    state = create_train_state(model, _cfg()["training_specific"], steps_per_epoch=1)
    ckpt = CheckpointManager(str(root / "run" / "checkpoints")).save(state, metric=None, step=3)
    scenes = root / "scenes"
    scenes.mkdir()
    rng = np.random.default_rng(0)
    for i in range(N):
        raw = make_raw_scene(rng, i % 2, num_actors=int(rng.integers(3, A + 1)),
                             num_lanes=int(rng.integers(4, L + 1)))
        np.savez(scenes / f"s{i}.npz", **raw)
    return dict(cfg=str(cfg), ckpt=ckpt, scenes=str(scenes), model=model, root=root)


def _common(setup, *extra):
    return ["-c", setup["cfg"], "--ckpt", setup["ckpt"], "--device", "cpu", *extra]


def test_batch_mode_serves_the_checkpoint(setup, tmp_path, capsys):
    """One ``*_pred.npz`` per scene.  At --max-batch 1 each scene is a batch
    of its own in file order, so the answers are those of an engine over the
    checkpoint's weights, bit for bit."""
    out = tmp_path / "preds"
    stats = serve_torch.main(_common(setup, "--input-dir", setup["scenes"], "--output-dir",
                                     str(out), "--max-batch", "1", "--warmup"))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == stats
    assert stats["served"] == N and stats["mean_batch"] == 1.0
    paths = sorted(os.listdir(setup["scenes"]))
    assert sorted(os.listdir(out)) == [p.replace(".npz", "_pred.npz") for p in paths]
    eng = ServingEngine(setup["model"], device="cpu", num_actors=A, num_lanes=L, max_batch=1)
    try:
        eng.warmup(load_scene_npz(os.path.join(setup["scenes"], paths[0])))
        want = eng.predict([load_scene_npz(os.path.join(setup["scenes"], p)) for p in paths])
    finally:
        eng.close()
    for p, w in zip(paths, want):
        with np.load(out / p.replace(".npz", "_pred.npz")) as z:
            assert set(z.files) == set(w)
            for k in w:
                np.testing.assert_array_equal(z[k], w[k], err_msg=k)
        assert w["agent_world"].shape == (K, TF, 2) and w["loc"].shape == (K, A, TF, 2)
        np.testing.assert_allclose(w["agent_pi"].sum(), 1.0, rtol=1e-5)


def test_batch_mode_ood_and_slim(setup, tmp_path):
    out = tmp_path / "preds"
    stats = serve_torch.main(_common(setup, "--input-dir", setup["scenes"], "--output-dir",
                                     str(out), "--ood", "--slim", "--max-wait-ms", "50"))
    assert stats["served"] == N
    for name in os.listdir(out):
        with np.load(out / name) as z:
            assert set(z.files) == {"agent_world", "agent_pi", "seq_id", "ood_std", "agent_std"}
            assert z["ood_std"].shape == (A,) and np.isfinite(z["agent_std"])


def test_daemon_mode_answers_each_line(setup, tmp_path):
    """JSON lines on stdin, one reply each, a malformed line answered with
    an error while the daemon goes on; the stats line last."""
    out = tmp_path / "preds"
    scenes = sorted(os.listdir(setup["scenes"]))
    lines = [json.dumps({"id": f"r{i}", "npz": os.path.join(setup["scenes"], s)})
             for i, s in enumerate(scenes[:3])]
    lines.insert(2, json.dumps({"id": "bad", "npz": "/nonexistent.npz"}))
    r = subprocess.run([sys.executable, "serve_torch.py", *_common(setup, "--output-dir",
                                                                  str(out), "--daemon", "--ood")],
                       input="\n".join(lines) + "\n", cwd=REPO, capture_output=True, text=True,
                       timeout=WAIT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    replies = [json.loads(x) for x in r.stdout.strip().splitlines()]
    stats = replies.pop()
    assert stats["served"] == 3
    by_id = {x["id"]: x for x in replies}
    assert set(by_id) == {"r0", "r1", "r2", "bad"} and "FileNotFoundError" in by_id["bad"]["error"]
    for i in range(3):
        reply = by_id[f"r{i}"]
        assert reply["out"] == str(out / f"s{i}_r{i}_pred.npz") and np.isfinite(reply["agent_std"])
        with np.load(reply["out"]) as z:
            assert z["agent_world"].shape == (K, TF, 2)


def test_refuses_to_start_without_a_card(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the no-GPU refusal is what this test checks")
    args = ["-c", setup["cfg"], "--ckpt", setup["ckpt"], "--input-dir", setup["scenes"],
            "--output-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_torch.main(args)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags,item", [(["--shard"], "item 10")])
def test_flags_not_ported_exit_naming_their_item(flags, item):
    with pytest.raises(SystemExit, match=f"ROADMAP.md Queue 1 {item}"):
        serve_torch.parse_args(["-c", "c.yml", "--ckpt", "x", "--http", "0", *flags])


@pytest.mark.parametrize("argv,message", [
    (["--export", "d", "--from-export", "e"], "cannot re-export an artifact"),
    (["--from-export", "e", "--http", "0", "--ood"], "--ood needs the live model"),
    (["-c", "c.yml", "--ckpt", "x", "--export", "d", "--slim"], "--slim cannot shrink"),
    (["-c", "c.yml", "--ckpt", "x", "--export", "d", "--ood"], "--ood needs the live model"),
    (["--export", "d", "-c", "c.yml"], "required unless --from-export"),
    (["--from-export", "e", "--input-dir", "s"], "--output-dir is required"),
    (["--from-export", "e"], "one of --input-dir, --daemon, --http or --export"),
])
def test_export_flags_follow_serve_pys_rules(argv, message, capsys):
    with pytest.raises(SystemExit):
        serve_torch.parse_args(argv)
    assert message in capsys.readouterr().err


def test_from_export_needs_no_config_or_checkpoint():
    args = serve_torch.parse_args(["--from-export", "art", "--http", "0"])
    assert args.from_export == "art" and args.config is None and args.ckpt is None
    args = serve_torch.parse_args(["-c", "c.yml", "--ckpt", "x", "--export", "art",
                                   "--export-platforms", "cpu,cuda"])
    assert args.export == "art" and args.export_platforms == "cpu,cuda"


@pytest.fixture(scope="module")
def artifact(setup):
    """``--export`` of the checkpoint at ``--max-batch 1`` (bucket 1)."""
    out = str(setup["root"] / "artifact")
    done = serve_torch.main(_common(setup, "--export", out, "--max-batch", "1"))
    assert done == {"exported": out, "buckets": [1], "platforms": ["cpu"]}
    return out


def test_export_then_from_export_batch_mode_writes_the_live_engines_predictions(
        setup, artifact, tmp_path, capsys):
    """``--from-export`` in batch mode writes, bit for bit, the npz files of
    the live scan engine over the checkpoint at the same seed (--max-batch
    1: each scene a batch of its own, in file order; both warm up first)."""
    assert sorted(os.listdir(artifact)) == ["bucket_1.pt2", "manifest.json"]
    live, exported = tmp_path / "live", tmp_path / "exported"
    serve_torch.main(_common(setup, "--engine", "scan", "--input-dir", setup["scenes"],
                             "--output-dir", str(live), "--max-batch", "1", "--warmup"))
    capsys.readouterr()
    stats = serve_torch.main(["--from-export", artifact, "--device", "cpu", "--input-dir",
                              setup["scenes"], "--output-dir", str(exported), "--max-batch", "1",
                              "--warmup"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == stats
    assert stats["served"] == N and stats["mean_batch"] == 1.0
    names = sorted(os.listdir(live))
    assert names == sorted(os.listdir(exported)) and len(names) == N
    for name in names:
        with np.load(live / name) as w, np.load(exported / name) as g:
            assert set(g.files) == set(w.files) == {"agent_world", "agent_pi", "seq_id", "loc",
                                                    "pi"}
            for k in w.files:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name} {k}")


def test_from_export_daemon_mode(setup, artifact, tmp_path):
    out = tmp_path / "preds"
    scenes = sorted(os.listdir(setup["scenes"]))
    lines = [json.dumps({"id": f"r{i}", "npz": os.path.join(setup["scenes"], s)})
             for i, s in enumerate(scenes[:2])]
    r = subprocess.run([sys.executable, "serve_torch.py", "--from-export", artifact, "--device",
                        "cpu", "--output-dir", str(out), "--daemon"],
                       input="\n".join(lines) + "\n", cwd=REPO, capture_output=True, text=True,
                       timeout=WAIT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    replies = [json.loads(x) for x in r.stdout.strip().splitlines()]
    assert replies.pop()["served"] == 2
    assert sorted(x["id"] for x in replies) == ["r0", "r1"]
    for reply in replies:
        with np.load(reply["out"]) as z:
            assert z["agent_world"].shape == (K, TF, 2) and z["loc"].shape == (K, A, TF, 2)


def test_from_export_http_mode(setup, artifact):
    """``--from-export --http 0``: the first line names the port, a POST is
    answered with the engine's fields, and SIGINT prints the stats."""
    import signal
    import urllib.request

    proc = subprocess.Popen([sys.executable, "serve_torch.py", "--from-export", artifact,
                             "--device", "cpu", "--http", "0"], cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        first = json.loads(proc.stdout.readline())
        path = os.path.join(setup["scenes"], sorted(os.listdir(setup["scenes"]))[0])
        req = urllib.request.Request(f"http://{first['http']}/predict",
                                     data=json.dumps({"npz": path}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            assert resp.status == 200
            reply = json.loads(resp.read())
        assert np.asarray(reply["agent_world"]).shape == (K, TF, 2)
        assert abs(sum(reply["agent_pi"]) - 1.0) < 1e-5
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert json.loads(out.strip().splitlines()[-1])["served"] == 1


def test_the_usage_lines_parse_as_written():
    """Each command of the docstring: the script, then flags its parser
    takes (the daemon's ``echo ... |`` dropped)."""
    text = serve_torch.__doc__.replace("\\\n", " ")
    commands = [line.split("|")[-1].strip() for line in text.splitlines()
                if "python serve_torch.py" in line]
    assert len(commands) == 3
    for command in commands:
        argv = shlex.split(command)
        assert argv[:2] == ["python", "serve_torch.py"]
        args = serve_torch.parse_args(argv[2:])
        assert args.config == "configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_h100.yml"
        assert os.path.isfile(os.path.join(REPO, args.config))
        assert re.fullmatch(r"logs/my_run/checkpoints/step_\d{8}", args.ckpt)
