"""Data-parallel training of the port (``trajsde_tpu_torch/parallel/mesh.py``,
the train step's all-reduces, ZeRO-1, the rank-aware loader, trainer and
CLI) on the CPU over gloo, against the single-process port and the JAX
package's sharded step on its 8-device CPU mesh.

The two-rank cases run in ONE spawn of two processes
(``tests/_torch_dist_worker.py``, a module fixture, joined within
``JOIN_S``), at a small size: the HiVT baseline (width 32, 2 heads, 2
temporal layers, dropout 0) and the flagship (width 16, 2 heads, 3 modes,
60 steps, dropout 0, pinned noise sliced per rank), batches of 8 scenes of
6 actors and 8 lanes.  While it runs, this process computes the references.

Bars: a two-rank SGD (lr 0.1) step's parameters within rtol 5e-4 / atol
1e-6 of the single-process step (``tests/test_distributed.py``'s sharding
bar), its update within 2e-3 x leaf scale + 1e-6 of JAX's sharded update
(the port-vs-JAX gradient bar), the loss rtol 1e-5; ZeRO-1 within rtol
1e-5 / atol 1e-7 of the replicated run (JAX's ZeRO bar); the eval's sums
rtol 1e-5 of the single process (counts equal) and rtol 1e-4 / atol 1e-6
of JAX's eval step.  A world of one gives the plain step's bits.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trajsde_tpu import losses as jlosses
from trajsde_tpu.config import ExperimentConfig, build_model as jax_build_model
from trajsde_tpu.data.synthetic import make_scene_batch as jax_make_scene_batch
from trajsde_tpu.parallel import mesh as jax_mesh
from trajsde_tpu.train import metrics as jmetrics
from trajsde_tpu.train.loop import TrainState as JaxTrainState
from trajsde_tpu.train.loop import make_eval_step as jax_make_eval_step
from trajsde_tpu.train.loop import make_train_step as jax_make_train_step
from trajsde_tpu_torch import losses as tlosses
from trajsde_tpu_torch.bridge import params_from_flax, params_to_flax
from trajsde_tpu_torch.config import build_losses
from trajsde_tpu_torch.data.grid import TH
from trajsde_tpu_torch.data.loader import BatchLoader, NuArgoDataset
from trajsde_tpu_torch.data.scene import SceneBatch
from trajsde_tpu_torch.parallel import mesh
from trajsde_tpu_torch.train.checkpoint import CheckpointManager
from trajsde_tpu_torch.train.loop import create_train_state, make_train_step

import _torch_dist_worker as worker
from _torch_helpers import (SCENE_FIELDS, check_leaves, noise_for, small_baseline_cfg,
                            small_cfg, torch_build_model, write_run)

torch.set_num_threads(1)
B, A, L, WORLD = 8, 6, 8, 2
JOIN_S = 120


def _pair(seed, n, uneven=False):
    """A JAX ``SceneBatch`` of ``n`` scenes and the port's copy; ``uneven``
    keeps only the agents' futures in the first half, so the halves hold
    very different numbers of valid cells."""
    js = jax_make_scene_batch(np.random.default_rng(seed), batch_size=n, num_actors=A,
                              num_lanes=L, sources=[0, 1])
    if uneven:
        pad = np.array(js.padding_mask)
        pad[: n // 2, 1:, TH:] = True
        js = dataclasses.replace(js, padding_mask=jnp.asarray(pad))
    ts = SceneBatch.from_numpy(**{f: np.asarray(getattr(js, f)) for f in SCENE_FIELDS})
    return js, ts


def _configs():
    base = small_baseline_cfg(Tf=60, drop=0.0)
    flag = small_cfg(Tf=60)
    flag["encoder"]["kwargs"]["dropout"] = flag["aggregator"]["kwargs"]["dropout"] = 0.0
    return base, flag


def _jax_references(base, base_sd, pairs, evals):
    """JAX's sharded SGD step (8-device mesh) on the even and uneven
    batches -> updated params by port name; JAX's eval (sum, count)."""
    jm = jax_build_model(ExperimentConfig(base))
    p = jax.tree.map(jnp.asarray, params_to_flax(base_sd))
    opt = optax.sgd(0.1)
    step = jax_make_train_step(jm, opt, [("L2", 1.0, jlosses.l2_loss)], donate=False)
    m8 = jax_mesh.make_mesh(n_data=8, n_model=1)
    out = {}
    for tag, (js, _) in pairs.items():
        state = JaxTrainState(params=p, opt_state=opt.init(p), step=jnp.int32(0),
                              key=jax.random.key(0))
        new, logs = step(jax.device_put(state, jax_mesh.replicated(m8)),
                         jax_mesh.shard_batch(js, m8))
        out[tag] = dict(params=params_from_flax(jax.tree.map(np.asarray, new.params)),
                        total=float(logs["train/total"]))
    jms = jmetrics.make_metrics(base["metrics_module"], base["metric_args"])
    jeval = jax_make_eval_step(jm, jms)
    for i, (js, _) in enumerate(evals):
        contribs = jeval(p, js, jax.random.key(12345), np.int32(i))
        for m in jms:
            m.accumulate(contribs[m.name])
    out["eval"] = {m.name: (float(m._sum), float(m._count)) for m in jms}
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The two ranks' results, the single-process port's and JAX's."""
    work = tmp_path_factory.mktemp("dist")
    base, flag = _configs()
    pairs = {"even": _pair(31, B), "uneven": _pair(32, B, uneven=True)}
    evals = [_pair(33, B), _pair(34, 5)]   # the second splits 3 / 2
    base_sd = torch_build_model(base, device="cpu", seed=5).state_dict()
    flag_sd = torch_build_model(flag, device="cpu", seed=6).state_dict()
    noise = [torch.from_numpy(n) for n in noise_for(flag, B, A, seed=7)]
    inputs = dict(baseline_cfg=base, baseline_sd=base_sd, flagship_cfg=flag, flagship_sd=flag_sd,
                  even=pairs["even"][1], uneven=pairs["uneven"][1],
                  eval=[ts for _, ts in evals], noise=noise,
                  cli_cfg=write_run(work / "cli", n_train=6, batch=4, actors=A, lanes=L))
    torch.save(inputs, work / "inputs.pt")
    logs = [open(work / f"rank{r}.log", "w") for r in range(WORLD)]
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, worker.__file__, str(r), str(WORLD), str(work)],
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        # the references, while the ranks run
        single = {tag: worker.sgd_step(base, base_sd, ts, worker.L2) for tag, (_, ts) in pairs.items()}
        single = {tag: dict(params=worker.params(m), total=float(lg["train/total"]))
                  for tag, (m, lg) in single.items()}
        model, lg = worker.sgd_step(base, base_sd, [pairs["even"][1], pairs["uneven"][1]],
                                    worker.L2, accum=2)
        single["accum"] = dict(params=worker.params(model), total=float(lg["train/total"]))
        alone = worker.head(pairs["uneven"][1], 4)
        for tag, group in (("second", [pairs["even"][1], alone]),
                           ("first", [alone, pairs["even"][1]])):
            model, lg = worker.sgd_step(base, base_sd, group, worker.L2, accum=2)
            single[f"accum_{tag}_empty"] = dict(params=worker.params(model),
                                                total=float(lg["train/total"]))
        model, lg = worker.sgd_step(flag, flag_sd, pairs["even"][1], build_losses(flag),
                                    noise=noise)
        single["flagship"] = dict(grads={k: p.grad for k, p in model.named_parameters()
                                         if p.grad is not None}, total=float(lg["train/total"]))
        single["eval"] = worker.evaluate(base, base_sd, [ts for _, ts in evals])
        jax_ref = _jax_references(base, base_sd, pairs, evals)
        for r, p in enumerate(procs):
            p.wait(timeout=max(1.0, JOIN_S - (time.monotonic() - t0)))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank did not finish within {JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (work / f"rank{r}.log").read_text()[-4000:]
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(work=work, ranks=ranks, single=single, jax=jax_ref, base=base, base_sd=base_sd)


def _close(got, want, rtol, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


def _same(a, b):
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------
def test_init_multihost_without_a_rendezvous_is_a_noop(monkeypatch):
    for var in ("TRAJSDE_COORDINATOR", "TRAJSDE_NUM_PROCESSES", "TRAJSDE_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.init_multihost() == 1
    assert mesh.init_multihost(num_processes=1) == 1
    assert not mesh.distributed() and (mesh.rank(), mesh.world()) == (0, 1)
    assert mesh.is_primary() and mesh.rank_seed(12345) == 12345


@pytest.mark.parametrize("launcher", ["torchrun", "trajsde"])
def test_init_multihost_joins_the_group_the_environment_names(launcher, monkeypatch, tmp_path):
    """torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``
    and the JAX package's ``TRAJSDE_*`` variables each start a group (of
    one here), on gloo over the CPU."""
    import socket

    for var in ("TRAJSDE_COORDINATOR", "TRAJSDE_NUM_PROCESSES", "TRAJSDE_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    if launcher == "torchrun":
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0",
                   LOCAL_RANK="0")
    else:
        env = dict(TRAJSDE_COORDINATOR=f"file://{tmp_path / 'rdzv'}", TRAJSDE_NUM_PROCESSES="1",
                   TRAJSDE_PROCESS_ID="0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        assert mesh.init_multihost(timeout_s=30) == 1
        assert mesh.distributed() and torch.distributed.get_backend() == "gloo"
        assert mesh.init_multihost() == 1   # a process already in a group stays in it
        assert (mesh.rank(), mesh.world(), mesh.local_rank()) == (0, 1, 0)
    finally:
        mesh.shutdown()
    assert not mesh.distributed()


@pytest.mark.parametrize("batch,world", [(12, 6), (8, 8), (7, 7), (3, 3), (13, 1), (48, 8),
                                         (12, 8), (13, 8), (7, 2)])
def test_ranks_for_batch_takes_every_rank_or_raises(batch, world):
    """``make_mesh_for_batch``'s cases (``tests/test_distributed.py``): a world
    that divides the batch takes every rank; one that does not raises,
    naming both numbers, as JAX's multi-process mesh does."""
    if batch % world == 0:
        assert mesh.ranks_for_batch(batch, world) == world
    else:
        with pytest.raises(ValueError, match=f"batch size {batch} .* {world} ranks"):
            mesh.ranks_for_batch(batch, world)


def test_shard_batch_cuts_as_tensor_split():
    _, ts = _pair(40, 5)
    for world in (1, 2, 3, 4, 6):
        parts = [mesh.shard_batch(ts, r, world) for r in range(world)]
        want = torch.tensor_split(ts.x, world)
        assert all(torch.equal(p.x, w) for p, w in zip(parts, want))
        assert torch.equal(torch.cat([p.padding_mask for p in parts]), ts.padding_mask)
    noise = torch.arange(2 * 5 * 3).reshape(2, 5, 3)
    assert torch.equal(mesh.shard_batch(noise, 1, 2, batch_axis=1), noise[:, 3:])


@pytest.mark.parametrize("bucket", [False, True])
def test_loader_slices_are_slices_of_the_global_pack(tmp_path, bucket):
    """Each rank packs its own scenes of every global batch (at the global
    batch's bucket when bucketing): the tensors are the slices of the
    single-process batch, in the same order, with the same seed."""
    cfg = json.loads(open(write_run(tmp_path, n_train=5, batch=4, actors=A, lanes=L)).read())
    kw = cfg["datamodule_specific"]["kwargs"]
    ds = lambda: NuArgoDataset("train", kw["nu_dir"], kw["Argo_dir"], random_flip=True,  # noqa: E731
                               seed=3)
    make = lambda r, w: BatchLoader(ds(), 4, 48 if bucket else A, 192 if bucket else L,  # noqa: E731
                                    seed=3, bucket=bucket, rank=r, world=w)
    whole = list(make(0, 1))
    assert len(whole) == 2 and len(make(1, 3)) == 2
    for world in (2, 3):
        ranks = [list(make(r, world)) for r in range(world)]
        for i, batch in enumerate(whole):
            for r in range(world):
                want = mesh.shard_batch(batch, r, world)
                got = ranks[r][i]
                for f in dataclasses.fields(batch):
                    a, b = getattr(got, f.name), getattr(want, f.name)
                    assert (a is None and b is None) or torch.equal(a, b), (world, r, i, f.name)


@pytest.mark.parametrize("name", sorted(tlosses.LOSS_REGISTRY))
def test_losses_with_their_own_counts_give_the_same_bits(name):
    """A world of one: the global normalizers are the batch's own, and each
    loss returns the bits it returns without them."""
    _, ts = _pair(41, 4)
    r = np.random.default_rng(0)
    out = dict(loc=torch.from_numpy(r.normal(size=(4, 3, A, 60, 4)).astype(np.float32)).abs() + 0.1,
               reg_mask=~ts.padding_mask[:, :, TH:],
               diff_in=torch.rand(4), diff_out=torch.rand(4),
               label_in=torch.zeros(4), label_out=torch.ones(4))
    fn = tlosses.LOSS_REGISTRY[name]
    counts = tlosses.batch_counts(ts)
    assert counts.tolist() == [4.0, float(out["reg_mask"].sum())]
    assert torch.equal(fn(ts.y, out, counts=counts), fn(ts.y, out))


# ---------------------------------------------------------------------------
# two ranks against one process and against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tag", ["even", "uneven"])
def test_two_rank_sgd_step_is_the_global_batchs_step(spawned, tag):
    got = [r[f"sgd_{tag}"] for r in spawned["ranks"]]
    single = spawned["single"][tag]
    _same(got[0]["params"], got[1]["params"])
    _close(got[0]["params"], single["params"], rtol=5e-4, atol=1e-6)
    assert got[0]["total"] == got[1]["total"]
    np.testing.assert_allclose(got[0]["total"], single["total"], rtol=1e-5)
    np.testing.assert_allclose(got[0]["total"], spawned["jax"][tag]["total"], rtol=1e-5)
    # the update against JAX's sharded update, leaf by leaf
    start = spawned["base_sd"]
    delta = lambda p: {k: v - start[k] for k, v in p.items()}  # noqa: E731
    check_leaves(delta(got[0]["params"]), delta(spawned["jax"][tag]["params"]))


def test_mean_of_rank_means_fails_the_uneven_batch(spawned):
    """The copy of the step that normalizes per rank and averages the
    gradients misses the bar the step meets."""
    single = spawned["single"]["uneven"]["params"]
    with pytest.raises(AssertionError):
        _close(spawned["ranks"][0]["sgd_uneven_naive"]["params"], single, rtol=5e-4, atol=1e-6)


def test_two_rank_flagship_step_gives_the_global_gradient(spawned):
    got = [r["flagship"] for r in spawned["ranks"]]
    single = spawned["single"]["flagship"]
    _same(got[0]["grads"], got[1]["grads"])
    _close(got[0]["grads"], {k: v for k, v in single["grads"].items()}, rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(got[0]["total"], single["total"], rtol=1e-5)


def test_two_rank_accumulation_matches_the_single_process(spawned):
    got = [r["accum"] for r in spawned["ranks"]]
    _same(got[0]["params"], got[1]["params"])
    _close(got[0]["params"], spawned["single"]["accum"]["params"], rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(got[0]["total"], spawned["single"]["accum"]["total"], rtol=1e-5)


@pytest.mark.parametrize("empty", ["second", "first"])
def test_two_rank_accumulation_with_a_slot_empty_on_one_rank(spawned, empty):
    """``--accum 2`` where one micro-batch of the group holds scenes on
    rank 0 alone (rank 1's slot is a batch of no scene, second or first):
    the update is the single process's on the global micro-batches, each
    rank adding half of each micro-batch's share."""
    got = [r[f"accum_{empty}_empty"] for r in spawned["ranks"]]
    single = spawned["single"][f"accum_{empty}_empty"]
    _same(got[0]["params"], got[1]["params"])
    _close(got[0]["params"], single["params"], rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(got[0]["total"], single["total"], rtol=1e-5)


def test_zero1_matches_the_replicated_run_and_partitions_the_moments(spawned):
    rep = [r["adamw_zero1=False"] for r in spawned["ranks"]]
    zero = [r["adamw_zero1=True"] for r in spawned["ranks"]]
    _same(zero[0]["params"], zero[1]["params"])
    _close(zero[0]["params"], rep[0]["params"], rtol=1e-5, atol=1e-7)
    whole = rep[0]["moment_elements"]
    assert all(0 < z["moment_elements"] < whole for z in zero)
    assert zero[0]["moment_elements"] + zero[1]["moment_elements"] == whole
    assert not set(zero[0]["moments"]) & set(zero[1]["moments"])


def test_zero1_checkpoint_resumes_in_a_single_process(spawned):
    """Layout-independent: rank 0 wrote the consolidated state, which a
    plain single-process AdamW restores with every rank's moments."""
    base = spawned["base"]
    state = create_train_state(torch_build_model(base, device="cpu", seed=9),
                               base["training_specific"], steps_per_epoch=2)
    CheckpointManager(str(spawned["work"] / "zero1_ckpt")).restore(state)
    assert state.step == 2
    zero = [r["adamw_zero1=True"] for r in spawned["ranks"]]
    _same(worker.params(state.model), zero[0]["params"])
    restored = state.optimizer.state_dict()["state"]
    held = zero[0]["moments"] | zero[1]["moments"]
    assert set(restored) == set(held)
    for i, s in held.items():
        _same(restored[i], s)


def test_two_rank_eval_matches_the_single_process_and_jax(spawned):
    got = [r["eval"] for r in spawned["ranks"]]
    assert got[0] == got[1]
    for name, (s, c) in spawned["single"]["eval"].items():
        assert got[0][name][1] == c
        np.testing.assert_allclose(got[0][name][0], s, rtol=1e-5, err_msg=name)
        js, jc = spawned["jax"]["eval"][name]
        assert jc == c
        np.testing.assert_allclose(got[0][name][0], js, rtol=1e-4, atol=1e-6, err_msg=name)


def test_a_signal_on_one_rank_stops_every_rank_after_the_same_update(spawned):
    """Rank 1 alone is preempted after update 1: its flag rides in update
    2's all-reduce, both ranks stop after it and save together (ZeRO-1's
    consolidation is a collective), unscored."""
    got = [r["preempt"] for r in spawned["ranks"]]
    assert [(g["step"], g["epochs"]) for g in got] == [(2, 0), (2, 0)]
    _same(got[0]["params"], got[1]["params"])
    board = CheckpointManager(str(spawned["work"] / "preempt")).latest()
    assert board["step"] == 2 and board["metric"] is None


def test_a_rank_whose_feed_ends_joins_the_others_updates(spawned):
    """Rank 1 has one batch, rank 0 four: rank 1 joins the last three
    updates with no scene (zero gradients and counts), so both take four
    updates to the same weights, and the epoch ends on both."""
    got = [r["ragged"] for r in spawned["ranks"]]
    assert [g["step"] for g in got] == [4, 4]
    _same(got[0]["params"], got[1]["params"])
    assert got[0]["val"] == got[1]["val"] and np.isfinite(got[0]["val"])


def test_only_rank_zero_writes(spawned):
    work = spawned["work"]
    assert os.listdir(work / "probe_rank0") and not os.path.exists(work / "probe_rank1")
    run = work / "logs" / "cli"
    with open(run / "metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f if "train/total" in line]
    assert steps == [1, 2, 3, 4, 5, 6]   # one record a step: one writer
    assert (run / "source_snapshot").is_dir()


def test_cli_trains_and_resumes_over_two_ranks(spawned):
    """``train_torch.main --multihost --zero1 --device cpu``: 12 scenes at a
    global batch of 4 (2 a rank) train 3 updates, the same weights on both
    ranks; ``--ckpt`` resumes from step 3 for 3 more."""
    cli = [r["cli"] for r in spawned["ranks"]]
    assert [c["first"]["step"] for c in cli] == [3, 3]
    assert [(c["resumed_from"], c["resumed_step"]) for c in cli] == [(3, 6), (3, 6)]
    _same(cli[0]["first"]["params"], cli[1]["first"]["params"])
    _same(cli[0]["params"], cli[1]["params"])
    for c in cli:
        for epoch in (c["first"]["epoch"], c["epoch"]):
            assert epoch["train/steps_skipped"] == 0.0
            assert np.isfinite(epoch["val/ADE_T"]) and epoch["perf/scenes_per_s"] > 0
    assert cli[0]["epoch"]["val/ADE_T"] == cli[1]["epoch"]["val/ADE_T"]


# ---------------------------------------------------------------------------
# a world of one
# ---------------------------------------------------------------------------
def test_a_world_of_one_gives_the_plain_steps_bits(tmp_path):
    """A one-rank gloo group: two train steps of the small fused flagship
    (dropout live, plain K1-K4), then the same with ZeRO-1, give the
    parameters and the AdamW moments of the plain steps bit for bit."""
    cfg = small_cfg(Tf=60)
    for sec in ("encoder", "decoder"):
        cfg[sec]["kwargs"]["fused"] = True
    scenes = [_pair(50 + k, 4)[1] for k in range(2)]

    def run(zero1):
        model = torch_build_model(cfg, device="cpu", seed=3)
        state = create_train_state(model, cfg["training_specific"], steps_per_epoch=2,
                                   zero1=zero1)
        step = make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg),
                               "cpu")
        logs = [step(scene, k, 1) for k, scene in enumerate(scenes)]
        return model, worker.local_moments(state.optimizer), logs

    plain_model, plain_moments, plain_logs = run(False)
    mesh.init_multihost(f"file://{tmp_path / 'rdzv'}", num_processes=1, process_id=0,
                        backend="gloo", timeout_s=60)
    try:
        assert mesh.distributed() and mesh.world() == 1
        for zero1 in (False, True):
            model, moments, logs = run(zero1)
            _same(worker.params(model), worker.params(plain_model))
            assert set(moments) == set(plain_moments)
            for i in moments:
                _same(moments[i], plain_moments[i])
            for got, want in zip(logs, plain_logs):
                assert got["stop"] is False and got["scenes"] == 4
                assert all(torch.equal(got[k], want[k]) for k in want if k.startswith("train/")
                           and k != "train/step_skipped")
    finally:
        mesh.shutdown()
