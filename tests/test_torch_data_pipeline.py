"""Port input pipeline vs the JAX package: flips, packing with truncation
and goal lanes, shards, the loader over npz and shards, the feed to the
device and ``Trainer.fit`` through them.

The same synthetic scenes, written from a numpy seed to ``tmp_path``, go
through both packages; every field must be equal (floats bit for bit,
integer ids by value: int32 in JAX, int64 in the port).
"""
import dataclasses
import gc
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from trajsde_tpu.data import augment as jaug, grid as jgrid, loader as jloader
from trajsde_tpu.data import pack as jpack, shards as jshards
from trajsde_tpu.data.synthetic import make_raw_scene
from trajsde_tpu_torch.config import FLAGSHIP, build_datamodule, build_losses, build_metrics
from trajsde_tpu_torch.config import build_model as torch_build_model
from trajsde_tpu_torch.data import augment as taug, loader as tloader
from trajsde_tpu_torch.data import pack as tpack, shards as tshards
from trajsde_tpu_torch.data.scene import SceneBatch, strip_for_device
from trajsde_tpu_torch.train.loop import (Trainer, create_train_state, device_prefetch,
                                          make_train_step, step_generator)

from _torch_helpers import small_cfg

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = [f.name for f in dataclasses.fields(SceneBatch)]


def assert_same(a, b, what=""):
    """Equal values and shapes; floats bit for bit."""
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=what)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=what)


def assert_same_batch(jb, tb, what=""):
    """A JAX ``SceneBatch`` (numpy leaves) and the port's (CPU tensors)."""
    for f in FIELDS:
        j, t = getattr(jb, f), getattr(tb, f)
        assert (j is None) == (t is None), (what, f)
        if j is not None:
            assert_same(j, t.numpy(), f"{what} {f}")


def with_goals(rng, raw):
    """A raw scene with a one-hot goal lane per actor and a has_goal flag."""
    n, nl = raw["x"].shape[0], raw["lane_positions"].shape[0]
    goal = np.zeros((n, nl), np.float32)
    goal[np.arange(n), rng.integers(0, nl, n)] = 1.0
    return dict(raw, goal_idcs=goal, has_goal=rng.uniform(size=n) < 0.7)


def write_tree(root, rng, n=10, goals=True):
    """``n`` scenes per domain and split, of ragged sizes, as per-scene npz
    files under ``root/{nuScenes,Argoverse}/{train,val}``; every third
    scene carries goal lanes."""
    for name, src in (("nuScenes", 0), ("Argoverse", 1)):
        for split in ("train", "val"):
            d = os.path.join(root, name, split)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                raw = make_raw_scene(rng, src, num_actors=int(rng.integers(3, 21)),
                                     num_lanes=int(rng.integers(4, 41)))
                if goals and i % 3 == 0:
                    raw = with_goals(rng, raw)
                np.savez(os.path.join(d, f"scene_{1000 + 7 * i:06d}.npz"), **raw)


def convert_tree(src, dst, mod, per_shard=4):
    for name in ("nuScenes", "Argoverse"):
        for split in ("train", "val"):
            mod.convert_npz_dir(os.path.join(src, name, split), os.path.join(dst, name, split),
                                scenes_per_shard=per_shard)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    write_tree(str(root / "npz"), np.random.default_rng(0))
    convert_tree(str(root / "npz"), str(root / "shards"), jshards)
    return root


# ---------------------------------------------------------------------------
# flips and packing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_random_flip_bit_equal_to_jax(seed):
    scene = jgrid.align_to_grid(make_raw_scene(np.random.default_rng(seed), seed % 2))
    j = jaug.random_flip(scene, np.random.default_rng(seed))
    t = taug.random_flip(scene, np.random.default_rng(seed))
    assert set(j) == set(t)
    for k in j:
        if j[k] is not None:
            assert_same(j[k], t[k], k)


def _aligned(seed, n=5, goals=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        raw = make_raw_scene(rng, i % 2, num_actors=int(rng.integers(3, 17)),
                             num_lanes=int(rng.integers(2, 31)),
                             lane_poses=int(rng.choice([7, 10, 13])))
        if goals and i % 2 == 0:
            raw = with_goals(rng, raw)
        s = jgrid.align_to_grid(dict(raw, seq_id=np.int32(100 + i)))
        if i == 3:
            s["y"] = None   # a test-split scene among labelled ones
        out.append(s)
    return out


@pytest.mark.parametrize("cap", [(6, 8), (16, 32), (20, 40)])
def test_pack_scenes_equal_to_jax(cap):
    scenes = _aligned(3)
    jb = jpack.pack_scenes(scenes, *cap, as_jax=False)
    tb = tpack.pack_scenes(scenes, *cap)
    assert tb.goal_idcs is not None and tb.seq_id.dtype == torch.int64
    assert_same_batch(jb, tb, f"cap {cap}")
    assert tpack.truncation_stats(scenes, *cap) == jpack.truncation_stats(scenes, *cap)


@pytest.mark.parametrize("seed", range(4))
def test_pack_scenes_equal_to_jax_fuzz(seed):
    """The ragged envelope: actor and lane counts above and below capacity,
    mixed sources, lane-pose widths above and below the destination's,
    test-split scenes (no ``y``) among labelled ones, and goal lanes on
    some scenes."""
    rng = np.random.default_rng(1234 + seed)
    for trial in range(3):
        scenes = []
        for _ in range(int(rng.integers(1, 6))):
            raw = make_raw_scene(rng, source=int(rng.integers(0, 2)),
                                 num_actors=int(rng.integers(2, 17)),
                                 num_lanes=int(rng.integers(1, 31)),
                                 lane_poses=int(rng.choice([7, 10, 13])))
            if rng.uniform() < 0.4:
                raw = with_goals(rng, raw)
            s = jgrid.align_to_grid(raw)
            if rng.uniform() < 0.3:
                s["y"] = None
            scenes.append(s)
        A, L = int(rng.integers(2, 21)), int(rng.integers(1, 41))
        assert_same_batch(jpack.pack_scenes(scenes, A, L, as_jax=False),
                          tpack.pack_scenes(scenes, A, L), f"trial {trial}")


def test_pack_drops_has_goal_with_a_truncated_goal_lane():
    rng = np.random.default_rng(9)
    s = jgrid.align_to_grid(with_goals(rng, make_raw_scene(rng, 1, num_actors=4,
                                                           num_lanes=12)))
    far = int(tpack._lane_keep_order(s)[-1])   # the lane cut first
    s["goal_idcs"][:] = 0.0
    s["goal_idcs"][:, far] = 1.0
    s["has_goal"][:] = True
    tb = tpack.pack_scenes([s], 4, 8)
    assert not tb.has_goal.any() and not tb.goal_idcs.any()
    assert_same_batch(jpack.pack_scenes([s], 4, 8, as_jax=False), tb)


def test_buckets_and_pick_bucket_equal_to_jax():
    assert tpack.ACTOR_BUCKETS == jpack.ACTOR_BUCKETS
    assert tpack.LANE_BUCKETS == jpack.LANE_BUCKETS
    for n in (1, 8, 9, 47, 48, 49, 128, 600):
        for buckets in (tpack.ACTOR_BUCKETS, tpack.LANE_BUCKETS):
            assert tpack.pick_bucket(n, buckets) == jpack.pick_bucket(n, buckets)


def test_from_numpy_wraps_without_copying():
    x = np.zeros((2, 3, 21, 2), np.float32)
    ids = np.arange(2, dtype=np.int64)
    ro = np.ones((2, 3), bool)
    ro.flags.writeable = False
    b = SceneBatch.from_numpy(x=x, positions=x, padding_mask=ro, bos_mask=ro,
                              rotate_angles=x[..., 0, 0], actor_valid=ro, agent_index=ids,
                              av_index=np.zeros(2, np.int32), source=ids)
    assert b.x.data_ptr() == x.ctypes.data and b.agent_index.data_ptr() == ids.ctypes.data
    assert b.av_index.dtype == torch.int64
    assert b.actor_valid.data_ptr() != ro.ctypes.data   # read-only input is copied


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------
def test_shards_read_across_packages(tmp_path):
    rng = np.random.default_rng(4)
    scenes = [with_goals(rng, make_raw_scene(rng, i % 2, num_actors=5, num_lanes=8))
              for i in range(5)]
    for writer, reader in ((jshards, tshards), (tshards, jshards)):
        path = str(tmp_path / f"{writer.__name__}.shard")
        writer.write_shard(path, scenes)
        shard = reader.ShardFile(path)
        assert len(shard) == 5
        for i, want in enumerate(scenes):
            got = shard.scene(i)
            assert set(got) == set(want)
            for k in want:
                assert_same(want[k], got[k], k)
    a, b = (open(tmp_path / f"{m.__name__}.shard", "rb").read() for m in (jshards, tshards))
    assert a == b


def test_convert_npz_dir_writes_the_same_bytes_and_guards(tree, tmp_path):
    src = str(tree / "npz" / "Argoverse" / "train")
    paths = tshards.convert_npz_dir(src, str(tmp_path / "port"), scenes_per_shard=4)
    want = sorted(tshards.list_shards(str(tree / "shards" / "Argoverse" / "train")))
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in want]
    for p, w in zip(paths, want):
        assert open(p, "rb").read() == open(w, "rb").read()
    for mod in (jshards, tshards):
        with pytest.raises(ValueError, match="dst_dir == src_dir"):
            mod.convert_npz_dir(src, src)
        with pytest.raises(ValueError, match="already holds"):
            mod.convert_npz_dir(src, str(tmp_path / "port"), scenes_per_shard=2)
    with pytest.raises(ValueError, match="not a TRJSHRD1 shard"):
        tshards.ShardFile(os.path.join(src, os.listdir(src)[0]))


def test_shard_conversion_cli(tree, tmp_path):
    dst = tmp_path / "cli"
    out = subprocess.run(
        [sys.executable, "-m", "trajsde_tpu_torch.data.shards", str(tree / "npz"), str(dst), "4"],
        capture_output=True, text=True, check=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", "")),
    )
    assert "Argoverse/train: 10 scenes -> 3 shards" in out.stdout
    for sub in ("nuScenes/train", "nuScenes/val", "Argoverse/train", "Argoverse/val"):
        got = sorted(os.listdir(dst / sub))
        assert got == sorted(os.listdir(tree / "shards" / sub))
        for f in got:
            assert (dst / sub / f).read_bytes() == (tree / "shards" / sub / f).read_bytes()


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------
def _dm_kwargs(root, fmt, workers, bucket):
    return dict(nu_dir=str(root / fmt / "nuScenes"), Argo_dir=str(root / fmt / "Argoverse"),
                train_batch_size=4, val_batch_size=3, num_actors=16, num_lanes=32,
                tr_dataset_args={"nus": True, "Argo": True, "random_flip": True},
                val_dataset_args={"nus": True, "Argo": True},
                num_workers=workers, bucket=bucket, seed=5)


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("fmt", ["npz", "shards"])
def test_loader_batches_equal_to_jax(tree, fmt, workers, bucket):
    """Two epochs of the training loader (a fresh loader each epoch,
    shuffle and flips on) and the validation loader give JAX's batches."""
    kw = _dm_kwargs(tree, fmt, workers, bucket)
    jdm = jloader.DataModuleNuArgoMix(**kw)
    tdm = tloader.DataModuleNuArgoMix(**kw)
    assert len(tdm.train_dataset) == len(jdm.train_dataset) == 20
    for epoch in range(2):
        jl, tl = jdm.train_loader(), tdm.train_loader()
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) == len(tl) == 5
        for i, (jb, tb) in enumerate(zip(jbs, tbs)):
            assert_same_batch(jb, tb, f"epoch {epoch} batch {i}")
        assert tl.stats == jl.stats
    assert tdm.train_dataset.epoch == jdm.train_dataset.epoch == 2
    jbs, tbs = list(jdm.val_loader()), list(tdm.val_loader())
    assert len(tbs) == 7   # drop_last off: 20 scenes in batches of 3
    for jb, tb in zip(jbs, tbs):
        assert_same_batch(jb, tb, "val")


def test_npz_and_shards_give_the_same_batches(tree):
    a = list(tloader.DataModuleNuArgoMix(**_dm_kwargs(tree, "npz", 1, False)).train_loader())
    b = list(tloader.DataModuleNuArgoMix(**_dm_kwargs(tree, "shards", 3, False)).train_loader())
    for x, y in zip(a, b):
        for f in FIELDS:
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None and v is None) or torch.equal(u, v), f


def test_build_datamodule_precedence(tree):
    cfg = {"datamodule_specific": {"module_name": "DataModuleNuArgoMix",
                                   "kwargs": dict(_dm_kwargs(tree, "npz", 1, False), seed=3)}}
    dm = build_datamodule(cfg, seed=9, num_actors=8, num_lanes=None)
    assert (dm.num_actors, dm.num_lanes, dm.seed) == (8, 32, 3)   # config seed wins
    del cfg["datamodule_specific"]["kwargs"]["seed"]
    assert build_datamodule(cfg, seed=9).seed == 9
    dm = build_datamodule(FLAGSHIP)
    assert (dm.train_batch_size, dm.num_actors, dm.num_lanes, dm.num_workers) == (128, 48, 192, 2)
    assert dm.train_dataset.random_flip and not dm.val_dataset.random_flip
    with pytest.raises(KeyError, match="unknown datamodule"):
        build_datamodule({"datamodule_specific": {"module_name": "Other"}})


def _corrupt_tree(tmp_path, n=4):
    d = tmp_path / "Argoverse" / "train"
    os.makedirs(d)
    rng = np.random.default_rng(2)
    for i in range(n):
        np.savez(d / f"s{i}.npz", **make_raw_scene(rng, 1, num_actors=5, num_lanes=8))
    (d / "s2.npz").write_bytes(b"not an npz")
    return tloader.NuArgoDataset("train", argo_dir=str(tmp_path / "Argoverse"), nus=False)


def _wait_for_threads(baseline, timeout=5.0):
    t0 = time.monotonic()
    while threading.active_count() > baseline and time.monotonic() - t0 < timeout:
        time.sleep(0.05)
    return threading.active_count()


@pytest.mark.parametrize("workers", [1, 3])
def test_loader_errors_reach_the_consumer_through_the_feed(tmp_path, workers):
    ds = _corrupt_tree(tmp_path)
    baseline = threading.active_count()
    loader = tloader.BatchLoader(ds, batch_size=1, num_actors=6, num_lanes=10, shuffle=False,
                                 drop_last=False, num_workers=workers)
    with pytest.raises(Exception, match="pickle|zip|npz|load"):
        list(loader)
    with pytest.raises(Exception, match="pickle|zip|npz|load"):
        list(device_prefetch(loader, "cpu"))
    assert _wait_for_threads(baseline) == baseline


def test_first_batch_has_no_side_effects(tree):
    dm = tloader.DataModuleNuArgoMix(**_dm_kwargs(tree, "npz", 3, False))
    loader = dm.train_loader()
    baseline = threading.active_count()
    b = loader.first_batch()
    assert b.x.shape == (4, 16, 21, 2) and isinstance(b.x, torch.Tensor)
    assert dm.train_dataset.epoch == 0 and threading.active_count() == baseline
    assert loader.stats == dict(actors_dropped=0, lanes_dropped=0, scenes_truncated=0)


class _Collecting:
    """A dataset that runs a full garbage collection before each scene
    load (in the loader's worker processes)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        gc.collect()
        return self.dataset[i]


class _Witness:
    """A cycle that only a collection frees; it writes down the pid of the
    process that frees it."""

    def __init__(self, path):
        self.path, self.me = path, self

    def __del__(self):
        with open(self.path, "a") as f:
            f.write(f"{os.getpid()}\n")


def test_loader_workers_leave_the_parents_garbage_alone(tree, tmp_path):
    """The workers fork from a process whose garbage may hold CUDA tensors,
    which a forked child cannot free: a cycle left in the parent is
    collected in the parent, never in a worker that collects."""
    dm = tloader.DataModuleNuArgoMix(**_dm_kwargs(tree, "npz", 2, False))
    loader = dm.train_loader()
    loader.dataset = _Collecting(loader.dataset)
    log = tmp_path / "freed_by"
    gc.disable()
    try:
        _Witness(str(log))
        assert len(list(loader)) == len(loader) > 0
        assert not log.exists()
    finally:
        gc.enable()
    gc.collect()
    assert log.read_text().split() == [str(os.getpid())]


@pytest.mark.parametrize("workers", [1, 3])
def test_a_consumer_that_leaves_early_stops_the_threads(tree, workers):
    dm = tloader.DataModuleNuArgoMix(**dict(_dm_kwargs(tree, "shards", workers, False),
                                            train_batch_size=1))
    baseline = threading.active_count()
    feed = device_prefetch(dm.train_loader(), "cpu", size=1)
    next(feed)
    feed.close()
    assert _wait_for_threads(baseline) == baseline


def test_truncation_is_counted_and_warned(tree, caplog):
    kw = dict(_dm_kwargs(tree, "npz", 1, False), num_actors=6, num_lanes=8)
    jl, tl = (m.DataModuleNuArgoMix(**kw).train_loader() for m in (jloader, tloader))
    with caplog.at_level("WARNING"):
        list(tl)
    list(jl)
    assert tl.stats == jl.stats and tl.stats["scenes_truncated"] > 0
    assert "capacity truncation this epoch" in caplog.text


# ---------------------------------------------------------------------------
# strip_for_device, the feed and the trainer
# ---------------------------------------------------------------------------
def test_strip_for_device_leaves_forward_and_losses_unchanged():
    cfg = small_cfg(Tf=60)
    scenes = _aligned(6, n=3)
    full = tpack.pack_scenes(scenes, 8, 16)
    stripped = strip_for_device(full)
    assert full.goal_idcs is not None and stripped.goal_idcs is None and stripped.has_goal is None
    assert stripped.positions.shape[2] == full.x.shape[2]
    assert stripped.x is full.x and strip_for_device(stripped) is stripped
    model = torch_build_model(cfg, device="cpu", seed=2)
    model.train()
    outs = []
    for scene in (full, stripped):
        gen, s = step_generator("cpu", 7, 0)
        out = model(scene, generator=gen, rollout_seed=s)
        outs.append((out, [fn(out["y"], out) for _, _, fn in build_losses(cfg)]))
    (a, la), (b, lb) = outs
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


class _Log:
    def __init__(self):
        self.rows = []

    def log_scalars(self, step, values):
        self.rows.append((step, dict(values)))


def test_trainer_fit_through_the_loader_and_feed(tree):
    """Losses of ``Trainer.fit`` fed by the loader (flips on, 3 workers)
    and the feed equal those of train steps on the same batches packed by
    hand, unstripped, with no feed."""
    cfg = small_cfg(Tf=60)
    cfg["decoder"]["kwargs"]["fused"] = True
    kw = dict(_dm_kwargs(tree, "shards", 3, False), num_actors=8, num_lanes=16)
    dm = tloader.DataModuleNuArgoMix(**kw)
    ds = dm.train_dataset
    # what the loader's first epoch holds: epoch 1's permutation and flips
    ds.epoch = 1
    idx = np.arange(len(ds))
    np.random.default_rng(np.random.SeedSequence([5, 1])).shuffle(idx)
    by_hand = [tpack.pack_scenes([ds[int(i)] for i in idx[k:k + 4]], 8, 16)
               for k in range(0, 20, 4)]
    ds.epoch = 0

    state = create_train_state(torch_build_model(cfg, device="cpu", seed=4),
                               cfg["training_specific"], steps_per_epoch=5, seed=2)
    log = _Log()
    trainer = Trainer(build_losses(cfg), build_metrics(cfg), device="cpu", logger=log)
    trainer.fit(state, dm.train_loader, dm.val_loader, max_epochs=1)
    got = [row["train/total"] for _, row in log.rows if "train/total" in row]
    assert state.step == 5 and trainer.epoch_logs[0]["perf/batch_wait_ms"] >= 0.0

    ref = create_train_state(torch_build_model(cfg, device="cpu", seed=4),
                             cfg["training_specific"], steps_per_epoch=5, seed=2)
    step = make_train_step(ref.model, ref.optimizer, ref.scheduler, build_losses(cfg), "cpu")
    want = [float(step(b, k, 2)["train/total"]) for k, b in enumerate(by_hand)]
    assert got == want
    a, b = state.model.state_dict(), ref.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
