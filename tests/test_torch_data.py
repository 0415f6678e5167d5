"""Port data layer vs the JAX package: synthetic scenes, grid alignment,
packing and bucketing give identical arrays from the same numpy inputs."""
import numpy as np
import pytest
import torch

from trajsde_tpu.data import grid as jgrid, pack as jpack, synthetic as jsyn
from trajsde_tpu_torch.data import grid as tgrid, pack as tpack, synthetic as tsyn

from _torch_helpers import SCENE_FIELDS

torch.set_num_threads(1)


def _assert_same_dict(a, b):
    assert set(a) == set(b)
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("source", [0, 1])
def test_make_raw_scene_identical(source):
    a = jsyn.make_raw_scene(np.random.default_rng(5), source, num_actors=7, num_lanes=9)
    b = tsyn.make_raw_scene(np.random.default_rng(5), source, num_actors=7, num_lanes=9)
    _assert_same_dict(a, b)


def test_make_scene_batch_identical():
    js = jsyn.make_scene_batch(np.random.default_rng(2), batch_size=3, num_actors=6, num_lanes=8)
    ts = tsyn.make_scene_batch(np.random.default_rng(2), batch_size=3, num_actors=6, num_lanes=8)
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ts, f).numpy(), err_msg=f)


@pytest.mark.parametrize("source,is_gtabs", [(0, True), (1, True), (0, False), (1, False)])
def test_align_to_grid_identical(source, is_gtabs):
    raw = jsyn.make_raw_scene(np.random.default_rng(11), source, num_actors=5, num_lanes=4)
    _assert_same_dict(jgrid.align_to_grid(raw, is_gtabs), tgrid.align_to_grid(raw, is_gtabs))


def test_pack_scenes_identical_with_truncation():
    rng = np.random.default_rng(4)
    raws = [jsyn.make_raw_scene(rng, s % 2, num_actors=9, num_lanes=14) for s in range(3)]
    aligned = [jgrid.align_to_grid(r) for r in raws]
    jb = jpack.pack_scenes(aligned, num_actors=6, num_lanes=10, as_jax=False)
    tb = tpack.pack_scenes(aligned, num_actors=6, num_lanes=10)
    for f in SCENE_FIELDS + ("seq_id",):
        np.testing.assert_array_equal(np.asarray(getattr(jb, f)), getattr(tb, f).numpy(), err_msg=f)


@pytest.mark.parametrize("n", [1, 3, 8, 9, 200])
def test_pick_bucket(n):
    buckets = (1, 2, 4, 8, 16)
    assert tpack.pick_bucket(n, buckets) == jpack.pick_bucket(n, buckets)
