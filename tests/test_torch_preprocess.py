"""The port's offline preprocessors (``trajsde_tpu_torch/data/preprocess``)
vs the JAX package's on ``tests/test_preprocess.py``'s cases and fakes:
every geometry function, Argoverse's ``process_scene`` and
``ArgoversePreprocessor.run`` over a CSV with a fake lane provider, and
``NuScenesPreprocessor.run`` under a fake devkit installed for both
packages' runs.  Outputs must be equal key for key, dtype for dtype and
bit for bit.  Then a scene that the port preprocessed, with goal lanes
and more actors and lane segments than the capacities, goes through the
port's ``align_to_grid``, ``pack_scenes`` and loader: the pack equals
JAX's bit for bit.  No dataset and no devkit are needed.
"""
import dataclasses
import sys
import types

import numpy as np
import pytest

from trajsde_tpu.data import grid as jgrid, loader as jloader, pack as jpack
from trajsde_tpu.data.preprocess import argoverse as jargo, common as jcommon
from trajsde_tpu.data.preprocess import nuscenes as jnus
from trajsde_tpu_torch.data import grid as tgrid, loader as tloader, pack as tpack
from trajsde_tpu_torch.data.preprocess import argoverse as targo, common as tcommon
from trajsde_tpu_torch.data.preprocess import nuscenes as tnus
from trajsde_tpu_torch.data.scene import SceneBatch


def assert_same(a, b, what=""):
    """Equal structure; arrays of one dtype and shape, bit for bit."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (what, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert isinstance(b, (np.ndarray, np.generic)), what
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape,
                                                           b.shape)
        np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.uint8),
                                      np.ascontiguousarray(b).view(np.uint8), err_msg=what)
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------
def _segments(mod):
    segs = mod.chunk_centerline(mod.resample_polyline(np.array([[0.0, 0.0], [10.0, 0.0]])))
    return segs + mod.chunk_centerline(mod.resample_polyline(np.array([[0.0, 5.0],
                                                                       [0.0, 15.0]])))


def _lane_edges(mod):
    e_succ = mod.successor_edges(["A", "A", "B", "C"], {"A": ["B"], "B": ["C"], "C": []})
    e_pred = mod.predecessor_edges(e_succ)
    fwd = np.stack([np.arange(5.0), np.zeros(5)], -1).astype(np.float32)
    positions = [fwd, fwd + [0.0, 2.0], fwd + [0.0, 50.0], np.flip(fwd, 0) + [0.0, 2.0]]
    e_prox = mod.proximal_edges(positions, [np.diff(p, axis=0) for p in positions],
                                [[], [], [], []], dist_thresh=4.0)
    return e_succ, e_pred, e_prox, mod.lane_edge_arrays(e_succ, e_pred, e_prox)


def _build_tracks(mod):
    steps = [np.arange(6), np.array([0, 1, 4, 5]), np.array([3, 4, 5])]
    xy = [np.cumsum(np.ones((len(s), 2)), 0) for s in steps]
    return mod.build_tracks(steps, xy, num_past=4, num_future=2, origin=np.zeros(2),
                            rot=np.eye(2, dtype=np.float32))


GEOMETRY = {
    "scene_frame": lambda m: m.scene_frame(np.array([3.0, -1.0]), np.array([0.3, 1.0])),
    "to_scene": lambda m: m.to_scene(np.array([[0.0, 1.0], [2.5, -3.0]]), np.array([1.0, 2.0]),
                                     m.scene_frame(np.zeros(2), np.array([1.0, 1.0]))[0]),
    "build_tracks": _build_tracks,
    "resample_polyline": lambda m: (m.resample_polyline(np.array([[0.0, 0.0], [10.0, 0.0]])),
                                    m.resample_polyline(np.array([[0.0, 0.0], [3.0, 4.0],
                                                                  [3.0, 9.5]]))),
    "chunk_centerline": lambda m: m.chunk_centerline(
        m.resample_polyline(np.array([[0.0, 0.0], [25.0, 0.0]])), lseg_len=10),
    "pad_lane_segments": lambda m: m.pad_lane_segments(_segments(m), 10),
    "wrap_angle": lambda m: m.wrap_angle(np.linspace(-9.0, 9.0, 13)),
    "lane_edges": _lane_edges,
    "lane2_subsets": lambda m: m.lane2_subsets(
        np.array([[0, 1, 1, 2], [0, 0, 1, 1]]),
        {"succ": [[1], [2], []], "pred": [[], [0], [1]], "neigh": [[], [], []]}),
    "assign_goal_lanes": lambda m: m.assign_goal_lanes(
        np.array([[5.0, 0.5], [0.0, 20.0], [5.0, 0.5]]),
        np.array([[1.0, 0.0], [0.0, 1.0], [0.0, 1.0]]), np.array([True, True, True]),
        _segments(m)),
    "ref_positions_global": lambda m: m.ref_positions_global(
        [np.arange(6), np.array([0, 1, 4, 5])], [np.ones((6, 2)), np.ones((4, 2)) * 2], 3,
        np.array([0.5, -0.5])),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_geometry_functions_are_jax_bit_for_bit(name):
    assert_same(GEOMETRY[name](tcommon), GEOMETRY[name](jcommon), name)


def test_nuscenes_process_scene_and_category_ids_are_jax():
    steps = [np.arange(jnus.NUM_PAST + jnus.NUM_FUT)] * 2
    xy = [np.stack([np.arange(len(steps[0]), dtype=np.float32), np.full(len(steps[0]), y)], -1)
          for y in (0.0, 3.0)]

    def provider(positions, map_name, radius=80.0):
        line = np.stack([np.arange(30.0), np.zeros(30)], -1).astype(np.float32)
        return [line, line + [0.0, 3.5]], ["L0", "L1"], {"L0": [], "L1": []}

    args = (steps, xy, [0, 0], 0, np.zeros(2, np.float32), np.array([1.0, 0.0]), "map", provider)
    assert_same(tnus.process_scene(*args), jnus.process_scene(*args))
    names = ["vehicle.car", "vehicle.truck", "human.pedestrian.adult", "movable_object.cone"]
    assert [tnus.category_id(n) for n in names] == [jnus.category_id(n) for n in names]


# ---------------------------------------------------------------------------
# Argoverse
# ---------------------------------------------------------------------------
def argo_tracks(rng, n_actors, n_lanes, spacing=3.5):
    """Tracks of ``n_actors`` driving +y on ``n_lanes`` parallel straight
    lanes (the AV first, the agent second, some actors seen late), and a
    lane provider that returns those lanes: every actor's last position
    lies on a lane with its heading, so it gets a goal lane."""
    xs = (np.arange(n_lanes) - n_lanes // 2) * spacing
    obs_steps, obs_xy = [], []
    for a in range(n_actors):
        first = 0 if a < 2 else int(rng.integers(0, 15))
        steps = np.arange(first, 50)
        speed = rng.uniform(5.0, 12.0)
        y = rng.uniform(-30.0, 10.0) + speed * 0.1 * steps
        obs_steps.append(steps)
        obs_xy.append(np.stack([np.full(len(steps), xs[a % n_lanes]), y], -1).astype(np.float32))

    def lanes(positions, city, radius=80.0):
        return [np.array([[x, -80.0], [x, 120.0]], np.float32) for x in xs]

    return obs_steps, obs_xy, lanes


def test_argoverse_process_scene_is_jax_with_goals_above_capacity():
    obs_steps, obs_xy, lanes = argo_tracks(np.random.default_rng(3), n_actors=9, n_lanes=4)
    got = targo.process_scene(obs_steps, obs_xy, 0, 1, "PIT", lanes)
    assert_same(got, jargo.process_scene(obs_steps, obs_xy, 0, 1, "PIT", lanes))
    assert got["has_goal"].all() and got["padding_mask"].shape[0] == 9
    # no heading at the reference step: both skip the scene
    late = [s[s != targo.REF_STEP - 1] for s in obs_steps]
    xy = [p[: len(s)] for p, s in zip(obs_xy, late)]
    assert targo.process_scene(late, xy, 0, 1, "PIT", lanes) is None
    assert jargo.process_scene(late, xy, 0, 1, "PIT", lanes) is None


def test_argoverse_preprocessor_run_is_jax(tmp_path):
    """``tests/test_preprocess.py``'s CSV and fake lane provider, plus a
    CSV without an AGENT (skipped by both)."""
    import pandas as pd

    rng = np.random.default_rng(0)
    ts = np.arange(50) * 0.1
    rows = []
    for tid, typ in [("av", "AV"), ("agent", "AGENT"), ("o1", "OTHERS")]:
        v, p0 = rng.uniform(-5, 5, 2), rng.uniform(-10, 10, 2)
        for i, tt in enumerate(ts):
            if typ == "OTHERS" and i < 10:
                continue
            p = p0 + v * i * 0.1
            rows.append(dict(TIMESTAMP=tt, TRACK_ID=tid, OBJECT_TYPE=typ, X=p[0], Y=p[1],
                             CITY_NAME="PIT"))
    raw = tmp_path / "raw"
    raw.mkdir()
    pd.DataFrame(rows).to_csv(raw / "1.csv", index=False)
    pd.DataFrame([r for r in rows if r["OBJECT_TYPE"] != "AGENT"]).to_csv(raw / "2.csv",
                                                                          index=False)

    def fake_lanes(positions, city, radius=80.0):
        return [np.array([[x, -20.0], [x, 20.0]], np.float32) for x in (-10.0, 0.0, 10.0)]

    for mod, name in ((targo, "torch"), (jargo, "jax")):
        assert mod.ArgoversePreprocessor(str(raw), str(tmp_path / name),
                                         lane_provider=fake_lanes).run() == 1
    got, want = (dict(np.load(tmp_path / n / "1.npz")) for n in ("torch", "jax"))
    assert_same(got, want)
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == ["1.npz"]


# ---------------------------------------------------------------------------
# nuScenes under a fake devkit (``tests/test_preprocess.py:177-338``)
# ---------------------------------------------------------------------------
def install_fake_devkit(monkeypatch):
    """A micro nuScenes devkit holding one consistent sample: a focal car
    driving +x, a truck on the neighbouring lane, a parked car and a
    pedestrian (both skipped), two lanes laneA -> laneB."""
    def mod(name, **attrs):
        m = types.ModuleType(name)
        for k, v in attrs.items():
            setattr(m, k, v)
        monkeypatch.setitem(sys.modules, name, m)
        return m

    def track(x0, y, n_past=4, n_fut=12):
        past = np.stack([[x0 - k - 1, y] for k in range(n_past)])   # most recent first
        fut = np.stack([[x0 + k + 1, y] for k in range(n_fut)])
        return past.astype(np.float32), fut.astype(np.float32)

    anns = [
        {"instance_token": "inst1", "category_name": "vehicle.car", "attribute_tokens": [],
         "translation": [100.0, 50.0, 0.0], "rotation": [1.0, 0.0, 0.0, 0.0]},
        {"instance_token": "inst2", "category_name": "vehicle.truck", "attribute_tokens": [],
         "translation": [95.0, 53.0, 0.0], "rotation": [1.0, 0.0, 0.0, 0.0]},
        {"instance_token": "inst3", "category_name": "vehicle.car",
         "attribute_tokens": ["attr_parked"], "translation": [105.0, 47.0, 0.0],
         "rotation": [1.0, 0.0, 0.0, 0.0]},
        {"instance_token": "inst4", "category_name": "human.pedestrian.adult",
         "attribute_tokens": [], "translation": [90.0, 55.0, 0.0],
         "rotation": [1.0, 0.0, 0.0, 0.0]},
    ]
    tracks = {"inst1": track(100.0, 50.0), "inst2": track(95.0, 53.0),
              "inst3": (np.zeros((4, 2), np.float32) + [105.0, 47.0],
                        np.zeros((12, 2), np.float32) + [105.0, 47.0]),
              "inst4": track(90.0, 55.0)}
    tables = {"sample": {"sample1": {"scene_token": "scene1"}},
              "scene": {"scene1": {"log_token": "log1"}},
              "log": {"log1": {"location": "fake-town"}},
              "attribute": {"attr_parked": {"name": "vehicle.parked"}}}

    class FakeNuScenes:
        def __init__(self, version, dataroot, verbose=False):
            self.version = version

        def get(self, table, token):
            return tables[table][token]

    class FakePredictHelper:
        def __init__(self, nusc):
            pass

        def get_sample_annotation(self, instance_token, sample_token):
            return next(a for a in anns if a["instance_token"] == instance_token)

        def get_annotations_for_sample(self, sample_token):
            return list(anns)

        def get_past_for_agent(self, inst, sample_token, seconds, in_agent_frame):
            assert not in_agent_frame
            return tracks[inst][0]

        def get_future_for_agent(self, inst, sample_token, seconds, in_agent_frame):
            assert not in_agent_frame
            return tracks[inst][1]

    class FakeQuaternion:
        def __init__(self, wxyz):
            w, _, _, z = wxyz
            self._yaw = 2.0 * np.arctan2(z, w)

        @property
        def yaw_pitch_roll(self):
            return (self._yaw, 0.0, 0.0)

    lanes = {"laneA": np.stack([[90.0 + k, 50.0, 0.0] for k in range(41)]),
             "laneB": np.stack([[130.0 + k, 50.0, 0.0] for k in range(21)])}
    outgoing = {"laneA": ["laneB"], "laneB": []}

    class FakeNuScenesMap:
        def __init__(self, dataroot, map_name):
            assert map_name == "fake-town"

        def get_records_in_radius(self, x, y, radius, layers):
            return {"lane": ["laneA"], "lane_connector": ["laneB"]}

        def get_arcline_path(self, tok):
            return tok

        def get_outgoing_lane_ids(self, tok):
            return outgoing[tok]

    def discretize_lane(path_token, resolution_meters):
        return [tuple(p) for p in lanes[path_token]]

    mod("nuscenes", NuScenes=FakeNuScenes)
    mod("nuscenes.prediction", PredictHelper=FakePredictHelper)
    mod("nuscenes.eval")
    mod("nuscenes.eval.prediction")
    mod("nuscenes.eval.prediction.splits",
        get_prediction_challenge_split=lambda split, dataroot: ["inst1_sample1"])
    mod("nuscenes.map_expansion")
    mod("nuscenes.map_expansion.map_api", NuScenesMap=FakeNuScenesMap)
    mod("nuscenes.map_expansion.arcline_path_utils", discretize_lane=discretize_lane)
    mod("pyquaternion", Quaternion=FakeQuaternion)


def test_nuscenes_preprocessor_run_under_the_fake_devkit_is_jax(tmp_path, monkeypatch):
    install_fake_devkit(monkeypatch)
    for mod, name in ((tnus, "torch"), (jnus, "jax")):
        out = tmp_path / name / "nuScenes" / "train"
        assert mod.NuScenesPreprocessor(dataroot="/nonexistent", out_dir=str(out),
                                        split="train", version="v1.0-mini").run() == 1
    got, want = (dict(np.load(tmp_path / n / "nuScenes" / "train" / "inst1_sample1.npz"))
                 for n in ("torch", "jax"))
    assert_same(got, want)
    assert got["padding_mask"].shape[0] == 2 and bool(got["has_goal"][0])
    # the file feeds both loaders to the same grid-aligned scene
    tds = tloader.NuArgoDataset(split="train", nu_dir=str(tmp_path / "torch" / "nuScenes"))
    jds = jloader.NuArgoDataset(split="train", nu_dir=str(tmp_path / "jax" / "nuScenes"))
    assert len(tds) == len(jds) == 1
    assert_same(tds[0], jds[0])


# ---------------------------------------------------------------------------
# a preprocessed scene through the port's loader
# ---------------------------------------------------------------------------
def _assert_same_batch(jb, tb):
    for f in dataclasses.fields(SceneBatch):
        j, t = getattr(jb, f.name), getattr(tb, f.name)
        assert (j is None) == (t is None), f.name
        if j is None:
            continue
        j, t = np.asarray(j), t.numpy()
        assert j.shape == t.shape, f.name
        if j.dtype.kind == "f":
            assert j.dtype == t.dtype, f.name
            np.testing.assert_array_equal(j.view(np.uint8), t.view(np.uint8), err_msg=f.name)
        else:   # integer ids: int32 in JAX, int64 in the port
            np.testing.assert_array_equal(j.astype(np.int64), t.astype(np.int64),
                                          err_msg=f.name)


def test_preprocessed_scenes_above_capacity_pack_and_load_as_jax(tmp_path):
    rng = np.random.default_rng(7)
    test_dir = tmp_path / "Argoverse" / "test_obs"
    test_dir.mkdir(parents=True)
    scenes = []
    for i, (n_actors, n_lanes) in enumerate(((9, 4), (3, 2), (7, 3))):
        obs_steps, obs_xy, lanes = argo_tracks(rng, n_actors, n_lanes)
        scene = targo.process_scene(obs_steps, obs_xy, 0, 1, "PIT", lanes)
        assert scene["has_goal"].all()
        np.savez(test_dir / f"{i}.npz", **scene)
        scenes.append(scene)
    num_actors, num_lanes = 6, 40
    assert scenes[0]["padding_mask"].shape[0] > num_actors
    assert scenes[0]["lane_positions"].shape[0] > num_lanes
    got = [tgrid.align_to_grid(s) for s in scenes]
    want = [jgrid.align_to_grid(s) for s in scenes]
    assert_same(got, want)
    _assert_same_batch(jpack.pack_scenes(want, num_actors, num_lanes, as_jax=False),
                       tpack.pack_scenes(got, num_actors, num_lanes))
    kw = dict(nu_dir=str(tmp_path / "nuScenes"), Argo_dir=str(tmp_path / "Argoverse"),
              val_batch_size=2, num_actors=num_actors, num_lanes=num_lanes,
              test_dataset_args={"nus": False, "Argo": True}, num_workers=1, seed=2)
    jbs = list(jloader.DataModuleNuArgoMix(**kw).test_loader())
    tbs = list(tloader.DataModuleNuArgoMix(**kw).test_loader())
    assert len(tbs) == len(jbs) == 2
    for jb, tb in zip(jbs, tbs):
        _assert_same_batch(jb, tb)
    assert bool(tbs[0].has_goal.any()) and tbs[0].goal_idcs.shape == (2, num_actors, num_lanes)
