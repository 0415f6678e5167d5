"""Deployment artifacts (``trajsde_tpu/deploy.py``): the serving pipeline
exported with :mod:`torch.export`.

The artifact is the scan engine's whole serving computation: the model's
own forward in eval mode (:func:`~trajsde_tpu_torch.serving.make_scan_fn`)
followed by the world-frame postprocess
(:func:`~trajsde_tpu_torch.server.make_postprocess`), with the trained
weights inside the program, exported once per batch bucket.  Kernels K1
and K3 enter the program as the registered ops ``trajsde::sde_rollout``
and ``trajsde::aa_fused_fwd`` (``ops/sde_rollout.py``, ``ops/aa_fused.py``),
which launch the kernels on the card and run their plain versions on the
CPU.  A deployment host needs torch, this module and the port's ops
modules with ``csrc/`` (nvcc builds the kernels at first use on a card):
no config, no checkpoint and no model code.

Artifact layout (one directory)::

    manifest.json     buckets, packing dims, leaf schema, draws, platforms, ops
    bucket_<B>.pt2    ``torch.export.save`` of the program for batch bucket B

Calling convention: the program takes the scene's present leaves in
``SceneBatch`` field order (the manifest's ``leaf_schema`` names every
field, ``None`` ones included, and is checked on every call), then the
draws.  A ``torch.Generator`` cannot be an input of an exported program,
so what the model draws in eval mode comes in as tensors
(``manifest["draws"]``): the SDE encoder's ``twin_noise [B, 1, Th, 2]``
and ``enc_noise [Th, B, A+1, D]``, then an unfused SDE decoder's
``dec_noise [Tf, B, F, A, D]`` or a fused one's ``rollout_seed``, a 0-d
int64 host tensor.  :class:`ExportedServing` draws them from a generator
seeded with the call's seed, in the model's order, shapes and dtypes, so
an artifact and the live scan engine at the same seed and counter give the
same answers.  The HiVT baseline draws nothing in eval mode.  An adaptive
SDE encoder is refused (ROADMAP.md Queue 1 item 11b): its step-doubling
loop runs a fixed number of iterations, but each segment's Brownian tree
draws 256 node normals of the state's shape, which as inputs would be
21 x 256 x [B, A + 1, D] f32 a call (one tree a historical step; about 8.6 GB
at bucket 128).  A fused AA encoder
in bf16 runs kernel K3b, which has no registered op yet, and is refused
(ROADMAP.md Queue 1 item 6c).

Platforms: each program is exported on the model's device and keeps it;
``platforms`` lists the devices (``cpu``, ``cuda``) it may be loaded on,
and a load onto another device than the export's moves the program with
``torch.export.passes.move_to_device_pass``.  A program exported on the
card stores CUDA tensors, which a host without a card cannot read, so an
artifact for the CPU is exported from a model on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import torch

# registers the trajsde ops that the programs call
from trajsde_tpu_torch.ops import aa_fused as _aa_fused  # noqa: F401
from trajsde_tpu_torch.ops import sde_rollout as _sde_rollout  # noqa: F401

MANIFEST = "manifest.json"
FORMAT = "trajsde_tpu_torch.serving_export.v1"
# Baked-postprocess revision (the JAX package's): bump when make_postprocess
# changes its math, so stale artifacts fail loudly.
# rev 2: delta-mode cumsum + nuScenes grid-scale undo in agent_world.
POSTPROCESS_REV = 2
PLATFORMS = ("cpu", "cuda")


def _leaf_schema(scene) -> List[Dict[str, Any]]:
    """Every ``SceneBatch`` field in order: its shape and dtype, or None for
    an absent field."""
    out = []
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        out.append({"name": f.name,
                    "shape": None if v is None else list(v.shape),
                    "dtype": None if v is None else str(v.dtype).replace("torch.", "")})
    return out


def _draws(model, scene) -> List[Dict[str, Any]]:
    """The inputs that stand for the model's eval-mode draws, in the order
    the model makes them, at batch 1 (``batch_axis`` is the axis a bucket
    tiles; None for the host seed)."""
    from trajsde_tpu_torch.models.decoders import SDEDecoder
    from trajsde_tpu_torch.models.sde_encoder import LocalEncoderSDESep

    enc, dec = model.encoder, model.decoder
    if not isinstance(enc, LocalEncoderSDESep):
        return []
    if enc.adaptive:
        raise NotImplementedError(
            "export_serving of an adaptive SDE encoder (encoder.adaptive: true): its "
            "Brownian trees' node normals would be inputs, 21 x 256 x [B, A+1, D] f32 a call "
            "(about 8.6 GB at bucket 128); this is ROADMAP.md Queue 1 item 11b (serve it with "
            "the scan or kernel engine)")
    name = lambda dt: str(dt).replace("torch.", "")  # noqa: E731
    Th, D, A = enc.historical_steps, enc.embed_dim, scene.x.shape[1]
    draws = [
        {"name": "twin_noise", "shape": [1, 1, Th, 2], "dtype": name(scene.x.dtype),
         "batch_axis": 0},
        {"name": "enc_noise", "shape": [Th, 1, A + 1, D],
         "dtype": name(enc.compute_dtype or scene.x.dtype), "batch_axis": 1},
    ]
    if isinstance(dec, SDEDecoder):
        if dec.fused:
            draws.append({"name": "rollout_seed", "shape": [], "dtype": "int64",
                          "batch_axis": None})
        else:
            draws.append({"name": "dec_noise",
                          "shape": [dec.future_steps, 1, dec.num_modes, A, dec.local_channels],
                          "dtype": name(dec.compute_dtype or torch.float32), "batch_axis": 1})
    return draws


def _draw_shape(draw: Dict[str, Any], batch: int) -> List[int]:
    shape = list(draw["shape"])
    if draw["batch_axis"] is not None:
        shape[draw["batch_axis"]] = batch
    return shape


class _Pipeline(torch.nn.Module):
    """forward(*leaves, *draws) -> the postprocessed result dict."""

    def __init__(self, model, scene_type, fields: Sequence[Optional[str]],
                 draws: Sequence[Dict[str, Any]], post) -> None:
        super().__init__()
        self.model = model
        self._scene_type = scene_type
        self._fields = list(fields)
        self._draws = [d["name"] for d in draws]
        self._post = post

    def forward(self, *inputs):
        n = sum(f is not None for f in self._fields)
        leaves = iter(inputs[:n])
        scene = self._scene_type(**{f: next(leaves) for f in self._fields if f is not None})
        kwargs = dict(zip(self._draws, inputs[n:]))
        out = self.model(scene, **kwargs)
        return self._post(scene, out)


def export_serving(model, example_scene, out_dir: str, *,
                   buckets: Sequence[int] = (1, 8, 32, 128), is_gtabs: bool = True,
                   ref_time: int = 20, platforms: Optional[Sequence[str]] = None
                   ) -> Dict[str, Any]:
    """Export the serving pipeline of ``model`` (on its device, in eval
    mode) for every batch bucket and write the manifest; returns it.

    ``example_scene`` is a packed B=1 ``SceneBatch`` on the CPU that fixes
    the leaf schema (actor / lane padding, which optional fields are
    present); each bucket's program tiles its leading batch dimension.
    ``platforms`` (``cpu`` and / or ``cuda``) lists where the artifact may
    be loaded; default the model's device.
    """
    from trajsde_tpu_torch.server import make_postprocess

    dev = next(model.parameters()).device
    platforms = list(platforms) if platforms else [dev.type]
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(f"unknown platforms {bad}: the port exports for {list(PLATFORMS)}")
    if "cpu" in platforms and dev.type != "cpu":
        raise ValueError(f"a program exported on {dev} keeps CUDA tensors that a host "
                         "without a card cannot read: export a 'cpu' artifact from a model "
                         "on the CPU")
    if int(example_scene.x.shape[0]) != 1:
        raise ValueError(f"example_scene must be a packed B=1 batch, got "
                         f"B={int(example_scene.x.shape[0])}")
    aa = getattr(model.encoder, "aa_encoder", None)
    if aa is not None and aa.fused and aa.chain_dtype == "bfloat16":
        raise NotImplementedError(
            "export_serving of a fused AA encoder in bf16 (encoder.fused: true with dtype: "
            "bfloat16): kernel K3b is not a registered op; this is ROADMAP.md Queue 1 item 6c "
            "(serve it with the scan or kernel engine)")
    model.eval()
    schema = _leaf_schema(example_scene)
    draws = _draws(model, example_scene)
    fields = [s["name"] if s["shape"] is not None else None for s in schema]
    pipe = _Pipeline(model, type(example_scene), fields, draws,
                     make_postprocess(is_gtabs, ref_time))
    os.makedirs(out_dir, exist_ok=True)
    buckets = sorted(set(int(b) for b in buckets))
    calls = set()
    for b in buckets:
        leaves = [getattr(example_scene, f) for f in fields if f is not None]
        leaves = [v.to(dev).expand(b, *v.shape[1:]).contiguous() for v in leaves]
        extra = [torch.zeros(_draw_shape(d, b), dtype=getattr(torch, d["dtype"]),
                             device="cpu" if d["batch_axis"] is None else dev) for d in draws]
        with torch.no_grad():
            ep = torch.export.export(pipe, tuple(leaves + extra), strict=False)
        calls |= {n.target.name() for n in ep.graph.nodes
                  if getattr(n.target, "namespace", None) == "trajsde"}
        # the tiled example and the zero draws are no part of the program
        # (tens of MiB at bucket 128)
        ep.example_inputs = None
        torch.export.save(ep, os.path.join(out_dir, f"bucket_{b}.pt2"))

    manifest = {
        "format": FORMAT,
        "buckets": buckets,
        "num_actors": int(example_scene.x.shape[1]),
        "num_lanes": int(example_scene.lane_positions.shape[1])
        if example_scene.lane_positions is not None else 0,
        "is_gtabs": bool(is_gtabs),
        "ref_time": int(ref_time),
        "platforms": platforms,
        "exported_on": dev.type,
        "leaf_schema": schema,
        "draws": draws,
        "ops": sorted(calls),
        "postprocess_rev": POSTPROCESS_REV,
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ExportedServing:
    """A loaded artifact on ``device``: ``(scene, seed, generator=None) ->
    result dict`` per bucket, the serve slot of
    :class:`~trajsde_tpu_torch.server.ServingEngine` (``engine="exported"``
    / ``ServingEngine.from_export``)."""

    def __init__(self, path: str, device="cuda") -> None:
        with open(os.path.join(path, MANIFEST)) as f:
            m = json.load(f)
        if m.get("format") != FORMAT:
            raise ValueError(f"{path}: not a serving export (got {m.get('format')!r})")
        self.path = path
        self.buckets = tuple(m["buckets"])
        self.num_actors = int(m["num_actors"])
        self.num_lanes = int(m["num_lanes"])
        self.is_gtabs = bool(m["is_gtabs"])
        # delta-mode artifacts baked before postprocess rev 2 are missing
        # the cumsum/grid-scale math in agent_world: refuse to serve them
        if not self.is_gtabs and m.get("postprocess_rev", 1) < POSTPROCESS_REV:
            raise ValueError(
                f"{path}: delta-mode (is_gtabs=false) artifact was exported "
                f"with postprocess rev {m.get('postprocess_rev', 1)} < "
                f"{POSTPROCESS_REV}; its baked world projection predates the "
                "delta-mode cumsum/grid-scale fix — re-export from the "
                "checkpoint"
            )
        self.ref_time = int(m["ref_time"])
        self.platforms = tuple(m["platforms"])
        self.device = torch.device(device)
        if self.device.type not in self.platforms:
            raise ValueError(f"{path}: exported for {list(self.platforms)}, not "
                             f"{self.device.type}; re-export with that platform")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{path}: loading onto {self.device} needs a CUDA GPU, and "
                               "torch sees none")
        missing = [op for op in m.get("ops", []) if not _registered(op)]
        if missing:
            raise RuntimeError(f"{path}: the programs call ops that are not registered: "
                               f"{missing}")
        self.leaf_schema = m["leaf_schema"]
        self.draws = m["draws"]
        self.manifest = m
        self.programs = {}   # bucket -> its ExportedProgram
        self._fns = {}
        for b in self.buckets:
            ep = torch.export.load(os.path.join(path, f"bucket_{b}.pt2"))
            if m.get("exported_on", self.device.type) != self.device.type:
                from torch.export.passes import move_to_device_pass

                ep = move_to_device_pass(ep, self.device)
            self.programs[b] = ep
            self._fns[b] = ep.module()

    def leaves(self, scene) -> List[torch.Tensor]:
        """The program's scene inputs, checked against the leaf schema."""
        values = [getattr(scene, s["name"], None) for s in self.leaf_schema]
        present = [v for v in values if v is not None]
        want = [s for s in self.leaf_schema if s["shape"] is not None]
        b = int(present[0].shape[0])
        if b not in self._fns:
            raise ValueError(f"batch size {b} has no exported bucket (have {self.buckets})")
        if len(present) != len(want) or any(
                (v is None) != (s["shape"] is None) for v, s in zip(values, self.leaf_schema)):
            raise ValueError(
                f"scene has {len(present)} leaves but the artifact was exported "
                f"with {len(want)} — optional SceneBatch fields "
                "must match the export-time example (check y/lane/goal/seq_id "
                "presence and the packer dims in manifest.json)"
            )
        for v, s in zip(present, want):
            if list(v.shape)[1:] != s["shape"][1:]:
                raise ValueError(
                    f"leaf shape {tuple(v.shape)} != exported {tuple(s['shape'])} "
                    "(batch dim aside) — repack with the manifest's "
                    f"num_actors={self.num_actors}/num_lanes={self.num_lanes}"
                )
            if str(v.dtype).replace("torch.", "") != s["dtype"]:
                raise ValueError(
                    f"leaf dtype {v.dtype} != exported {s['dtype']} — repack with the "
                    "manifest schema (plain python floats default to float64; cast "
                    "before calling)"
                )
        return [v.to(self.device) for v in present]

    def __call__(self, scene, seed: int, generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Serve one packed batch.  The draws come from ``generator``, or
        from a generator on the device seeded with ``seed``, in the
        manifest's order; a fused decoder's rollout seed is ``seed``.
        ``draws`` pins some of them by name (tests)."""
        leaves = self.leaves(scene)
        b = int(leaves[0].shape[0])
        draws = draws or {}
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(int(seed))
        extra = []
        for d in self.draws:
            if d["name"] in draws:
                extra.append(draws[d["name"]].to(self.device if d["batch_axis"] is not None
                                                 else "cpu"))
            elif d["batch_axis"] is None:
                extra.append(torch.tensor(int(seed), dtype=torch.int64))
            else:
                extra.append(torch.randn(_draw_shape(d, b), generator=generator,
                                         device=self.device, dtype=getattr(torch, d["dtype"])))
        with torch.no_grad():
            return self._fns[b](*leaves, *extra)


def _registered(op: str) -> bool:
    ns, name = op.split("::")
    return hasattr(getattr(torch.ops, ns), name)


def load_serving(path: str, device="cuda") -> ExportedServing:
    return ExportedServing(path, device)
