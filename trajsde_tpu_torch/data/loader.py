"""Mixed-domain dataset, batch loader and datamodule: the host-side
input pipeline (``trajsde_tpu/data/loader.py``).

* per-scene ``.npz`` files and packed shards (:mod:`.shards`) are listed
  per domain and mixed with ``source`` in {0 = nuScenes, 1 = Argoverse};
* each scene is grid-aligned (:mod:`.grid`), optionally flip-augmented
  (:mod:`.augment`), then packed into a dense ``SceneBatch`` of CPU
  tensors at a fixed (A, L) or bucketed capacity (:mod:`.pack`);
* worker processes pack batches ahead of the consumer and hand them back
  in shared memory, in order.

Shuffles and flips follow the JAX loader draw for draw: the permutation of
an epoch comes from ``SeedSequence([seed, epoch])`` and a scene's flips
from ``SeedSequence([seed, epoch, index])``, so a batch's content depends
only on (seed, epoch, indices), whatever the threads' timing.

Under data parallelism (``rank`` / ``world``) every rank draws the same
global batches and packs its own contiguous slice of each
(``mesh.shard_bounds``), at the capacity the whole global batch picks
when bucketing: the tensors are that slice of the global batch's pack.
"""
from __future__ import annotations

import gc
import logging
import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch.utils.data

from trajsde_tpu_torch.data.augment import random_flip
from trajsde_tpu_torch.data.grid import align_to_grid
from trajsde_tpu_torch.data.pack import (
    ACTOR_BUCKETS,
    LANE_BUCKETS,
    pack_scenes,
    pick_bucket,
    truncation_stats,
)
from trajsde_tpu_torch.data.shards import ShardFile, list_shards
from trajsde_tpu_torch.parallel.mesh import shard_bounds

SPLIT_NAME = {
    "nuScenes": {"train": "train", "val": "val", "test": "val"},
    "Argoverse": {"train": "train", "val": "val", "test": "test_obs"},
}


def load_scene_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class NuArgoDataset:
    """Mixed nuScenes+Argoverse dataset over preprocessed ``.npz`` scenes
    and packed shards.  The keyword arguments follow the config's
    ``tr_dataset_args`` (type/nus/Argo/ref_time/random_flip/is_gtabs).
    """

    def __init__(
        self,
        split: str,
        nu_dir: Optional[str] = None,
        argo_dir: Optional[str] = None,
        nus: bool = True,
        argo: bool = True,
        random_flip: bool = False,
        is_gtabs: bool = True,
        seed: int = 0,
        type: str = "grid",
        **_unused,
    ):
        # the 'continuous' irregular-timestamp mode is unimplemented in the
        # JAX package and its reference too: refuse rather than grid-align
        if type != "grid":
            raise NotImplementedError(
                f"dataset type {type!r} is not supported (grid only; the "
                "reference's 'continuous' mode is unimplemented there as well)"
            )
        self.split = split
        self.random_flip = random_flip
        self.is_gtabs = is_gtabs
        self.seed = seed
        # bumped by BatchLoader at each epoch so augmentation draws vary
        # across epochs yet stay deterministic per (seed, epoch, index),
        # whatever the workers' timing
        self.epoch = 0
        # entries: ("npz", path) or ("shard", ShardFile, scene_idx); shards
        # mix freely with per-scene .npz files
        self._entries: List[tuple] = []
        self.sources: List[int] = []

        def add_domain(root, split_name, source):
            d = os.path.join(root, split_name)
            for spath in list_shards(d):
                shard = ShardFile(spath)
                for i in range(len(shard)):
                    self._entries.append(("shard", shard, i))
                    self.sources.append(source)
            files = (
                sorted(f for f in os.listdir(d) if f.endswith(".npz"))
                if os.path.isdir(d)
                else []
            )
            for f in files:
                self._entries.append(("npz", os.path.join(d, f), None))
                self.sources.append(source)

        if nus and nu_dir:
            add_domain(nu_dir, SPLIT_NAME["nuScenes"][split], 0)
        if argo and argo_dir:
            add_domain(argo_dir, SPLIT_NAME["Argoverse"][split], 1)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        kind, a, b = self._entries[idx]
        if kind == "npz":
            scene = load_scene_npz(a)
            if "seq_id" not in scene:
                # scene identity for submissions: the digits of the
                # filename, falling back to the dataset index
                stem = os.path.splitext(os.path.basename(a))[0]
                digits = "".join(ch for ch in stem if ch.isdigit())
                scene["seq_id"] = np.int32(int(digits[-9:]) if digits else idx)
        else:
            scene = dict(a.scene(b))
            scene.setdefault("seq_id", np.int32(idx))
        scene["source"] = np.int32(self.sources[idx])
        scene = align_to_grid(scene, is_gtabs=self.is_gtabs)
        if self.split == "train" and self.random_flip:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch, idx])
            )
            scene = random_flip(scene, rng)
        return scene


class _PackBatches(torch.utils.data.Dataset):
    """Batch ``i`` of an epoch: this rank's scenes of it loaded, aligned,
    flipped and packed, with the truncation counts of that pack.  Runs in a
    worker process."""

    def __init__(self, loader: "BatchLoader", batches: List[np.ndarray]):
        self.loader, self.batches = loader, batches

    def __len__(self) -> int:
        return len(self.batches)

    def __getitem__(self, i: int):
        ld = self.loader
        mine = shard_bounds(len(self.batches[i]), ld.rank, ld.world)
        # a bucketing capacity is the global batch's: load all of its scenes
        load = slice(None) if ld.bucket else mine
        scenes = [ld.dataset[int(j)] for j in self.batches[i][load]]
        A, L = ld._capacity(scenes)
        if ld.bucket:
            scenes = scenes[mine]
        return (pack_scenes(scenes, A, L),
                truncation_stats(scenes, A, L))


class BatchLoader:
    """Shuffling, bucketed, prefetching batch iterator -> ``SceneBatch`` of
    CPU tensors; with ``world > 1``, rank ``rank``'s slice of each global
    batch of ``batch_size`` scenes."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_actors: int,
        num_lanes: int,
        shuffle: bool = True,
        drop_last: bool = True,
        prefetch: int = 2,   # batches each worker packs ahead
        seed: int = 0,
        bucket: bool = False,
        num_workers: int = 1,
        rank: int = 0,
        world: int = 1,
    ):
        self.dataset = dataset
        self.rank, self.world = rank, world
        self.batch_size = batch_size
        self.num_actors = num_actors
        self.num_lanes = num_lanes
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.bucket = bucket
        self.num_workers = max(1, num_workers)
        # when bucketing, (num_actors, num_lanes) are caps; each batch packs
        # to the smallest standard bucket covering its scenes
        self._actor_buckets = sorted(
            {b for b in ACTOR_BUCKETS if b < num_actors} | {num_actors}
        )
        self._lane_buckets = sorted(
            {b for b in LANE_BUCKETS if b < num_lanes} | {num_lanes}
        )
        # truncation accounting: no silent caps
        self.stats = dict(actors_dropped=0, lanes_dropped=0, scenes_truncated=0)
        self._seed = seed

    def _capacity(self, scenes):
        A, L = self.num_actors, self.num_lanes
        if self.bucket:
            A = pick_bucket(
                min(max(s["x"].shape[0] for s in scenes), A), self._actor_buckets
            )
            L = pick_bucket(
                min(max(s["lane_positions"].shape[0] for s in scenes), L),
                self._lane_buckets,
            )
        return A, L

    def first_batch(self):
        """One packed batch, synchronously: the shape template for model
        init.  Starts no thread, and leaves the augmentation epoch, the
        shuffle stream and the truncation counts as they were."""
        n = min(self.batch_size, len(self.dataset))
        scenes = [self.dataset[i] for i in range(n)]
        return pack_scenes(scenes, *self._capacity(scenes))

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            # reshuffle every epoch, deterministically: the permutation is
            # keyed by (seed, dataset.epoch), so it survives the loader
            # being re-created per epoch (drop_last would otherwise exclude
            # the same tail scenes from all of training)
            epoch = getattr(self.dataset, "epoch", 0)
            rng = np.random.default_rng(
                np.random.SeedSequence([self._seed, int(epoch)])
            )
            rng.shuffle(idx)
        stop = (len(idx) // self.batch_size) * self.batch_size if self.drop_last else len(idx)
        for i in range(0, stop, self.batch_size):
            yield idx[i : i + self.batch_size]

    def _iter_workers(self) -> Iterator:
        """``num_workers`` forked processes pack the epoch's batches, each
        handing its batch back in shared memory; the batches come out in
        order.  Processes, not threads: the loading, alignment and the
        per-scene loop of the pack hold the GIL, which the training step's
        launch thread needs.  An error of a worker re-raises here; a
        consumer that leaves early shuts the workers down."""
        batches = list(self._batches_indices())
        if not batches:
            return
        workers = torch.utils.data.DataLoader(
            _PackBatches(self, batches), batch_size=None, shuffle=False,
            num_workers=self.num_workers, multiprocessing_context="fork",
            prefetch_factor=self.prefetch,
        )
        # the workers fork here, from a process whose garbage may hold CUDA
        # tensors: a child that collected a cycle of them would free them
        # through a CUDA context it cannot use, and abort.  Frozen objects
        # are never collected in the children; the parent thaws them.
        gc.freeze()
        try:
            it = iter(workers)
        finally:
            gc.unfreeze()
        try:
            for batch, stats in it:
                for k, v in stats.items():
                    self.stats[k] += v
                yield batch
        finally:
            # now, not when the iterator is collected: a traceback that
            # holds it would keep the workers alive
            it._shutdown_workers()

    def __iter__(self) -> Iterator:
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch += 1
        start_stats = dict(self.stats)
        yield from self._iter_workers()
        dropped = {k: self.stats[k] - start_stats[k] for k in self.stats}
        if dropped["scenes_truncated"]:
            logging.getLogger(__name__).warning(
                "capacity truncation this epoch: %(scenes_truncated)d scenes "
                "lost %(actors_dropped)d actors / %(lanes_dropped)d lanes "
                "(raise num_actors/num_lanes to keep them)",
                dropped,
            )


class DataModuleNuArgoMix:
    """The datamodule of the config's ``datamodule_specific.kwargs``:
    ``nu_dir``/``Argo_dir``, batch sizes, ``tr``/``val``/``test_dataset_args``
    and the dense capacities ``num_actors`` / ``num_lanes``.
    """

    def __init__(
        self,
        nu_dir: Optional[str] = None,
        Argo_dir: Optional[str] = None,
        train_batch_size: int = 32,
        val_batch_size: int = 32,
        num_actors: int = 48,
        num_lanes: int = 192,
        shuffle: bool = True,
        tr_dataset_args: Optional[dict] = None,
        val_dataset_args: Optional[dict] = None,
        test_dataset_args: Optional[dict] = None,
        num_workers: int = 2,
        bucket: bool = False,
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
        **_unused,
    ):
        def mk(split, args):
            args = dict(args or {})
            return NuArgoDataset(
                split,
                nu_dir=nu_dir,
                argo_dir=Argo_dir,
                nus=args.get("nus", True),
                argo=args.get("Argo", True),
                random_flip=args.get("random_flip", False),
                is_gtabs=args.get("is_gtabs", True),
                type=args.get("type", "grid"),
                seed=seed,
            )

        self.train_dataset = mk("train", tr_dataset_args)
        self.val_dataset = mk("val", val_dataset_args)
        self.test_dataset = mk("test", test_dataset_args)
        self.train_batch_size = train_batch_size
        self.val_batch_size = val_batch_size
        self.num_actors = num_actors
        self.num_lanes = num_lanes
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.bucket = bucket
        self.seed = seed
        # data parallelism: every loader yields this rank's slices
        self.shard = dict(rank=rank, world=world)

    def train_loader(self) -> BatchLoader:
        return BatchLoader(
            self.train_dataset, self.train_batch_size, self.num_actors,
            self.num_lanes, shuffle=self.shuffle,
            num_workers=self.num_workers, bucket=self.bucket,
            seed=self.seed, **self.shard,
        )

    def val_loader(self) -> BatchLoader:
        return BatchLoader(
            self.val_dataset, self.val_batch_size, self.num_actors,
            self.num_lanes, shuffle=False, drop_last=False,
            num_workers=self.num_workers, bucket=self.bucket, **self.shard,
        )

    def test_loader(self) -> BatchLoader:
        return BatchLoader(
            self.test_dataset, self.val_batch_size, self.num_actors,
            self.num_lanes, shuffle=False, drop_last=False,
            num_workers=self.num_workers, bucket=self.bucket, **self.shard,
        )
