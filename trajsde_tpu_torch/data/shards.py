"""Packed scene shards: the fast on-disk format of the input pipeline
(``trajsde_tpu/data/shards.py``, the same format, so each package reads
the other's shards).

A shard bundles many scenes into one flat binary file:

    [0:8]    magic  b"TRJSHRD1"
    [8:16]   uint64 little-endian index offset
    [16:..]  raw array bytes, each 8-byte aligned
    [index:] JSON index {"scenes": [{field: [dtype, shape, offset, nbytes]}]}

Reads are ``np.memmap`` views: no per-scene zip parsing and no copy, with
pages faulted in on demand.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Sequence

import numpy as np

MAGIC = b"TRJSHRD1"
SHARD_SUFFIX = ".shard"
_ALIGN = 8


def write_shard(path: str, scenes: Sequence[Dict[str, np.ndarray]]) -> None:
    index: List[Dict[str, list]] = []
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", 0))  # index offset placeholder
        offset = 16
        for scene in scenes:
            entry = {}
            for field, arr in scene.items():
                arr = np.ascontiguousarray(arr)
                pad = (-offset) % _ALIGN
                if pad:
                    f.write(b"\x00" * pad)
                    offset += pad
                data = arr.tobytes()
                f.write(data)
                entry[field] = [arr.dtype.str, list(arr.shape), offset, len(data)]
                offset += len(data)
            index.append(entry)
        f.write(json.dumps({"scenes": index}).encode())
        f.seek(8)
        f.write(struct.pack("<Q", offset))


class ShardFile:
    """Random access to one shard; arrays are memmap views (zero copy)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(16)
            if head[:8] != MAGIC:
                raise ValueError(f"{path}: not a TRJSHRD1 shard")
            (index_offset,) = struct.unpack("<Q", head[8:16])
            f.seek(index_offset)
            self._index = json.loads(f.read().decode())["scenes"]
        self._mm = np.memmap(path, np.uint8, mode="r")

    def __len__(self) -> int:
        return len(self._index)

    def scene(self, i: int) -> Dict[str, np.ndarray]:
        out = {}
        for field, (dtype, shape, offset, nbytes) in self._index[i].items():
            view = self._mm[offset : offset + nbytes].view(np.dtype(dtype))
            out[field] = view.reshape(shape)
        return out


def list_shards(directory: str) -> List[str]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.endswith(SHARD_SUFFIX)
    )


def convert_npz_dir(
    src_dir: str, dst_dir: str, scenes_per_shard: int = 256
) -> List[str]:
    """Bundle a directory of per-scene ``.npz`` files into shards.

    The npz filename digits become each scene's ``seq_id`` (the identity
    the submission writer keys on), matching the loader's npz behavior.
    """
    if os.path.abspath(dst_dir) == os.path.abspath(src_dir):
        raise ValueError(
            f"dst_dir == src_dir ({src_dir}): the loader reads BOTH formats "
            "from one directory, so in-place conversion would duplicate "
            "every scene"
        )
    files = sorted(f for f in os.listdir(src_dir) if f.endswith(".npz"))
    os.makedirs(dst_dir, exist_ok=True)
    stale = [f for f in os.listdir(dst_dir) if f.endswith(SHARD_SUFFIX)]
    if stale:
        # shard filenames encode (start, scenes_per_shard), so re-converting
        # with different settings would leave old shards that silently
        # duplicate scenes — refuse instead
        raise ValueError(
            f"{dst_dir} already holds {len(stale)} shard file(s); remove "
            "them (or pick a fresh directory) before converting"
        )
    out_paths = []
    for start in range(0, len(files), scenes_per_shard):
        chunk = files[start : start + scenes_per_shard]
        scenes = []
        for j, fname in enumerate(chunk):
            with np.load(os.path.join(src_dir, fname), allow_pickle=False) as z:
                scene = {k: z[k] for k in z.files}
            if "seq_id" not in scene:
                digits = "".join(ch for ch in os.path.splitext(fname)[0] if ch.isdigit())
                scene["seq_id"] = np.int32(int(digits[-9:]) if digits else start + j)
            scenes.append(scene)
        path = os.path.join(dst_dir, f"scenes_{start:08d}{SHARD_SUFFIX}")
        write_shard(path, scenes)
        out_paths.append(path)
    return out_paths


def _main() -> None:
    """Offline conversion CLI:

        python -m trajsde_tpu_torch.data.shards <src_root> <dst_root> [N]

    Walks every split directory under ``src_root`` that contains ``.npz``
    scenes and writes the packed-shard mirror under ``dst_root`` (same
    relative layout, N scenes per shard, default 256).  Point the config's
    ``nu_dir``/``Argo_dir`` at ``dst_root`` afterwards: the loader reads
    both formats.
    """
    import argparse

    p = argparse.ArgumentParser(description=_main.__doc__)
    p.add_argument("src_root")
    p.add_argument("dst_root")
    p.add_argument("scenes_per_shard", nargs="?", type=int, default=256)
    args = p.parse_args()

    converted = 0
    for dirpath, _dirnames, filenames in os.walk(args.src_root):
        if not any(f.endswith(".npz") for f in filenames):
            continue
        rel = os.path.relpath(dirpath, args.src_root)
        dst = os.path.join(args.dst_root, rel)
        paths = convert_npz_dir(dirpath, dst, args.scenes_per_shard)
        n = sum(1 for f in filenames if f.endswith(".npz"))
        print(f"{rel}: {n} scenes -> {len(paths)} shards")
        converted += n
    if not converted:
        raise SystemExit(f"no .npz scenes found under {args.src_root}")


if __name__ == "__main__":
    _main()
