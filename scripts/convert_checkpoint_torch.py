#!/usr/bin/env python3
"""Convert a reference (daeheepark/TrajSDE) Lightning checkpoint into a
weights-only checkpoint of the PyTorch port, which ``test_torch.py --ckpt``
and ``train_torch.py --wonly`` read.

    python scripts/convert_checkpoint_torch.py -c <config.yml|.json> \\
        --torch-ckpt <lightning.ckpt> --out <step dir>

The config must be the experiment config the checkpoint was trained with
(the same file drops into both stacks; MIGRATION.md).  The output is a
step directory holding ``state.pt`` with the converted ``"model"``
``state_dict`` (``trajsde_tpu_torch.train.checkpoint.save_weights``);
optimizer state and step counters are not carried over, so resume it as a
warm start, not mid-run.  The conversion is a file transform: it runs on
the CPU and writes CPU tensors, which the readers map to their device.
Prints one JSON line: ``out``, ``converted_leaves``, ``skipped_dead`` and
``unused_keys``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--torch-ckpt", required=True)
    p.add_argument("--out", required=True)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from trajsde_tpu_torch.config import build_model, load_config
    from trajsde_tpu_torch.train.checkpoint import save_weights
    from trajsde_tpu_torch.utils.convert import convert_state_dict

    if not os.path.exists(args.torch_ckpt):
        raise FileNotFoundError(args.torch_ckpt)
    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    # bf16 leaves as f32, as the JAX package's converter reads them
    sd = {k: (v.detach().float() if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
              else v) for k, v in sd.items()}

    cfg = load_config(args.config)
    model = build_model(cfg, device="cpu")
    weights, report = convert_state_dict(sd, cfg, model)
    out = save_weights(weights, args.out)
    line = {"out": out, "converted_leaves": len(weights), "skipped_dead": report["skipped"],
            "unused_keys": report["unused"]}
    print(json.dumps(line))
    if report["unused"]:
        print(f"warning: {len(report['unused'])} unrecognized checkpoint keys were ignored "
              "(see unused_keys above)", file=sys.stderr)
    return line


if __name__ == "__main__":
    main()
