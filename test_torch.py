#!/usr/bin/env python3
"""Evaluation CLI of the PyTorch/CUDA port (``trajsde_tpu_torch``), with
``test.py``'s flags and meaning.

    python test_torch.py -c configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_h100.yml \\
        --ckpt logs/my_run/checkpoints/step_XXXXXXXX [--ood] [--only-agent] [--submit] \\
        [--serving [--serving-increments rademacher|gaussian]] [--viz-ood [--viz-limit N]] \\
        [--num-actors A] [--num-lanes L] [--device cuda|cpu]

Runs the test split through the checkpoint's weights and writes
``out/result_<ckpt>.json`` beside ``checkpoints/``; the metrics JSON is the
last line printed.  ``--ood`` scores through the encoder's OOD ensemble
and adds ``agent_std_mean``; ``--only-agent`` (or the config's
``only_agent``) cuts every batch to its focal agents before the metrics;
``--submit`` writes the focal agents' world-frame modes to
``out/submission_<ckpt>.npz``; ``--serving`` runs the serving forward
(the rollout in one kernel launch).  ``--viz-ood`` with ``--ood`` draws scene 0
of each of the first ``--viz-limit`` batches, its actors coloured by their
OOD std, to ``out/viz_ood/batch<i>.png`` (needs matplotlib).  Batch ``i`` draws from
``mix_seed(EVAL_SEED, i)``, as ``Trainer.evaluate`` does.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--ood", action="store_true")
    p.add_argument("--submit", action="store_true",
                   help="write the focal agents' world-frame predictions for submission")
    p.add_argument("--viz-ood", action="store_true",
                   help="with --ood: draw scene 0 of each batch, its actors coloured by "
                        "their OOD std, to out/viz_ood/batch<i>.png")
    p.add_argument("--viz-limit", type=int, default=8,
                   help="--viz-ood draws the first N batches")
    p.add_argument("--num-actors", type=int, default=None,
                   help="actor capacity (overrides the config)")
    p.add_argument("--num-lanes", type=int, default=None,
                   help="lane capacity (overrides the config)")
    p.add_argument("--only-agent", action="store_true",
                   help="cut each batch to its focal agents before the metrics")
    p.add_argument("--serving", action="store_true",
                   help="run the serving forward: the decoder rollout in kernel K1")
    p.add_argument("--serving-increments", choices=["rademacher", "gaussian"],
                   default="rademacher")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.viz_ood:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit("--viz-ood needs matplotlib, which is not installed") from None
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Evaluate; returns the metrics dict that it prints."""
    args = parse_args(argv)

    import torch

    from trajsde_tpu_torch.config import build_datamodule, build_metrics, build_model, load_config
    from trajsde_tpu_torch.data.transforms import (leave_only_agent, leave_only_agent_output,
                                                   take_per_scene)
    from trajsde_tpu_torch.device import resolve_device
    from trajsde_tpu_torch.models.decoders import SDEDecoder
    from trajsde_tpu_torch.models.sde_encoder import gather_agent
    from trajsde_tpu_torch.server import make_postprocess
    from trajsde_tpu_torch.serving import make_serving_fn
    from trajsde_tpu_torch.train.checkpoint import CheckpointManager
    from trajsde_tpu_torch.train.loop import EVAL_SEED, agent_slices, device_prefetch, step_generator
    from trajsde_tpu_torch.utils import viz

    cfg = load_config(args.config)
    device = resolve_device(args.device)
    datamodule = build_datamodule(cfg, num_actors=args.num_actors, num_lanes=args.num_lanes)
    model = build_model(cfg, device=device)
    ckpt_dir = os.path.dirname(os.path.abspath(args.ckpt))
    # weights only: whatever optimizer trained the checkpoint
    CheckpointManager(ckpt_dir).restore_params(model, args.ckpt)
    model.eval()
    metrics = build_metrics(cfg)
    model_kwargs = cfg.get("model_specific", {}).get("kwargs", {})
    # the reference carries only_agent as a model kwarg; the flag also works
    only_agent = args.only_agent or bool(model_kwargs.get("only_agent", False))
    test_args = cfg.get("datamodule_specific", {}).get("kwargs", {}).get("test_dataset_args") or {}
    is_gtabs = test_args.get("is_gtabs", True)
    post_fn = make_postprocess(is_gtabs, model_kwargs.get("ref_time", 20)) if args.submit else None
    if args.ood and not hasattr(model.encoder, "forward_ood"):
        raise SystemExit(f"--ood needs an encoder with forward_ood (OOD ensemble scoring); "
                         f"this config's {type(model.encoder).__name__} has none")
    if args.serving and not isinstance(model.decoder, SDEDecoder):
        raise SystemExit("--serving requires the SDE decoder (the fused rollout engine); "
                         "this config's decoder has no rollout")
    # with --ood the encoder scores through its ensemble, the rollout stays K1
    serve = (make_serving_fn(model, device, increments=args.serving_increments, ood=args.ood)
             if args.serving else None)
    ood_kwargs = {"ood": True} if args.ood else {}   # the baseline's forward takes no ood

    for m in metrics:
        m.reset()
    std_sum, std_cnt = 0.0, 0
    submissions = []
    viz_dir = os.path.join(os.path.dirname(ckpt_dir), "out", "viz_ood")
    with torch.no_grad(), contextlib.closing(
            device_prefetch(datamodule.test_loader(), device)) as feed:
        for i, scene in enumerate(feed):
            gen, seed = step_generator(device, EVAL_SEED, i)
            if serve is not None:
                out = serve(scene, seed, generator=gen)
            else:
                out = model(scene, generator=gen, rollout_seed=seed, **ood_kwargs)
            # the full-actor stds and batch for --viz-ood, taken before the
            # only-agent cut; viz_ood reads the history and the lanes alone,
            # so the stripped batch draws test.py's picture of its host batch
            stds_full, scene_full = out.get("stds"), scene
            if only_agent:
                if "stds" in out:
                    out["stds"] = take_per_scene(out["stds"], scene.agent_index, axis=1)
                out = leave_only_agent_output(out, scene.agent_index)
                scene = leave_only_agent(scene)
            if out.get("y") is not None:
                pred, target, reg_mask, source = agent_slices(scene, out, is_gtabs)
                for m in metrics:
                    m.accumulate(m.update_fn(pred, target, reg_mask, source))
            if "stds" in out:
                agent_std = gather_agent(out["stds"], scene.agent_index, axis=1)
                std_sum += float(agent_std.sum())
                std_cnt += agent_std.shape[0]
            if args.viz_ood and stds_full is not None and i < args.viz_limit:
                viz.viz_ood(scene_full, stds_full, 0, os.path.join(viz_dir, f"batch{i:04d}.png"))
            if post_fn is not None:
                post = post_fn(scene, out)
                seq = (scene.seq_id if scene.seq_id is not None
                       else torch.zeros(scene.x.shape[0], dtype=torch.int64))
                submissions.append(tuple(v.cpu().numpy() for v in (
                    post["agent_world"], post["agent_pi"], seq, scene.source)))

    results = {m.name: m.compute() for m in metrics}
    if std_cnt:
        results["agent_std_mean"] = std_sum / std_cnt
    out_dir = os.path.join(os.path.dirname(ckpt_dir), "out")
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.ckpt.rstrip("/")))[0]
    with open(os.path.join(out_dir, f"result_{stem}.json"), "w") as f:
        json.dump(results, f, indent=2)
    if submissions:
        world, probs, seqs, sources = (np.concatenate(c) for c in zip(*submissions))
        np.savez(os.path.join(out_dir, f"submission_{stem}.npz"), trajectories=world,
                 probabilities=probs, seq_ids=seqs, sources=sources)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
