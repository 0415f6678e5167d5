#!/usr/bin/env python3
"""Serve and train the flagship neural-SDE model, and the HiVT baseline, on
one NVIDIA GPU through the PyTorch/CUDA port (``trajsde_tpu_torch``) and
hold its kernels against their plain PyTorch versions.

    python3 chip_smoke.py   # from the repository root, on a GPU machine

Phases (any failure raises and exits non-zero; nothing falls back):
  1. device: require CUDA, print the card's name and power limit, f32
     matmuls in full precision (TF32 off);
  2. build: compile every kernel from ``trajsde_tpu_torch/csrc`` and the
     check copies of phases G and L (:func:`build_check_copies`), one nvcc
     per source in parallel, and print ptxas's registers and spills;
  3. kernels: the rollout kernel K1 vs its plain version at the row count
     of each served bucket (1, 8, 128: 480, 3,840 and 61,440 rows x 60
     steps x 64) with explicit, Rademacher and gaussian increments, within
     ``TOL_KERNEL`` and ``TOL_K1_TIGHT``; CUDA-event medians of K1 at each
     row count beside the bound on its route (its products on the tensor
     cores) and the CUDA-core bound, and of the plain version at bucket 128;
  4. serve: a full-width ``ServingEngine`` (48 actors, 192 lanes, K=10,
     seeded weights) answers batches of 1, 5 and 128 scenes; outputs are
     checked, K1's launch count must equal the batch count and K3's be 0;
     peak device memory of the phase;
  5. splice: one served bucket (kernel rollout) vs the model's own
     forward (plain rollout loop) with the same pinned noise;
  A. fused AA kernel: K3 vs its plain version at the bucket-128 twin
     shape (128 x 21 x 49 receivers x 48 senders), the bucket-1 shape and
     the OOD shape (Aq = Ak = 48), with and without a dropout keep mask,
     for the model's packed weights and for random ones with non-zero
     off-diagonal blocks, a mask with empty receivers, within ``TOL_K3``
     and ``TOL_K3_TIGHT``; two runs bit-equal; CUDA-event medians at
     bucket 128 and the OOD shape beside the bound on K3's route (its
     products on the tensor cores) and the CUDA-core bound;
  B. fused serving: a full-width ``ServingEngine`` over
     ``FLAGSHIP_FUSED`` (``encoder.fused: true``, the same seeded weights)
     answers batches of 1, 5 and 128; K3 and K1 launch once per batch, K2
     never; times beside phase 4's;
  C. fused splice: at bucket 8 the fused model's served answer vs the
     DENSE model's own forward (same weights, pinned noise), and one fused
     ``forward_ood`` vs the dense one (K3 launches once);
  6. backward kernel: K2 vs its plain version at the training shape
     (61,440 rows x 60 steps x 64), explicit and in-kernel gaussian
     increments, per output within ``k2_tol``; two runs bit-equal;
     CUDA-event medians beside the bound on K2's route (its products on
     the f64 tensor cores) and the CUDA-core bound;
  7. train: ``FLAGSHIP_TRAIN`` (fused rollout, full width, seeded init)
     fits one epoch of synthetic batches of both sources, evaluates two
     batches, takes repeated steps on one batch (the loss must fall), and
     saves and restores a checkpoint; K1 and K2 must launch once per
     optimizer step, K3 never;
  8. train splice: one step's loss and every gradient of the fused path
     (K1 + K2, explicit decoder noise) vs autograd through the plain loop;
  D. fused AA backward kernel: K4 vs its plain version (autograd through
     the plain chain) at the training twin shape (128 x 21 x 49 x 48) and
     at batch 1, with and without a dropout keep mask, for the model's
     packed weights and random ones, a mask with empty receivers and a
     random cotangent; two runs bit-equal; CUDA-event medians at the
     training shape with keep beside the bound on K4's route and the
     CUDA-core bound;
  E. fused-encoder training: phase 7 on ``FLAGSHIP_TRAIN_FUSED``
     (``encoder.fused: true`` as well); K1, K2, K3 and K4 launch once per
     optimizer step, eval launches K3 and K1 once per batch; times beside
     phase 7's;
  F. fused-encoder train splice: one step's loss and every gradient of
     ``FLAGSHIP_TRAIN_FUSED`` (K3 + K4 + K1 + K2) vs ``FLAGSHIP_TRAIN`` (the
     dense encoder), same weights, pinned noise; K3 and K4 launch once;
  G. ``aa_attention`` (K5, the AA chain from positions, with the q
     projection and the pair features in the kernel; K3's products and
     softmax): its own path, one call at the twin shape (128 x 21 x 49 x
     48, 8 heads) and one at the baseline's (128 x 21 x 48 x 48, 4 heads),
     launches K5 twice; then K5 vs its plain version and vs K3 fed the
     same q and u within ``TOL_K3_TIGHT``, which a copy of K5 with one
     TF32 product per term must fail, at the ``test_aa_kernel.py`` shape,
     a ragged one and the twin shape at 8 heads, and at the first two and
     the baseline's shape at 4, for the model's packed weights (the
     flagship's, the baseline's) and random ones, a mask with empty
     receivers; two runs bit-equal; CUDA-event medians at the twin shape
     and the baseline's, beside the bounds on K5's route and on the CUDA
     cores;
  H. the elementwise-rate probe (K6, ``scripts/bench_vpu_dtype_torch.py``):
     the MUFU instructions per value and round of each variant, read from
     the built library's SASS (``scripts/vpu_probe_sass_torch.py``), equal
     to ``K6_MUFU``; its own path, f32 and bf16 on the JAX probe's [2048,
     128] tile, then f32, approximate-tanh f32 and bf16 on a [65536, 128]
     tile that fills the card, timed beside the bound (the special-function
     units' time for those instructions, the CUDA cores' for the multiply
     and add, or the bytes, whichever is longest); then K6 vs its plain
     version element by element, in ulps, in every run, and the rates;
  I. train from files (after F): 4 batches of 128 synthetic scenes of both
     sources written as per-scene ``.npz`` and converted to shards by the
     port's ``convert_npz_dir``; ``FLAGSHIP_TRAIN_FUSED`` trains one epoch
     from each format through ``build_datamodule`` (the YAML's batch of 128,
     48 / 192, flips on, 2 workers), ``Trainer.fit`` and its feed to the
     card (pinned buffers, a copy stream); K1-K4 launch once per step, K5
     and K6 never, no step is skipped, and the loader's first batch, packed
     in a worker process, equals the pack of its scenes in this process
     bit for bit; prints the pack time, each format's load time and
     host-clock ms/step beside phase E's pre-packed step, and the trainer's
     wait;
  J. the command line (after I, on I's npz files and 160 nuScenes
     validation / test scenes): ``train_torch.main`` on a JSON copy of
     ``FLAGSHIP_H100`` trains one epoch at batch 128, then resumes from its
     checkpoint (``--ckpt``) for one more with ``--profile 1``;
     ``test_torch.main`` evaluates the best checkpoint plain, with ``--ood
     --only-agent``, ``--submit`` and ``--serving``.  K1-K4 launch once per
     train step and K1 and K3 once per eval or test batch, K5 and K6 never;
     the step continues after the resume, the profiler leaves a trace, the
     metrics are finite, the submission has the scenes' shapes, ids and
     probabilities that sum to 1; prints the CLI's host-clock ms per step
     and wait beside phase I's.
  K. the serving engine (after J): a ``FLAGSHIP_FUSED`` engine at full
     width (seeded weights, the default buckets, max_batch 128) warms all
     8 buckets, timed, recording nothing; pipelined and serial ``predict``
     of 512 scenes on two engines of one seed agree within
     ``TOL_PIPELINE`` (bit-equal or not is printed) and are timed in 4
     alternating rounds (scenes/s), with the device's idle share across
     one pipelined and one serial ``predict`` under ``torch.profiler``; 256
     scenes submitted from 16 threads at ``max_wait_ms`` 5 all resolve,
     ``mean_batch`` > 1,
     K1 and K3 launch once per recorded batch and K2, K4, K5 and K6 never
     (p50 / p99 printed); 20 single scenes submitted one at a time give
     bucket 1's p50 / p99; 8 concurrent HTTP ``POST /predict`` on
     127.0.0.1 (half JSON, half ``Accept: application/x-npz``) answer 200
     with the engine's fields, ``/stats`` counts them and, after
     ``close()``, a POST answers 503; ``serve_torch.py`` in batch mode on
     J's checkpoint and validation scenes under ``FLAGSHIP_H100`` writes one
     ``*_pred.npz`` per scene with the right shapes and probabilities that
     sum to 1, and a stats line (K1 and K3 once per batch and warmup
     bucket).
  L. the HiVT baseline (after K): ``BASELINE`` (dense AA chain) and
     ``BASELINE_TRAIN`` (``encoder.fused: true``, the same weights) at the
     published widths (embed 64, 4 heads, 4 temporal and 3 global layers,
     K = 10, 60 steps, 48 / 192) with seeded weights, on one batch of 128
     synthetic scenes.  First K3 and K4 at 4 heads at the baseline's shape
     (128 x 21 x 48 receivers x 48 senders): K3 vs its plain version for
     the model's packed weights without a keep mask and random ones with
     one, within ``TOL_K3_TIGHT``, which a copy of K3 with one TF32
     product per term must fail; K4 vs autograd through the plain chain
     by ``k4_tol``; bit-equal reruns; K4's recomputed logits equal to
     K3's bit for bit, and K3's softmax max their max (check copies built
     with ``AA_WRITE_LOGITS`` in phase 2); CUDA-event medians of both beside their
     bounds.  Then, dense and fused: the forward (finite, shaped; the
     fused one within ``TOL_SPLICE`` of the dense one) and three train
     steps (dropout live; finite and falling loss), CUDA-event times,
     scenes/s and peak memory of each; the dense paths launch no kernel,
     the fused forward K3 once and each fused train step K3 and K4 once;
     then a scan engine over each (``engine="auto"`` picks ``scan``):
     pipelined and serial ``predict`` of BASELINE_SCENES scenes agree
     within ``TOL_PIPELINE`` (the fused one launches K3 once per batch),
     timed in alternating rounds, and BASELINE_SINGLES single scenes
     submitted one at a time give p50 / p99.  K1, K2, K5 and K6 never
     launch on the baseline's paths.
  M. training as ``train.py`` does (after L).  M1: ``FLAGSHIP_CAPPED`` (the
     ``_tpu_fast`` YAML in f32: ``neighbor_cap: 24`` on the dense AA
     block) with the fused decoder, batch 128: at the batch's largest
     in-radius degree (below Ak) nothing drops and the forward with pinned
     encoder and twin noise is the dense model's within ``TOL_CAPPED`` of
     max|dense|; at cap 24 ``aa_overflow_edges`` equals numpy's count from
     the masks and is above 0 (the share dropped printed), one train step
     is finite and launches K1 and K2 once and K3-K6 never; the forward
     and the step, capped and dense, in turns (CUDA events) with their
     peak memory.  M2: one accum-2 update of ``FLAGSHIP_TRAIN_FUSED`` on
     two batches of 64, dropout live: its gradients are (g1 + g2) / 2 of
     the micro-batches run alone with the same seeds, bit for bit, K1-K4
     once per micro-batch; its peak memory beside one step of 128; the
     time ``save`` blocks, synchronous and asynchronous, in turns; then
     ``train_torch.main`` on a JSON copy of ``FLAGSHIP_H100`` at batch 64
     with ``--accum 2 --async-ckpt`` on I's npz files: K1-K4 once per
     micro-batch, ceil(batches / 2) updates, the checkpoint on the board
     after the run, and ``--ckpt`` resumes it for one more epoch.
  N. bf16 mixed precision (after M), batch 128, 48 / 192, seeded weights
     shared with the f32 models.  N1: ``FLAGSHIP_BF16``
     (``configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_tpu.yml``) served
     through ``engine="kernel"`` at bucket 128 launches K1 once (the bf16
     fuse cast to f32 rows); loc and pi are finite f32 and mean|pi| is
     within ``TOL_BF16_PI`` of ``FLAGSHIP``'s; the bf16 loc's distance from
     the f32 one with pinned noise is printed.  N2: ``FLAGSHIP_BF16`` with
     the fused decoder takes BF16_STEPS train steps, K1 and K2 once each
     per step, finite losses, every parameter, gradient and AdamW moment
     f32.  N3: ``FLAGSHIP_BF16_CAPPED`` (the ``_tpu_fast`` YAML as written,
     cap 24) with the fused decoder on M1's scenes: ``aa_overflow_edges``
     equals M1's count, then its train steps as N2's.  Each path is timed
     in turns with its f32 counterpart (``FLAGSHIP``, ``FLAGSHIP_TRAIN``,
     ``FLAGSHIP_CAPPED`` with the fused decoder), with peak memory.
  O. the adaptive solver (after N; ``encoder.adaptive: true``, step
     doubling in each ODE-RNN segment, no kernel of its own).  O1: a
     Brownian tree at [6,272, 64] (bucket 128's twin rows), depth 8, on the
     card: additive within ``TOL_TREE``, var W(t) within 5% of t, the same
     bits whatever the query order, and within ``TOL_TREE`` of the port's
     CPU tree on the same nodes.  O2: ``sdeint_adaptive`` on the card
     reproduces the Ornstein-Uhlenbeck mean and variance (JAX's own case),
     with the CPU run's counts on the same nodes.  O3: the adaptive
     ``FLAGSHIP_FUSED`` encoder on the card vs the port's CPU run on
     ADAPTIVE_SCENES scenes, the same weights, twin noise and tree nodes,
     within ``TOL_ADAPTIVE_CPU`` of max|CPU|.  O4: ``ServingEngine.predict``
     at bucket 128 over the adaptive ``FLAGSHIP_FUSED`` launches K3 and K1
     once and the rest never, finite answers; the served bucket and the
     encoder alone, adaptive and fixed grid, in turns (CUDA events, one run
     a round, peak memory).  O5: ``FLAGSHIP_TRAIN_FUSED`` with ``adaptive:
     true`` takes ADAPTIVE_STEPS train steps at batch 128: K1-K4 once per
     step, finite losses, finite non-zero gradients on ``f_func``,
     ``g_nus`` and ``g_argo``; the step in turns against the fixed grid's
     (one run a round).
  P. rematerialization (after O; ``encoder.remat: true``: the AA and AL
     blocks run again in the backward, no kernel of its own).  For each of
     ``FLAGSHIP_TRAIN`` (dense AA, K1 + K2), ``FLAGSHIP_TRAIN_FUSED`` (K1-K4),
     ``BASELINE_TRAIN`` (K3 + K4 at 4 heads) and ``BASELINE`` (dense, no
     kernel) at batch 128 with seeded weights shared with the plain build:
     one train step of each, dropout live and every draw from a CUDA
     generator of one seed: the loss and every gradient by phase F's bar
     (bit-equal or not is printed), the generator left where the plain step
     leaves it, K3 twice and K4 once in a fused remat step, K1 and K2 once
     on the flagship, nothing else; one eval batch bit-equal to the plain
     one (K3 once on the fused builds, K1 once on the flagship); then
     REMAT_STEPS steps of each through ``make_train_step`` with the same
     launches, and the step in turns against the plain one (CUDA events,
     peak memory).
  Q. data-parallel training (after N, on J's files; ``trajsde_tpu_torch/
     parallel/mesh.py``, no kernel of its own).  Q1: one NCCL rank on this
     card runs ``train_torch.main --multihost --zero1`` on J's config for
     one epoch: K1-K4 once per update and K1 / K3 once per eval batch, and
     its checkpoint (weights, AdamW moments, schedule) bit-equal to J's
     plain first epoch (a world of one changes nothing); the checkpoint
     restores into a plain single-process AdamW bit for bit; then the
     data-parallel ZeRO-1 step against the plain one at TRAIN_BATCH, in
     turns (CUDA events and host clock).  Q2: two ranks, each in a process
     of its own (:func:`multi_rank_worker`), over gloo sharing this card
     (NCCL refuses two ranks on one device), or over NCCL one card each
     when the machine has two (printed): ``FLAGSHIP_TRAIN_FUSED`` with
     dropout 0 at MULTI_BATCH global scenes and ``_splice_train_inputs``'
     pinned noise, each rank its slice.  One step's global loss and every
     all-reduced gradient against the single-process step on the whole
     batch by phase F's bar; after MULTI_STEPS AdamW updates the ZeRO-1
     parameters bit-equal across the ranks and within rtol 1e-5 / atol 1e-7
     of the replicated run; K1-K4 once per update on each rank; a rank
     that fails or outlives RANK_TIMEOUT_S fails the phase; the ZeRO-1
     step's times, marked as gloo on one card.
  R. the deployment artifact (after Q, on J's files;
     ``trajsde_tpu_torch/deploy.py``, K1 and K3 as the registered ops
     ``trajsde::sde_rollout`` and ``trajsde::aa_fused_fwd``).  R1:
     ``FLAGSHIP_H100`` at full width with seeded weights exported on the
     card for EXPORT_BUCKETS (1 and 128); the export's seconds and the size
     on disk printed.  R2: a process of its own that imports no ``models``,
     ``config`` or ``train`` module (``EXPORT_WORKER``) loads it with
     ``ServingEngine.from_export`` and serves 1 scene, then 128: K1 and K3
     once per batch, K2 and K4 never, and the answers within
     ``TOL_PIPELINE`` of the live scan engine's at the same seed (bit-equal
     or not printed).  R3: one served batch at buckets 1 and 128, exported
     against live, in EXPORT_ROUNDS alternating rounds of CUDA-event
     medians; nothing is claimed from them.  R4: the same model exported on
     the CPU for ``cpu`` and ``cuda`` and moved to the card at load: K1 and
     K3 once, within ``TOL_SPLICE`` of the CPU program on pinned encoder
     draws.  R5: ``serve_torch.py --export`` on J's checkpoint (bucket 1),
     then ``--from-export`` over J's validation scenes: K1 and K3 once per
     scene, the predictions checked.
  S. a converted reference checkpoint over preprocessed scenes (after R, on
     J's files; ``trajsde_tpu_torch/utils/convert.py``,
     ``scripts/convert_checkpoint_torch.py``, ``data/preprocess``).  S1: the
     port's ``argoverse.process_scene`` (numpy, a fake lane provider) writes
     PREPROCESSED_SCENES Argoverse test scenes, one above the 48-actor and
     one above the 192-lane capacity, every actor with a goal lane; with J's
     nuScenes scenes they make the test split of a JSON copy of
     ``FLAGSHIP_H100``.  S2: the seeded ``FLAGSHIP_H100`` weights written as
     a reference Lightning checkpoint (``convert.to_reference``, the dead
     tensors at their reference shapes, two unknown keys).  S3:
     ``scripts/convert_checkpoint_torch.py`` in a process of its own: its
     report names every leaf, the dead tensors and the unknown keys, and the
     converted weights are the seeded ones bit for bit.  S4:
     ``test_torch.main --serving --ood`` on the card over that split, on the
     converted checkpoint and on one saved directly from the seeded weights:
     finite metrics and ``agent_std_mean``, equal bit for bit, K1 and K3
     once per batch, nothing else.  S5: the phase's and the conversion's
     seconds beside the card's name and power limit.
  T. bf16 inside the fused AA kernels (after S; K3b and K4b, the bf16
     forms of K3 and K4 in ``csrc/aa_fused.cu`` and ``csrc/aa_fused_bwd.cu``).
     T1: K3b against its plain version (``compute_dtype="bfloat16"``, with
     ``ln_mm``) at the bucket-128 twin shape and the OOD shape at 8 heads
     and the baseline's at 4, with and without keep, for the model's packed
     weights and random ones with non-zero off-diagonal w1 blocks, empty
     receivers exactly 0, within ``TOL_K3B`` (max and mean), which K3 (f32)
     on the same inputs must fail; bit-equal reruns; with ``ln_mm`` off
     against its own plain version, and apart from the ``ln_mm`` one; timed
     at bucket 128 beside K3 in the same call, its bound on its route (bf16
     products on the tensor cores) and on the CUDA cores.  T2: K4b against
     its plain version at the training twin shape at BF16_FUSED_BATCH with
     keep, model and random weights, within ``TOL_K4B`` per output (K4
     (f32) must fail it on some output), bit-equal reruns, its recomputed
     logits K3b's bit for bit (the check copies), timed beside K4.  T3: a
     ``ServingEngine`` over ``FLAGSHIP_BF16_FUSED`` (48 / 192, seeded
     weights) answers buckets 1 and 128: K3b and K1 once a batch, K3 never;
     loc and pi finite; mean|pi| within ``TOL_BF16_PI`` of ``FLAGSHIP``'s;
     the distance from dense ``FLAGSHIP_BF16`` with pinned noise printed.
     T4: ``FLAGSHIP_BF16_FUSED`` takes BF16_FUSED_STEPS train steps on one
     batch of BF16_FUSED_BATCH (the decoder as the YAML writes it): the
     loss falls, K3b and K4b once a step and nothing else; then the step in
     turns beside dense ``FLAGSHIP_BF16``'s with peak memory, beside the
     card's name and power limit.
  U. the chained train step (``train_torch.py --chain``; after S, on J's
     files).  U1: K1 and K2 reading the rollout keys from device memory
     equal the host-key launches bit for bit at 61,440 rows, and another
     seed's keys draw other bits.  U2: ``FLAGSHIP_H100`` at TRAIN_BATCH,
     dropout live: two graphed chains of CHAIN (update 1 runs uncaptured on
     a side stream, then the update is captured; the rest replay) against
     the uncaptured chained function from the same seeded state, every
     chain's logs, weights, moments, counts and schedule bit for bit, K1-K4
     once per update under replay; the same for a chain of 2 of each of
     ``CHAIN_BUILDS``, the second chain traced: each kernel as often in the
     profiler's trace as its counter and as the build launches it.  U3: the
     first chain against CHAIN eager steps: update 1's logs bit-equal,
     every weight outside the noise leaves (the attention key biases,
     picked by their eager gradient) within ``optim.chain_eager_bound``,
     which a leaf left unchanged and a chain of the wrong sign fail.  U4: a
     third chain with a NaN planted in update 2: one skip, the same bits in
     both paths, the schedule one behind.
     U5: ``train_torch.main --chain CHAIN`` on J's files (one train record,
     the launches, its weights within the bound of J's eager epoch, whose
     checkpoint must be there), then ``--chain 1 --ckpt``.  U6: CHAIN eager
     updates against one graphed chain in CHAIN_ROUNDS alternating rounds,
     ms per update by CUDA events and the host clock, peak memory, the idle
     share under ``torch.profiler`` (device activity only) and the
     capture's seconds, beside the card's name and power limit; in the
     profiled graphed chain, K1-K4's kernels counted by name in the trace,
     once per update and equal to the counters' replayed counts (the
     kernels line's ``chain_train``).
     U7: every other shipped build at CHAIN_BUILD_BATCH (``CHAIN_MORE_BUILDS``:
     ``FLAGSHIP_BF16``, it with the fused decoder, ``FLAGSHIP_BF16_CAPPED``,
     ``FLAGSHIP_BF16_FUSED``, ``BASELINE``, ``BASELINE_TRAIN``), U2's check:
     two graphed chains of 2 bit-equal to the uncaptured ones, K3b / K4b
     twice a chain on the fused bf16 build, K3 / K4 at 4 heads twice on the
     fused baseline, K1 / K2 twice with the fused decoder, nothing on the
     dense builds, by the counters and the second chain's trace;
     ``aa_overflow_edges`` None after each chain; each build's graphs
     released before the next, their pool printed.  U8:
     the full-width bf16 paths ``CHAIN_WIDE`` (``FLAGSHIP_BF16_FUSED`` at
     BF16_FUSED_BATCH, ``_tpu_fast.yml`` as written at TRAIN_BATCH): a
     graphed chain of CHAIN against CHAIN eager steps (update 1's logs
     bit-equal, every weight outside the key-bias entries within
     ``chain_eager_bound`` in bf16, which an unchanged trained leaf and a
     chain of the wrong sign fail), a planted NaN skipped in both paths,
     then eager against chained in CHAIN_WIDE_ROUNDS rounds as U6, with
     K3b / K4b counted by name in the profiled graphed chain's trace, equal
     to the counters, and each part's seconds.  U9: ``train_torch.main`` on
     a JSON copy of ``_tpu_fast.yml`` over J's files, a ``--chain 1`` epoch then a
     ``--chain CHAIN`` epoch from the same seed: no kernel, finite val
     metrics, the chained weights within the bf16 bar of the eager ones.
     U10: ``encoder.remat: true`` on each of CHAIN_REMAT_BUILDS
     (``FLAGSHIP_TRAIN``, ``FLAGSHIP_TRAIN_FUSED``, both baselines,
     ``FLAGSHIP_BF16``, ``FLAGSHIP_BF16_FUSED``), U2's check at
     CHAIN_BUILD_BATCH with K3 (K3b) twice an update (forward and the
     recompute's replay) and K4 (K4b) once, by the trace and the counters,
     and each graphed chain bit for bit the same build's graphed chain
     without remat; then ``FLAGSHIP_H100`` with remat at TRAIN_BATCH as U8
     (a graphed chain of CHAIN against eager within ``chain_eager_bound``,
     then CHAIN_WIDE_ROUNDS rounds in turns, the idle share, the peak, the
     graph's nodes and pool, the capture's seconds).  U11, after U10's
     graphs are freed: the adaptive ``FLAGSHIP_H100`` at TRAIN_BATCH the same
     way with chains of ADAPTIVE_CHAIN, its graphed chain also bit for bit
     its uncaptured chain; then ``encoder.adaptive: true`` on each of
     CHAIN_ADAPTIVE_BUILDS (``FLAGSHIP_TRAIN``, and ``FLAGSHIP_TRAIN_FUSED``
     with remat as well) as U10's builds.
Phases 4, B, C and 7 check that K4 never launches on their paths, and the
serving and training phases that K5 and K6 never do.
The last lines are the card, a JSON object per kernel and the device line.
"""
from __future__ import annotations

import concurrent.futures
import copy
import ctypes
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from trajsde_tpu_torch import ops
from trajsde_tpu_torch.config import (BASELINE, BASELINE_TRAIN, FLAGSHIP, FLAGSHIP_BF16,
                                      FLAGSHIP_BF16_CAPPED, FLAGSHIP_BF16_FUSED,
                                      FLAGSHIP_CAPPED, FLAGSHIP_FUSED,
                                      FLAGSHIP_H100, FLAGSHIP_TRAIN, FLAGSHIP_TRAIN_FUSED,
                                      build_datamodule, build_dtype, build_losses, build_metrics,
                                      build_model)
from trajsde_tpu_torch.data.pack import pack_scenes, pick_bucket
from trajsde_tpu_torch.data.preprocess import argoverse as argo_pre
from trajsde_tpu_torch.data.shards import convert_npz_dir
from trajsde_tpu_torch.data.synthetic import make_raw_scene
from trajsde_tpu_torch.models import graph
from trajsde_tpu_torch.models.sde import ADAPTIVE_DEPTH
from trajsde_tpu_torch.ops import aa_attention as K5
from trajsde_tpu_torch.ops import aa_fused as K3
from trajsde_tpu_torch.ops import build as kernel_build
from trajsde_tpu_torch.ops import sde_rollout as K1
from trajsde_tpu_torch.ops import vpu_probe as K6
from trajsde_tpu_torch.ops.brownian import BrownianTree
from trajsde_tpu_torch.ops.sdeint import ou_moments, sdeint_adaptive
from trajsde_tpu_torch.parallel import mesh
from trajsde_tpu_torch.deploy import export_serving, load_serving
from trajsde_tpu_torch.server import ServingEngine, align_scene, make_postprocess
from trajsde_tpu_torch.serving import make_scan_fn, make_serving_fn
from trajsde_tpu_torch.train.checkpoint import CheckpointManager, save_weights
from trajsde_tpu_torch.train.loop import (ChainedStep, Trainer, create_train_state,
                                          make_train_step, micro_seeds)
from trajsde_tpu_torch.train.optim import (NOISE_GRAD, chain_eager_bound, chain_eager_gap,
                                           grad_split, largest_gap, noise_entries)
from trajsde_tpu_torch.utils.convert import to_reference

NUM_ACTORS, NUM_LANES = 48, 192
BATCHES = (1, 5, 128)
SPLICE_BATCH = 8
SEED = 0
# kernel vs plain, 60 f32 steps: tanhf, FMA contraction and cuBLAS
# summation order differ from the plain version
TOL_KERNEL = 1e-4
# K1 vs plain, max |kernel - plain| / max |plain|, tighter, so that a build
# with the tensor-core products at TF32 precision fails: on an H100 K1 (its
# five products in 3xTF32) reads 4.2e-7 to 5.8e-7 over this phase's nine
# cases, the FMA build of K1 3.1e-7 to 5.5e-7, and a copy with one TF32
# product per term 6.9e-4 to 1.2e-3 (scripts/compare_rollout_fwd_builds_torch.py)
TOL_K1_TIGHT = 1e-5
# served path vs model forward (loc / pi), same pinned noise, full width;
# also the fused encoder's served answer and forward_ood vs the dense ones
TOL_SPLICE = 1e-3
# K3 vs plain, max |kernel - plain| / max |plain|: the same chain with its
# products in 3xTF32 on the tensor cores, w1 folded, another summation
# order and an online softmax
TOL_K3 = 1e-4
# and tighter, so that a build with the tensor-core products at TF32
# precision fails: on an H100 K3 (3xTF32) reads 3.4e-7 to 5.7e-7 over this
# phase's cases, and at bucket 128 the FMA build of K3 5.0e-7 to 5.4e-7 and
# a copy with one TF32 product per term 4.0e-4 to 5.6e-4
# (scripts/compare_aa_fwd_builds_torch.py)
TOL_K3_TIGHT = 1e-5
K3_DROPOUT = 0.1
# K2 vs plain, max |kernel - plain| / max |plain| per output: dy0 is a
# 60-step chain per row; each weight gradient sums 61,440 x 60 row-steps in
# another order (the kernel per block and tile, the plain version by cuBLAS)
TOL_K2_DY0, TOL_K2_W = 1e-4, 1e-3
# and tighter on every output (no K2 output sits behind a ReLU), so that a
# build with the tensor-core products at TF32 precision fails: on an H100 at
# the training shape K2 (its products on the f64 tensor cores) reads up to
# 6.8e-7, its 3xTF32 build 1.4e-6, the FMA build of K2 4.3e-6, and a copy
# with each operand rounded to TF32 1.8e-4 to 6.6e-4 on every output
# (scripts/compare_rollout_bwd_builds_torch.py)
TOL_K2_TIGHT = 2e-5


def k2_tol(leaf: str) -> float:
    """K2's limit on one output (``dy0`` or a name of ``PARAM_ORDER``)."""
    return min(TOL_K2_DY0 if leaf == "dy0" else TOL_K2_W, TOL_K2_TIGHT)


# K4 vs plain, max |kernel - plain| / max |plain|, as K2: dq sums each
# receiver's senders in another order; each weight gradient sums 6.3 M
# pairs in another order (per block and chunk, then over blocks)
TOL_K4_DQ, TOL_K4_W = 1e-4, 1e-3
# and tighter on the leaves that no ReLU's derivative reaches, so that a
# build with the tensor-core products at TF32 precision fails: on an H100
# at the training shape K4 (3xTF32) reads up to 2.8e-6 on them, the FMA
# build of K4 3.2e-6, and a copy with one TF32 product per term 8.5e-5 to
# 3.1e-4 on wagg, bagg, lna1s, lna1b and wkv
# (scripts/compare_aa_bwd_builds_torch.py)
TOL_K4_SMOOTH = 2e-5
K4_SMOOTH_LEAVES = ("dq", "wagg", "bagg", "lna1s", "lna1b", "wkv", "bkv")


def k4_tol(leaf: str) -> float:
    """K4's limit on one output (``dq`` or a name of ``W_ORDER``)."""
    loose = TOL_K4_DQ if leaf == "dq" else TOL_K4_W
    return min(loose, TOL_K4_SMOOTH) if leaf in K4_SMOOTH_LEAVES else loose


# K5 vs plain and vs K3 (fed q = centre . wq + bq and the same u):
# TOL_K3_TIGHT, K3's chain and products; the kernel's q is its own FMA
# product, not cuBLAS's, and a copy of K5 with one TF32 product per term
# must fail it
# K6 vs plain: per element, by vpu_probe.agreement (in ulps within
# TOL_ULPS, and a least share of bit-equal elements; its comment gives the
# reasons)
K5_SHAPES = {"test": (2, 5, 9, 8), "ragged": (3, 7, 13, 11), "twin": (128, 21, 49, 48)}
# and at the HiVT baseline's 4 heads in place of the twin shape
K5_BASELINE_SHAPE = (128, 21, 48, 48)
# fused train step (K1 + K2) vs autograd through the plain loop, full width:
# loss relative; each gradient leaf max |diff| <= TOL * max |grad| + ATOL (the
# atol covers leaves whose exact gradient is 0, such as the key biases under
# the shift-invariant softmax)
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD, ATOL_TRAIN_GRAD = 1e-5, 1e-3, 1e-6
TRAIN_BATCHES, VAL_BATCHES, REPEAT_STEPS = 3, 2, 8
# phase I: batches of TRAIN_BATCH scenes written per format, and pack timings
FILE_BATCHES, PACK_RUNS = 4, 5
# phase J: nuScenes validation / test scenes (two eval batches: 128 and 32)
CLI_VAL_SCENES = 160
TRAIN_SPLICE_BATCH = 8
# phase K: scenes of each predict (4 batches of 128), timed rounds (the two
# modes alternate), scenes submitted and the threads that submit them,
# single requests, HTTP requests, and how long a future may take
ENGINE_SCENES, ENGINE_ROUNDS = 512, 4
SUBMITTED, SUBMIT_THREADS, SINGLES, HTTP_POSTS = 256, 16, 20, 8
FUTURE_TIMEOUT_S = 300
# pipelined vs serial predict, max |pipelined - serial| / max |serial| per
# scene and field: the same kernels on the same inputs and draws, so 0 is
# expected
TOL_PIPELINE = 1e-5
# the flagship YAML's datamodule train_batch_size (it fits the card in f32)
TRAIN_BATCH = 128
# phase L: train steps a baseline path takes, scenes of its engine's
# predict, single submitted scenes
BASELINE_STEPS, BASELINE_SCENES, BASELINE_SINGLES = 3, 512, 20
# phase M: the _tpu_fast recipe's cap, M1(a)'s limit on max|capped - dense| /
# max|dense| (the same chain over the gathered senders, summed in another
# order, then 60 rollout steps), the rounds of M1's turns, M2's micro-batch
# and the rounds of its save timing
CAP = 24
TOL_CAPPED = 1e-5
CAPPED_ROUNDS, ACCUM_BATCH, SAVE_ROUNDS = 2, 64, 3
# phase N: bf16 mean|pi| against the f32 model's on the same weights and
# scenes, relative (the JAX package's own statistic for its bf16 model,
# tests/test_models_forward.py), the train steps each bf16 path takes, and
# the rounds of its turns against f32
TOL_BF16_PI = 0.15
BF16_STEPS, BF16_ROUNDS = 3, 3
# phase O: the tree's rows (bucket 128 x 49 twin-forward rows) and its
# limits (f32 bridge arithmetic, the CUDA cores' FMA against the CPU's);
# the encoder on the card vs the CPU, max|diff| / max|CPU| (21 segments of
# step doubling and K3 against its plain version); the scenes of that
# comparison and the train steps (its turns take BF16_ROUNDS rounds)
ADAPTIVE_ROWS = 128 * 49
TOL_TREE = 1e-6
TOL_ADAPTIVE_CPU = 1e-4
ADAPTIVE_SCENES, ADAPTIVE_STEPS = 4, 3
# phase P: the builds that train with encoder.remat: true (each against its
# plain build on the same weights), and the train steps of each before its
# turns (BF16_ROUNDS rounds)
REMAT_BUILDS = {"flagship": FLAGSHIP_TRAIN, "flagship fused": FLAGSHIP_TRAIN_FUSED,
                "baseline fused": BASELINE_TRAIN, "baseline": BASELINE}
REMAT_STEPS = 2
# phase Q: Q2's global batch (half a rank), its AdamW updates, the timed
# ZeRO-1 steps after them, the rounds of Q1's turns, and how long a rank or
# a collective may take before the phase fails
MULTI_BATCH, MULTI_STEPS, MULTI_TIMED, MULTI_ROUNDS = 128, 3, 6, 3
# phase R: the artifact's buckets, the rounds of exported vs live timing
EXPORT_BUCKETS, EXPORT_ROUNDS = (1, 128), 4
# phase S: the Argoverse test scenes that the port's preprocessor writes,
# (actors, straight lanes) each; a lane 200 m long makes 19 segments, so the
# first scene is above the actor capacity and the second above the lane
# capacity; and the keys planted in the reference checkpoint that no rule reads
PREPROCESSED_SCENES = ((60, 6), (24, 12), (9, 3))
PLANTED_UNKNOWN = ("metric.ADE_T.total", "aggregator.some_new_buffer")
RANK_TIMEOUT_S = 240
# phase T: bf16 inside the fused AA kernels.  K3b vs its plain version (the
# same bf16 chain in f32 sums; tests/test_torch_aa_fused_bf16.py holds the
# plain one to JAX), max|kernel - plain| / max|plain| and mean|kernel -
# plain| / mean|plain| over the output: the kernel sums each product and
# LayerNorm in another order, so now and then a value lands on the other
# side of a bf16 tie and one a0, a1 or nbr element moves one bf16 step
# (2^-8 of it), which the max sees and the mean hardly does.  On an H100
# K3b read 9.7e-4 to 2.1e-3 (max) and 5.2e-6 to 8.9e-6 (mean) at bucket 128,
# K3 (f32) on the same inputs 4.9e-3 to 7.3e-3 and 2.7e-3 to 3.0e-3: K3
# must fail the bar, which holds the kernel to the bf16 arithmetic
TOL_K3B = (5e-3, 1e-4)
# K4b vs its plain version (autograd through the plain bf16 chain), per
# output, max and mean as TOL_K3B: such a step also moves a pre-ReLU value
# across 0 now and then, so the leaves behind a ReLU read up to 6.3e-4 in
# the mean on an H100 at batch 64 (dq and the others up to 6.3e-5), and
# the max up to 2.5e-3 (dq); K4 (f32) must fail it on some output
TOL_K4B = (1e-2, 2e-3)
# T4's batch (the _tpu.yml recipe's memory-bound regime) and steps on it
BF16_FUSED_BATCH, BF16_FUSED_STEPS = 64, 4
# phase U: the chained train step (train_torch.py --chain): its chain length
# (U2-U6), the builds beside FLAGSHIP_H100 whose graphed chain of 2 is held
# to the uncaptured one and their batch (two copies of a build, each
# with a graph, must fit beside nothing else: dense at 128 peaks at 30 GiB a
# step), and the rounds of U6's turns
CHAIN, CHAIN_ROUNDS = 4, 3
CHAIN_BUILD_BATCH = 32
CHAIN_BUILDS = {"FLAGSHIP_TRAIN": FLAGSHIP_TRAIN, "FLAGSHIP_FUSED": FLAGSHIP_FUSED,
                "FLAGSHIP": FLAGSHIP}
# U7: every other shipped build as written, and _tpu.yml with the fused
# decoder (phase N2's build, K1 / K2 in a bf16 model), bits only at
# CHAIN_BUILD_BATCH
FLAGSHIP_BF16_TRAIN = copy.deepcopy(FLAGSHIP_BF16)
FLAGSHIP_BF16_TRAIN["decoder"]["kwargs"]["fused"] = True
CHAIN_MORE_BUILDS = {"FLAGSHIP_BF16": FLAGSHIP_BF16, "FLAGSHIP_BF16_TRAIN": FLAGSHIP_BF16_TRAIN,
                     "FLAGSHIP_BF16_CAPPED": FLAGSHIP_BF16_CAPPED,
                     "FLAGSHIP_BF16_FUSED": FLAGSHIP_BF16_FUSED, "BASELINE": BASELINE,
                     "BASELINE_TRAIN": BASELINE_TRAIN}
# U8: the full-width bf16 paths, (build, batch): the fused fallback at the
# _tpu.yml recipe's memory-tight batch, _tpu_fast.yml as written at its own;
# the rounds of their turns
CHAIN_WIDE = {"FLAGSHIP_BF16_FUSED": (FLAGSHIP_BF16_FUSED, BF16_FUSED_BATCH),
              "FLAGSHIP_BF16_CAPPED": (FLAGSHIP_BF16_CAPPED, TRAIN_BATCH)}
CHAIN_WIDE_ROUNDS = 2
# U10: the builds that chain with encoder.remat: true at CHAIN_BUILD_BATCH,
# each held to its uncaptured chain and to the same build's graphed chain
# without remat (phase P's four and the two bf16 AA paths); then
# FLAGSHIP_H100 with remat at TRAIN_BATCH (a chain of CHAIN in
# CHAIN_WIDE_ROUNDS rounds).  U11: FLAGSHIP_H100 adaptive at TRAIN_BATCH,
# against its uncaptured chain too, chains of ADAPTIVE_CHAIN (an eager
# adaptive update launches about 64,000 kernels on the host, 2 s); then
# the other builds that chain with encoder.adaptive: true at
# CHAIN_BUILD_BATCH, one with remat as well
CHAIN_REMAT_BUILDS = {"FLAGSHIP_TRAIN": FLAGSHIP_TRAIN,
                      "FLAGSHIP_TRAIN_FUSED": FLAGSHIP_TRAIN_FUSED, "BASELINE": BASELINE,
                      "BASELINE_TRAIN": BASELINE_TRAIN, "FLAGSHIP_BF16": FLAGSHIP_BF16,
                      "FLAGSHIP_BF16_FUSED": FLAGSHIP_BF16_FUSED}
CHAIN_ADAPTIVE_BUILDS = {"FLAGSHIP_TRAIN": FLAGSHIP_TRAIN,
                         "FLAGSHIP_TRAIN_FUSED+remat": FLAGSHIP_TRAIN_FUSED}
ADAPTIVE_CHAIN = 2


# H100 SXM published peaks (dense): f32 on CUDA cores, TF32, bf16 and f64
# on the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_F64_TC_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# the special-function units of an H100 SXM: 16 results a clock per SM for
# sm_90 (CUDA C++ Programming Guide, "Arithmetic Instructions": reciprocal,
# exponential, sine, ...; one MUFU instruction each) x 132 SMs x 1.98 GHz
PEAK_SFU_PER_S = 132 * 16 * 1.98e9
# K6's MUFU instructions per value and round in each variant, read from
# cuobjdump -sass of the built library (scripts/vpu_probe_sass_torch.py,
# which phase H runs and holds to these counts): tanhf takes MUFU.EX2 and
# MUFU.RCP, tanh.approx.f32 one MUFU.TANH, and tanh.approx.bf16x2 one
# MUFU.TANH.BF16 for each of its two halves
K6_MUFU = {"float32": 2, "float32-approx": 1, "bfloat16": 1}
TIMED_RUNS, WARMUP = 20, 3


# the two small terms of each k-step in mma_tf32.cuh's mma3x2 and mma3x2_apart
SMALL_TERMS = ("  mma(c, as0, bb0);\n", "  mma(c, ab0, bs0);\n", "  mma(c, as1, bb1);\n",
               "  mma(c, ab1, bs1);\n")


def one_term_header(header: str) -> str:
    """``mma_tf32.cuh`` with one TF32 product (big * big) per k-step."""
    for term in SMALL_TERMS:
        if header.count(term) != 2:
            raise RuntimeError(f"{term!r} is not in mma_tf32.cuh's two product sums")
        header = header.replace(term, "")
    return header


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, runs: int = TIMED_RUNS, warmup: int = WARMUP) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()`` after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device: chip_smoke.py needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)
    return card


KERNELS = ("sde_rollout", "sde_rollout_bwd", "aa_fused", "aa_fused_bwd", "aa_attention",
           "vpu_probe")


def phase_build() -> dict:
    """Builds every kernel and, at the same time, the check copies
    (:func:`build_check_copies`), one nvcc per source; returns the copies."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        copies = pool.submit(build_check_copies)
        kernel_build.load_all(KERNELS)
        checks = copies.result()
    print(f"[build] {', '.join(KERNELS)} and the check copies {', '.join(checks)} ready in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in KERNELS:
        for line in kernel_build.build_log.get(name, "").splitlines():
            if ("registers" in line or "spill" in line or line.startswith("built")
                    or "Compiling entry" in line):
                print(f"[build]   {name}: {line.strip()}")
    return checks


def rollout_bound(rows: int, steps: int, dim: int, explicit_noise: bool):
    """(bound_ms, bound_by, flops, bytes, route_ms, route_by) of one K1 call:
    5 products of 2*dim^2 plus the 2*dim diffusion output per row-step; y0,
    the weights, the time table (and explicit noise) read once, ys written
    once.  ``bound_ms`` takes every operation at the f32 CUDA-core peak;
    ``route_ms`` is the bound on the route K1 takes: the five products
    (``10 dim^2`` a row-step) on the tensor cores at f32 accuracy, three
    TF32 products each (``PEAK_TF32_FLOPS / 3``), and the rest on the CUDA
    cores at their peak, the two pipes running at the same time;
    ``route_by`` says which of the route's operations and the bytes bounds
    it."""
    flops = rows * steps * (5 * 2 * dim * dim + 2 * dim)
    weights = 5 * dim * dim + 10 * dim + 4
    nbytes = 4 * (rows * dim + weights + 4 * steps + steps * rows * dim)
    if explicit_noise:
        nbytes += 4 * steps * rows * dim
    return _route_bounds(flops, rows * steps * 10 * dim * dim, nbytes)


def _increments(mode: str, noise: torch.Tensor) -> dict:
    return dict(noise=noise, increments="gaussian") if mode == "explicit" else dict(increments=mode)


def phase_kernels(model, buckets) -> dict:
    """The rollout kernel vs its plain version at the row count of every
    bucket the served batches land in, within ``TOL_KERNEL`` and
    ``TOL_K1_TIGHT``; timed at each."""
    dec = model.decoder
    T, D = dec.future_steps, dec.local_channels
    shapes = sorted({pick_bucket(n, buckets) * dec.num_modes * NUM_ACTORS for n in BATCHES})
    rows = shapes[-1]
    kp = {k: v.contiguous() for k, v in K1.rollout_params_from_module(dec.sde_rollout).items()}
    t0s, dts = dec.time_grid(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    y0 = torch.relu(torch.randn((rows, D), generator=gen, device="cuda"))
    noise = torch.randn((T, rows, D), generator=gen, device="cuda")

    errs = []
    for n in shapes:
        y0_n, noise_n = y0[:n].contiguous(), noise[:, :n].contiguous()
        for mode in ("explicit", "rademacher", "gaussian"):
            kw = _increments(mode, noise_n)
            got = K1.sde_rollout(y0_n, kp, t0s, dts, 11, T, **kw)
            torch.cuda.synchronize()
            want = K1.sde_rollout_reference(y0_n, kp, t0s, dts, 11, T, **kw)
            check(bool(torch.isfinite(got).all()), f"sde_rollout ({mode}) produced non-finite values")
            errs.append((got - want).abs().max().item())
            rel = errs[-1] / want.abs().max().item()
            print(f"[kernels] sde_rollout {mode}: max |kernel - plain| = {errs[-1]:.3e} "
                  f"(tol {TOL_KERNEL:g}), / max |plain| = {rel:.3e} (tol {TOL_K1_TIGHT:g}) "
                  f"over [{T}, {n}, {D}]", flush=True)
            check(errs[-1] < TOL_KERNEL, f"sde_rollout ({mode}) disagrees with its plain version")
            check(rel <= TOL_K1_TIGHT, f"sde_rollout ({mode}): {rel:.3e} > TOL_K1_TIGHT "
                  f"{TOL_K1_TIGHT:g}")
            del got, want

    times = {}
    for n in shapes:
        y0_n, noise_n = y0[:n].contiguous(), noise[:, :n].contiguous()
        times[n] = {}
        for mode in ("rademacher", "gaussian", "explicit"):
            kw = _increments(mode, noise_n)
            times[n][mode] = cuda_ms(lambda: K1.sde_rollout(y0_n, kp, t0s, dts, 11, T, **kw))
            bound, by, flops, nbytes, route, route_by = rollout_bound(n, T, D, mode == "explicit")
            print(f"[kernels] sde_rollout {mode} at {n} rows: {times[n][mode]:.3f} ms (median of "
                  f"{TIMED_RUNS}), bound {route:.3f} ms by {route_by} on its route (3xTF32 "
                  f"products on the tensor cores) and {bound:.3f} ms by {by} on the CUDA cores "
                  f"({flops:.3e} flop, {nbytes:.3e} B), "
                  f"{flops / times[n][mode] / 1e9:.1f} TFLOP/s", flush=True)
        del y0_n, noise_n
    plain_ms = cuda_ms(lambda: K1.sde_rollout_reference(y0, kp, t0s, dts, 11, T,
                                                        increments="rademacher"), warmup=1)
    print(f"[kernels] sde_rollout plain version (rademacher): {plain_ms:.3f} ms", flush=True)
    bound, by, _, _, route, route_by = rollout_bound(rows, T, D, False)
    # the main path draws Rademacher increments in the kernel: its numbers;
    # bound_ms is the route's, cuda_core_bound_ms every operation on the CUDA cores
    return dict(name="sde_rollout", route="cuda", source="trajsde_tpu_torch/csrc/sde_rollout.cu",
                replaces="trajsde_tpu/ops/pallas/sde_rollout.py:452", launches=None,
                max_abs_err=max(errs), ms=times[rows]["rademacher"], plain_ms=plain_ms,
                bound_ms=route, bound_by=route_by, cuda_core_bound_ms=bound,
                cuda_core_bound_by=by, ms_by_rows=times, library_ms=None)


def _requests(rng):
    return {n: [make_raw_scene(rng, i % 2, num_actors=NUM_ACTORS, num_lanes=NUM_LANES)
                for i in range(n)] for n in BATCHES}


def _check_results(results, n, model):
    K, Tf = model.decoder.num_modes, model.decoder.future_steps
    check(len(results) == n, f"{len(results)} results for {n} scenes")
    for r in results:
        check(r["agent_world"].shape == (K, Tf, 2), f"agent_world {r['agent_world'].shape}")
        check(r["agent_pi"].shape == (K,), f"agent_pi {r['agent_pi'].shape}")
        check(r["loc"].shape == (K, NUM_ACTORS, Tf, 2), f"loc {r['loc'].shape}")
        check(r["pi"].shape == (NUM_ACTORS, K), f"pi {r['pi'].shape}")
        for k in ("agent_world", "agent_pi", "loc", "pi"):
            check(bool(np.isfinite(r[k]).all()), f"non-finite {k}")
        check(abs(float(r["agent_pi"].sum()) - 1.0) < 1e-5, "agent_pi does not sum to 1")


def zero_counts() -> None:
    """Every kernel's launch count to 0 (just before a path is driven)."""
    ops.zero_counts()


def phase_serve(engine, model, tag: str = "serve"):
    """Serve batches of 1, 5 and 128 through ``engine``; K1 launches once
    per batch, and K3 too when the model's AA encoder is fused (else
    never); K2 and K4 never.  Returns (K1 launches, K3 launches, K4
    launches, {batch: second-call ms})."""
    fused = model.encoder.aa_encoder.fused
    rng = np.random.default_rng(SEED)
    requests = _requests(rng)
    torch.cuda.reset_peak_memory_stats()
    engine.predict(requests[1])  # warm-up: CUDA context, cuBLAS handles, allocator

    zero_counts()
    ms = {}
    for n in BATCHES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.predict(requests[n])
        ms[n] = 1e3 * (time.perf_counter() - t0)
        _check_results(results, n, model)
    launches, k3 = K1.sde_rollout.launches, K3.fused_pair_attention.launches
    print(f"[{tag}] launches on the main path for {len(BATCHES)} batches: sde_rollout {launches}, "
          f"aa_fused {k3}", flush=True)
    check(launches == len(BATCHES), "the rollout kernel did not run once per served batch")
    check(k3 == (len(BATCHES) if fused else 0),
          "the fused AA kernel did not run once per served batch" if fused
          else "the dense encoder launched the fused AA kernel")
    k4 = K3.fused_pair_attention_bwd.launches
    check(K1.sde_rollout_bwd.launches == 0 and k4 == 0, "serving launched a backward kernel")
    check(K5.aa_attention.launches == 0 and K6.chained_tanh.launches == 0,
          "serving launched K5 or K6")

    warm = {}
    for n in BATCHES:  # second pass: allocator and kernels warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict(requests[n])
        warm[n] = 1e3 * (time.perf_counter() - t0)
        print(f"[{tag}] batch {n:3d} (bucket {pick_bucket(n, engine.buckets)}): first {ms[n]:.1f} "
              f"ms, again {warm[n]:.1f} ms, {n / warm[n] * 1e3:.1f} scenes/s", flush=True)
    print(f"[{tag}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    return launches, k3, k4, warm


def _splice_inputs(model):
    """A bucket-8 scene on the card and pinned encoder, twin and decoder
    noise (the decoder's laid out as the served rollout's rows)."""
    rng = np.random.default_rng(SEED + 1)
    raws = [make_raw_scene(rng, i % 2, num_actors=NUM_ACTORS, num_lanes=NUM_LANES)
            for i in range(SPLICE_BATCH)]
    scene = pack_scenes([align_scene(r)[0] for r in raws], NUM_ACTORS, NUM_LANES).to("cuda")
    enc, dec = model.encoder, model.decoder
    B, A, Th, D = SPLICE_BATCH, NUM_ACTORS, enc.historical_steps, enc.embed_dim
    Tf, Km = dec.future_steps, dec.num_modes
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    enc_noise = torch.randn((Th, B, A + 1, D), generator=gen, device="cuda")
    twin_noise = torch.randn((B, 1, Th, 2), generator=gen, device="cuda")
    dec_noise = torch.randn((Tf, B, Km, A, D), generator=gen, device="cuda")
    return scene, enc_noise, twin_noise, dec_noise, dec_noise.reshape(Tf, B * Km * A, D)


def _check_splice(tag: str, served, plain, what: str) -> None:
    for k in ("loc", "pi"):
        err = (served[k] - plain[k]).abs().max().item()
        print(f"[{tag}] {k}: max |served - {what}| = {err:.3e} (tol {TOL_SPLICE:g}) "
              f"over {tuple(plain[k].shape)}", flush=True)
        check(bool(torch.isfinite(served[k]).all()), f"served {k} is not finite")
        check(err < TOL_SPLICE, f"served {k} disagrees with the {what}")


@torch.inference_mode()
def phase_splice(model) -> None:
    scene, enc_noise, twin_noise, dec_noise, rows = _splice_inputs(model)
    served = make_serving_fn(model, "cuda")(scene, 0, noise=rows, sde_noise=enc_noise,
                                            twin_noise=twin_noise)
    plain = model(scene, enc_noise=enc_noise, twin_noise=twin_noise, dec_noise=dec_noise)
    _check_splice("splice", served, plain, "forward")


def aa_pair_ops(dim: int, heads: int):
    """(matmul, elementwise) operations of the AA pair chain per pair, the
    work the function needs (the packed layout's zero blocks not counted):
    the two Linear(2 -> D) first layers (2 x 2 x 2 D), the two
    Linear(D -> D) second layers (2 x 2 D^2), ``wagg`` (2 D^2), ``[k|v]``
    (4 D^2), the head logits and the weighted sum (2 D each); LayerNorms
    over 4 D values at 7 operations each, ReLUs over 3 D, the softmax at 5
    per head."""
    d = dim
    matmul = 2 * 2 * 2 * d + 2 * 2 * d * d + 2 * d * d + 4 * d * d + 2 * d + 2 * d
    return matmul, 7 * 4 * d + 3 * d + 5 * heads


def aa_weight_floats(dim: int) -> int:
    """Floats of the 14 packed pair-chain weights (``pack_aa_params``)."""
    d = dim
    return 4 * 2 * d + 2 * d + 2 * (2 * d) + 4 * d * d + 2 * d + 2 * d + d * d + d + 2 * d \
        + 2 * d * d + 2 * d


def _route_bounds(flops: float, tc_flops: float, nbytes: float,
                  tc_rate: float = PEAK_TF32_FLOPS / 3):
    """(bound_ms, bound_by, flops, bytes, route_ms, route_by): every operation
    at the f32 CUDA-core peak, or the bytes at the memory rate, whichever is
    longer; and on a kernel's route, ``tc_flops`` of its operations on the
    tensor cores at ``tc_rate`` (by default f32 accuracy in three TF32
    products each, ``PEAK_TF32_FLOPS / 3``) and the rest on the CUDA cores
    at their peak, the two pipes running at the same time."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    t_route = max(tc_flops / tc_rate, (flops - tc_flops) / PEAK_F32_FLOPS)
    return (1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops,
            nbytes, 1e3 * max(t_route, t_bytes), ("operations" if t_route >= t_bytes else "bytes"))


def aa_fused_bound(B: int, T: int, Aq: int, Ak: int, dim: int, heads: int, with_keep: bool,
                   bf16: bool = False):
    """(bound_ms, bound_by, flops, bytes, route_ms, route_by) of one K3 call:
    :func:`aa_pair_ops` per pair; q, u, the f32 mask (and the keep mask), the
    weights read once, the aggregate written once.  ``bound_ms`` takes every
    operation at the f32 CUDA-core peak; ``route_ms`` is the bound on the
    route K3 takes: its three chain products (``10 dim^2`` a pair: ``a0``
    times the folded ``w1`` 4 dim^2, ``wagg`` 2 dim^2, ``[k|v]`` 4 dim^2) on
    the tensor cores at f32 accuracy, three TF32 products each
    (``PEAK_TF32_FLOPS / 3``), and the rest on the CUDA cores at their peak,
    the two pipes running at the same time; ``route_by`` says which of the
    route's operations and the bytes bounds it.  ``bf16``: K3b's route, the
    products at the bf16 tensor-core rate (``PEAK_BF16_FLOPS``)."""
    pairs, rows = B * T * Aq * Ak, B * T * Aq
    flops = pairs * sum(aa_pair_ops(dim, heads))
    nbytes = 4 * (rows * dim + pairs * 4 + pairs + aa_weight_floats(dim) + rows * dim)
    if with_keep:
        nbytes += 4 * pairs * heads
    return _route_bounds(flops, pairs * 10 * dim * dim, nbytes,
                         PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS / 3)


def aa_fused_bwd_bound(B: int, T: int, Aq: int, Ak: int, dim: int, heads: int, with_keep: bool,
                       bf16: bool = False):
    """(bound_ms, bound_by, flops, bytes, route_ms, route_by) of one K4 call: per pair
    the chain recomputed, then its input and its weight gradients, three
    times :func:`aa_pair_ops`; K3's inputs (with the keep mask) and the
    cotangent read once, dq and the weight gradients written once.
    ``bound_ms`` takes every operation at the f32 CUDA-core peak;
    ``route_ms`` is the bound on the route K4 takes: the recompute's three
    products (K3's, ``10 dim^2`` a pair) and the six backward products
    (``20 dim^2``: the input and weight gradients of ``[k|v]`` 4 dim^2
    each, of ``wagg`` 2 dim^2, of the two second layers 4 dim^2) on the
    tensor cores at f32 accuracy, three TF32 products each
    (``PEAK_TF32_FLOPS / 3``), and the rest on the CUDA cores at their
    peak, the two pipes running at the same time; ``route_by`` says which
    of the route's operations and the bytes bounds it.  ``bf16``: K4b's
    route, the recompute's products (``10 dim^2``) at the bf16 tensor-core
    rate and the six backward products (``20 dim^2``, an f32 cotangent
    against a bf16 operand) at half the TF32 rate, two TF32 products each."""
    pairs, rows = B * T * Aq * Ak, B * T * Aq
    flops = pairs * 3 * sum(aa_pair_ops(dim, heads))
    w = aa_weight_floats(dim)
    nbytes = 4 * (rows * dim + pairs * 4 + pairs + w + rows * dim   # q, u, mask, weights, g
                  + rows * dim + w)                                   # dq, weight gradients
    if with_keep:
        nbytes += 4 * pairs * heads
    if bf16:  # one rate for the 30 dim^2: the time of both kinds of product over their flops
        rate = 30 / (10 / PEAK_BF16_FLOPS + 20 / (PEAK_TF32_FLOPS / 2))
        return _route_bounds(flops, pairs * 30 * dim * dim, nbytes, rate)
    return _route_bounds(flops, pairs * 30 * dim * dim, nbytes)


def _random_aa_weights(gen, like):
    """Random pair-chain weights shaped as ``like``: matrices N(0, 1/fan_in),
    LayerNorm scales 1 + N(0, 0.04), other vectors N(0, 0.04); the w1 blocks
    off the diagonal are not zero, as they are in the model's layout."""
    out = []
    for name, w in zip(K3.W_ORDER, like):
        x = torch.randn(w.shape, generator=gen, device=w.device)
        if name.startswith("w"):
            x = x / w.shape[0] ** 0.5
        else:
            x = 0.2 * x + (1.0 if name.endswith("s") else 0.0)
        out.append(x.contiguous())
    return tuple(out)


def _k3_inputs(shape, with_keep: bool, gen, heads: int = K3.KERNEL_HEADS):
    """q, u, the 0/1 mask (every 7th receiver without a sender) and the
    keep mask [.., heads] or None at ``shape`` = (B, T, Aq, Ak)."""
    B, T, Aq, Ak = shape
    D, H = K3.KERNEL_DIM, heads
    q = torch.randn((B, T, Aq, D), generator=gen, device="cuda")
    u = 5.0 * torch.randn((B, T, Aq, Ak, 4), generator=gen, device="cuda")
    mask = (torch.rand((B, T, Aq, Ak), generator=gen, device="cuda") < 0.6).float()
    mask[:, :, ::7] = 0.0
    keep = None
    if with_keep:
        keep = (torch.rand((B, T, Aq, Ak, H), generator=gen, device="cuda") >= K3_DROPOUT).float()
    return q, u, mask, keep


@torch.inference_mode()
def phase_fused_kernel(model) -> dict:
    """K3 vs its plain version at the shapes the fused encoder gives it:
    the twin forward at buckets 128 and 1 (Aq = A + 1) and forward_ood
    (Aq = Ak = A); bit-equal reruns; timed at bucket 128 and the OOD shape."""
    Th, A = model.encoder.historical_steps, NUM_ACTORS
    D, H = K3.KERNEL_DIM, K3.KERNEL_HEADS
    shapes = {"bucket 128": (128, Th, A + 1, A), "bucket 1": (1, Th, A + 1, A),
              "ood": (128, Th, A, A)}
    model_ws = tuple(w.contiguous() for w in
                     K3.weights_of(K3.pack_aa_params(model.encoder.aa_encoder)))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    weights = {"model": model_ws, "random": _random_aa_weights(gen, model_ws)}
    max_abs = 0.0
    for name, shape in shapes.items():
        for wname, ws in weights.items():
            for with_keep in (False, True):
                q, u, mask, keep = _k3_inputs(shape, with_keep, gen)
                p = K3_DROPOUT if with_keep else 0.0
                got = K3.fused_pair_attention(q, u, mask, keep, ws, H, p)
                again = K3.fused_pair_attention(q, u, mask, keep, ws, H, p)
                torch.cuda.synchronize()
                kept = f"p={p:g}" if with_keep else "None"
                case = f"{name} {list(shape)}, {wname} weights, keep {kept}"
                check(bool(torch.isfinite(got).all()), f"aa_fused ({case}) is not finite")
                check(torch.equal(got, again), f"aa_fused ({case}) is not bit-equal across two runs")
                check(bool((got[:, :, ::7] == 0).all()), f"aa_fused ({case}): an empty receiver "
                      "did not give exactly 0")
                want = K3.fused_pair_attention_reference(q, u, mask, keep, ws, H, p)
                diff = (got - want).abs().max().item()
                rel = diff / want.abs().max().item()
                max_abs = max(max_abs, diff)
                print(f"[fused-kernel] aa_fused {case}: bit-equal reruns, max|kernel - plain| "
                      f"{diff:.3e} = {rel:.3e} of max|plain| (tol {TOL_K3:g}, tight "
                      f"{TOL_K3_TIGHT:g})", flush=True)
                check(rel <= TOL_K3, f"aa_fused ({case}) disagrees with its plain version")
                check(rel <= TOL_K3_TIGHT, f"aa_fused ({case}): {rel:.3e} > TOL_K3_TIGHT "
                      f"{TOL_K3_TIGHT:g}")
                del got, again, want, q, u, mask, keep
    times, bounds = {}, {}
    for name in ("bucket 128", "ood"):
        q, u, mask, _ = _k3_inputs(shapes[name], False, gen)
        times[name] = cuda_ms(lambda: K3.fused_pair_attention(q, u, mask, None, model_ws, H))
        bounds[name] = aa_fused_bound(*shapes[name], D, H, False)
        bound, by, flops, nbytes, route, route_by = bounds[name]
        print(f"[fused-kernel] aa_fused {name} {list(shapes[name])}: {times[name]:.3f} ms (median "
              f"of {TIMED_RUNS}), bound {route:.3f} ms by {route_by} on its route (3xTF32 "
              f"products on the tensor cores) and {bound:.3f} ms by {by} on the CUDA cores "
              f"({flops:.3e} flop, {nbytes:.3e} B), {flops / times[name] / 1e9:.1f} TFLOP/s",
              flush=True)
    q, u, mask, _ = _k3_inputs(shapes["bucket 128"], False, gen)
    plain_ms = cuda_ms(lambda: K3.fused_pair_attention_reference(q, u, mask, None, model_ws, H),
                       runs=5, warmup=1)
    print(f"[fused-kernel] aa_fused plain version at bucket 128: {plain_ms:.3f} ms (median of 5)",
          flush=True)
    bound, by, _, _, route, route_by = bounds["bucket 128"]
    # bound_ms is the route's, cuda_core_bound_ms every operation on the CUDA cores
    return dict(name="aa_fused", route="cuda", source="trajsde_tpu_torch/csrc/aa_fused.cu",
                replaces="trajsde_tpu/ops/pallas/aa_fused.py:319", launches=None,
                max_abs_err=max_abs, ms=times["bucket 128"], plain_ms=plain_ms, bound_ms=route,
                bound_by=route_by, route_ms=route, route_by=route_by, cuda_core_bound_ms=bound,
                cuda_core_bound_by=by, ood_ms=times["ood"], library_ms=None)


@torch.inference_mode()
def phase_fused_splice(dense, fused) -> int:
    """The fused model's served bucket-8 answer vs the dense model's own
    forward (same weights, pinned noise), then one fused ``forward_ood``
    vs the dense one (same generator seed); returns K3's and K4's OOD
    launches."""
    scene, enc_noise, twin_noise, dec_noise, rows = _splice_inputs(fused)
    zero_counts()
    served = make_serving_fn(fused, "cuda")(scene, 0, noise=rows, sde_noise=enc_noise,
                                            twin_noise=twin_noise)
    check(K3.fused_pair_attention.launches == 1, "the fused served batch did not launch K3 once")
    check(K3.fused_pair_attention_bwd.launches == 0, "the fused served batch launched K4")
    plain = dense(scene, enc_noise=enc_noise, twin_noise=twin_noise, dec_noise=dec_noise)
    _check_splice("fused-splice", served, plain, "dense forward")

    zero_counts()
    emb_f, std_f = fused.encoder.forward_ood(
        scene, generator=torch.Generator(device="cuda").manual_seed(SEED + 11))
    ood = K3.fused_pair_attention.launches
    emb_d, std_d = dense.encoder.forward_ood(
        scene, generator=torch.Generator(device="cuda").manual_seed(SEED + 11))
    for name, a, b in (("embedding", emb_f, emb_d), ("stds", std_f, std_d)):
        err = (a - b).abs().max().item()
        print(f"[fused-splice] forward_ood {name}: max |fused - dense| = {err:.3e} "
              f"(tol {TOL_SPLICE:g}) over {tuple(b.shape)}", flush=True)
        check(bool(torch.isfinite(a).all()), f"fused forward_ood {name} is not finite")
        check(err < TOL_SPLICE, f"fused forward_ood {name} disagrees with the dense one")
    print(f"[fused-splice] forward_ood launched aa_fused {ood} time(s)", flush=True)
    check(ood == 1, "forward_ood did not launch K3 once")
    k4 = K3.fused_pair_attention_bwd.launches
    check(k4 == 0, "forward_ood launched K4")
    return ood, k4


def bwd_bound(rows: int, steps: int, dim: int, explicit_noise: bool,
              tc_rate: float = PEAK_F64_TC_FLOPS):
    """(bound_ms, bound_by, flops, bytes, route_ms, route_by) of one K2 call:
    per row-step 4 recomputed, 5 input-gradient and 5 weight-gradient
    dim x dim products plus the three dim-wide dots of the diffusion output;
    y0, ys[:T-1], ct, the weights and the time table (and explicit noise)
    read once, dy0 and the weight gradients written once.  ``bound_ms``
    takes every operation at the f32 CUDA-core peak; ``route_ms`` is the
    bound on the route K2 takes: the 14 products (``28 dim^2`` a row-step)
    on the f64 tensor cores (``tc_rate``, by default ``PEAK_F64_TC_FLOPS``;
    ``PEAK_TF32_FLOPS / 3`` gives the 3xTF32 route K2 took before, the
    fastest f32-accurate arithmetic the card has), and the rest on the CUDA
    cores at their peak, the two pipes running at the same time;
    ``route_by`` says which of the route's operations and the bytes bounds
    it."""
    flops = rows * steps * (28 * dim * dim + 6 * dim)
    weights = 5 * dim * dim + 10 * dim + 4
    nbytes = 4 * (rows * dim + (steps - 1) * rows * dim + steps * rows * dim + weights + 4 * steps
                  + rows * dim + weights)
    if explicit_noise:
        nbytes += 4 * steps * rows * dim
    return _route_bounds(flops, rows * steps * 28 * dim * dim, nbytes, tc_rate)


def train_rows(model) -> int:
    """Rows of the decoder rollout in a training step at ``TRAIN_BATCH``."""
    return TRAIN_BATCH * model.decoder.num_modes * NUM_ACTORS


def phase_backward(model, rows: int) -> dict:
    """K2 vs its plain version at the training shape, for explicit and for
    regenerated gaussian increments; bit-equal reruns; timed."""
    dec = model.decoder
    T, D = dec.future_steps, dec.local_channels
    kp = {k: v.contiguous() for k, v in K1.rollout_params_from_module(dec.sde_rollout).items()}
    w = K1.pack_params(kp)
    t0s, dts = dec.time_grid(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    y0 = torch.relu(torch.randn((rows, D), generator=gen, device="cuda"))
    noise = torch.randn((T, rows, D), generator=gen, device="cuda")
    ct = torch.randn((T, rows, D), generator=gen, device="cuda")
    max_abs = 0.0
    for mode in ("explicit", "gaussian"):
        kw = _increments(mode, noise)
        nz, inc = kw.get("noise"), kw["increments"]
        ys = K1.sde_rollout_packed(y0, w, t0s, dts, 13, T, nz, inc)
        got = K1.sde_rollout_bwd(y0, ys, ct, w, t0s, dts, 13, T, nz, inc)
        again = K1.sde_rollout_bwd(y0, ys, ct, w, t0s, dts, 13, T, nz, inc)
        torch.cuda.synchronize()
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              f"sde_rollout_bwd ({mode}) is not bit-equal across two runs")
        want_dy0, want = K1.sde_rollout_bwd_reference(y0, ys, ct, kp, t0s, dts, 13, T, nz, inc)
        outs = {"dy0": (got[0], want_dy0, k2_tol("dy0"))}
        outs.update({k: (v, want[k], k2_tol(k)) for k, v in K1.unpack_params(got[1], D).items()})
        rels = {}
        for name, (g, p, tol) in outs.items():
            check(bool(torch.isfinite(g).all()), f"sde_rollout_bwd ({mode}) {name} is not finite")
            diff = (g - p).abs().max().item()
            max_abs = max(max_abs, diff)
            rels[name] = diff / max(p.abs().max().item(), 1e-30)
            check(rels[name] < tol, f"sde_rollout_bwd ({mode}) {name}: {rels[name]:.3e} >= {tol:g}")
        print(f"[backward] sde_rollout_bwd {mode} over [{T}, {rows}, {D}]: bit-equal reruns; "
              f"max|kernel - plain| / max|plain|: "
              + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
              + f" (tol {TOL_K2_TIGHT:g} each)", flush=True)
        del got, again, want, want_dy0, outs
    times = {}
    for mode in ("gaussian", "explicit"):
        kw = _increments(mode, noise)
        nz, inc = kw.get("noise"), kw["increments"]
        ys = K1.sde_rollout_packed(y0, w, t0s, dts, 13, T, nz, inc)
        times[mode] = cuda_ms(lambda: K1.sde_rollout_bwd(y0, ys, ct, w, t0s, dts, 13, T, nz, inc))
        bound, by, flops, nbytes, route, route_by = bwd_bound(rows, T, D, mode == "explicit")
        print(f"[backward] sde_rollout_bwd {mode}: {times[mode]:.3f} ms (median of {TIMED_RUNS}), "
              f"bound {route:.3f} ms by {route_by} on its route (products on the f64 tensor "
              f"cores) and {bound:.3f} ms by {by} on the CUDA cores ({flops:.3e} flop, "
              f"{nbytes:.3e} B), {flops / times[mode] / 1e9:.1f} TFLOP/s", flush=True)
    ys = K1.sde_rollout_packed(y0, w, t0s, dts, 13, T, None, "gaussian")
    plain_ms = cuda_ms(lambda: K1.sde_rollout_bwd_reference(y0, ys, ct, kp, t0s, dts, 13, T),
                       runs=5, warmup=1)
    print(f"[backward] sde_rollout_bwd plain version (gaussian): {plain_ms:.3f} ms (median of 5)",
          flush=True)
    bound, by, _, _, route, route_by = bwd_bound(rows, T, D, False)
    tf32_route = bwd_bound(rows, T, D, False, PEAK_TF32_FLOPS / 3)[4]
    print(f"[backward] sde_rollout_bwd: with its 14 products in 3xTF32 on the TF32 tensor "
          f"cores the bound would be {tf32_route:.3f} ms, the card's floor at f32 accuracy",
          flush=True)
    # the training path draws gaussian increments in the kernel: its numbers;
    # bound_ms is the route's (f64 tensor cores), tf32x3_bound_ms the same
    # work with the products in 3xTF32, cuda_core_bound_ms every operation on
    # the CUDA cores
    return dict(name="sde_rollout_bwd", route="cuda",
                source="trajsde_tpu_torch/csrc/sde_rollout_bwd.cu",
                replaces="trajsde_tpu/ops/pallas/sde_rollout.py:290", launches=None,
                max_abs_err=max_abs, ms=times["gaussian"], plain_ms=plain_ms, bound_ms=route,
                bound_by=route_by, tf32x3_bound_ms=tf32_route, cuda_core_bound_ms=bound,
                cuda_core_bound_by=by, library_ms=None)


def _train_batch(rng, n):
    raws = [make_raw_scene(rng, i % 2, num_actors=NUM_ACTORS, num_lanes=NUM_LANES)
            for i in range(n)]
    return pack_scenes([align_scene(r)[0] for r in raws], NUM_ACTORS, NUM_LANES)


def _counts() -> dict:
    return {"sde_rollout": K1.sde_rollout.launches,
            "sde_rollout_bwd": K1.sde_rollout_bwd.launches,
            "aa_fused": K3.fused_pair_attention.launches,
            "aa_fused_bwd": K3.fused_pair_attention_bwd.launches,
            "aa_attention": K5.aa_attention.launches,
            "vpu_probe": K6.chained_tanh.launches}


def phase_train(cfg, batch: int, tag: str = "train") -> dict:
    """Full-width training of ``cfg`` through the Trainer: every kernel of
    the path (K1 and K2, and K3 and K4 when the AA encoder is fused)
    launches once per optimizer step, the others never; eval launches the
    forward kernels once per batch.  Returns the training path's launches
    and its ms/step, scenes/s and peak memory."""
    fused_aa = bool(cfg["encoder"]["kwargs"].get("fused", False))
    model = build_model(cfg, device="cuda", seed=SEED)
    losses, metrics = build_losses(cfg), build_metrics(cfg)
    rng = np.random.default_rng(SEED + 3)
    train = [_train_batch(rng, batch) for _ in range(TRAIN_BATCHES)]
    val = [_train_batch(rng, batch) for _ in range(VAL_BATCHES)]
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=len(train),
                               seed=SEED)
    trainer = Trainer(losses, metrics, device="cuda")
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    trainer.fit(state, lambda: train, lambda: [], max_epochs=1)
    launches = _counts()
    print(f"[{tag}] launches on the training path: {launches} for {state.step} optimizer steps",
          flush=True)
    n_aa = state.step if fused_aa else 0
    check(launches == {"sde_rollout": state.step, "sde_rollout_bwd": state.step,
                       "aa_fused": n_aa, "aa_fused_bwd": n_aa, "aa_attention": 0, "vpu_probe": 0},
          "K1 and K2 (and K3 and K4 with the fused AA encoder, else never) did not launch "
          "once per optimizer step, or K5 or K6 launched")
    epoch = trainer.epoch_logs[-1]
    check(epoch["train/steps_skipped"] == 0.0, "the NaN guard skipped a training step")
    print(f"[{tag}] epoch of {state.step} steps at batch {batch} (incl. first-step warm-up): "
          f"{1e3 / epoch['perf/steps_per_s']:.1f} ms/step, {epoch['perf/scenes_per_s']:.1f} "
          f"scenes/s", flush=True)

    results = trainer.evaluate(state, lambda: val)
    print(f"[{tag}] val over {VAL_BATCHES} batches: "
          + ", ".join(f"{k} {v:.4f}" for k, v in results.items()), flush=True)
    check(all(np.isfinite(v) for v in results.values()), "non-finite val metrics")
    evals = {k: v - launches[k] for k, v in _counts().items()}
    print(f"[{tag}] launches in eval: {evals}", flush=True)
    check(evals == {"sde_rollout": VAL_BATCHES, "sde_rollout_bwd": 0,
                    "aa_fused": VAL_BATCHES if fused_aa else 0, "aa_fused_bwd": 0,
                    "aa_attention": 0, "vpu_probe": 0},
          "eval did not run K1 (and K3 with the fused AA encoder) once per batch and the "
          "backward kernels never")

    step = make_train_step(model, state.optimizer, state.scheduler, losses, torch.device("cuda"))
    totals, times = [], []
    before = _counts()
    for _ in range(REPEAT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = step(train[0].to("cuda"), state.step, state.seed)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        state.step += 1
        totals.append(float(logs["train/total"]))
        check(np.isfinite(totals[-1]) and logs["train/step_skipped"] == 0.0,
              "non-finite training loss")
    ms = statistics.median(times[1:])
    repeated = {k: v - before[k] for k, v in _counts().items()}
    check(repeated == {k: (REPEAT_STEPS if n else 0) for k, n in launches.items()},
          f"the repeated steps launched {repeated}, not every path kernel once per step")
    print(f"[{tag}] {REPEAT_STEPS} steps on one batch: loss "
          + " ".join(f"{x:.4f}" for x in totals), flush=True)
    check(float(np.mean(totals[-3:])) < totals[0], "the loss did not fall on a repeated batch")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] batch {batch}: {ms:.1f} ms/step (median of the last {REPEAT_STEPS - 1}, "
          f"host clock, synchronized, copy to device included), {batch / ms * 1e3:.1f} scenes/s; "
          f"peak device memory {peak:.2f} GiB", flush=True)

    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(d, save_top_k=1)
        ckpt.save(state, metric=results["ADE_T"], step=state.step)
        other = create_train_state(build_model(cfg, device="cuda", seed=SEED + 9),
                                   cfg["training_specific"], steps_per_epoch=len(train))
        CheckpointManager(d).restore(other)
        a, b = state.model.state_dict(), other.model.state_dict()
        check(other.step == state.step and all(torch.equal(a[k], b[k]) for k in a),
              "checkpoint restore differs")
    print(f"[{tag}] checkpoint saved and restored at step {state.step}", flush=True)
    return dict(launches=launches, ms=ms, scenes_per_s=batch / ms * 1e3, peak_gib=peak)


class _StepClock:
    """A logger that notes the host clock at each optimizer step's log
    (each step ends by reading its NaN guard from the device)."""

    def __init__(self):
        self.times = []

    def log_scalars(self, step, values):
        if "train/total" in values:
            self.times.append(time.perf_counter())


def _same_batch(a, b) -> bool:
    """Every field of two ``SceneBatch``es equal (or both None)."""
    pairs = [(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)]
    return all((u is None and v is None) or (u is not None and v is not None and torch.equal(u, v))
               for u, v in pairs)


def phase_train_from_files(prepacked_ms: float, d: str) -> dict:
    """I. ``FLAGSHIP_TRAIN_FUSED`` trained from scene files: FILE_BATCHES
    batches of TRAIN_BATCH synthetic scenes of both sources written as
    per-scene ``.npz`` and converted to shards with ``convert_npz_dir``, then
    one epoch from each format through ``build_datamodule`` (the YAML's
    batch, capacities and flips, its default of 2 workers), ``Trainer.fit``
    and the feed.  K1-K4 launch once per step, K5 and K6 never; no step is
    skipped; the first batch the loader yields, packed in a worker process,
    equals the pack of the same scenes in this process bit for bit.  Prints
    the pack time, the scene load times of each format, and the host-clock
    ms/step from each format beside phase E's pre-packed step.  The files
    stay in ``d`` for phase J."""
    cfg = FLAGSHIP_TRAIN_FUSED
    n = FILE_BATCHES * TRAIN_BATCH
    rng = np.random.default_rng(SEED + 11)
    t0 = time.perf_counter()
    for name, src in (("nuScenes", 0), ("Argoverse", 1)):
        os.makedirs(os.path.join(d, "npz", name, "train"))
        for i in range(n // 2):
            raw = make_raw_scene(rng, src, num_actors=NUM_ACTORS, num_lanes=NUM_LANES)
            np.savez(os.path.join(d, "npz", name, "train", f"scene_{i:06d}.npz"), **raw)
        convert_npz_dir(os.path.join(d, "npz", name, "train"),
                        os.path.join(d, "shards", name, "train"))
    print(f"[files] {n} scenes of both sources written as npz and converted to shards in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    out = {}
    for fmt in ("npz", "shards"):
        dm = build_datamodule(cfg, seed=SEED, nu_dir=os.path.join(d, fmt, "nuScenes"),
                              Argo_dir=os.path.join(d, fmt, "Argoverse"))
        check(len(dm.train_dataset) == n and dm.train_batch_size == TRAIN_BATCH
              and (dm.num_actors, dm.num_lanes) == (NUM_ACTORS, NUM_LANES)
              and dm.train_dataset.random_flip and dm.num_workers == 2,
              f"the {fmt} datamodule is not the YAML's")
        ds = dm.train_dataset
        loader = dm.train_loader()
        it = iter(loader)
        first = next(it)
        it.close()
        # the scenes of that batch: epoch 1's permutation and flips
        idx = np.arange(n)
        np.random.default_rng(np.random.SeedSequence([SEED, 1])).shuffle(idx)
        load = []
        for _ in range(2):
            t0 = time.perf_counter()
            scenes = [ds[int(i)] for i in idx[:TRAIN_BATCH]]
            load.append(1e3 * (time.perf_counter() - t0))
        check(_same_batch(first, pack_scenes(scenes, NUM_ACTORS, NUM_LANES)),
              f"the loader's first batch from {fmt} differs from the pack of its scenes")
        pack = []
        for _ in range(PACK_RUNS):
            t0 = time.perf_counter()
            pack_scenes(scenes, NUM_ACTORS, NUM_LANES)
            pack.append(1e3 * (time.perf_counter() - t0))
        ds.epoch = 0

        model = build_model(cfg, device="cuda", seed=SEED)
        state = create_train_state(model, cfg["training_specific"],
                                   steps_per_epoch=len(loader), seed=SEED)
        clock = _StepClock()
        trainer = Trainer(build_losses(cfg), build_metrics(cfg), device="cuda", logger=clock)
        zero_counts()
        t0 = time.perf_counter()
        trainer.fit(state, dm.train_loader, lambda: [], max_epochs=1)
        launches = _counts()
        steps = state.step
        check(steps == FILE_BATCHES, f"{steps} steps from {fmt}, expected {FILE_BATCHES}")
        check(launches == {"sde_rollout": steps, "sde_rollout_bwd": steps, "aa_fused": steps,
                           "aa_fused_bwd": steps, "aa_attention": 0, "vpu_probe": 0},
              f"training from {fmt} launched {launches}, not K1-K4 once per step and K5 "
              "and K6 never")
        epoch = trainer.epoch_logs[-1]
        check(epoch["train/steps_skipped"] == 0.0, f"the NaN guard skipped a step ({fmt})")
        gaps = np.diff([t0] + clock.times) * 1e3
        out[fmt] = dict(launches=launches, first_step_ms=float(gaps[0]),
                        ms=float(np.median(gaps[1:])), wait_ms=epoch["perf/batch_wait_ms"],
                        pack_ms=statistics.median(pack), load_ms=min(load))
        print(f"[train-files] {fmt}: {steps} steps, launches {launches}; first step "
              f"{gaps[0]:.1f} ms (loader start included), then "
              + " ".join(f"{g:.1f}" for g in gaps[1:])
              + f" ms (median {out[fmt]['ms']:.1f}) vs phase E's pre-packed "
              f"{prepacked_ms:.1f} ms/step; the trainer waited "
              f"{epoch['perf/batch_wait_ms']:.1f} ms a step for its batch", flush=True)
        print(f"[train-files] {fmt}: load + align + flip of {TRAIN_BATCH} scenes "
              f"{min(load):.1f} ms; pack at {NUM_ACTORS} / {NUM_LANES} "
              f"{out[fmt]['pack_ms']:.1f} ms (host clock, median of {PACK_RUNS}); the first "
              "batch equals the pack of its scenes bit for bit", flush=True)
        del model, state, trainer
        torch.cuda.empty_cache()
    return out



def phase_cli(d: str, from_files: dict, card: str) -> dict:
    """J. The command line on the card: phase I's npz files and
    CLI_VAL_SCENES nuScenes validation / test scenes, under a JSON copy of
    ``FLAGSHIP_H100`` (both fused paths, 2 workers).  ``train_torch.main``
    trains one epoch, then resumes from its checkpoint with ``--ckpt`` for
    one more with ``--profile 1``; ``test_torch.main`` evaluates the best
    checkpoint plain, with ``--ood --only-agent``, ``--submit`` and
    ``--serving``.  Checks: the step continues after the resume, a trace
    file, finite metrics, the submission's shapes and probabilities, and
    the launches of each run (K1-K4 once per train step, K1 and K3 once per
    eval or test batch, K5 and K6 never).  Prints the host-clock ms per
    step and the trainer's wait beside phase I's."""
    import test_torch
    import train_torch

    rng = np.random.default_rng(SEED + 13)
    val_dir = os.path.join(d, "npz", "nuScenes", "val")
    os.makedirs(val_dir)
    for i in range(CLI_VAL_SCENES):
        raw = make_raw_scene(rng, 0, num_actors=NUM_ACTORS, num_lanes=NUM_LANES)
        np.savez(os.path.join(val_dir, f"scene_{i:06d}.npz"), **raw)
    n_eval = -(-CLI_VAL_SCENES // TRAIN_BATCH)
    cfg = copy.deepcopy(FLAGSHIP_H100)
    kw = cfg["datamodule_specific"]["kwargs"]
    kw.update(nu_dir=os.path.join(d, "npz", "nuScenes"),
              Argo_dir=os.path.join(d, "npz", "Argoverse"))
    check(cfg["encoder"]["kwargs"]["fused"] and cfg["decoder"]["kwargs"]["fused"]
          and kw["train_batch_size"] == TRAIN_BATCH and kw["num_workers"] >= 2,
          "FLAGSHIP_H100 is not the fused f32 config at batch 128")
    cfg_path = os.path.join(d, "h100.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    logdir = os.path.join(d, "logs")
    run_dir = os.path.join(logdir, "cli")
    common = ["-c", cfg_path, "-n", "cli", "--logdir", logdir, "--epochs", "1",
              "--seed", str(SEED)]
    train_want = {"sde_rollout": FILE_BATCHES + n_eval, "sde_rollout_bwd": FILE_BATCHES,
                  "aa_fused": FILE_BATCHES + n_eval, "aa_fused_bwd": FILE_BATCHES,
                  "aa_attention": 0, "vpu_probe": 0}
    out = {}
    for tag, extra in (("train", []), ("resume", ["--profile", "1"])):
        if tag == "resume":
            extra = extra + ["--ckpt", CheckpointManager(os.path.join(run_dir, "checkpoints"))
                             .latest()["path"]]
        t0 = time.perf_counter()
        zero_counts()
        state, trainer = train_torch.main(common + extra)
        launches = _counts()
        wall = time.perf_counter() - t0
        steps = FILE_BATCHES * (2 if tag == "resume" else 1)
        check(state.step == steps, f"[cli {tag}] the run ended at step {state.step}, not {steps}")
        check(launches == train_want, f"[cli {tag}] launched {launches}, not K1-K4 once per train "
              f"step and K1 and K3 once per eval batch ({train_want})")
        epoch = trainer.epoch_logs[-1]
        check(epoch["train/steps_skipped"] == 0.0, f"[cli {tag}] the NaN guard skipped a step")
        vals = {k: v for k, v in epoch.items() if k.startswith("val/")}
        check(vals and all(np.isfinite(v) for v in vals.values()),
              f"[cli {tag}] non-finite val metrics {vals}")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        times = [r["time"] for r in rows if "train/total" in r][-FILE_BATCHES:]
        gaps = 1e3 * np.diff(times)
        out[tag] = dict(launches=launches, ms=float(np.median(gaps)),
                        wait_ms=epoch["perf/batch_wait_ms"], wall_s=wall, val=vals)
        print(f"[cli] train_torch.py {tag}: step {state.step}, launches {launches}; host-clock "
              f"ms between step records " + " ".join(f"{g:.1f}" for g in gaps)
              + f" (median {out[tag]['ms']:.1f}), waited {epoch['perf/batch_wait_ms']:.1f} ms a "
              f"step for its batch; val " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
              + f"; {wall:.1f} s in all", flush=True)
    traces = os.listdir(os.path.join(run_dir, "profile"))
    check(traces == ["trace_step5.json"], f"--profile 1 on the resumed run left {traces}")
    trace_mb = os.path.getsize(os.path.join(run_dir, "profile", traces[0])) / 2**20
    check(os.path.isdir(os.path.join(run_dir, "source_snapshot", "trajsde_tpu_torch")),
          "no source snapshot in the run directory")
    npz_i = from_files["npz"]
    print(f"[cli] {card}: CLI from npz {out['train']['ms']:.1f} ms/step (median of the "
          f"gaps between step records, after the first), waited {out['train']['wait_ms']:.1f} "
          f"ms a step; resumed {out['resume']['ms']:.1f} / {out['resume']['wait_ms']:.1f} "
          f"(profiler on for step 5; trace {trace_mb:.1f} MiB); phase I from npz "
          f"{npz_i['ms']:.1f} ms/step, waited {npz_i['wait_ms']:.1f}", flush=True)

    best = CheckpointManager(os.path.join(run_dir, "checkpoints")).best()
    check(best is not None and best["step"] in (FILE_BATCHES, 2 * FILE_BATCHES),
          f"no scored checkpoint: {best}")
    # every test_torch.py run: K1 and K3 once per batch (the fused decoder's
    # or the serving rollout; the fused AA block, also in its OOD form)
    test_want = {"sde_rollout": n_eval, "sde_rollout_bwd": 0, "aa_fused": n_eval,
                 "aa_fused_bwd": 0, "aa_attention": 0, "vpu_probe": 0}
    for flags in ([], ["--ood", "--only-agent"], ["--submit"], ["--serving"]):
        tag = " ".join(flags) or "plain"
        zero_counts()
        t0 = time.perf_counter()
        results = test_torch.main(["-c", cfg_path, "--ckpt", best["path"], *flags])
        wall = time.perf_counter() - t0
        launches = _counts()
        check(launches == test_want, f"[cli test {tag}] launched {launches}, not {test_want}")
        check({"ADE_T", "FDE_T", "MR_T"} <= set(results)
              and all(np.isfinite(v) for v in results.values()),
              f"[cli test {tag}] metrics {results}")
        check(("agent_std_mean" in results) == ("--ood" in flags),
              f"[cli test {tag}] agent_std_mean {'missing' if '--ood' in flags else 'present'}")
        out["test " + tag] = dict(launches=launches, results=results, wall_s=wall)
        print(f"[cli] test_torch.py {tag}: launches {launches}; "
              + ", ".join(f"{k} {v:.4f}" for k, v in results.items()) + f"; {wall:.1f} s",
              flush=True)
    stem = os.path.basename(best["path"])
    sub = np.load(os.path.join(run_dir, "out", f"submission_{stem}.npz"))
    n = CLI_VAL_SCENES
    check(sub["trajectories"].shape == (n, 10, 60, 2) and sub["probabilities"].shape == (n, 10)
          and sub["seq_ids"].shape == (n,) and sub["sources"].shape == (n,),
          f"submission shapes {[sub[k].shape for k in sub.files]}")
    check(np.isfinite(sub["trajectories"]).all()
          and np.allclose(sub["probabilities"].sum(-1), 1.0, atol=1e-5),
          "the submission's trajectories are not finite or its probabilities do not sum to 1")
    check(sorted(sub["seq_ids"].tolist()) == list(range(n)), "the submission's seq_ids are not "
          "the scenes' file numbers")
    check(os.path.isfile(os.path.join(run_dir, "out", f"result_{stem}.json")), "no result file")
    print(f"[cli] submission of {n} scenes: trajectories {sub['trajectories'].shape}, "
          "probabilities sum to 1, seq_ids are the file numbers", flush=True)
    return out


def _results_distance(got, want) -> tuple:
    """(max over the result fields of max |got - want| / max |want|, and
    whether every array is bit-equal) over two lists of served results."""
    worst, equal = 0.0, True
    for g, w in zip(got, want, strict=True):
        for k in ("agent_world", "agent_pi", "loc", "pi"):
            a, b = np.asarray(g[k], np.float64), np.asarray(w[k], np.float64)
            equal = equal and np.array_equal(g[k], w[k])
            worst = max(worst, float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)))
    return worst, equal


def _post(url: str, body: bytes, headers: dict):
    """(status, content type, body) of one POST; an HTTP error's too."""
    req = urllib.request.Request(url, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=FUTURE_TIMEOUT_S) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def phase_engine(d: str, card: str) -> dict:
    """K. The serving engine beyond ``predict`` at full width: a
    ``FLAGSHIP_FUSED`` engine (seeded weights, 48 / 192, K = 10, the default
    buckets, max_batch 128) warms all 8 buckets (timed); pipelined and
    serial ``predict`` of ENGINE_SCENES scenes on two engines of one seed
    agree within ``TOL_PIPELINE``, and are timed in ENGINE_ROUNDS
    alternating rounds, with the device's idle share across one pipelined
    and one serial ``predict`` under ``torch.profiler``; SUBMITTED scenes submitted from
    SUBMIT_THREADS threads all resolve, with ``mean_batch`` > 1 and K1 and K3
    once per recorded batch (K2, K4, K5, K6 never); SINGLES scenes
    submitted one at a time give bucket 1's p50 / p99; HTTP_POSTS concurrent
    ``POST /predict`` (half a JSON body and reply, half npz bytes with
    ``Accept: application/x-npz``) answer 200, ``/stats`` counts them, and
    after ``close()`` a POST answers 503; last ``serve_torch.py`` in batch
    mode on phase J's checkpoint and validation scenes under
    ``FLAGSHIP_H100`` writes one prediction per scene."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from torch.profiler import ProfilerActivity, profile

    import serve_torch
    from trajsde_tpu_torch import httpd

    t_phase = time.perf_counter()
    model = build_model(FLAGSHIP_FUSED, device="cuda", seed=SEED)
    rng = np.random.default_rng(SEED + 17)
    raws = [make_raw_scene(rng, i % 2, num_actors=NUM_ACTORS, num_lanes=NUM_LANES)
            for i in range(ENGINE_SCENES)]
    piped, serial = (ServingEngine(model, num_actors=NUM_ACTORS, num_lanes=NUM_LANES,
                                   device="cuda", seed=SEED, max_batch=TRAIN_BATCH)
                     for _ in range(2))
    out = {}
    server = None
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        piped.warmup(raws[0])
        torch.cuda.synchronize()
        out["warmup_s"] = time.perf_counter() - t0
        n_buckets = len(piped.buckets)
        check(n_buckets == 8 and piped.stats()["served"] == 0,
              f"warmup ran {piped.buckets} and recorded {piped.stats()}")
        check(_counts()["sde_rollout"] == _counts()["aa_fused"] == n_buckets,
              f"warmup launched {_counts()}")
        print(f"[engine] warmup of buckets {piped.buckets}: {out['warmup_s']:.2f} s, nothing "
              "recorded", flush=True)
        serial.warmup(raws[0])   # its counter moves as piped's did

        got = piped.predict(raws)
        want = serial.predict(raws, pipeline=False)
        _check_results(got, ENGINE_SCENES, model)
        out["pipeline_rel"], out["pipeline_bit_equal"] = _results_distance(got, want)
        print(f"[engine] pipelined vs serial predict of {ENGINE_SCENES} scenes (engines of one "
              f"seed): max |pipelined - serial| / max |serial| = {out['pipeline_rel']:.3e} (tol "
              f"{TOL_PIPELINE:g}); bit-equal: {out['pipeline_bit_equal']}", flush=True)
        check(out["pipeline_rel"] <= TOL_PIPELINE, "the pipelined predict disagrees with serial")
        del got, want

        times = {"pipelined": [], "serial": []}
        for r in range(ENGINE_ROUNDS):
            for mode in (("pipelined", "serial") if r % 2 == 0 else ("serial", "pipelined")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                piped.predict(raws, pipeline=mode == "pipelined")
                times[mode].append(time.perf_counter() - t0)
        for mode, ts in times.items():
            out[f"{mode}_scenes_per_s"] = ENGINE_SCENES / statistics.median(ts)
            out[f"{mode}_rounds_s"] = ts
        print(f"[engine] {card}: {ENGINE_SCENES} scenes a predict, {ENGINE_ROUNDS} alternating "
              f"rounds, medians: pipelined {out['pipelined_scenes_per_s']:.1f} scenes/s, serial "
              f"{out['serial_scenes_per_s']:.1f}; rounds (s) pipelined "
              + " ".join(f"{t:.3f}" for t in times["pipelined"]) + ", serial "
              + " ".join(f"{t:.3f}" for t in times["serial"]), flush=True)

        for mode in ("pipelined", "serial"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                piped.predict(raws, pipeline=mode == "pipelined")
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            out[f"{mode}_profiled"] = dict(wall_ms=wall, busy_ms=busy,
                                           idle_share=1.0 - busy / wall if busy > 0 else None)
            print(f"[engine] one {mode} predict of {ENGINE_SCENES} under torch.profiler: "
                  f"{wall:.1f} ms, device busy {busy:.1f} ms, idle share "
                  + (f"{1.0 - busy / wall:.3f}" if busy > 0 else "not measured (no device events)"),
                  flush=True)

        piped.reset_stats()
        futs, lock = [], threading.Lock()

        def send(chunk):
            for raw in chunk:
                f = piped.submit(raw)
                with lock:
                    futs.append(f)

        per = SUBMITTED // SUBMIT_THREADS
        threads = [threading.Thread(target=send, args=(raws[i * per:(i + 1) * per],))
                   for i in range(SUBMIT_THREADS)]
        zero_counts()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=FUTURE_TIMEOUT_S)
        results = [f.result(timeout=FUTURE_TIMEOUT_S) for f in futs]
        launches = _counts()
        st = piped.stats()
        batches = len(piped._batch_sizes)
        _check_results(results, SUBMITTED, model)
        out["submit"] = dict(stats=st, batches=batches, launches=launches)
        print(f"[engine] {SUBMITTED} scenes submitted from {SUBMIT_THREADS} threads at max_wait_ms "
              f"{piped.max_wait_ms:g}: served {st['served']} in {batches} batches (mean "
              f"{st['mean_batch']:.2f}), p50 {st['p50_ms']:.1f} ms, p99 {st['p99_ms']:.1f} ms, "
              f"{st['scenes_per_sec']:.1f} scenes/s; launches {launches}", flush=True)
        check(st["served"] == SUBMITTED and st["mean_batch"] > 1.0, f"micro-batcher stats {st}")
        check(launches == {"sde_rollout": batches, "sde_rollout_bwd": 0, "aa_fused": batches,
                           "aa_fused_bwd": 0, "aa_attention": 0, "vpu_probe": 0},
              f"submitted batches launched {launches}, not K1 and K3 once per batch ({batches})")
        del results, futs

        piped.reset_stats()
        for raw in raws[:SINGLES]:
            piped.submit(raw).result(timeout=FUTURE_TIMEOUT_S)
        st1 = piped.stats()
        out["single"] = st1
        check(st1["served"] == SINGLES and st1["mean_batch"] == 1.0, f"single requests {st1}")
        print(f"[engine] {SINGLES} single scenes submitted one at a time (bucket 1): p50 "
              f"{st1['p50_ms']:.2f} ms, p99 {st1['p99_ms']:.2f} ms", flush=True)

        npz_dir = os.path.join(d, "engine_npz")
        os.makedirs(npz_dir)
        bodies = []
        for i in range(HTTP_POSTS):
            path = os.path.join(npz_dir, f"scene_{i}.npz")
            np.savez(path, **raws[i])
            with open(path, "rb") as f:
                bodies.append((path, f.read()))
        piped.reset_stats()
        server, port = httpd.run_http_server(piped, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{port}"

        def post(i):
            path, raw = bodies[i]
            if i % 2 == 0:
                return _post(f"{url}/predict", json.dumps({"npz": path}).encode(),
                             {"Content-Type": "application/json"})
            return _post(f"{url}/predict", raw, {"Content-Type": "application/octet-stream",
                                                 "Accept": "application/x-npz"})

        t0 = time.perf_counter()
        with ThreadPoolExecutor(HTTP_POSTS) as ex:
            replies = list(ex.map(post, range(HTTP_POSTS)))
        http_s = time.perf_counter() - t0
        replied = []
        for i, (code, ctype, body) in enumerate(replies):
            check(code == 200, f"POST /predict {i} answered {code}: {body[:300]!r}")
            if i % 2 == 0:
                check(ctype == "application/json", f"reply {i} is {ctype}")
                replied.append({k: np.asarray(v, np.float32) for k, v in json.loads(body).items()
                                if k != "seq_id"})
            else:
                check(ctype == "application/x-npz", f"reply {i} is {ctype}")
                with np.load(io.BytesIO(body)) as z:
                    replied.append({k: z[k] for k in z.files if k != "seq_id"})
        _check_results(replied, HTTP_POSTS, model)
        with urllib.request.urlopen(f"{url}/stats", timeout=FUTURE_TIMEOUT_S) as r:
            http_stats = json.loads(r.read())
        check(http_stats["served"] == HTTP_POSTS, f"/stats after {HTTP_POSTS} posts: {http_stats}")
        piped.close()
        closed = post(1)[0]
        check(closed == 503, f"a POST after close() answered {closed}, not 503")
        out["http"] = dict(stats=http_stats, s=http_s)
        print(f"[engine] HTTP: {HTTP_POSTS} concurrent POST /predict (half JSON, half npz) all "
              f"200 in {http_s:.2f} s; /stats served {http_stats['served']} in mean batch "
              f"{http_stats['mean_batch']:.2f}; after close() a POST answers {closed}", flush=True)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        piped.close()
        serial.close()
    del piped, serial, raws
    torch.cuda.empty_cache()

    # serve_torch.py batch mode on phase J's checkpoint and validation scenes
    run_dir = os.path.join(d, "logs", "cli")
    best = CheckpointManager(os.path.join(run_dir, "checkpoints")).best()["path"]
    val_dir = os.path.join(d, "npz", "nuScenes", "val")
    preds = os.path.join(d, "serve_preds")
    zero_counts()
    t0 = time.perf_counter()
    stats = serve_torch.main(["-c", os.path.join(d, "h100.json"), "--ckpt", best, "--input-dir",
                              val_dir, "--output-dir", preds, "--max-batch", str(TRAIN_BATCH),
                              "--warmup"])
    cli_s = time.perf_counter() - t0
    launches = _counts()
    batches = round(stats["served"] / stats["mean_batch"])
    check(stats["served"] == CLI_VAL_SCENES, f"serve_torch.py served {stats}")
    check(launches == {"sde_rollout": 8 + batches, "sde_rollout_bwd": 0, "aa_fused": 8 + batches,
                       "aa_fused_bwd": 0, "aa_attention": 0, "vpu_probe": 0},
          f"serve_torch.py launched {launches}, not K1 and K3 once per batch and warmup bucket")
    names = sorted(os.listdir(preds))
    check(names == sorted(f.replace(".npz", "_pred.npz") for f in os.listdir(val_dir)),
          f"serve_torch.py wrote {len(names)} predictions for {CLI_VAL_SCENES} scenes")
    written = []
    for name in names:
        with np.load(os.path.join(preds, name)) as z:
            written.append({k: z[k] for k in z.files})
    _check_results(written, CLI_VAL_SCENES, model)   # FLAGSHIP_H100 has the same K and Tf
    out["serve_cli"] = dict(stats=stats, launches=launches, s=cli_s)
    print(f"[engine] serve_torch.py batch mode (FLAGSHIP_H100, phase J's checkpoint): "
          f"{len(names)} predictions for {CLI_VAL_SCENES} scenes, shapes and probabilities "
          f"checked; stats {stats}; launches {launches}; {cli_s:.1f} s", flush=True)
    print(f"[engine] phase K took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def _losses_of(cfg, out):
    return sum(w * fn(out["y"], out) for _, w, fn in build_losses(cfg))


def _splice_train_inputs(model, batch: int = TRAIN_SPLICE_BATCH):
    """A training scene of ``batch`` (default 8) scenes and pinned encoder,
    twin and decoder noise, on the current card."""
    rng = np.random.default_rng(SEED + 6)
    scene = _train_batch(rng, batch).to("cuda")
    enc, dec = model.encoder, model.decoder
    B, A, Th, D = batch, NUM_ACTORS, enc.historical_steps, enc.embed_dim
    Tf, Km = dec.future_steps, dec.num_modes
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    en = torch.randn((Th, B, A + 1, D), generator=gen, device="cuda")
    tw = torch.randn((B, 1, Th, 2), generator=gen, device="cuda")
    de = torch.randn((Tf, B, Km, A, D), generator=gen, device="cuda")
    return scene, en, tw, de


class _PinnedFused(torch.nn.Module):
    """``model``'s training forward with the rollout through K1 (K2 in the
    backward) on the pinned decoder noise ``de`` and the encoder on ``en``
    / ``tw``; every draw the forward's arguments would seed is pinned."""

    def __init__(self, model, en, tw, de):
        super().__init__()
        self.model, self.noise = model, (en, tw, de)

    def forward(self, scene, generator=None, rollout_seed=None):
        model, (en, tw, de) = self.model, self.noise
        enc, dec = model.encoder, model.decoder
        local, d_in, d_out, l_in, l_out = enc(scene, sde_noise=en, twin_noise=tw)
        glob = model.aggregator(scene, local)
        y0 = dec.fuse(scene, local, glob)
        ys = dec.fused_rollout(y0, 0, noise=de.reshape(de.shape[0], -1, y0.shape[-1]))
        out = dec.decode(scene, ys.permute(1, 2, 3, 0, 4), local, glob)
        out.update(y=model.rotated_y(scene), diff_in=d_in, diff_out=d_out, label_in=l_in,
                   label_out=l_out)
        return out


def _fused_decoder_loss(model, cfg, scene, en, tw, de):
    """One training forward (:class:`_PinnedFused`) and its loss."""
    return _losses_of(cfg, _PinnedFused(model, en, tw, de)(scene))


def _check_step(tag: str, what: str, loss_a, loss_b, model_a, model_b,
                batch: int = TRAIN_SPLICE_BATCH) -> None:
    """Loss within TOL_TRAIN_LOSS (relative) and every gradient leaf of
    ``model_a`` within TOL_TRAIN_GRAD * max|grad| + ATOL_TRAIN_GRAD of
    ``model_b``'s."""
    _check_grads(tag, what, loss_a.item(), loss_b.item(),
                 {n: p.grad for n, p in model_a.named_parameters()},
                 {n: p.grad for n, p in model_b.named_parameters()}, batch)


def _check_grads(tag: str, what: str, loss_a: float, loss_b: float, grads_a: dict,
                 grads_b: dict, batch: int) -> None:
    """:func:`_check_step` on losses and {name: gradient or None} dicts."""
    rel_loss = abs(loss_a - loss_b) / abs(loss_b)
    print(f"[{tag}] batch {batch}: loss {loss_a:.6f} vs {what} "
          f"{loss_b:.6f}, relative {rel_loss:.3e} (tol {TOL_TRAIN_LOSS:g})", flush=True)
    check(rel_loss < TOL_TRAIN_LOSS, f"the training loss disagrees with the {what}")
    worst, name_w, n = 0.0, "", 0
    check(set(grads_a) == set(grads_b), f"the leaves differ from the {what}'s")
    for name, g in grads_a.items():
        ref = grads_b[name]
        if ref is None:   # the pi head gets no gradient from L2 + DiffBCE
            check(g is None, f"{name}: gradient on one path only")
            continue
        check(g is not None and bool(torch.isfinite(g).all()), f"{name}: no or non-finite gradient")
        scale = max(ref.abs().max().item(), g.abs().max().item())
        frac = (g - ref).abs().max().item() / (TOL_TRAIN_GRAD * scale + ATOL_TRAIN_GRAD)
        n += 1
        if frac > worst:
            worst, name_w = frac, name
    print(f"[{tag}] {n} gradient leaves: worst max|diff| from the {what} is {worst:.3f} of its "
          f"tolerance ({TOL_TRAIN_GRAD:g} * max|grad| + {ATOL_TRAIN_GRAD:g}) at {name_w}",
          flush=True)
    check(worst <= 1.0, f"the gradients disagree with the {what}")


def _no_dropout(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["encoder"]["kwargs"]["dropout"] = cfg["aggregator"]["kwargs"]["dropout"] = 0.0
    return cfg


def phase_train_splice() -> None:
    """One training step's loss and gradients: fused path (K1 + K2, pinned
    decoder noise) vs the unfused model (autograd through the plain loop)."""
    cfg = _no_dropout(FLAGSHIP_TRAIN)
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg["decoder"]["kwargs"]["fused"] = False
    fused = build_model(cfg, device="cuda", seed=SEED + 5).train()
    plain = build_model(plain_cfg, device="cuda", seed=SEED + 5).train()
    scene, en, tw, de = _splice_train_inputs(fused)

    zero_counts()
    loss_f = _fused_decoder_loss(fused, cfg, scene, en, tw, de)
    loss_f.backward()
    check(K1.sde_rollout.launches == 1 and K1.sde_rollout_bwd.launches == 1,
          "the fused step did not run K1 and K2 once each")
    loss_p = _losses_of(plain_cfg, plain(scene, enc_noise=en, twin_noise=tw, dec_noise=de))
    loss_p.backward()
    _check_step("train-splice", "plain loop", loss_f, loss_p, fused, plain)


def phase_fused_backward() -> dict:
    """K4 vs its plain version (autograd through the plain chain) at the
    training twin shape and at batch 1, with and without a keep mask, for
    the model's packed weights and random ones, every 7th receiver without
    a sender and a random cotangent; bit-equal reruns; K3's output the same
    bits whether or not it writes the softmax statistics; timed at the
    training shape with keep."""
    model = build_model(FLAGSHIP_TRAIN_FUSED, device="cuda", seed=SEED)
    Th, A = model.encoder.historical_steps, NUM_ACTORS
    D, H = K3.KERNEL_DIM, K3.KERNEL_HEADS
    model_ws = tuple(w.contiguous() for w in
                     K3.weights_of(K3.pack_aa_params(model.encoder.aa_encoder)))
    del model
    shapes = {"train": (TRAIN_BATCH, Th, A + 1, A), "batch 1": (1, Th, A + 1, A)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    weights = {"model": model_ws, "random": _random_aa_weights(gen, model_ws)}
    max_abs = 0.0
    for name, shape in shapes.items():
        for wname, ws in weights.items():
            for with_keep in (False, True):
                q, u, mask, keep = _k3_inputs(shape, with_keep, gen)
                g = torch.randn(q.shape, generator=gen, device="cuda")
                p = K3_DROPOUT if with_keep else 0.0
                kept = f"p={p:g}" if with_keep else "None"
                case = f"{name} {list(shape)}, {wname} weights, keep {kept}"
                out, stats = K3.fused_pair_attention_fwd(q, u, mask, keep, ws, H, p)
                served = K3.fused_pair_attention(q, u, mask, keep, ws, H, p)
                dq, dws = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, H, p, out=out,
                                                      stats=stats)
                dq2, dws2 = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, H, p, out=out,
                                                        stats=stats)
                torch.cuda.synchronize()
                check(torch.equal(out, served), f"aa_fused ({case}): writing the softmax "
                      "statistics changed the output")
                check(bool(torch.isfinite(dq).all()) and all(bool(torch.isfinite(d).all())
                                                             for d in dws),
                      f"aa_fused_bwd ({case}) is not finite")
                check(torch.equal(dq, dq2) and all(torch.equal(a, b) for a, b in zip(dws, dws2)),
                      f"aa_fused_bwd ({case}) is not bit-equal across two runs")
                check(bool((dq[:, :, ::7] == 0).all()), f"aa_fused_bwd ({case}): an empty "
                      "receiver did not give exactly 0")
                del out, stats, served, dq2, dws2
                want_dq, want = K3.fused_pair_attention_bwd_reference(q, u, mask, keep, ws, g, H,
                                                                      p)
                outs = {k: (a, b, k4_tol(k)) for k, a, b in
                        zip(("dq", *K3.W_ORDER), (dq, *dws), (want_dq, *want))}
                rels = {}
                for k, (a, b, tol) in outs.items():
                    check(a.shape == b.shape, f"aa_fused_bwd ({case}) {k}: shape {tuple(a.shape)}")
                    diff = (a - b).abs().max().item()
                    max_abs = max(max_abs, diff)
                    rels[k] = diff / max(b.abs().max().item(), 1e-30)
                    check(rels[k] <= tol, f"aa_fused_bwd ({case}) {k}: {rels[k]:.3e} > {tol:g}")
                print(f"[fused-backward] aa_fused_bwd {case}: bit-equal reruns; max|kernel - "
                      f"plain| / max|plain|: " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
                      + f" (tol {TOL_K4_SMOOTH:g} {', '.join(K4_SMOOTH_LEAVES)}; "
                      f"{TOL_K4_W:g} the other weights)", flush=True)
                del q, u, mask, keep, g, dq, dws, want_dq, want, outs
                torch.cuda.empty_cache()

    shape = shapes["train"]
    q, u, mask, keep = _k3_inputs(shape, True, gen)
    g = torch.randn(q.shape, generator=gen, device="cuda")
    out, stats = K3.fused_pair_attention_fwd(q, u, mask, keep, model_ws, H, K3_DROPOUT)
    ms = cuda_ms(lambda: K3.fused_pair_attention_bwd(q, u, mask, keep, model_ws, g, H, K3_DROPOUT,
                                                     out=out, stats=stats))
    bound, by, flops, nbytes, route, route_by = aa_fused_bwd_bound(*shape, D, H, True)
    print(f"[fused-backward] aa_fused_bwd train {list(shape)}, keep p={K3_DROPOUT:g}: {ms:.3f} ms "
          f"(median of {TIMED_RUNS}), bound {route:.3f} ms by {route_by} on its route (3xTF32 "
          f"products on the tensor cores) and {bound:.3f} ms by {by} on the CUDA cores "
          f"({flops:.3e} flop, {nbytes:.3e} B), {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    del out, stats
    torch.cuda.empty_cache()
    plain_ms = cuda_ms(lambda: K3.fused_pair_attention_bwd_reference(q, u, mask, keep, model_ws,
                                                                     g, H, K3_DROPOUT),
                       runs=5, warmup=1)
    print(f"[fused-backward] aa_fused_bwd plain version at the training shape: {plain_ms:.3f} ms "
          f"(median of 5)", flush=True)
    del q, u, mask, keep, g
    torch.cuda.empty_cache()
    return dict(name="aa_fused_bwd", route="cuda", source="trajsde_tpu_torch/csrc/aa_fused_bwd.cu",
                replaces="trajsde_tpu/ops/pallas/aa_fused.py:343", launches=None,
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=route, bound_by=route_by,
                library_ms=None)


def phase_fused_train_splice() -> None:
    """One training step of ``FLAGSHIP_TRAIN_FUSED`` (K3 + K4 for the AA
    block, K1 + K2 for the rollout) vs ``FLAGSHIP_TRAIN`` (the dense
    encoder's autograd), the same weights, dropout 0 and pinned noise."""
    cfg = _no_dropout(FLAGSHIP_TRAIN_FUSED)
    dense_cfg = _no_dropout(FLAGSHIP_TRAIN)
    fused = build_model(cfg, device="cuda", seed=SEED + 5).train()
    dense = build_model(dense_cfg, device="cuda", seed=SEED + 5).train()
    dense.load_state_dict(fused.state_dict())
    scene, en, tw, de = _splice_train_inputs(fused)

    zero_counts()
    loss_f = _fused_decoder_loss(fused, cfg, scene, en, tw, de)
    loss_f.backward()
    launched = _counts()
    print(f"[fused-train-splice] launches of the fused-encoder step: {launched}", flush=True)
    check(launched == {"sde_rollout": 1, "sde_rollout_bwd": 1, "aa_fused": 1, "aa_fused_bwd": 1,
                       "aa_attention": 0, "vpu_probe": 0},
          "the fused-encoder step did not run K1, K2, K3 and K4 once each")
    loss_d = _fused_decoder_loss(dense, dense_cfg, scene, en, tw, de)
    loss_d.backward()
    _check_step("fused-train-splice", "dense encoder", loss_f, loss_d, fused, dense)


def aa_attention_bound(B: int, T: int, Aq: int, Ak: int, dim: int, heads: int):
    """(bound_ms, bound_by, flops, bytes, route_ms, route_by) of one K5
    call: :func:`aa_pair_ops` per pair plus the pair features' 14 (two
    differences, eight products, four sums) and the q projection's
    2 D^2 + D per receiver; the centres, x_k, pos_q, pos_k and rot (f32),
    the bool mask (1 byte), the weights with wq and bq read once, the
    aggregate written once.  ``bound_ms`` takes every operation at the f32
    CUDA-core peak; ``route_ms`` is the bound on K5's route, K3's: its three
    chain products (``10 dim^2`` a pair) on the tensor cores at f32
    accuracy, the rest on the CUDA cores at the same time (see
    :func:`_route_bounds`)."""
    pairs, rows = B * T * Aq * Ak, B * T * Aq
    flops = pairs * (sum(aa_pair_ops(dim, heads)) + 14) + rows * (2 * dim * dim + dim)
    floats = (rows * dim + 2 * B * T * Ak * 2 + rows * 2 + B * Aq * 4
              + aa_weight_floats(dim) + dim * dim + dim + rows * dim)
    nbytes = 4 * floats + pairs
    return _route_bounds(flops, pairs * 10 * dim * dim, nbytes)


def vpu_probe_bound(n: int, rounds: int, variant: str):
    """(bound_ms, bound_by, flops, bytes) of one K6 call on ``n`` values of
    ``variant``: the longest of three times.  The multiply and add of each
    value and round, 2 operations at the f32 CUDA-core peak (twice it for
    bf16, two values per lane); the tanh on the special-function units,
    ``K6_MUFU[variant]`` instructions per value and round at
    ``PEAK_SFU_PER_S``; the input read and the output written once.
    ``bound_by`` names the longest: ``operations`` (CUDA cores),
    ``special-function units`` or ``bytes``.  ``flops`` counts the 3
    operations (tanh, multiply, add) of each value and round."""
    bf16 = variant == "bfloat16"
    t_fma = 2 * n * rounds / (PEAK_F32_FLOPS * (2 if bf16 else 1))
    t_sfu = K6_MUFU[variant] * n * rounds / PEAK_SFU_PER_S
    nbytes = 2 * n * (2 if bf16 else 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    times = {"operations": t_fma, "special-function units": t_sfu, "bytes": t_bytes}
    by = max(times, key=times.get)
    return 1e3 * times[by], by, 3 * n * rounds, nbytes


def _k5_inputs(shape, gen):
    """``test_aa_kernel.py``'s inputs at ``shape`` = (B, T, Aq, Ak): centres
    and x_k N(0, 1), receivers N(0, 20^2), sender j near receiver j mod Aq
    (N(0, 5^2) apart), random rotations, a bool mask with every 7th
    receiver empty."""
    B, T, Aq, Ak = shape
    dev = "cuda"
    center = torch.randn((B, T, Aq, K3.KERNEL_DIM), generator=gen, device=dev)
    x_k = torch.randn((B, T, Ak, 2), generator=gen, device=dev)
    pos_q = 20.0 * torch.randn((B, T, Aq, 2), generator=gen, device=dev)
    near = torch.arange(Ak, device=dev) % Aq
    pos_k = (pos_q[:, :, near] + 5.0 * torch.randn((B, T, Ak, 2), generator=gen,
                                                   device=dev)).contiguous()
    ang = (torch.rand((B, Aq), generator=gen, device=dev) * 2.0 - 1.0) * np.pi
    c, s = torch.cos(ang), torch.sin(ang)
    rot = torch.stack([c, -s, s, c], dim=-1).contiguous()
    mask = torch.rand((B, T, Aq, Ak), generator=gen, device=dev) > 0.4
    mask[:, :, ::7] = False
    return center, x_k, pos_q, pos_k, rot, mask


def _k5_packed(model, gen) -> dict:
    """``model``'s packed AA weights with wq / bq (``model``) and random ones
    (``random``, the w1 blocks off the diagonal filled in)."""
    D = K3.KERNEL_DIM
    packed = {k: v.contiguous() for k, v in K3.pack_aa_params(model.encoder.aa_encoder).items()}
    rand = dict(zip(K3.W_ORDER, _random_aa_weights(gen, K3.weights_of(packed))))
    rand["wq"] = torch.randn((D, D), generator=gen, device="cuda") / D ** 0.5
    rand["bq"] = 0.2 * torch.randn((1, D), generator=gen, device="cuda")
    return {"model": packed, "random": rand}


@torch.inference_mode()
def phase_aa_attention(model, one_term) -> dict:
    """K5's own path (one ``aa_attention`` call at each head count), then
    K5 vs its plain version and vs K3 on the same q and u within
    ``TOL_K3_TIGHT``, which the ``one_term`` copy of K5 must fail, at every
    shape of ``K5_SHAPES`` at 8 heads (the flagship's weights) and at 4
    (the baseline's, ``K5_BASELINE_SHAPE`` for the twin), for the model's
    packed weights and random ones; bit-equal reruns, empty receivers
    exactly 0; timed at the twin shape (8 heads) and the baseline's (4)."""
    t0 = time.perf_counter()
    D = K3.KERNEL_DIM
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    baseline = build_model(BASELINE_TRAIN, device="cuda", seed=SEED)
    weights = {8: _k5_packed(model, gen), 4: _k5_packed(baseline, gen)}
    del baseline
    shapes = {8: K5_SHAPES, 4: dict(K5_SHAPES, twin=K5_BASELINE_SHAPE)}
    timed = {h: _k5_inputs(shapes[h]["twin"], gen) for h in shapes}

    zero_counts()
    for h, args in timed.items():
        K5.aa_attention(*args, weights[h]["model"], h)
    torch.cuda.synchronize()
    launches = _counts()
    print(f"[aa-attention] launches of one aa_attention call at 8 and one at 4 heads: "
          f"{launches}", flush=True)
    check(launches == {k: 2 * int(k == "aa_attention") for k in launches},
          "aa_attention did not launch K5 once a call, and nothing else")

    max_abs = {8: 0.0, 4: 0.0}
    one_term_rel = {8: [], 4: []}
    for H, at_heads in shapes.items():
        for name, shape in at_heads.items():
            args = timed[H] if name == "twin" else _k5_inputs(shape, gen)
            center, x_k, pos_q, pos_k, rot, mask = args
            for wname, ws in weights[H].items():
                case = f"{H} heads, {name} {list(shape)}, {wname} weights"
                got = K5.aa_attention(*args, ws, H)
                again = K5.aa_attention(*args, ws, H)
                coarse = K5.launch(one_term, *args, ws, H)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), f"aa_attention ({case}) is not finite")
                check(torch.equal(got, again),
                      f"aa_attention ({case}) is not bit-equal across two runs")
                check(bool((got[:, :, ::7] == 0).all()), f"aa_attention ({case}): an empty "
                      "receiver did not give exactly 0")
                want = K5.aa_attention_reference(*args, ws, H)
                q = (center @ ws["wq"] + ws["bq"][0]).contiguous()
                u = K3.build_pair_features(x_k, pos_k[:, :, None] - pos_q[:, :, :, None],
                                           rot).contiguous()
                k3 = K3.fused_pair_attention(q, u, mask.float(), None, K3.weights_of(ws), H)
                scale = want.abs().max().item()
                diff = (got - want).abs().max().item()
                rel, rel_k3 = diff / scale, (got - k3).abs().max().item() / scale
                one_term_rel[H].append((coarse - want).abs().max().item() / scale)
                max_abs[H] = max(max_abs[H], diff)
                print(f"[aa-attention] aa_attention {case}: bit-equal reruns, max|kernel - "
                      f"plain| {diff:.3e} = {rel:.3e} of max|plain|, max|K5 - K3| {rel_k3:.3e} "
                      f"of it (tight {TOL_K3_TIGHT:g}); the one-term copy "
                      f"{one_term_rel[H][-1]:.3e}", flush=True)
                check(rel <= TOL_K3_TIGHT, f"aa_attention ({case}): {rel:.3e} > TOL_K3_TIGHT "
                      "against its plain version")
                check(rel_k3 <= TOL_K3_TIGHT, f"aa_attention ({case}): {rel_k3:.3e} > "
                      "TOL_K3_TIGHT against K3 on the same q and u")
                del got, again, coarse, want, q, u, k3
        check(max(one_term_rel[H]) > TOL_K3_TIGHT, f"the one-term copy of K5 passes "
              f"TOL_K3_TIGHT at {H} heads ({max(one_term_rel[H]):.3e})")
        torch.cuda.empty_cache()

    row = {}
    for H, args in timed.items():
        packed = weights[H]["model"]
        ms = cuda_ms(lambda: K5.aa_attention(*args, packed, H))
        plain_ms = cuda_ms(lambda: K5.aa_attention_reference(*args, packed, H), runs=5, warmup=1)
        shape = shapes[H]["twin"]
        bound, by, flops, nbytes, route, route_by = aa_attention_bound(*shape, D, H)
        print(f"[aa-attention] aa_attention at {H} heads, {list(shape)}: {ms:.3f} ms (median of "
              f"{TIMED_RUNS}), bound {route:.3f} ms by {route_by} on its route (3xTF32 products "
              f"on the tensor cores) and {bound:.3f} ms by {by} on the CUDA cores ({flops:.3e} "
              f"flop, {nbytes:.3e} B), {flops / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.3f} ms "
              f"(median of 5)", flush=True)
        prefix = "" if H == 8 else "h4_"
        row.update({f"{prefix}max_abs_err": max_abs[H], f"{prefix}ms": ms,
                    f"{prefix}plain_ms": plain_ms, f"{prefix}bound_ms": route,
                    f"{prefix}bound_by": route_by, f"{prefix}cuda_core_bound_ms": bound,
                    f"{prefix}cuda_core_bound_by": by,
                    f"{prefix}one_term_max_rel_err": max(one_term_rel[H])})
        torch.cuda.empty_cache()
    del timed
    torch.cuda.empty_cache()
    print(f"[aa-attention] phase G took {time.perf_counter() - t0:.1f} s", flush=True)
    # bound_ms is the route's, cuda_core_bound_ms every operation on the CUDA
    # cores (8 heads, the twin shape); h4_* at 4 heads, the baseline's shape
    return dict(name="aa_attention", route="cuda", source="trajsde_tpu_torch/csrc/aa_attention.cu",
                replaces="trajsde_tpu/ops/pallas/aa_attention.py:201",
                launches=launches["aa_attention"], library_ms=None,
                h4_shape=list(K5_BASELINE_SHAPE), **row)


def phase_vpu_probe() -> dict:
    """K6's own path (the probe script's runs), then K6 vs its plain
    version element by element in every run, and the plain version's
    time.  The row's numbers are f32's on the JAX probe's tile; ``runs``
    holds every run's."""
    from scripts import bench_vpu_dtype_torch as probe
    from scripts.vpu_probe_sass_torch import mufu_per_value

    t0 = time.perf_counter()
    mufu = mufu_per_value()
    check(mufu == K6_MUFU, f"the built probe's MUFU instructions per value and round {mufu} are "
          f"not K6_MUFU {K6_MUFU}: its bound would be wrong")
    zero_counts()
    runs = [probe.run(variant, rows) for variant, rows in probe.RUNS]
    launches = _counts()
    want_launches = len(runs) * (probe.WARMUP + probe.REPS + 1)
    print(f"[vpu-probe] launches of the probe: {launches}", flush=True)
    check(launches == {k: want_launches if k == "vpu_probe" else 0 for k in launches},
          f"the probe did not launch K6 {want_launches} times, and nothing else")

    rows = []
    for r in runs:
        variant, x = r["variant"], r["x"]
        want = K6.chained_tanh_reference(x)
        agree = K6.agreement(r["y"], want, variant)
        max_ulps = agree["max_ulps"]
        diff = (r["y"].float() - want.float()).abs().max().item()
        plain_us = probe.device_us(lambda: K6.chained_tanh_reference(x), 20)
        bound, by, _, _ = vpu_probe_bound(x.numel(), K6.ROUNDS, variant)
        case = f"{variant} {list(x.shape)}"
        print(f"[vpu-probe] {case} x {K6.ROUNDS} rounds: max|kernel - plain| {max_ulps:g} ulps "
              f"(tol {K6.TOL_ULPS[variant]}), {diff:.3e}; bit-equal {agree['bit_equal']:.6f} "
              f"(least {K6.MIN_BIT_EQUAL[variant]}); {r['us']:.3f} us (bound "
              f"{bound * 1e3:.3f} us by {by}), {r['rate'] / 1e12:.3f} T(tanh.mul.add)/s; plain "
              f"version {plain_us:.3f} us", flush=True)
        check(agree["ok"], f"vpu_probe ({case}) disagrees with its plain version")
        rows.append(dict(variant=variant, rows=r["rows"], max_abs_err=diff, max_ulps=max_ulps,
                         bit_equal=agree["bit_equal"],
                         ms=r["us"] / 1e3, plain_ms=plain_us / 1e3, bound_ms=bound, bound_by=by,
                         rate=r["rate"]))
    ratios = probe.rate_ratios(runs)
    print("[vpu-probe] rates: " + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items())
          + f"; phase H took {time.perf_counter() - t0:.1f} s", flush=True)
    tile = rows[0]
    return dict(name="vpu_probe", route="cuda", source="trajsde_tpu_torch/csrc/vpu_probe.cu",
                replaces="scripts/bench_vpu_dtype.py:34", launches=launches["vpu_probe"],
                max_abs_err=tile["max_abs_err"], ms=tile["ms"], plain_ms=tile["plain_ms"],
                bound_ms=tile["bound_ms"], bound_by=tile["bound_by"], library_ms=None,
                runs=rows, rate_ratios=ratios)


def baseline_train_steps(model, cfg, scene, steps: int):
    """``steps`` train steps of the baseline ``model`` (built from ``cfg``)
    on ``scene``, dropout live: (each step's ms by CUDA events, each step's
    total loss, the peak device memory in GiB).  Phase L's steps, and
    ``scripts/baseline_step_torch.py``'s at other batches."""
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=1, seed=SEED)
    step = make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg),
                           torch.device("cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals, times = [], []
    for i in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logs = step(scene, i, state.seed)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        totals.append(float(logs["train/total"]))
        check(np.isfinite(totals[-1]) and logs["train/step_skipped"] == 0.0,
              "non-finite baseline training loss")
    return times, totals, torch.cuda.max_memory_allocated() / 2**30


def build_check_copies() -> dict:
    """The check copies of phases G and L, built in parallel under the build
    directory's ``checks/``: ``logits_fwd`` and ``logits_bwd``, K3 and K4
    with ``AA_WRITE_LOGITS`` defined (each writes every pair's head logits,
    -inf where masked, to the buffer its ``*_set_logits`` names: K3 the ones
    its softmax takes, K4 the ones its recompute gives), and ``one_term`` and
    ``one_term_k5``, K3 and K5 with one TF32 product per term
    (``mma_tf32.cuh`` without its two small terms, beside the copies).
    Returns name -> configured library."""
    out_dir = os.path.join(kernel_build.BUILD_DIR, "checks")

    def source(name: str) -> str:
        with open(os.path.join(kernel_build.CSRC_DIR, name)) as f:
            return f.read()

    def write(path: str, text: str) -> str:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
        return path

    logits = "#define AA_WRITE_LOGITS\n"
    sources = {
        "logits_fwd": write(os.path.join(out_dir, "logits_fwd", "aa_fused.cu"),
                            logits + source("aa_fused.cu")),
        "logits_bwd": write(os.path.join(out_dir, "logits_bwd", "aa_fused_bwd.cu"),
                            logits + source("aa_fused_bwd.cu")),
        "one_term": write(os.path.join(out_dir, "one_term", "aa_fused.cu"), source("aa_fused.cu")),
        "one_term_k5": write(os.path.join(out_dir, "one_term", "aa_attention.cu"),
                             source("aa_attention.cu")),
    }
    # the copy's own header lies beside it, so its include finds that first
    write(os.path.join(out_dir, "one_term", "mma_tf32.cuh"),
          one_term_header(source("mma_tf32.cuh")))
    libs = {name: lib for name, (lib, _) in kernel_build.build_copies(sources, out_dir).items()}
    fwd, bwd = K3.configure_fwd(libs["logits_fwd"]), K3.configure_bwd(libs["logits_bwd"])
    fwd.aa_fused_set_logits.argtypes = [ctypes.c_void_p]
    bwd.aa_fused_bwd_set_logits.argtypes = [ctypes.c_void_p]
    return {"logits_fwd": fwd, "logits_bwd": bwd, "one_term": K3.configure_fwd(libs["one_term"]),
            "one_term_k5": K5.configure(libs["one_term_k5"])}


def phase_baseline_kernels(fused, checks: dict) -> tuple:
    """K3 and K4 at the baseline's heads and shape (see the module's
    docstring, phase L); returns the ``h4_*`` numbers of K3's and K4's
    kernels lines."""
    enc = fused.encoder
    Th, A, D, H = enc.historical_steps, NUM_ACTORS, K3.KERNEL_DIM, enc.aa_encoder.attn.num_heads
    shape = (TRAIN_BATCH, Th, A, A)
    model_ws = tuple(w.contiguous() for w in K3.weights_of(K3.pack_aa_params(enc.aa_encoder)))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    cases = {"model weights, keep None": (model_ws, False),
             f"random weights, keep p={K3_DROPOUT:g}": (_random_aa_weights(gen, model_ws), True)}
    k3_abs = k4_abs = 0.0
    one_term = []
    for case, (ws, with_keep) in cases.items():
        q, u, mask, keep = _k3_inputs(shape, with_keep, gen, H)
        g = torch.randn(q.shape, generator=gen, device="cuda")
        p = K3_DROPOUT if with_keep else 0.0
        what = f"{H} heads, {list(shape)}, {case}"
        with torch.no_grad():
            got = K3.fused_pair_attention(q, u, mask, keep, ws, H, p)
            again = K3.fused_pair_attention(q, u, mask, keep, ws, H, p)
            coarse = K3.launch_fwd(checks["one_term"], q, u, mask, keep, ws, H, p)[0]
            want = K3.fused_pair_attention_reference(q, u, mask, keep, ws, H, p)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"aa_fused ({what}) is not finite")
        check(torch.equal(got, again), f"aa_fused ({what}) is not bit-equal across two runs")
        check(bool((got[:, :, ::7] == 0).all()), f"aa_fused ({what}): an empty receiver did not "
              "give exactly 0")
        diff = (got - want).abs().max().item()
        rel = diff / want.abs().max().item()
        one_term.append(((coarse - want).abs().max() / want.abs().max()).item())
        k3_abs = max(k3_abs, diff)
        print(f"[baseline-kernels] aa_fused {what}: bit-equal reruns, max|kernel - plain| "
              f"{diff:.3e} = {rel:.3e} of max|plain| (tight {TOL_K3_TIGHT:g}); the one-term copy "
              f"{one_term[-1]:.3e}", flush=True)
        check(rel <= TOL_K3_TIGHT, f"aa_fused ({what}): {rel:.3e} > TOL_K3_TIGHT")
        del got, again, coarse, want

        out, stats = K3.fused_pair_attention_fwd(q, u, mask, keep, ws, H, p)
        dq, dws = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, H, p, out=out, stats=stats)
        dq2, dws2 = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, H, p, out=out,
                                                stats=stats)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(dq).all()) and all(bool(torch.isfinite(d).all()) for d in dws),
              f"aa_fused_bwd ({what}) is not finite")
        check(torch.equal(dq, dq2) and all(torch.equal(a, b) for a, b in zip(dws, dws2)),
              f"aa_fused_bwd ({what}) is not bit-equal across two runs")
        check(bool((dq[:, :, ::7] == 0).all()), f"aa_fused_bwd ({what}): an empty receiver did "
              "not give exactly 0")
        del dq2, dws2
        if with_keep:  # K4's recomputed logits against K3's, from the check copies
            rows = q.shape[0] * q.shape[1] * q.shape[2] * u.shape[3]
            lg3 = torch.full((rows, H), float("nan"), device="cuda")
            lg4 = torch.full((rows, H), float("nan"), device="cuda")
            check(checks["logits_fwd"].aa_fused_set_logits(lg3.data_ptr()) == 0, "set_logits")
            out3, stats3 = K3.launch_fwd(checks["logits_fwd"], q, u, mask, keep, ws, H, p,
                                         with_stats=True)
            check(checks["logits_bwd"].aa_fused_bwd_set_logits(lg4.data_ptr()) == 0, "set_logits")
            K3.launch_bwd(checks["logits_bwd"], q, u, mask, keep, ws, g, out3, stats3, H, p)
            torch.cuda.synchronize()
            check(not bool(torch.isnan(lg3).any()) and not bool(torch.isnan(lg4).any()),
                  "a pair's logits were not written")
            check(torch.equal(lg3, lg4), f"K4's recomputed logits ({what}) are not K3's")
            check(torch.equal(out3, out) and torch.equal(stats3, stats),
                  "the logits check copy of K3 gave other outputs than K3")
            check(torch.equal(stats[0], lg4.view(stats.shape[1], -1, H).amax(dim=1)),
                  "K3's softmax max is not the max of K4's recomputed logits")
            print(f"[baseline-kernels] aa_fused_bwd {what}: its recomputed logits are K3's bit "
                  f"for bit ({rows * H} logits), K3's softmax max their max", flush=True)
            del lg3, lg4, out3, stats3
        del out, stats
        want_dq, want = K3.fused_pair_attention_bwd_reference(q, u, mask, keep, ws, g, H, p)
        rels = {}
        for k, a, b in zip(("dq", *K3.W_ORDER), (dq, *dws), (want_dq, *want)):
            diff = (a - b).abs().max().item()
            k4_abs = max(k4_abs, diff)
            rels[k] = diff / max(b.abs().max().item(), 1e-30)
            check(rels[k] <= k4_tol(k), f"aa_fused_bwd ({what}) {k}: {rels[k]:.3e} > {k4_tol(k):g}")
        print(f"[baseline-kernels] aa_fused_bwd {what}: bit-equal reruns; max|kernel - plain| / "
              f"max|plain|: " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
              + f" (tol {TOL_K4_SMOOTH:g} {', '.join(K4_SMOOTH_LEAVES)}; {TOL_K4_W:g} the other "
              "weights)", flush=True)
        del q, u, mask, keep, g, dq, dws, want_dq, want
        torch.cuda.empty_cache()
    check(max(one_term) > TOL_K3_TIGHT, f"the one-term copy of K3 passes TOL_K3_TIGHT at {H} "
          f"heads ({max(one_term):.3e})")

    # timed: K3 as the fused forward calls it (model weights, no keep), K4
    # as a fused train step does (keep)
    q, u, mask, keep = _k3_inputs(shape, True, gen, H)
    g = torch.randn(q.shape, generator=gen, device="cuda")
    with torch.no_grad():
        k3_ms = cuda_ms(lambda: K3.fused_pair_attention(q, u, mask, None, model_ws, H))
        k3_plain = cuda_ms(lambda: K3.fused_pair_attention_reference(q, u, mask, None, model_ws,
                                                                     H), runs=5, warmup=1)
    out, stats = K3.fused_pair_attention_fwd(q, u, mask, keep, model_ws, H, K3_DROPOUT)
    k4_ms = cuda_ms(lambda: K3.fused_pair_attention_bwd(q, u, mask, keep, model_ws, g, H,
                                                        K3_DROPOUT, out=out, stats=stats))
    del out, stats
    torch.cuda.empty_cache()
    k4_plain = cuda_ms(lambda: K3.fused_pair_attention_bwd_reference(q, u, mask, keep, model_ws, g,
                                                                     H, K3_DROPOUT),
                       runs=5, warmup=1)
    del q, u, mask, keep, g
    torch.cuda.empty_cache()
    lines = []
    for name, ms, plain, bound, abs_err in (
            ("aa_fused", k3_ms, k3_plain, aa_fused_bound(*shape, D, H, False), k3_abs),
            ("aa_fused_bwd", k4_ms, k4_plain, aa_fused_bwd_bound(*shape, D, H, True), k4_abs)):
        cores, cores_by, flops, nbytes, route, route_by = bound
        print(f"[baseline-kernels] {name} at {H} heads, {list(shape)}: {ms:.3f} ms (median of "
              f"{TIMED_RUNS}), bound {route:.3f} ms by {route_by} on its route (3xTF32 products "
              f"on the tensor cores) and {cores:.3f} ms by {cores_by} on the CUDA cores "
              f"({flops:.3e} flop, {nbytes:.3e} B), {flops / ms / 1e9:.1f} TFLOP/s; plain "
              f"{plain:.3f} ms (median of 5)", flush=True)
        lines.append(dict(h4_shape=list(shape), h4_ms=ms, h4_plain_ms=plain, h4_bound_ms=route,
                          h4_bound_by=route_by, h4_cuda_core_bound_ms=cores,
                          h4_max_abs_err=abs_err))
    lines[0]["h4_one_term_max_rel_err"] = max(one_term)
    return lines[0], lines[1]


def _baseline_engine(model, raws, card: str, tag: str) -> dict:
    """A scan engine over ``model``: pipelined vs serial ``predict`` of
    ``raws`` (launches counted across the pipelined one), timed in 2
    alternating rounds, then BASELINE_SINGLES single scenes."""
    piped, serial = (ServingEngine(model, num_actors=NUM_ACTORS, num_lanes=NUM_LANES,
                                   device="cuda", seed=SEED, max_batch=TRAIN_BATCH)
                     for _ in range(2))
    try:
        check(piped.engine == serial.engine == "scan", f"auto chose {piped.engine}")
        piped.warmup(raws[0])
        serial.warmup(raws[0])
        zero_counts()
        got = piped.predict(raws)
        launches = _counts()
        want = serial.predict(raws, pipeline=False)
        _check_results(got, len(raws), model)
        rel, equal = _results_distance(got, want)
        print(f"[baseline] {tag} scan engine: pipelined vs serial predict of {len(raws)} scenes: "
              f"max rel. difference {rel:.3e} (tol {TOL_PIPELINE:g}), bit-equal {equal}; "
              f"launches {launches}", flush=True)
        check(rel <= TOL_PIPELINE, f"the {tag} scan engine's pipelined predict disagrees with "
              "serial")
        del got, want
        times = {"pipelined": [], "serial": []}
        for r in range(2):
            for mode in (("pipelined", "serial") if r % 2 == 0 else ("serial", "pipelined")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                piped.predict(raws, pipeline=mode == "pipelined")
                times[mode].append(time.perf_counter() - t0)
        engine = {f"{m}_scenes_per_s": len(raws) / statistics.median(t) for m, t in times.items()}
        engine.update(pipeline_rel=rel, pipeline_bit_equal=equal, launches=launches)
        piped.reset_stats()
        for raw in raws[:BASELINE_SINGLES]:
            piped.submit(raw).result(timeout=FUTURE_TIMEOUT_S)
        st = piped.stats()
        check(st["served"] == BASELINE_SINGLES and st["mean_batch"] == 1.0,
              f"single requests {st}")
        engine["single"] = st
        print(f"[baseline] {card}: {tag} scan engine, {len(raws)} scenes a predict in batches "
              f"of {TRAIN_BATCH}, 2 alternating rounds (host clock): pipelined "
              f"{engine['pipelined_scenes_per_s']:.1f} scenes/s, serial "
              f"{engine['serial_scenes_per_s']:.1f}; {BASELINE_SINGLES} single scenes: p50 "
              f"{st['p50_ms']:.2f} ms, p99 {st['p99_ms']:.2f} ms", flush=True)
    finally:
        piped.close()
        serial.close()
    return engine


def phase_baseline(card: str, checks: dict) -> dict:
    """L. The HiVT baseline at the published widths (see the module's
    docstring).  Returns K3's and K4's numbers at 4 heads, and for the
    dense and the fused model the forward's and the train step's times,
    scenes/s, peak memory and launches, and the engine's numbers."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 23)
    scene = _train_batch(rng, TRAIN_BATCH).to("cuda")
    zero = {k: 0 for k in _counts()}
    models = {"dense": build_model(BASELINE, device="cuda", seed=SEED),
              "fused": build_model(BASELINE_TRAIN, device="cuda", seed=SEED)}
    models["fused"].load_state_dict(models["dense"].state_dict())
    out = {}
    out["k3"], out["k4"] = phase_baseline_kernels(models["fused"], checks)

    preds = {}
    for tag, model in models.items():
        with torch.no_grad():
            model(scene)   # warm-up
            zero_counts()
            preds[tag] = model(scene)
            launches = _counts()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: model(scene), runs=5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        pred = preds[tag]
        K, Tf = model.decoder.num_modes, model.decoder.future_steps
        check(pred["loc"].shape == (TRAIN_BATCH, K, NUM_ACTORS, Tf, 4)
              and pred["pi"].shape == (TRAIN_BATCH, NUM_ACTORS, K), f"{tag} baseline output shapes")
        check(all(bool(torch.isfinite(pred[k]).all()) for k in ("loc", "pi")),
              f"non-finite {tag} baseline output")
        want = zero if tag == "dense" else dict(zero, aa_fused=1)
        check(launches == want, f"the {tag} baseline's forward launched {launches}")
        out[tag] = dict(forward_ms=ms, forward_scenes_per_s=TRAIN_BATCH / ms * 1e3,
                        forward_peak_gib=peak, forward_launches=launches)
        print(f"[baseline] {card}: {tag} forward at batch {TRAIN_BATCH}: {ms:.2f} ms (CUDA events, "
              f"median of 5), {TRAIN_BATCH / ms * 1e3:.1f} scenes/s, peak {peak:.2f} GiB; "
              f"launches {launches}", flush=True)
    for k in ("loc", "pi"):
        err = (preds["fused"][k] - preds["dense"][k]).abs().max().item()
        print(f"[baseline] fused vs dense forward, {k}: max |fused - dense| = {err:.3e} "
              f"(tol {TOL_SPLICE:g}) over {tuple(preds['dense'][k].shape)}", flush=True)
        check(err < TOL_SPLICE, f"the fused baseline's {k} disagrees with the dense one")
        out["fused"][f"vs_dense_{k}"] = err
    del preds

    for tag, cfg in (("dense", BASELINE), ("fused", BASELINE_TRAIN)):
        zero_counts()
        times, totals, peak = baseline_train_steps(models[tag], cfg, scene, BASELINE_STEPS)
        launches = _counts()
        ms = statistics.median(times[1:])
        out[tag].update(train_ms=ms, train_step_ms=times, train_scenes_per_s=TRAIN_BATCH / ms * 1e3,
                        train_peak_gib=peak, train_losses=totals, train_launches=launches)
        print(f"[baseline] {card}: {tag} train step at batch {TRAIN_BATCH}: "
              + " ".join(f"{t:.1f}" for t in times) + f" ms (CUDA events; median of the last "
              f"{BASELINE_STEPS - 1} {ms:.1f}), {TRAIN_BATCH / ms * 1e3:.1f} scenes/s, peak "
              f"{peak:.2f} GiB; loss " + " ".join(f"{x:.4f}" for x in totals)
              + f"; launches {launches}", flush=True)
        want = zero if tag == "dense" else dict(zero, aa_fused=BASELINE_STEPS,
                                                aa_fused_bwd=BASELINE_STEPS)
        check(launches == want, f"the {tag} baseline's train steps launched {launches}")
        check(totals[-1] < totals[0], f"the {tag} baseline's loss did not fall")
        models[tag].eval()
    print(f"[baseline] {card}: fused vs dense, batch {TRAIN_BATCH}: forward "
          f"{out['fused']['forward_ms']:.2f} vs {out['dense']['forward_ms']:.2f} ms, train step "
          f"{out['fused']['train_ms']:.1f} vs {out['dense']['train_ms']:.1f} ms, peak "
          f"{out['fused']['train_peak_gib']:.2f} vs {out['dense']['train_peak_gib']:.2f} GiB",
          flush=True)

    raws = [make_raw_scene(rng, i % 2, num_actors=NUM_ACTORS, num_lanes=NUM_LANES)
            for i in range(BASELINE_SCENES)]
    batches = -(-BASELINE_SCENES // TRAIN_BATCH)
    for tag, model in models.items():
        engine = _baseline_engine(model, raws, card, tag)
        want = zero if tag == "dense" else dict(zero, aa_fused=batches)
        check(engine["launches"] == want, f"the {tag} scan engine launched {engine['launches']}")
        out[tag]["engine"] = engine
    print(f"[baseline] phase L: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out

def _capped_models():
    """M1's models: ``FLAGSHIP_CAPPED`` (the ``_tpu_fast`` YAML in f32, cap
    24) with ``decoder.fused: true``, as the H100 config rolls out through
    K1 / K2, and the same weights uncapped (the dense AA block)."""
    cfg = copy.deepcopy(FLAGSHIP_CAPPED)
    cfg["decoder"]["kwargs"]["fused"] = True
    check(cfg["encoder"]["kwargs"]["neighbor_cap"] == CAP
          and not cfg["encoder"]["kwargs"].get("fused", False),
          "FLAGSHIP_CAPPED is not the dense AA block at cap 24")
    dense_cfg = copy.deepcopy(cfg)
    dense_cfg["encoder"]["kwargs"]["neighbor_cap"] = 0
    capped = build_model(cfg, device="cuda", seed=SEED)
    dense = build_model(dense_cfg, device="cuda", seed=SEED)
    dense.load_state_dict(capped.state_dict())
    return cfg, capped, dense


def numpy_overflow(scene, radius: float, cap: int) -> tuple:
    """(edges past ``cap`` summed over every receiver row, in-radius edges,
    the largest in-radius degree) of the flagship's AA block on ``scene``,
    from its masks in numpy: the A actors' rows and the twin's (the focal
    agent's row again)."""
    mask = graph.aa_masks(scene, radius).cpu().numpy()
    agent = scene.agent_index.cpu().numpy()
    twin = mask[np.arange(mask.shape[0]), :, agent][:, :, None]
    deg = np.concatenate([mask, twin], axis=2).sum(-1)
    return int(np.maximum(deg - cap, 0).sum()), int(deg.sum()), int(deg.max())


def phase_capped(card: str) -> dict:
    """M1. ``neighbor_cap`` on the dense AA path at full width, batch 128:
    (a) at the batch's largest in-radius degree (below Ak) the gather drops
    nothing and the forward (pinned encoder and twin noise, the same
    rollout seed) is the dense model's within ``TOL_CAPPED`` of max|dense|;
    (b) at cap 24 ``aa_overflow_edges`` is numpy's count from the masks and
    above 0, one train step is finite and launches K1 and K2 once and K3 /
    K4 never; then the forward and the step of the capped and the dense
    model in turns (CUDA events) with their peak memory.  Returns the
    step's launches and the numbers."""
    t_phase = time.perf_counter()
    cfg, capped, dense = _capped_models()
    enc = capped.encoder
    rng = np.random.default_rng(SEED + 31)
    scene = _train_batch(rng, TRAIN_BATCH).to("cuda")
    B, A, Th, D = TRAIN_BATCH, NUM_ACTORS, enc.historical_steps, enc.embed_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 32)
    en = torch.randn((Th, B, A + 1, D), generator=gen, device="cuda")
    tw = torch.randn((B, 1, Th, 2), generator=gen, device="cuda")
    radius = enc.local_radius
    overflow_np, edges, max_deg = numpy_overflow(scene, radius, CAP)
    check(max_deg < A, f"the batch's largest in-radius degree {max_deg} is not below Ak {A}")
    out = {"max_degree": max_deg, "in_radius_edges": edges}

    exact = copy.deepcopy(capped)
    exact.encoder.aa_encoder.neighbor_cap = max_deg
    with torch.no_grad():
        for m in (capped, dense, exact):
            m.eval()
        want = dense(scene, enc_noise=en, twin_noise=tw, rollout_seed=SEED)
        got = exact(scene, enc_noise=en, twin_noise=tw, rollout_seed=SEED)
        check(int(exact.encoder.aa_encoder.aa_overflow_edges) == 0,
              f"the cap at the largest degree {max_deg} dropped edges")
        for k in ("loc", "pi"):
            rel = ((got[k] - want[k]).abs().max() / want[k].abs().max()).item()
            out[f"exact_vs_dense_{k}"] = rel
            print(f"[capped] cap {max_deg} (the batch's largest in-radius degree, Ak {A}) vs "
                  f"dense, {k}: max|capped - dense| / max|dense| = {rel:.3e} "
                  f"(tol {TOL_CAPPED:g})", flush=True)
            check(rel <= TOL_CAPPED, f"the capped forward's {k} at cap {max_deg} is not the dense "
                  "one")
        del exact, got, want
        capped_out = capped(scene, enc_noise=en, twin_noise=tw, rollout_seed=SEED)
        counted = int(capped.encoder.aa_encoder.aa_overflow_edges)
    check(all(bool(torch.isfinite(capped_out[k]).all()) for k in ("loc", "pi")),
          "non-finite capped forward")
    print(f"[capped] cap {CAP}: aa_overflow_edges {counted}, numpy's count from the masks "
          f"{overflow_np}; {edges} in-radius edges (the twin row's included), "
          f"{100.0 * overflow_np / edges:.2f}% dropped", flush=True)
    check(counted == overflow_np, "aa_overflow_edges is not numpy's count")
    check(counted > 0, f"the batch does not overflow at cap {CAP}")
    out.update(overflow_edges=counted, dropped_share=overflow_np / edges)

    losses = build_losses(cfg)
    steps = {}
    for tag, model in (("capped", capped), ("dense", dense)):
        state = create_train_state(model, cfg["training_specific"], steps_per_epoch=1, seed=SEED)
        steps[tag] = make_train_step(model, state.optimizer, state.scheduler, losses,
                                     torch.device("cuda"))
    zero_counts()
    logs = steps["capped"](scene, 0, SEED)
    launches = _counts()
    total = float(logs["train/total"])
    print(f"[capped] one train step at cap {CAP}: loss {total:.4f}, launches {launches}, "
          f"aa_overflow_edges {int(capped.encoder.aa_encoder.aa_overflow_edges)}", flush=True)
    check(np.isfinite(total) and logs["train/step_skipped"] == 0.0, "non-finite capped step")
    check(launches == {"sde_rollout": 1, "sde_rollout_bwd": 1, "aa_fused": 0, "aa_fused_bwd": 0,
                       "aa_attention": 0, "vpu_probe": 0},
          "the capped train step did not launch K1 and K2 once and K3-K6 never")
    check(int(capped.encoder.aa_encoder.aa_overflow_edges) == overflow_np,
          "the train step's overflow count is not numpy's")
    out["step_launches"] = launches

    times = {tag: {"forward": [], "step": []} for tag in steps}
    peaks = {tag: {} for tag in steps}
    counter = [1]

    def step_once(tag):
        steps[tag](scene, counter[0], SEED)
        counter[0] += 1

    for _ in range(CAPPED_ROUNDS):
        for tag, model in (("capped", capped), ("dense", dense)):
            model.eval()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                times[tag]["forward"].append(
                    cuda_ms(lambda: model(scene, rollout_seed=SEED), runs=3, warmup=1))
            peaks[tag]["forward"] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            times[tag]["step"].append(cuda_ms(lambda: step_once(tag), runs=3, warmup=1))
            peaks[tag]["step"] = torch.cuda.max_memory_allocated() / 2**30
    for tag in steps:
        print(f"[capped] {card}: {tag} at batch {TRAIN_BATCH}: forward "
              + ", ".join(f"{t:.2f}" for t in times[tag]["forward"]) + " ms, train step "
              + ", ".join(f"{t:.2f}" for t in times[tag]["step"])
              + f" ms (CUDA events, medians of 3, {CAPPED_ROUNDS} rounds in turns); peak "
              f"{peaks[tag]['forward']:.2f} GiB forward, {peaks[tag]['step']:.2f} GiB step",
              flush=True)
    out.update(times=times, peaks=peaks)
    del capped, dense, steps, capped_out
    torch.cuda.empty_cache()
    print(f"[capped] phase M1: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def _micro_alone(model, losses, scene, s: int) -> None:
    """One micro-batch's forward, loss and backward as the train step runs it."""
    out = model(scene, generator=torch.Generator(device="cuda").manual_seed(s), rollout_seed=s)
    total = 0.0
    for _, w, fn in losses:
        total = total + w * fn(out["y"], out)
    total.backward()


def phase_accum(d: str, card: str) -> dict:
    """M2. Gradient accumulation and asynchronous checkpoints at full width:
    the splice (one accum-2 update of ``FLAGSHIP_TRAIN_FUSED`` on two fixed
    batches of ACCUM_BATCH, dropout live: its gradients are (g1 + g2) / 2 of
    the micro-batches run alone with the same seeds, bit for bit; K1-K4 once
    per micro-batch), the peak memory of that update beside one step of
    TRAIN_BATCH, the time ``save`` blocks, synchronous against
    asynchronous, in turns, then ``train_torch.main`` with ``--accum 2
    --async-ckpt`` at ACCUM_BATCH on phase I's npz files (K1-K4 once per
    micro-batch, ceil(batches / 2) updates, the checkpoint on the board
    after the run, ``--ckpt`` resumes it)."""
    import train_torch

    t_phase = time.perf_counter()
    cfg = FLAGSHIP_TRAIN_FUSED
    losses = build_losses(cfg)
    rng = np.random.default_rng(SEED + 33)
    micro = [_train_batch(rng, ACCUM_BATCH).to("cuda") for _ in range(2)]
    model = build_model(cfg, device="cuda", seed=SEED).train()
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=1, seed=SEED)
    step = make_train_step(model, state.optimizer, state.scheduler, losses, torch.device("cuda"))
    seeds = micro_seeds(K1.mix_seed(SEED, 0), 2)
    alone = []
    for scene, s in zip(micro, seeds):
        model.zero_grad(set_to_none=True)
        _micro_alone(model, losses, scene, s)
        alone.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logs = step(micro, 0, SEED)
    accum_peak = torch.cuda.max_memory_allocated() / 2**30
    launches = _counts()
    check(logs["train/step_skipped"] == 0.0, "the NaN guard skipped the accumulated update")
    check(launches == {"sde_rollout": 2, "sde_rollout_bwd": 2, "aa_fused": 2, "aa_fused_bwd": 2,
                       "aa_attention": 0, "vpu_probe": 0},
          f"the accum-2 update launched {launches}, not K1-K4 once per micro-batch")
    unequal = [n for n, p in model.named_parameters() if p.grad is not None
               and not torch.equal(p.grad, (alone[0][n] + alone[1][n]) / 2)]
    named = {n for n, p in model.named_parameters() if p.grad is not None}
    check(named == set(alone[0]) == set(alone[1]), "the leaves with a gradient differ")
    print(f"[accum] splice: accum-2 update of two batches of {ACCUM_BATCH} "
          f"(FLAGSHIP_TRAIN_FUSED, dropout live), launches {launches}; {len(named)} gradient "
          f"leaves, {len(named) - len(unequal)} equal to (g1 + g2) / 2 of the micro-batches "
          "alone bit for bit", flush=True)
    check(not unequal, f"accumulated gradients differ from (g1 + g2) / 2 at {unequal[:5]}")
    del alone
    big = _train_batch(rng, TRAIN_BATCH).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(big, 1, SEED)
    full_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[accum] {card}: peak device memory of the accum 2 x {ACCUM_BATCH} update "
          f"{accum_peak:.2f} GiB, of one step of {TRAIN_BATCH} {full_peak:.2f} GiB", flush=True)
    del big, micro

    # the time the epoch loop spends in save(), in turns
    state.step = 2
    blocked = {"sync": [], "async": []}
    landed = []
    with tempfile.TemporaryDirectory() as ck:
        managers = {"sync": CheckpointManager(os.path.join(ck, "sync")),
                    "async": CheckpointManager(os.path.join(ck, "async"), async_save=True)}
        for r in range(SAVE_ROUNDS):
            for mode, mgr in managers.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mgr.save(state, metric=float(r), step=r)
                blocked[mode].append(1e3 * (time.perf_counter() - t0))
                if mode == "async":
                    mgr.wait()
                    landed.append(1e3 * (time.perf_counter() - t0))
        size_mb = os.path.getsize(os.path.join(mgr.latest()["path"], "state.pt")) / 2**20
    print(f"[accum] {card}: save() of the FLAGSHIP_TRAIN_FUSED state ({size_mb:.1f} MiB) "
          "blocks the epoch loop: synchronous " + ", ".join(f"{t:.2f}" for t in blocked["sync"])
          + " ms; asynchronous " + ", ".join(f"{t:.2f}" for t in blocked["async"])
          + " ms (landed after " + ", ".join(f"{t:.2f}" for t in landed) + " ms; host clock, "
          f"{SAVE_ROUNDS} rounds in turns)", flush=True)
    del model, state, step
    torch.cuda.empty_cache()

    n_train = FILE_BATCHES * TRAIN_BATCH // ACCUM_BATCH
    updates = -(-n_train // 2)
    n_eval = -(-CLI_VAL_SCENES // TRAIN_BATCH)
    raw = copy.deepcopy(FLAGSHIP_H100)
    kw = raw["datamodule_specific"]["kwargs"]
    kw.update(train_batch_size=ACCUM_BATCH, nu_dir=os.path.join(d, "npz", "nuScenes"),
              Argo_dir=os.path.join(d, "npz", "Argoverse"))
    cfg_path = os.path.join(d, "h100_accum.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    logdir = os.path.join(d, "logs")
    common = ["-c", cfg_path, "-n", "accum", "--logdir", logdir, "--epochs", "1", "--seed",
              str(SEED), "--accum", "2", "--async-ckpt"]
    want = {"sde_rollout": n_train + n_eval, "sde_rollout_bwd": n_train,
            "aa_fused": n_train + n_eval, "aa_fused_bwd": n_train, "aa_attention": 0,
            "vpu_probe": 0}
    out = {"splice_launches": launches, "accum_peak_gib": accum_peak, "full_peak_gib": full_peak,
           "save_blocked_ms": blocked, "save_landed_ms": landed}
    for tag, extra in (("train", []), ("resume", None)):
        if extra is None:
            board = CheckpointManager(os.path.join(logdir, "accum", "checkpoints"))
            extra = ["--ckpt", board.latest()["path"]]
        zero_counts()
        t0 = time.perf_counter()
        state, trainer = train_torch.main(common + extra)
        wall = time.perf_counter() - t0
        cli = _counts()
        steps = updates * (2 if tag == "resume" else 1)
        epoch = trainer.epoch_logs[-1]
        check(state.step == steps, f"[accum cli {tag}] the run ended at step {state.step}, not "
              f"{steps} (ceil({n_train} / 2) an epoch)")
        check(cli == want, f"[accum cli {tag}] launched {cli}, not K1-K4 once per micro-batch "
              f"and K1 and K3 once per eval batch ({want})")
        check(epoch["train/steps_skipped"] == 0.0, f"[accum cli {tag}] a step was skipped")
        latest = trainer.checkpointer.latest()
        check(trainer.checkpointer.async_save and latest is not None and latest["step"] == steps
              and os.path.isfile(os.path.join(latest["path"], "state.pt")),
              f"[accum cli {tag}] the checkpoint of step {steps} is not on the board")
        vals = {k: v for k, v in epoch.items() if k.startswith("val/")}
        check(vals and all(np.isfinite(v) for v in vals.values()),
              f"[accum cli {tag}] non-finite val metrics {vals}")
        out[f"cli_{tag}"] = dict(launches=cli, steps=state.step, wall_s=wall)
        print(f"[accum] train_torch.py --accum 2 --async-ckpt {tag} at batch {ACCUM_BATCH}: "
              f"{n_train} micro-batches, step {state.step}, launches {cli}, checkpoint "
              f"{os.path.basename(latest['path'])} on the board; val "
              + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()) + f"; {wall:.1f} s",
              flush=True)
    print(f"[accum] phase M2: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def _fused_decoder(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["decoder"]["kwargs"]["fused"] = True
    return cfg


def _bf16_pair(cfg16, cfg32):
    """The bf16 model of ``cfg16`` and the f32 model of ``cfg32``, one
    seeded init (parameters are f32 in both)."""
    m16 = build_model(cfg16, device="cuda", seed=SEED)
    m32 = build_model(cfg32, device="cuda", seed=SEED)
    a, b = m16.state_dict(), m32.state_dict()
    check(list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
          and all(v.dtype == torch.float32 for v in a.values()),
          "the bf16 and the f32 model do not share one f32 parameter tree")
    check(m16.encoder.compute_dtype is torch.bfloat16 and m32.encoder.compute_dtype is None,
          "the models' compute dtypes are not bf16 and f32")
    return m16, m32


def _in_turns(fns: dict, runs: int = 3) -> tuple:
    """CUDA-event medians of each of ``fns`` in BF16_ROUNDS alternating
    rounds, and each one's peak device memory (GiB)."""
    times, peaks = {k: [] for k in fns}, {}
    for _ in range(BF16_ROUNDS):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times[k].append(cuda_ms(fn, runs=runs, warmup=1))
            peaks[k] = torch.cuda.max_memory_allocated() / 2**30
    return times, peaks


def _print_turns(card: str, what: str, times: dict, peaks: dict, tag: str = "bf16",
                 runs: int = 3) -> None:
    print(f"[{tag}] {card}: {what}: " + "; ".join(
        f"{k} " + ", ".join(f"{t:.2f}" for t in v) + f" ms, peak {peaks[k]:.2f} GiB"
        for k, v in times.items()) + f" (CUDA events, medians of {runs}, {BF16_ROUNDS} rounds "
        "in turns)", flush=True)


def _all_f32(model, optimizer) -> bool:
    moments = [v for st in optimizer.state.values() for k, v in st.items()
               if k in ("exp_avg", "exp_avg_sq")]
    return bool(moments) and all(m.dtype == torch.float32 for m in moments) and all(
        p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
        for p in model.parameters())


def _bf16_steps(tag: str, cfg, model, scene) -> tuple:
    """BF16_STEPS train steps of ``model`` on ``scene``: K1 and K2 once per
    step and K3-K6 never, finite losses, every parameter, gradient and AdamW
    moment f32.  Returns (the first step's launches, the step function)."""
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=1, seed=SEED)
    step = make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg),
                           torch.device("cuda"))
    want = {"sde_rollout": 1, "sde_rollout_bwd": 1, "aa_fused": 0, "aa_fused_bwd": 0,
            "aa_attention": 0, "vpu_probe": 0}
    totals, first = [], None
    for i in range(BF16_STEPS):
        zero_counts()
        logs = step(scene, i, SEED)
        launches = _counts()
        first = first or launches
        totals.append(float(logs["train/total"]))
        check(launches == want, f"[{tag}] train step {i} launched {launches}, not K1 and K2 once")
        check(np.isfinite(totals[-1]) and logs["train/step_skipped"] == 0.0,
              f"[{tag}] non-finite train step {i}")
    check(_all_f32(model, state.optimizer),
          f"[{tag}] a parameter, gradient or AdamW moment is not f32 after the steps")
    print(f"[{tag}] {BF16_STEPS} train steps at batch {TRAIN_BATCH}: loss "
          + " ".join(f"{x:.4f}" for x in totals) + f", launches each {first}; every parameter, "
          "gradient and AdamW moment f32", flush=True)
    counter = [BF16_STEPS]

    def again():
        step(scene, counter[0], SEED)
        counter[0] += 1

    return first, again


def phase_bf16(card: str, capped_overflow: int) -> dict:
    """N. bf16 mixed precision at the published widths, batch 128, 48 / 192.
    N1: ``FLAGSHIP_BF16`` (``configs/nusargo/*_tpu.yml``) served through
    ``engine="kernel"`` at bucket 128: K1 once per batch (the bf16 fuse cast
    to f32 rows), loc and pi f32 and finite, mean|pi| within TOL_BF16_PI of
    ``FLAGSHIP``'s on the same weights, scenes and draws; the bf16 loc's distance
    from the f32 one with pinned noise through the models' own forward (the
    scan engine's); served bucket 128 in turns against f32.  N2:
    ``FLAGSHIP_BF16`` with the fused decoder, BF16_STEPS train steps: K1 and
    K2 once each per step, finite losses, parameters, gradients and AdamW
    moments f32; the step in turns against ``FLAGSHIP_TRAIN``'s.  N3:
    ``FLAGSHIP_BF16_CAPPED`` as written (cap 24, dense AA) with the fused
    decoder on phase M1's scenes: ``aa_overflow_edges`` equals M1's count
    (the cap's scores are f32 geometry in both), then the forward and the
    train steps, each in turns against ``FLAGSHIP_CAPPED``'s."""
    t_phase = time.perf_counter()
    out = {}
    # N1: serving
    m16, m32 = _bf16_pair(FLAGSHIP_BF16, FLAGSHIP)
    engine = ServingEngine(m16, num_actors=NUM_ACTORS, num_lanes=NUM_LANES, device="cuda",
                           engine="kernel", seed=SEED)
    requests = _requests(np.random.default_rng(SEED))[TRAIN_BATCH]
    engine.predict(requests[:1])
    zero_counts()
    results = engine.predict(requests)
    served = _counts()
    engine.close()
    _check_results(results, TRAIN_BATCH, m16)
    check(served == {"sde_rollout": 1, "sde_rollout_bwd": 0, "aa_fused": 0, "aa_fused_bwd": 0,
                     "aa_attention": 0, "vpu_probe": 0},
          f"the bf16 engine's bucket {TRAIN_BATCH} launched {served}, not K1 once")
    scene = _train_batch(np.random.default_rng(SEED + 41), TRAIN_BATCH).to("cuda")
    serve16, serve32 = make_serving_fn(m16, "cuda"), make_serving_fn(m32, "cuda")
    # one generator state for both encoders' draws (bf16 draws them in bf16)
    o16, o32 = (serve(scene, SEED, generator=torch.Generator(device="cuda").manual_seed(SEED + 43))
                for serve in (serve16, serve32))
    for k in ("loc", "pi"):
        check(o16[k].dtype == torch.float32 and bool(torch.isfinite(o16[k]).all()),
              f"the bf16 model's served {k} is not finite f32")
    pi16, pi32 = float(o16["pi"].abs().mean()), float(o32["pi"].abs().mean())
    pi_rel = abs(pi16 - pi32) / pi32
    print(f"[bf16] N1 FLAGSHIP_BF16 through the kernel engine at bucket {TRAIN_BATCH}: "
          f"launches {served}; mean|pi| {pi16:.5f} vs {pi32:.5f} in f32, relative {pi_rel:.4f} "
          f"(tol {TOL_BF16_PI})", flush=True)
    check(pi_rel <= TOL_BF16_PI, "the bf16 model's mean|pi| is not the f32 model's")
    B, Th, D = TRAIN_BATCH, m16.encoder.historical_steps, m16.encoder.embed_dim
    K, Tf = m16.decoder.num_modes, m16.decoder.future_steps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    en = torch.randn((Th, B, NUM_ACTORS + 1, D), generator=gen, device="cuda")
    tw = torch.randn((B, 1, Th, 2), generator=gen, device="cuda")
    de = torch.randn((Tf, B, K, NUM_ACTORS, D), generator=gen, device="cuda")
    with torch.inference_mode():
        p16 = m16(scene, enc_noise=en, twin_noise=tw, dec_noise=de)
        p32 = m32(scene, enc_noise=en, twin_noise=tw, dec_noise=de)
    valid = ~scene.padding_mask[:, None, :, -Tf:, None].expand_as(p32["loc"])
    d = (p16["loc"] - p32["loc"])[valid].abs()
    ref = p32["loc"][valid].abs()
    loc_max, loc_mean = float(d.max() / ref.max()), float(d.mean() / ref.mean())
    print(f"[bf16] N1 pinned noise, the models' own forward (the scan engine's): bf16 loc vs "
          f"f32, max|diff| / max|f32| {loc_max:.3e}, mean|diff| / mean|f32| {loc_mean:.3e} "
          "over the valid steps", flush=True)
    times, peaks = _in_turns({"bf16": lambda: serve16(scene, SEED),
                              "f32": lambda: serve32(scene, SEED)})
    _print_turns(card, f"served bucket {TRAIN_BATCH} (FLAGSHIP_BF16 vs FLAGSHIP, K1)", times,
                 peaks)
    out["serve"] = dict(launches=served, pi_rel=pi_rel, loc_max=loc_max, loc_mean=loc_mean,
                        ms=times, peak_gib=peaks)
    del engine, m16, m32, serve16, serve32, o16, o32, p16, p32
    torch.cuda.empty_cache()

    # N2: training with the fused decoder
    m16, m32 = _bf16_pair(_fused_decoder(FLAGSHIP_BF16), FLAGSHIP_TRAIN)
    batch = _train_batch(np.random.default_rng(SEED + 3), TRAIN_BATCH).to("cuda")
    launches, step16 = _bf16_steps("bf16 train", _fused_decoder(FLAGSHIP_BF16), m16, batch)
    _, step32 = _bf16_steps("f32 train", FLAGSHIP_TRAIN, m32, batch)
    times, peaks = _in_turns({"bf16": step16, "f32": step32})
    _print_turns(card, f"train step at batch {TRAIN_BATCH} (FLAGSHIP_BF16 + fused decoder vs "
                 "FLAGSHIP_TRAIN, K1 + K2)", times, peaks)
    out["train"] = dict(launches=launches, ms=times, peak_gib=peaks)
    del m16, m32, step16, step32
    torch.cuda.empty_cache()

    # N3: the _tpu_fast YAML as written, on phase M1's scenes
    cfg16 = _fused_decoder(FLAGSHIP_BF16_CAPPED)
    m16, m32 = _bf16_pair(cfg16, _fused_decoder(FLAGSHIP_CAPPED))
    scene = _train_batch(np.random.default_rng(SEED + 31), TRAIN_BATCH).to("cuda")
    for m in (m16, m32):
        m.eval()
    with torch.no_grad():
        f16 = m16(scene, rollout_seed=SEED)
    counted = int(m16.encoder.aa_encoder.aa_overflow_edges)
    check(all(f16[k].dtype == torch.float32 and bool(torch.isfinite(f16[k]).all())
              for k in ("loc", "pi")), "non-finite bf16 capped forward")
    print(f"[bf16] N3 FLAGSHIP_BF16_CAPPED (cap {CAP}, bf16): aa_overflow_edges {counted}, "
          f"phase M1's count in f32 on the same scenes {capped_overflow}", flush=True)
    check(counted == capped_overflow, "the bf16 cap dropped other edges than the f32 one")
    launches_c, step16 = _bf16_steps("bf16 capped train", cfg16, m16, scene)
    _, step32 = _bf16_steps("f32 capped train", _fused_decoder(FLAGSHIP_CAPPED), m32, scene)

    def forward(m):
        m.eval()
        with torch.no_grad():
            m(scene, rollout_seed=SEED)

    times, peaks = _in_turns({"bf16 forward": lambda: forward(m16),
                              "f32 forward": lambda: forward(m32)})
    _print_turns(card, f"cap {CAP} forward at batch {TRAIN_BATCH} (FLAGSHIP_BF16_CAPPED vs "
                 "FLAGSHIP_CAPPED, fused decoder)", times, peaks)
    stimes, speaks = _in_turns({"bf16 step": lambda: (m16.train(), step16()),
                                "f32 step": lambda: (m32.train(), step32())})
    _print_turns(card, f"cap {CAP} train step at batch {TRAIN_BATCH}", stimes, speaks)
    out["capped"] = dict(launches=launches_c, overflow_edges=counted,
                         ms=dict(times, **stimes), peak_gib=dict(peaks, **speaks))
    del m16, m32, step16, step32
    torch.cuda.empty_cache()
    print(f"[bf16] phase N: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def _adaptive(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["encoder"]["kwargs"]["adaptive"] = True
    return cfg


def _tree_checks() -> dict:
    """O1: the Brownian tree on the card at bucket 128's twin rows."""
    D = FLAGSHIP["encoder"]["kwargs"]["embed_dim"]
    shape = (ADAPTIVE_ROWS, D)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    nodes = torch.randn((2 ** ADAPTIVE_DEPTH,) + shape, generator=gen, device="cuda")
    tree, again = (BrownianTree(0.0, 1.0, shape, ADAPTIVE_DEPTH, nodes) for _ in range(2))

    def at(x):
        return torch.full((), x, device="cuda")

    additive = max(float((tree.increment(at(s), at(u)) + tree.increment(at(u), at(v))
                          - tree.increment(at(s), at(v))).abs().max())
                   for s, u, v in ((0.0, 0.5, 1.0), (0.125, 0.25, 0.75), (0.3, 0.41, 0.97),
                                   (0.0, 0.0625, 0.125)))
    var = {x: float(tree(at(x)).double().var()) / x for x in (0.25, 0.5, 1.0)}
    qs = (0.75, 0.25, 1.0, 0.5, 0.0, 0.33)
    first = [tree(at(x)) for x in qs]
    order = all(torch.equal(a, b) for a, b in zip(first, [again(at(x)) for x in qs[::-1]][::-1]))
    cpu = BrownianTree(0.0, 1.0, shape, ADAPTIVE_DEPTH, nodes.cpu())
    vs_cpu = float((tree.leaves.cpu() - cpu.leaves).abs().max())
    print(f"[adaptive] O1 tree {shape}, depth {ADAPTIVE_DEPTH}, on the card: additivity "
          f"{additive:.3e} (tol {TOL_TREE:g}), var W(t) / t " + ", ".join(
              f"t={x}: {v:.4f}" for x, v in var.items()) + f", query order bit-equal {order}, "
          f"max|card - CPU| over the {cpu.leaves.shape[0]} leaves {vs_cpu:.3e} (tol "
          f"{TOL_TREE:g})", flush=True)
    check(additive <= TOL_TREE, "the tree on the card is not additive")
    check(all(abs(v - 1.0) <= 0.05 for v in var.values()), "var W(t) is not t within 5%")
    check(order, "the tree's values depend on the order of the queries")
    check(vs_cpu <= TOL_TREE, "the tree on the card is not the CPU's on the same nodes")
    return dict(additivity=additive, var_over_t=var, order_bit_equal=order, vs_cpu=vs_cpu)


def _ou_check() -> dict:
    """O2: JAX's Ornstein-Uhlenbeck case (tests/test_adaptive.py) on the
    card, and the CPU on the same nodes."""
    theta, mu, sigma, n = 1.0, 0.3, 0.5, 8192
    gen = torch.Generator(device="cuda").manual_seed(SEED + 52)
    nodes = torch.randn((2 ** 10, n, 1), generator=gen, device="cuda")
    runs = {}
    for dev in ("cuda", "cpu"):
        ys, st = sdeint_adaptive(lambda t, y: theta * (mu - y),
                                 lambda t, y: torch.full_like(y, sigma),
                                 torch.full((n, 1), 1.5, device=dev),
                                 torch.tensor([0.0, 1.0], device=dev), dt0=0.05, rtol=2e-3,
                                 atol=2e-3, max_steps=128, depth=10, nodes=nodes.to(dev))
        runs[dev] = (ys, {k: float(v) for k, v in st.items()})
    ys, st = runs["cuda"]
    ms = cuda_ms(lambda: sdeint_adaptive(
        lambda t, y: theta * (mu - y), lambda t, y: torch.full_like(y, sigma),
        torch.full((n, 1), 1.5, device="cuda"), torch.tensor([0.0, 1.0], device="cuda"),
        dt0=0.05, rtol=2e-3, atol=2e-3, max_steps=128, depth=10, nodes=nodes), runs=3, warmup=1)
    mean_ref, var_ref = (float(v) for v in ou_moments(1.5, theta, mu, sigma, 1.0))
    samples = ys[0, :, 0].double()
    mean, var = float(samples.mean()), float(samples.var(unbiased=False))
    vs_cpu = float((ys.cpu() - runs["cpu"][0]).abs().max())
    print(f"[adaptive] O2 OU on the card, {n} paths, depth 10: accepted {st['n_accepted']:.0f}, "
          f"rejected {st['n_rejected']:.0f}, converged {bool(st['converged'])}, final dt "
          f"{st['final_dt']:.4g}; mean {mean:.4f} (analytic {mean_ref:.4f}, tol 0.03), var "
          f"{var:.4f} (analytic {var_ref:.4f}, rtol 0.15); the CPU on the same nodes: counts "
          f"{runs['cpu'][1]}, max|card - CPU| {vs_cpu:.3e}; {ms:.2f} ms a solve (CUDA events, "
          f"128 iterations)", flush=True)
    check(bool(st["converged"]), "the OU solve did not reach t = 1")
    check(abs(mean - mean_ref) <= 0.03 and abs(var / var_ref - 1.0) <= 0.15,
          "the OU moments are off")
    return dict(stats=st, cpu_stats=runs["cpu"][1], mean=mean, var=var, vs_cpu=vs_cpu, ms=ms)


@torch.inference_mode()
def _encoder_vs_cpu() -> dict:
    """O3: the adaptive fused encoder on the card vs the port on the CPU."""
    cfg = _adaptive(FLAGSHIP_FUSED)
    card_model = build_model(cfg, device="cuda", seed=SEED)
    cpu_model = build_model(cfg, device="cpu", seed=SEED)
    enc = cpu_model.encoder
    B, Th, D = ADAPTIVE_SCENES, enc.historical_steps, enc.embed_dim
    scene = _train_batch(np.random.default_rng(SEED + 53), B)
    gen = torch.Generator().manual_seed(SEED + 54)
    tw = torch.randn((B, 1, Th, 2), generator=gen)
    nodes = torch.randn((Th, 2 ** ADAPTIVE_DEPTH, B, NUM_ACTORS + 1, D), generator=gen)
    zero_counts()
    got = card_model.encoder(scene.to("cuda"), twin_noise=tw.cuda(), sde_nodes=nodes.cuda())
    launches = _counts()
    want = enc(scene, twin_noise=tw, sde_nodes=nodes)
    errs = {k: float((g.cpu() - w).abs().max() / w.abs().max().clamp_min(1e-30))
            for k, g, w in zip(("local", "diff_in", "diff_out"), got, want)}
    print(f"[adaptive] O3 the adaptive FLAGSHIP_FUSED encoder on the card vs the CPU, {B} scenes, "
          f"pinned twin noise and tree nodes: max|card - CPU| / max|CPU| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {TOL_ADAPTIVE_CPU:g}); launches on the card {launches}", flush=True)
    check(all(v <= TOL_ADAPTIVE_CPU for v in errs.values()),
          "the adaptive encoder on the card disagrees with the CPU")
    check(launches["aa_fused"] == 1, "the adaptive encoder did not launch K3 once")
    return errs


def _adaptive_steps(tag: str, cfg, model, scene) -> tuple:
    """ADAPTIVE_STEPS train steps of ``model`` on ``scene``: K1-K4 once per
    step and K5 / K6 never, finite losses, finite non-zero gradients on the
    three SDE nets of the ODE-RNN.  Returns (the first step's launches, the
    losses, the step function)."""
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=1, seed=SEED)
    step = make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg),
                           torch.device("cuda"))
    want = {"sde_rollout": 1, "sde_rollout_bwd": 1, "aa_fused": 1, "aa_fused_bwd": 1,
            "aa_attention": 0, "vpu_probe": 0}
    rnn = model.encoder.sde_rnn
    totals, first = [], None
    for i in range(ADAPTIVE_STEPS):
        zero_counts()
        logs = step(scene, i, SEED)
        launches = _counts()
        first = first or launches
        totals.append(float(logs["train/total"]))
        check(launches == want, f"[{tag}] train step {i} launched {launches}, not K1-K4 once")
        check(np.isfinite(totals[-1]) and logs["train/step_skipped"] == 0.0,
              f"[{tag}] non-finite train step {i}")
        for name in ("f_func", "g_nus", "g_argo"):
            grads = [p.grad for p in getattr(rnn, name).parameters()]
            check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
                  and any(float(g.abs().max()) > 0 for g in grads),
                  f"[{tag}] step {i}: the gradient of {name} is missing, non-finite or 0")
    print(f"[{tag}] {ADAPTIVE_STEPS} train steps at batch {TRAIN_BATCH}: loss "
          + " ".join(f"{x:.4f}" for x in totals) + f", launches each {first}; f_func, g_nus and "
          "g_argo gradients finite and non-zero", flush=True)
    counter = [ADAPTIVE_STEPS]

    def again():
        step(scene, counter[0], SEED)
        counter[0] += 1

    return first, totals, again


def phase_adaptive(card: str) -> dict:
    """O. ``encoder.adaptive: true`` on the card: the tree (O1), the solver
    (O2), the encoder vs the CPU (O3), serving (O4) and training (O5); see
    the module docstring."""
    t_phase = time.perf_counter()
    out = {"tree": _tree_checks(), "ou": _ou_check(), "encoder_vs_cpu": _encoder_vs_cpu()}
    torch.cuda.empty_cache()

    # O4: serving at bucket 128
    ada = build_model(_adaptive(FLAGSHIP_FUSED), device="cuda", seed=SEED)
    fix = build_model(FLAGSHIP_FUSED, device="cuda", seed=SEED)
    engine = ServingEngine(ada, num_actors=NUM_ACTORS, num_lanes=NUM_LANES, device="cuda",
                           seed=SEED)
    requests = _requests(np.random.default_rng(SEED))[TRAIN_BATCH]
    engine.predict(requests[:1])
    zero_counts()
    results = engine.predict(requests)
    served = _counts()
    engine.close()
    _check_results(results, TRAIN_BATCH, ada)
    check(served == {"sde_rollout": 1, "sde_rollout_bwd": 0, "aa_fused": 1, "aa_fused_bwd": 0,
                     "aa_attention": 0, "vpu_probe": 0},
          f"the adaptive engine's bucket {TRAIN_BATCH} launched {served}, not K3 and K1 once")
    print(f"[adaptive] O4 ServingEngine.predict over the adaptive FLAGSHIP_FUSED at bucket "
          f"{TRAIN_BATCH}: launches {served}; loc and pi finite", flush=True)
    scene = _train_batch(np.random.default_rng(SEED + 55), TRAIN_BATCH).to("cuda")
    serve_a, serve_f = make_serving_fn(ada, "cuda"), make_serving_fn(fix, "cuda")

    def encode(m):
        with torch.inference_mode():
            m.encoder(scene)

    # one run a round: an adaptive call takes 0.6-0.8 s, most of it the host
    times, peaks = _in_turns({"adaptive": lambda: serve_a(scene, SEED),
                              "fixed": lambda: serve_f(scene, SEED),
                              "adaptive encoder": lambda: encode(ada),
                              "fixed encoder": lambda: encode(fix)}, runs=1)
    _print_turns(card, f"served bucket {TRAIN_BATCH} (FLAGSHIP_FUSED, adaptive vs fixed grid, "
                 "K3 + K1) and its encoder alone", times, peaks, "adaptive", runs=1)
    out["serve"] = dict(launches=served, ms=times, peak_gib=peaks)
    del engine, ada, fix, serve_a, serve_f
    torch.cuda.empty_cache()

    # O5: training with both fused paths
    cfg_a = _adaptive(FLAGSHIP_TRAIN_FUSED)
    ada = build_model(cfg_a, device="cuda", seed=SEED)
    fix = build_model(FLAGSHIP_TRAIN_FUSED, device="cuda", seed=SEED)
    batch = _train_batch(np.random.default_rng(SEED + 3), TRAIN_BATCH).to("cuda")
    launches, losses, step_a = _adaptive_steps("adaptive train", cfg_a, ada, batch)
    _, fixed_losses, step_f = _adaptive_steps("fixed train", FLAGSHIP_TRAIN_FUSED, fix, batch)
    # one run a round (an adaptive step takes about 2 s; U11 times it against its graph)
    times, peaks = _in_turns({"adaptive": step_a, "fixed": step_f}, runs=1)
    _print_turns(card, f"train step at batch {TRAIN_BATCH} (FLAGSHIP_TRAIN_FUSED, adaptive vs "
                 "fixed grid, K1-K4)", times, peaks, "adaptive", runs=1)
    out["train"] = dict(launches=launches, losses=losses, fixed_losses=fixed_losses, ms=times,
                        peak_gib=peaks)
    del ada, fix, step_a, step_f
    torch.cuda.empty_cache()
    print(f"[adaptive] phase O: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def _remat(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["encoder"]["kwargs"]["remat"] = True
    return cfg


def _launches(k1: bool, k3: int, k4: int, k2: bool = None) -> dict:
    k2 = k1 if k2 is None else k2
    return {"sde_rollout": int(k1), "sde_rollout_bwd": int(k2), "aa_fused": k3,
            "aa_fused_bwd": k4, "aa_attention": 0, "vpu_probe": 0}


def _remat_compare(tag: str, cfg, plain, remat, scene) -> dict:
    """One train step of each model on ``scene``, dropout live, every draw
    from a CUDA generator of one seed (the decoder's rollout from one seed
    too): the loss and every gradient by phase F's bar, the generators left
    in one state, and the remat step's launches.  Then one eval batch of
    each, bit for bit, with its launches."""
    fused = bool(cfg["encoder"]["kwargs"].get("fused", False))
    sde = bool(cfg["decoder"]["kwargs"].get("fused", False))    # K1 / K2 roll it out
    outs, gens, launched = {}, {}, {}
    for name, model in (("plain", plain), ("remat", remat)):
        gens[name] = torch.Generator(device="cuda").manual_seed(SEED + 43)
        model.zero_grad(set_to_none=True)
        zero_counts()
        loss = _losses_of(cfg, model(scene, generator=gens[name], rollout_seed=SEED + 44))
        loss.backward()
        torch.cuda.synchronize()
        launched[name] = _counts()
        outs[name] = loss.detach()
    print(f"[remat] {tag}: launches of one train step, remat {launched['remat']}, plain "
          f"{launched['plain']}", flush=True)
    check(launched["remat"] == _launches(sde, 2 if fused else 0, int(fused)),
          f"{tag}: the remat step did not launch K3 twice and K4 once (fused AA), K1 and K2 "
          "once (the SDE decoder), and nothing else")
    check(launched["plain"] == _launches(sde, int(fused), int(fused)),
          f"{tag}: the plain step's launches changed")
    _check_step(f"remat {tag}", "plain step", outs["remat"], outs["plain"], remat, plain,
                batch=TRAIN_BATCH)
    bits = all(torch.equal(a.grad, b.grad) if a.grad is not None else b.grad is None
               for a, b in zip(remat.parameters(), plain.parameters()))
    same_gen = torch.equal(gens["remat"].get_state(), gens["plain"].get_state())
    print(f"[remat] {tag}: gradients bit-equal to the plain step's: {bits}; loss bit-equal: "
          f"{torch.equal(outs['remat'], outs['plain'])}; the generator where the plain step "
          f"left it: {same_gen}", flush=True)
    check(same_gen, f"{tag}: the remat step left its generator elsewhere than the plain step")

    evals, ev = {}, {}
    for name, model in (("plain", plain), ("remat", remat)):
        model.eval()
        zero_counts()
        with torch.no_grad():
            out = model(scene, generator=torch.Generator(device="cuda").manual_seed(SEED + 45),
                        rollout_seed=SEED + 46)
        torch.cuda.synchronize()
        ev[name] = _counts()
        evals[name] = {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}
        model.train()
    check(ev["remat"] == ev["plain"] == _launches(sde, int(fused), 0, k2=False),
          f"{tag}: an eval batch launched {ev['remat']} (plain {ev['plain']}), not K3 (fused "
          "AA) and K1 (SDE decoder) once")
    check(evals["remat"].keys() == evals["plain"].keys() and all(
        torch.equal(evals["remat"][k], evals["plain"][k]) for k in evals["plain"]),
        f"{tag}: the remat model's eval batch differs from the plain one")
    print(f"[remat] {tag}: eval batch of {TRAIN_BATCH} bit-equal to the plain build's, launches "
          f"{ev['remat']}", flush=True)
    return dict(step_launches=launched["remat"], plain_step_launches=launched["plain"],
                grads_bit_equal=bits, eval_launches=ev["remat"])


def _remat_steps(tag: str, cfg, model, scene, want: dict) -> tuple:
    """REMAT_STEPS train steps of ``model`` through ``make_train_step``, each
    launching ``want``, finite; returns (the losses, the step function)."""
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=1, seed=SEED)
    step = make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg),
                           torch.device("cuda"))
    totals = []
    for i in range(REMAT_STEPS):
        zero_counts()
        logs = step(scene, i, SEED)
        launches = _counts()
        totals.append(float(logs["train/total"]))
        check(launches == want, f"[{tag}] train step {i} launched {launches}, not {want}")
        check(np.isfinite(totals[-1]) and logs["train/step_skipped"] == 0.0,
              f"[{tag}] non-finite train step {i}")
    counter = [REMAT_STEPS]

    def again():
        step(scene, counter[0], SEED)
        counter[0] += 1

    return totals, again


def phase_remat(card: str) -> dict:
    """P. ``encoder.remat: true`` (the AA and AL blocks rematerialized in the
    backward) on each of REMAT_BUILDS at batch 128, against the plain build
    on the same seeded weights; see the module docstring."""
    t_phase = time.perf_counter()
    scene = _train_batch(np.random.default_rng(SEED + 61), TRAIN_BATCH).to("cuda")
    out = {}
    for tag, cfg in REMAT_BUILDS.items():
        plain = build_model(cfg, device="cuda", seed=SEED + 41).train()
        remat = build_model(_remat(cfg), device="cuda", seed=SEED + 41).train()
        remat.load_state_dict(plain.state_dict())
        check(remat.encoder.remat and not plain.encoder.remat, f"{tag}: remat did not build")
        res = _remat_compare(tag, cfg, plain, remat, scene)
        want = res["step_launches"]
        losses_r, step_r = _remat_steps(f"remat {tag}", _remat(cfg), remat, scene, want)
        losses_p, step_p = _remat_steps(f"plain {tag}", cfg, plain, scene,
                                        res["plain_step_launches"])
        print(f"[remat] {tag}: {REMAT_STEPS} train steps through make_train_step, losses remat "
              + " ".join(f"{x:.4f}" for x in losses_r) + ", plain "
              + " ".join(f"{x:.4f}" for x in losses_p) + f"; launches each {want}", flush=True)
        times, peaks = _in_turns({"remat": step_r, "plain": step_p})
        _print_turns(card, f"train step at batch {TRAIN_BATCH} ({tag}, remat vs plain)", times,
                     peaks, "remat")
        res.update(ms=times, peak_gib=peaks, losses=losses_r, plain_losses=losses_p)
        out[tag] = res
        del plain, remat, step_r, step_p
        torch.cuda.empty_cache()
    print(f"[remat] phase P: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out

def _step_turns(fns: dict, rounds: int = MULTI_ROUNDS, runs: int = 3) -> dict:
    """Each of ``fns`` (a train step that ends by reading its NaN guard)
    after one warm-up call, ``runs`` calls a round in alternating rounds:
    {name: {"cuda": [ms], "host": [ms]}}, CUDA events and the host clock
    around each synchronized call."""
    for fn in fns.values():
        fn()
    out = {k: {"cuda": [], "host": []} for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            for _ in range(runs):
                out[k]["cuda"].append(0.0)
                out[k]["host"].append(0.0)
                out[k]["cuda"][-1], out[k]["host"][-1] = _timed(fn)
    return out


def _timed(fn) -> tuple:
    """(CUDA-event ms, host-clock ms) of one synchronized call of ``fn``."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), 1e3 * (time.perf_counter() - t0)


def _same_state(a: dict, b: dict) -> bool:
    """Two ``state.pt`` payloads equal bit for bit: weights, AdamW moments
    and param groups, schedule, step and seed."""
    if a.keys() != b.keys() or a["model"].keys() != b["model"].keys():
        return False
    if not all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"]):
        return False
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    if sa.keys() != sb.keys() or any(sa[i].keys() != sb[i].keys() for i in sa):
        return False
    if not all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i]):
        return False
    return (a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
            and a["scheduler"] == b["scheduler"] and (a["step"], a["seed"]) == (b["step"], b["seed"]))


def _multi_one_rank(d: str, card: str) -> dict:
    """Q1. One NCCL rank on the card: ``train_torch.main --multihost --zero1``
    on phase J's config and npz files for one epoch, against phase J's plain
    first epoch; then its step against the plain one, in turns."""
    import train_torch
    from torch.distributed.optim import ZeroRedundancyOptimizer

    cfg_path, logdir = os.path.join(d, "h100.json"), os.path.join(d, "logs")
    stem = f"step_{FILE_BATCHES:08d}"
    plain_file = os.path.join(logdir, "cli", "checkpoints", stem, "state.pt")
    check(os.path.isfile(plain_file), f"phase J's checkpoint {stem} is gone")
    cfg, losses = FLAGSHIP_TRAIN_FUSED, build_losses(FLAGSHIP_TRAIN_FUSED)
    scene = _train_batch(np.random.default_rng(SEED + 71), TRAIN_BATCH).to("cuda")

    def stepper(zero1: bool):
        """A train step at TRAIN_BATCH: its collectives skipped outside the
        group (plain), one NCCL rank's all-reduces inside it (and ZeRO-1)."""
        model = build_model(cfg, device="cuda", seed=SEED)
        state = create_train_state(model, cfg["training_specific"], steps_per_epoch=100,
                                   seed=SEED, zero1=zero1)
        step = make_train_step(model, state.optimizer, state.scheduler, losses,
                               torch.device("cuda"))

        def run():
            logs = step(scene, state.step, SEED)
            state.step += 1
            check(logs["train/step_skipped"] == 0.0, "the NaN guard skipped a timed step")
        return run

    plain = stepper(False)
    n_eval = -(-CLI_VAL_SCENES // TRAIN_BATCH)
    want = {"sde_rollout": FILE_BATCHES + n_eval, "sde_rollout_bwd": FILE_BATCHES,
            "aa_fused": FILE_BATCHES + n_eval, "aa_fused_bwd": FILE_BATCHES,
            "aa_attention": 0, "vpu_probe": 0}
    env = {"TRAJSDE_COORDINATOR": f"file://{os.path.join(d, 'rdzv_q1')}",
           "TRAJSDE_NUM_PROCESSES": "1", "TRAJSDE_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        world = mesh.init_multihost(timeout_s=RANK_TIMEOUT_S)
        backend = torch.distributed.get_backend()
        check(world == 1 and backend == "nccl", f"a group of {world} over {backend}, not one "
              "NCCL rank")
        zero_counts()
        t0 = time.perf_counter()
        state, trainer = train_torch.main(["-c", cfg_path, "-n", "multi", "--logdir", logdir,
                                           "--epochs", "1", "--seed", str(SEED), "--multihost",
                                           "--zero1"])
        wall = time.perf_counter() - t0
        launches = _counts()
        print(f"[multi] Q1 train_torch.py --multihost --zero1, one NCCL rank: step {state.step}, "
              f"launches {launches}; {wall:.1f} s", flush=True)
        check(isinstance(state.optimizer, ZeroRedundancyOptimizer), "--zero1 built no ZeRO-1")
        check(state.step == FILE_BATCHES and launches == want,
              f"[multi] launched {launches} in {state.step} steps, not K1-K4 once per update "
              f"and K1 and K3 once per eval batch ({want})")
        check(trainer.epoch_logs[-1]["train/steps_skipped"] == 0.0, "[multi] a step was skipped")
        mine_file = os.path.join(logdir, "multi", "checkpoints", stem, "state.pt")
        mine = torch.load(mine_file, map_location="cpu", weights_only=True)
        same = _same_state(mine, torch.load(plain_file, map_location="cpu", weights_only=True))
        print(f"[multi] Q1 checkpoint {stem} against phase J's plain run: weights, AdamW moments, "
              f"schedule {'bit-equal' if same else 'DIFFER'}", flush=True)
        check(same, "a world of one changed the training: the --multihost --zero1 checkpoint "
              "differs from the plain run's")
        times = _step_turns({"plain": plain, "one NCCL rank": stepper(False),
                             "one NCCL rank + ZeRO-1": stepper(True)})
    finally:
        mesh.shutdown()
        for k in env:
            os.environ.pop(k, None)
    # the ZeRO-1 checkpoint resumes in a plain (single-process) state
    other = create_train_state(build_model(FLAGSHIP_H100, device="cuda", seed=SEED + 9),
                               FLAGSHIP_H100["training_specific"], steps_per_epoch=FILE_BATCHES)
    CheckpointManager(os.path.join(logdir, "multi", "checkpoints")).restore(
        other, os.path.dirname(mine_file))
    resumed = CheckpointManager(os.path.join(d, "resumed"))
    resumed.save(other, None, other.step)
    back = torch.load(os.path.join(resumed.latest()["path"], "state.pt"), map_location="cpu",
                      weights_only=True)
    check(_same_state(back, mine), "the ZeRO-1 checkpoint does not resume in a plain run")
    print(f"[multi] Q1 the checkpoint resumes in a plain AdamW at step {other.step}, bit for bit",
          flush=True)
    print(f"[multi] {card}: train step at batch {TRAIN_BATCH} (FLAGSHIP_TRAIN_FUSED), plain vs "
          "one NCCL rank (the step's all-reduces of one rank) and with ZeRO-1 (and ZeRO's "
          "bookkeeping): "
          + "; ".join(f"{k} CUDA events " + ", ".join(f"{t:.1f}" for t in v["cuda"])
                      + " ms, host clock " + ", ".join(f"{t:.1f}" for t in v["host"]) + " ms"
                      for k, v in times.items())
          + f" ({MULTI_ROUNDS} rounds of 3 in turns)", flush=True)
    return dict(launches=launches, wall_s=wall, ms=times)


def multi_rank_worker(rank: int, world: int, work: str, backend: str) -> None:
    """One rank of phase Q2, in a process of its own: ``FLAGSHIP_TRAIN_FUSED``
    (dropout 0) at MULTI_BATCH global scenes with ``_splice_train_inputs``'
    pinned noise, this rank's slice of each.  One AdamW update (its loss and
    the all-reduced gradients kept), MULTI_STEPS - 1 more, then MULTI_STEPS
    ZeRO-1 updates of a fresh copy (K1-K4 counted over both runs), then
    MULTI_TIMED more, timed.  Writes ``<work>/rank<rank>.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_build.load_all(KERNELS)
    mesh.init_multihost(backend=backend, timeout_s=RANK_TIMEOUT_S)
    try:
        cfg = _no_dropout(FLAGSHIP_TRAIN_FUSED)
        losses = build_losses(cfg)
        models = [build_model(cfg, device="cuda", seed=SEED + 5).train() for _ in range(2)]
        scene, *noise = _splice_train_inputs(models[0], MULTI_BATCH)
        scene = mesh.shard_batch(scene, rank, world)
        en, tw, de = (mesh.shard_batch(n, rank, world, ax).contiguous()
                      for n, ax in zip(noise, (1, 0, 1)))
        del noise
        out = {"device": str(torch.cuda.current_device()), "scenes": int(scene.x.shape[0])}
        zero_counts()
        for zero1, model in zip((False, True), models):
            state = create_train_state(model, cfg["training_specific"], steps_per_epoch=100,
                                       seed=SEED, zero1=zero1)
            step = make_train_step(_PinnedFused(model, en, tw, de), state.optimizer,
                                   state.scheduler, losses, torch.device("cuda"))
            for k in range(MULTI_STEPS):
                logs = step(scene, k, SEED)
                check(logs["train/step_skipped"] == 0.0, f"rank {rank}: a step was skipped")
                if k == 0 and not zero1:
                    out["total"] = float(logs["train/total"])
                    out["grads"] = {n: None if p.grad is None else p.grad.cpu()
                                    for n, p in model.named_parameters()}
            out["zero1" if zero1 else "replicated"] = {
                n: p.detach().cpu() for n, p in model.named_parameters()}
        out["launches"] = _counts()
        times = [_timed(lambda: step(scene, MULTI_STEPS, SEED)) for _ in range(MULTI_TIMED)]
        out["ms_cuda"], out["ms_host"] = [t[0] for t in times], [t[1] for t in times]
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        torch.distributed.barrier()
    finally:
        mesh.shutdown()


def _multi_two_ranks(card: str) -> dict:
    """Q2. Two ranks in processes of their own: over gloo, both on this
    card (NCCL refuses two ranks on one device), or over NCCL, one card
    each, when the machine has two; see :func:`multi_rank_worker`."""
    t0 = time.perf_counter()
    cfg = _no_dropout(FLAGSHIP_TRAIN_FUSED)
    model = build_model(cfg, device="cuda", seed=SEED + 5).train()
    scene, en, tw, de = _splice_train_inputs(model, MULTI_BATCH)
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=100, seed=SEED)
    step = make_train_step(_PinnedFused(model, en, tw, de), state.optimizer, state.scheduler,
                           build_losses(cfg), torch.device("cuda"))
    total = float(step(scene, 0, SEED)["train/total"])
    grads = {n: None if p.grad is None else p.grad.cpu() for n, p in model.named_parameters()}
    del model, state, step, scene, en, tw, de
    torch.cuda.empty_cache()

    n_cards = torch.cuda.device_count()
    backend, world = ("nccl" if n_cards >= 2 else "gloo"), 2
    how = (f"NCCL, one rank per card (cards 0 and 1 of {n_cards})" if backend == "nccl" else
           "gloo, both ranks on card 0 (a figure of gloo on one card: it says nothing of NCCL "
           "across cards)")
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as work:
        logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in range(world)]
        procs = []
        for r in range(world):
            env = dict(os.environ, TRAJSDE_COORDINATOR=f"file://{os.path.join(work, 'rdzv')}",
                       TRAJSDE_NUM_PROCESSES=str(world), TRAJSDE_PROCESS_ID=str(r),
                       LOCAL_RANK=str(r if backend == "nccl" else 0))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke; chip_smoke.multi_rank_worker("
                 f"{r}, {world}, {work!r}, {backend!r})"],
                cwd=here, env=env, stdout=logs[r], stderr=subprocess.STDOUT))
        try:
            for p in procs:
                p.wait(timeout=max(1.0, RANK_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(work, f"rank{r}.log")) as f:
                    print(f.read()[-6000:], flush=True)
            check(p.returncode == 0, f"[multi] Q2 rank {r} failed or hung (exit {p.returncode}) "
                  f"within {RANK_TIMEOUT_S} s")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=True)
                 for r in range(world)]
    print(f"[multi] Q2 two ranks over {how}: {ranks[0]['scenes']} + {ranks[1]['scenes']} scenes "
          f"on cards {ranks[0]['device']} and {ranks[1]['device']}", flush=True)
    grads_equal = all((a is None and b is None) or torch.equal(a, b)
                      for a, b in zip(ranks[0]["grads"].values(), ranks[1]["grads"].values()))
    print(f"[multi] Q2 the all-reduced gradients of the two ranks are "
          f"{'bit-equal' if grads_equal else 'NOT bit-equal'}", flush=True)
    _check_grads("multi", "single-process step on the whole batch", ranks[0]["total"], total,
                 ranks[0]["grads"], grads, MULTI_BATCH)
    zero, rep = ranks[0]["zero1"], ranks[0]["replicated"]
    check(all(torch.equal(zero[k], ranks[1]["zero1"][k]) for k in zero),
          f"[multi] after {MULTI_STEPS} ZeRO-1 updates the ranks' parameters differ")
    far = [k for k in zero if not torch.allclose(zero[k], rep[k], rtol=1e-5, atol=1e-7)]
    worst = max(float(((zero[k] - rep[k]).abs() / (1e-7 + 1e-5 * rep[k].abs())).max())
                for k in zero)
    same = all(torch.equal(zero[k], rep[k]) for k in zero)
    print(f"[multi] Q2 after {MULTI_STEPS} AdamW updates: ZeRO-1 parameters bit-equal across the "
          f"ranks; against the replicated run the worst |diff| is {worst:.3f} of 1e-7 + 1e-5 "
          f"|replicated| ({'bit-equal' if same else 'not bit-equal'})", flush=True)
    check(not far, f"[multi] ZeRO-1 is off the replicated run at {far[:5]}")
    want = {"sde_rollout": 2 * MULTI_STEPS, "sde_rollout_bwd": 2 * MULTI_STEPS,
            "aa_fused": 2 * MULTI_STEPS, "aa_fused_bwd": 2 * MULTI_STEPS,
            "aa_attention": 0, "vpu_probe": 0}
    for r, res in enumerate(ranks):
        print(f"[multi] Q2 rank {r} launches over {2 * MULTI_STEPS} updates: {res['launches']}",
              flush=True)
        check(res["launches"] == want, f"[multi] rank {r} launched {res['launches']}, not "
              f"K1-K4 once per update ({want})")
    print(f"[multi] {card}: Q2 ZeRO-1 step at {MULTI_BATCH // world} scenes a rank over {how}: "
          + "; ".join(f"rank {r} CUDA events " + ", ".join(f"{t:.1f}" for t in res["ms_cuda"])
                      + " ms, host clock " + ", ".join(f"{t:.1f}" for t in res["ms_host"])
                      + " ms" for r, res in enumerate(ranks))
          + f"; {time.perf_counter() - t0:.1f} s in all", flush=True)
    return dict(backend=backend, launches=ranks[0]["launches"],
                ms_cuda=[r["ms_cuda"] for r in ranks], ms_host=[r["ms_host"] for r in ranks],
                grads_bit_equal=grads_equal, zero1_bit_equal=same)


def phase_multigpu(d: str, card: str) -> dict:
    """Q. Data-parallel training (``--multihost``, ``--zero1``); see the
    module docstring."""
    t_phase = time.perf_counter()
    out = {"one_rank": _multi_one_rank(d, card)}
    torch.cuda.empty_cache()
    out["two_ranks"] = _multi_two_ranks(card)
    print(f"[multi] phase Q: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# R's loader: a process of its own that imports no model code (argv: the
# artifact, the result file, the engine's seed, actors, lanes, the scenes'
# generator seed, the scene count); it serves one scene, then the rest as
# one batch, and prints its launches, load time and imported modules
EXPORT_WORKER = r"""
import json, sys, time
import numpy as np
from trajsde_tpu_torch.data.synthetic import make_raw_scene
from trajsde_tpu_torch.ops import aa_fused as K3, sde_rollout as K1
from trajsde_tpu_torch.server import ServingEngine
art, out = sys.argv[1:3]
seed, actors, lanes, rng_seed, n = map(int, sys.argv[3:8])
t0 = time.perf_counter()
eng = ServingEngine.from_export(art, device="cuda", seed=seed)
load_s = time.perf_counter() - t0
rng = np.random.default_rng(rng_seed)
raws = [make_raw_scene(rng, i % 2, num_actors=actors, num_lanes=lanes) for i in range(n)]
got = eng.predict(raws[:1]) + eng.predict(raws[1:])
eng.close()
np.savez(out, **{f"{i}/{k}": v for i, r in enumerate(got) for k, v in r.items()})
print(json.dumps({"load_s": load_s, "launches": {
    "sde_rollout": K1.sde_rollout.launches, "sde_rollout_bwd": K1.sde_rollout_bwd.launches,
    "aa_fused": K3.fused_pair_attention.launches,
    "aa_fused_bwd": K3.fused_pair_attention_bwd.launches},
    "modules": sorted(m for m in sys.modules if m.startswith("trajsde"))}))
"""


def _artifact_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def phase_export(d: str, card: str) -> dict:
    """R. The deployment artifact (``trajsde_tpu_torch/deploy.py``, after Q,
    on J's files); see the module docstring."""
    import serve_torch

    t_phase = time.perf_counter()
    out = {}
    rng_seed, n = SEED + 71, 1 + TRAIN_BATCH
    rng = np.random.default_rng(rng_seed)
    raws = [make_raw_scene(rng, i % 2, num_actors=NUM_ACTORS, num_lanes=NUM_LANES)
            for i in range(n)]
    example = pack_scenes([align_scene(raws[0])[0]], NUM_ACTORS, NUM_LANES)
    model = build_model(FLAGSHIP_H100, device="cuda", seed=SEED)

    # R1: export at full width, buckets 1 and 128
    art = os.path.join(d, "artifact")
    t0 = time.perf_counter()
    manifest = export_serving(model, example, art, buckets=EXPORT_BUCKETS)
    out["export_s"], out["artifact_bytes"] = time.perf_counter() - t0, _artifact_bytes(art)
    check(manifest["ops"] == ["trajsde::aa_fused_fwd", "trajsde::sde_rollout"]
          and [x["name"] for x in manifest["draws"]] == ["twin_noise", "enc_noise",
                                                          "rollout_seed"],
          f"the artifact's ops {manifest['ops']} and draws {manifest['draws']}")
    print(f"[export] R1 FLAGSHIP_H100 ({NUM_ACTORS} actors, {NUM_LANES} lanes, seeded weights) "
          f"exported for buckets {manifest['buckets']} on {manifest['platforms']} in "
          f"{out['export_s']:.1f} s; {out['artifact_bytes'] / 2**20:.1f} MiB on disk; ops "
          f"{manifest['ops']}", flush=True)

    # R2: a process with no model code serves 1 then 128 scenes; the live
    # scan engine of the same seed answers the same batches
    live = ServingEngine(model, num_actors=NUM_ACTORS, num_lanes=NUM_LANES, device="cuda",
                         engine="scan", batch_buckets=EXPORT_BUCKETS, seed=SEED)
    try:
        want = live.predict(raws[:1]) + live.predict(raws[1:])
    finally:
        live.close()
    got_path = os.path.join(d, "exported_answers.npz")
    root = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", EXPORT_WORKER, art, got_path, str(SEED),
                        str(NUM_ACTORS), str(NUM_LANES), str(rng_seed), str(n)],
                       cwd=root, capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=root))
    check(r.returncode == 0, f"the artifact's loader failed:\n{r.stderr[-4000:]}")
    worker = json.loads(r.stdout.strip().splitlines()[-1])
    bad = [m for m in worker["modules"] if m.startswith(("trajsde_tpu_torch.models",
                                                         "trajsde_tpu_torch.config",
                                                         "trajsde_tpu_torch.train"))]
    check(not bad, f"the artifact's loader imported model code: {bad}")
    launches = dict(worker["launches"], aa_attention=0, vpu_probe=0)
    check(launches["sde_rollout"] == launches["aa_fused"] == 2
          and launches["sde_rollout_bwd"] == launches["aa_fused_bwd"] == 0,
          f"two exported batches launched {launches}, not K1 and K3 once each per batch")
    with np.load(got_path) as z:
        got = [{k: z[f"{i}/{k}"] for k in want[i]} for i in range(n)]
    _check_results(got, n, model)
    out["rel"], out["bit_equal"] = _results_distance(got, want)
    check(out["rel"] <= TOL_PIPELINE, f"the exported answers are {out['rel']:.3e} of max from "
          "the live scan engine's")
    out["launches"], out["load_s"] = launches, worker["load_s"]
    print(f"[export] R2 a process with no model code ({len(worker['modules'])} trajsde "
          f"modules, none of models / config / train) loaded the artifact in "
          f"{worker['load_s']:.1f} s and served 1 + {TRAIN_BATCH} scenes: launches {launches}; "
          f"max |exported - live scan engine| / max |live| = {out['rel']:.3e} (tol "
          f"{TOL_PIPELINE:g}); bit-equal: {out['bit_equal']}", flush=True)

    # R3: exported vs live, one served batch each, in turns (CUDA events)
    exp = load_serving(art, device="cuda")
    scan, post = make_scan_fn(model, "cuda"), make_postprocess(True, 20)
    seed = 7

    def live_fn(scene):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        with torch.inference_mode():
            return post(scene, scan(scene, seed, generator=gen))

    times = {}
    for b in EXPORT_BUCKETS:
        scene = pack_scenes([align_scene(x)[0] for x in raws[1:1 + b]], NUM_ACTORS,
                            NUM_LANES).to("cuda")
        a, b_ = exp(scene, seed), live_fn(scene)
        same = all(torch.equal(v, b_[k]) for k, v in a.items())
        del a, b_
        ts = {"exported": [], "live": []}
        for rnd in range(EXPORT_ROUNDS):
            for mode in (("exported", "live") if rnd % 2 == 0 else ("live", "exported")):
                fn = (lambda: exp(scene, seed)) if mode == "exported" else \
                    (lambda: live_fn(scene))
                ts[mode].append(cuda_ms(fn, runs=5, warmup=1))
        times[b] = {k: statistics.median(v) for k, v in ts.items()}
        print(f"[export] R3 {card}: bucket {b}, one served batch (draws, forward, projection), "
              f"{EXPORT_ROUNDS} alternating rounds of CUDA-event medians: exported "
              f"{times[b]['exported']:.2f} ms, live scan engine {times[b]['live']:.2f} ms; the "
              f"two bit-equal here: {same}", flush=True)
    out["ms"] = times
    del exp, scan

    # R4: a CPU export for cpu and cuda, moved to the card at load; pinned
    # encoder draws, the same rollout seed
    cpu_model = build_model(FLAGSHIP_H100, device="cpu", seed=SEED)
    art_cpu = os.path.join(d, "artifact_cpu")
    t0 = time.perf_counter()
    export_serving(cpu_model, example, art_cpu, buckets=(1,), platforms=["cpu", "cuda"])
    cpu_export_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(SEED + 72)
    draws = {"twin_noise": torch.randn((1, 1, 21, 2), generator=gen),
             "enc_noise": torch.randn((21, 1, NUM_ACTORS + 1, 64), generator=gen)}
    on_cpu = load_serving(art_cpu, device="cpu")(example, seed, draws=draws)
    zero_counts()
    on_card = load_serving(art_cpu, device="cuda")(example, seed, draws=draws)
    moved = _counts()
    check(moved["sde_rollout"] == moved["aa_fused"] == 1,
          f"the moved program launched {moved}, not K1 and K3 once")
    rel = max(((on_card[k].cpu() - v).abs().max() / v.abs().max()).item()
              for k, v in on_cpu.items())
    check(rel <= TOL_SPLICE, f"the moved program is {rel:.3e} of max from the CPU's")
    out["moved_rel"] = rel
    print(f"[export] R4 FLAGSHIP_H100 exported on the CPU for cpu and cuda (bucket 1, "
          f"{cpu_export_s:.1f} s), moved to the card at load: K1 and K3 once; max |card - CPU| "
          f"/ max |CPU| = {rel:.3e} (tol {TOL_SPLICE:g}, K1 and K3 against their plain "
          "versions, pinned encoder draws)", flush=True)
    del cpu_model, on_cpu, on_card

    # R5: serve_torch.py --export, then --from-export, on J's checkpoint and
    # validation scenes (bucket 1)
    run_dir = os.path.join(d, "logs", "cli")
    best = CheckpointManager(os.path.join(run_dir, "checkpoints")).best()["path"]
    val_dir = os.path.join(d, "npz", "nuScenes", "val")
    art_cli, preds = os.path.join(d, "artifact_cli"), os.path.join(d, "export_preds")
    t0 = time.perf_counter()
    done = serve_torch.main(["-c", os.path.join(d, "h100.json"), "--ckpt", best, "--export",
                             art_cli, "--max-batch", "1"])
    cli_export_s = time.perf_counter() - t0
    check(done["buckets"] == [1] and done["platforms"] == ["cuda"], f"--export wrote {done}")
    zero_counts()
    t0 = time.perf_counter()
    stats = serve_torch.main(["--from-export", art_cli, "--input-dir", val_dir, "--output-dir",
                              preds, "--max-batch", "1"])
    cli_s = time.perf_counter() - t0
    cli_launches = _counts()
    check(stats["served"] == CLI_VAL_SCENES and cli_launches["sde_rollout"] == CLI_VAL_SCENES
          and cli_launches["aa_fused"] == CLI_VAL_SCENES, f"--from-export served {stats} with "
          f"{cli_launches}, not K1 and K3 once per scene")
    written = []
    for name in sorted(os.listdir(preds)):
        with np.load(os.path.join(preds, name)) as z:
            written.append({k: z[k] for k in z.files})
    _check_results(written, CLI_VAL_SCENES, model)
    out["cli"] = dict(export_s=cli_export_s, s=cli_s, stats=stats, launches=cli_launches)
    print(f"[export] R5 serve_torch.py --export (phase J's checkpoint, bucket 1) in "
          f"{cli_export_s:.1f} s, then --from-export over {CLI_VAL_SCENES} validation scenes in "
          f"{cli_s:.1f} s: {stats}; launches {cli_launches}", flush=True)
    del model
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    print(f"[export] phase R: {out['s']:.1f} s", flush=True)
    return out


def _argo_tracks(rng, n_actors: int, n_lanes: int, spacing: float = 3.5):
    """Argoverse tracks (50 steps at 10 Hz) of ``n_actors`` driving +y on
    ``n_lanes`` parallel straight lanes, the AV first and the agent second,
    the others first seen at steps 0-14, and a fake lane provider returning
    those lanes (200 m each): every actor ends on a lane, heading along it,
    so it gets a goal lane."""
    xs = (np.arange(n_lanes) - n_lanes // 2) * spacing
    obs_steps, obs_xy = [], []
    for a in range(n_actors):
        steps = np.arange(0 if a < 2 else int(rng.integers(0, 15)), 50)
        y = rng.uniform(-30.0, 10.0) + rng.uniform(5.0, 12.0) * 0.1 * steps
        obs_steps.append(steps)
        obs_xy.append(np.stack([np.full(len(steps), xs[a % n_lanes]), y], -1).astype(np.float32))

    def lanes(positions, city, radius=80.0):
        return [np.array([[x, -80.0], [x, 120.0]], np.float32) for x in xs]

    return obs_steps, obs_xy, lanes


def _dead_tensors(dim: int) -> dict:
    """The reference tensors that no live config reads, at HiVT's and
    TrajSDE's shapes (``trajsde_tpu_torch/utils/convert.py``'s skip lists)."""
    z = lambda *s: torch.zeros(*s)  # noqa: E731
    return {"encoder.al_encoder.is_intersection_embed": z(2, dim),
            "encoder.al_encoder.turn_direction_embed": z(3, dim),
            "encoder.al_encoder.traffic_control_embed": z(2, dim),
            "encoder.lsde_func.h_func.theta": torch.ones(1),
            "encoder.lsde_func.h_func.mu": z(1), "decoder.hidden": z(dim)}


def phase_converted(d: str, card: str) -> dict:
    """S. A reference checkpoint converted and evaluated over preprocessed
    scenes (after R, on J's files); see the module docstring."""
    import test_torch

    t_phase = time.perf_counter()
    root = os.path.join(d, "preprocessed")
    test_dir = os.path.join(root, "Argoverse", "test_obs")
    os.makedirs(test_dir)
    rng = np.random.default_rng(SEED + 81)
    shapes = []
    for i, (n_actors, n_lanes) in enumerate(PREPROCESSED_SCENES):
        obs_steps, obs_xy, lanes = _argo_tracks(rng, n_actors, n_lanes)
        scene = argo_pre.process_scene(obs_steps, obs_xy, 0, 1, "PIT", lanes)
        check(scene is not None and bool(scene["has_goal"].all()),
              f"[converted] preprocessed scene {i} has actors without a goal lane")
        np.savez(os.path.join(test_dir, f"{i}.npz"), **scene)
        shapes.append((scene["padding_mask"].shape[0], scene["lane_positions"].shape[0]))
    check(any(a > NUM_ACTORS for a, _ in shapes) and any(n > NUM_LANES for _, n in shapes),
          f"[converted] no preprocessed scene above the capacities: (actors, lane segments) "
          f"{shapes}")
    cfg = copy.deepcopy(FLAGSHIP_H100)
    kw = cfg["datamodule_specific"]["kwargs"]
    kw.update(nu_dir=os.path.join(d, "npz", "nuScenes"), Argo_dir=os.path.join(root, "Argoverse"))
    kw["test_dataset_args"] = dict(kw["test_dataset_args"], Argo=True)
    cfg_path = os.path.join(root, "h100_test.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    n_scenes = CLI_VAL_SCENES + len(PREPROCESSED_SCENES)
    n_eval = -(-n_scenes // TRAIN_BATCH)
    check(len(build_datamodule(cfg).test_dataset) == n_scenes,
          f"[converted] the test split does not hold J's {CLI_VAL_SCENES} nuScenes scenes and "
          f"the {len(PREPROCESSED_SCENES)} preprocessed ones")
    print(f"[converted] S1 {len(PREPROCESSED_SCENES)} Argoverse test scenes preprocessed by "
          f"the port (actors, lane segments) {shapes}, every actor with a goal lane, beside "
          f"phase J's {CLI_VAL_SCENES} nuScenes scenes: {n_eval} test batches", flush=True)

    # S2: the seeded FLAGSHIP_H100 weights as a reference Lightning checkpoint
    seeded = build_model(FLAGSHIP_H100, device="cpu", seed=SEED).state_dict()
    dim = FLAGSHIP_H100["encoder"]["kwargs"]["embed_dim"]
    dead = _dead_tensors(dim)
    unknown = {k: torch.ones(3) for k in PLANTED_UNKNOWN}
    ref_path = os.path.join(root, "reference.ckpt")
    torch.save({"state_dict": {**to_reference(seeded, FLAGSHIP_H100), **dead, **unknown},
                "epoch": 63, "global_step": 1000}, ref_path)

    # S3: the port's converter, a process of its own
    ckpts = os.path.join(root, "checkpoints")
    converted = os.path.join(ckpts, "converted")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join("scripts", "convert_checkpoint_torch.py"),
                           "-c", cfg_path, "--torch-ckpt", ref_path, "--out", converted],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=300)
    convert_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"[converted] the converter exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    check(line == {"out": converted, "converted_leaves": len(seeded),
                   "skipped_dead": sorted(dead), "unused_keys": sorted(unknown)},
          f"[converted] the converter's report {line}")
    check("2 unrecognized checkpoint keys" in proc.stderr, "[converted] no warning of the "
          f"unused keys on stderr: {proc.stderr[-2000:]}")
    weights = torch.load(os.path.join(converted, "state.pt"), weights_only=True)["model"]
    check(list(weights) == list(seeded) and all(torch.equal(weights[k], v)
                                                for k, v in seeded.items()),
          "[converted] the converted weights are not the seeded ones bit for bit")
    print(f"[converted] S2-S3 the seeded FLAGSHIP_H100 weights under the reference's names, "
          f"{len(dead)} dead tensors and {len(unknown)} unknown keys: "
          f"scripts/convert_checkpoint_torch.py in {convert_s:.1f} s (a process of its own, "
          f"import included): {line['converted_leaves']} leaves bit-equal to the seeded "
          f"weights, skipped {len(line['skipped_dead'])}, unused {line['unused_keys']}",
          flush=True)

    # S4: test_torch.py --serving --ood on the card, converted vs saved directly
    direct = save_weights(seeded, os.path.join(ckpts, "direct"))
    want = {"sde_rollout": n_eval, "sde_rollout_bwd": 0, "aa_fused": n_eval,
            "aa_fused_bwd": 0, "aa_attention": 0, "vpu_probe": 0}
    runs = {}
    for tag, path in (("converted", converted), ("direct", direct)):
        zero_counts()
        t0 = time.perf_counter()
        results = test_torch.main(["-c", cfg_path, "--ckpt", path, "--serving", "--ood"])
        wall = time.perf_counter() - t0
        launches = _counts()
        check(launches == want, f"[converted] test_torch.py --serving --ood on the {tag} "
              f"checkpoint launched {launches}, not K1 and K3 once per batch ({want})")
        check({"ADE_T", "FDE_T", "MR_T", "agent_std_mean"} <= set(results)
              and all(np.isfinite(v) for v in results.values()),
              f"[converted] {tag} metrics {results}")
        runs[tag] = dict(results=results, launches=launches, wall_s=wall)
        print(f"[converted] S4 test_torch.py --serving --ood, {tag} checkpoint: launches "
              f"{launches}; " + ", ".join(f"{k} {v:.6f}" for k, v in results.items())
              + f"; {wall:.1f} s", flush=True)
    check(runs["converted"]["results"] == runs["direct"]["results"],
          "[converted] the converted checkpoint's evaluation differs from the direct one's")
    out = dict(launches=runs["converted"]["launches"], convert_s=convert_s, runs=runs,
               shapes=shapes)
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    print(f"[converted] S5 {card}: phase S {out['s']:.1f} s, the conversion {convert_s:.1f} s; "
          "the converted checkpoint's metrics equal the direct one's bit for bit", flush=True)
    return out


def _bf16_counts() -> dict:
    """K3b's and K4b's launch counts (``_counts`` holds K1-K6's)."""
    return {"aa_fused_bf16": K3.fused_pair_attention.bf16_launches,
            "aa_fused_bwd_bf16": K3.fused_pair_attention_bwd.bf16_launches}


def _bf16_dist(got, want) -> tuple:
    """(max|got - want| / max|want|, mean|got - want| / mean|want|)."""
    d = (got - want).abs()
    return ((d.max() / want.abs().max().clamp_min(1e-30)).item(),
            (d.mean() / want.abs().mean().clamp_min(1e-30)).item())


def _within(dist: tuple, tol: tuple) -> bool:
    return dist[0] <= tol[0] and dist[1] <= tol[1]


def _packed(model) -> tuple:
    return tuple(w.contiguous() for w in K3.weights_of(K3.pack_aa_params(model.encoder.aa_encoder)))


@torch.inference_mode()
def _bf16_fused_fwd_kernel(ws8: tuple, ws4: tuple) -> dict:
    """T1: K3b against its plain version; returns its kernels line."""
    Th, A, D = FLAGSHIP["encoder"]["kwargs"]["historical_steps"], NUM_ACTORS, K3.KERNEL_DIM
    shapes = {"bucket 128": ((TRAIN_BATCH, Th, A + 1, A), 8, ws8),
              "ood": ((TRAIN_BATCH, Th, A, A), 8, ws8),
              "baseline": ((TRAIN_BATCH, Th, A, A), 4, ws4)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    max_abs, worst = 0.0, (0.0, 0.0)
    for name, (shape, H, model_ws) in shapes.items():
        for wname, ws in (("model", model_ws), ("random", _random_aa_weights(gen, model_ws))):
            for with_keep in (False, True):
                q, u, mask, keep = _k3_inputs(shape, with_keep, gen, H)
                p = K3_DROPOUT if with_keep else 0.0
                case = (f"{name} {list(shape)}, {H} heads, {wname} weights, keep "
                        + (f"p={p:g}" if with_keep else "None"))
                got = K3.fused_pair_attention(q, u, mask, keep, ws, H, p, "bfloat16")
                again = K3.fused_pair_attention(q, u, mask, keep, ws, H, p, "bfloat16")
                f32 = K3.fused_pair_attention(q, u, mask, keep, ws, H, p)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), f"aa_fused_bf16 ({case}) is not finite")
                check(torch.equal(got, again), f"aa_fused_bf16 ({case}) is not bit-equal across "
                      "two runs")
                check(bool((got[:, :, ::7] == 0).all()), f"aa_fused_bf16 ({case}): an empty "
                      "receiver did not give exactly 0")
                want = K3.fused_pair_attention_reference(q, u, mask, keep, ws, H, p,
                                                         compute_dtype="bfloat16")
                dist, fdist = _bf16_dist(got, want), _bf16_dist(f32, want)
                max_abs = max(max_abs, (got - want).abs().max().item())
                worst = tuple(max(a, b) for a, b in zip(worst, dist))
                print(f"[bf16-fused] T1 aa_fused_bf16 {case}: bit-equal reruns; max / mean "
                      f"|kernel - plain| {dist[0]:.3e} / {dist[1]:.3e} of max / mean |plain| (tol "
                      f"{TOL_K3B[0]:g} / {TOL_K3B[1]:g}); K3 (f32) {fdist[0]:.3e} / "
                      f"{fdist[1]:.3e}", flush=True)
                check(_within(dist, TOL_K3B), f"aa_fused_bf16 ({case}) disagrees with its plain "
                      "version")
                check(not _within(fdist, TOL_K3B), f"K3 (f32) passes TOL_K3B ({case}): the bar "
                      "does not hold the kernel to bf16")
                del got, again, f32, want, q, u, mask, keep
    # ln_mm off reaches the kernel: against its own plain version, and apart
    # from the plain version with ln_mm
    shape = shapes["bucket 128"][0]
    q, u, mask, _ = _k3_inputs(shape, False, gen)
    off = K3.fused_pair_attention(q, u, mask, None, ws8, 8, 0.0, "bfloat16", ln_mm=False)
    d_off = _bf16_dist(off, K3.fused_pair_attention_reference(
        q, u, mask, None, ws8, 8, compute_dtype="bfloat16", ln_mm=False))
    d_on = _bf16_dist(off, K3.fused_pair_attention_reference(q, u, mask, None, ws8, 8,
                                                             compute_dtype="bfloat16"))
    print(f"[bf16-fused] T1 aa_fused_bf16 bucket 128, ln_mm off: {d_off[0]:.3e} / {d_off[1]:.3e} "
          f"from its plain version, {d_on[0]:.3e} / {d_on[1]:.3e} from the plain version with "
          "ln_mm", flush=True)
    check(_within(d_off, TOL_K3B), "aa_fused_bf16 with ln_mm off disagrees with its plain version")
    check(not _within(d_on, TOL_K3B), "aa_fused_bf16 with ln_mm off passes the ln_mm plain "
          "version's bar: the flag does not reach the kernel")
    del off
    # timed at bucket 128 (model weights, no keep, as a served batch), K3 in the same call
    ms = cuda_ms(lambda: K3.fused_pair_attention(q, u, mask, None, ws8, 8, 0.0, "bfloat16"))
    f32_ms = cuda_ms(lambda: K3.fused_pair_attention(q, u, mask, None, ws8, 8))
    plain_ms = cuda_ms(lambda: K3.fused_pair_attention_reference(
        q, u, mask, None, ws8, 8, compute_dtype="bfloat16"), runs=5, warmup=1)
    cores, cores_by, flops, nbytes, route, route_by = aa_fused_bound(*shape, D, 8, False, True)
    print(f"[bf16-fused] T1 aa_fused_bf16 bucket 128 {list(shape)}: {ms:.3f} ms (median of "
          f"{TIMED_RUNS}); K3 (f32) {f32_ms:.3f} ms in this call; bound {route:.3f} ms by "
          f"{route_by} on its route (bf16 products on the tensor cores) and {cores:.3f} ms by "
          f"{cores_by} on the CUDA cores ({flops:.3e} flop, {nbytes:.3e} B), "
          f"{flops / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.3f} ms (median of 5)", flush=True)
    # and at the baseline's 4 heads and shape
    shape4 = shapes["baseline"][0]
    q, u, mask, _ = _k3_inputs(shape4, False, gen, 4)
    h4_ms = cuda_ms(lambda: K3.fused_pair_attention(q, u, mask, None, ws4, 4, 0.0, "bfloat16"))
    h4_f32 = cuda_ms(lambda: K3.fused_pair_attention(q, u, mask, None, ws4, 4))
    h4_cores, _, _, _, h4_route, _ = aa_fused_bound(*shape4, D, 4, False, True)
    print(f"[bf16-fused] T1 aa_fused_bf16 at 4 heads {list(shape4)}: {h4_ms:.3f} ms (median of "
          f"{TIMED_RUNS}); K3 (f32) {h4_f32:.3f} ms in this call; bound {h4_route:.3f} ms on its "
          f"route, {h4_cores:.3f} ms on the CUDA cores", flush=True)
    return dict(name="aa_fused_bf16", route="cuda", source="trajsde_tpu_torch/csrc/aa_fused.cu",
                replaces="trajsde_tpu/ops/pallas/aa_fused.py:319", compute_dtype="bfloat16",
                launches=None, max_abs_err=max_abs, max_rel_err=worst[0], mean_rel_err=worst[1],
                ms=ms, plain_ms=plain_ms, bound_ms=route, bound_by=route_by, route_ms=route,
                cuda_core_bound_ms=cores, cuda_core_bound_by=cores_by, f32_kernel_ms=f32_ms,
                h4_shape=list(shape4), h4_ms=h4_ms, h4_f32_kernel_ms=h4_f32, h4_bound_ms=h4_route,
                h4_cuda_core_bound_ms=h4_cores, library_ms=None)


def _bf16_fused_bwd_kernel(ws8: tuple, checks: dict) -> dict:
    """T2: K4b against its plain version at the training twin shape at
    BF16_FUSED_BATCH, with keep; returns its kernels line."""
    Th, A, D, H = (FLAGSHIP["encoder"]["kwargs"]["historical_steps"], NUM_ACTORS,
                   K3.KERNEL_DIM, 8)
    shape = (BF16_FUSED_BATCH, Th, A + 1, A)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 52)
    p, bf = K3_DROPOUT, dict(compute_dtype="bfloat16")
    max_abs, worst = 0.0, (0.0, 0.0)
    for wname, ws in (("model", ws8), ("random", _random_aa_weights(gen, ws8))):
        q, u, mask, keep = _k3_inputs(shape, True, gen)
        g = torch.randn(q.shape, generator=gen, device="cuda")
        case = f"train {list(shape)}, {wname} weights, keep p={p:g}"
        out, stats = K3.fused_pair_attention_fwd(q, u, mask, keep, ws, H, p, **bf)
        with torch.no_grad():
            served = K3.fused_pair_attention(q, u, mask, keep, ws, H, p, **bf)
        dq, dws = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, H, p, out=out,
                                              stats=stats, **bf)
        dq2, dws2 = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, H, p, out=out,
                                                stats=stats, **bf)
        torch.cuda.synchronize()
        check(torch.equal(out, served), f"aa_fused_bf16 ({case}): writing the softmax statistics "
              "changed the output")
        check(bool(torch.isfinite(dq).all()) and all(bool(torch.isfinite(d).all()) for d in dws),
              f"aa_fused_bwd_bf16 ({case}) is not finite")
        check(torch.equal(dq, dq2) and all(torch.equal(a, b) for a, b in zip(dws, dws2)),
              f"aa_fused_bwd_bf16 ({case}) is not bit-equal across two runs")
        check(bool((dq[:, :, ::7] == 0).all()), f"aa_fused_bwd_bf16 ({case}): an empty receiver "
              "did not give exactly 0")
        del served, dq2, dws2
        # K4b's recomputed logits against K3b's, from the check copies
        rows = q.shape[0] * q.shape[1] * q.shape[2] * u.shape[3]
        lg3 = torch.full((rows, H), float("nan"), device="cuda")
        lg4 = torch.full((rows, H), float("nan"), device="cuda")
        check(checks["logits_fwd"].aa_fused_set_logits(lg3.data_ptr()) == 0, "set_logits")
        out3, stats3 = K3.launch_fwd(checks["logits_fwd"], q, u, mask, keep, ws, H, p,
                                     with_stats=True, **bf)
        check(checks["logits_bwd"].aa_fused_bwd_set_logits(lg4.data_ptr()) == 0, "set_logits")
        K3.launch_bwd(checks["logits_bwd"], q, u, mask, keep, ws, g, out3, stats3, H, p, **bf)
        torch.cuda.synchronize()
        check(not bool(torch.isnan(lg3).any()) and not bool(torch.isnan(lg4).any()),
              "a pair's logits were not written")
        check(torch.equal(lg3, lg4), f"K4b's recomputed logits ({case}) are not K3b's")
        check(torch.equal(out3, out) and torch.equal(stats3, stats),
              "the logits check copy of K3b gave other outputs than K3b")
        del lg3, lg4, out3, stats3
        out32, stats32 = K3.fused_pair_attention_fwd(q, u, mask, keep, ws, H, p)
        dq32, dws32 = K3.fused_pair_attention_bwd(q, u, mask, keep, ws, g, H, p, out=out32,
                                                  stats=stats32)
        del out, stats, out32, stats32
        want_dq, want = K3.fused_pair_attention_bwd_reference(q, u, mask, keep, ws, g, H, p, **bf)
        rels, f32_fails = {}, []
        for k, a, a32, b in zip(("dq", *K3.W_ORDER), (dq, *dws), (dq32, *dws32),
                                (want_dq, *want)):
            dist = _bf16_dist(a, b)
            rels[k] = dist
            max_abs = max(max_abs, (a - b).abs().max().item())
            worst = tuple(max(x, y) for x, y in zip(worst, dist))
            check(_within(dist, TOL_K4B), f"aa_fused_bwd_bf16 ({case}) {k}: {dist[0]:.3e} / "
                  f"{dist[1]:.3e} past {TOL_K4B}")
            if not _within(_bf16_dist(a32, b), TOL_K4B):
                f32_fails.append(k)
        print(f"[bf16-fused] T2 aa_fused_bwd_bf16 {case}: bit-equal reruns, its logits K3b's bit "
              f"for bit; max / mean |kernel - plain| over max / mean |plain|: "
              + ", ".join(f"{k} {v[0]:.2e} / {v[1]:.2e}" for k, v in rels.items())
              + f" (tol {TOL_K4B[0]:g} / {TOL_K4B[1]:g}); K4 (f32) fails it on "
              + (", ".join(f32_fails) or "nothing"), flush=True)
        check(bool(f32_fails), f"K4 (f32) passes TOL_K4B on every output ({case})")
        del q, u, mask, g, dq, dws, dq32, dws32, want_dq, want
        torch.cuda.empty_cache()
    # timed with keep and the model's weights, as a train step calls it; K4 in the same call
    q, u, mask, keep = _k3_inputs(shape, True, gen)
    g = torch.randn(q.shape, generator=gen, device="cuda")
    out, stats = K3.fused_pair_attention_fwd(q, u, mask, keep, ws8, H, p, **bf)
    out32, stats32 = K3.fused_pair_attention_fwd(q, u, mask, keep, ws8, H, p)
    ms = cuda_ms(lambda: K3.fused_pair_attention_bwd(q, u, mask, keep, ws8, g, H, p, out=out,
                                                     stats=stats, **bf))
    f32_ms = cuda_ms(lambda: K3.fused_pair_attention_bwd(q, u, mask, keep, ws8, g, H, p,
                                                         out=out32, stats=stats32))
    del out, stats, out32, stats32
    torch.cuda.empty_cache()
    plain_ms = cuda_ms(lambda: K3.fused_pair_attention_bwd_reference(q, u, mask, keep, ws8, g, H,
                                                                     p, **bf), runs=5, warmup=1)
    cores, cores_by, flops, nbytes, route, route_by = aa_fused_bwd_bound(*shape, D, H, True, True)
    print(f"[bf16-fused] T2 aa_fused_bwd_bf16 train {list(shape)}, keep p={p:g}: {ms:.3f} ms "
          f"(median of {TIMED_RUNS}); K4 (f32) {f32_ms:.3f} ms in this call; bound {route:.3f} "
          f"ms by {route_by} on its route (bf16 recompute, 2xTF32 backward products) and "
          f"{cores:.3f} ms by {cores_by} on the CUDA cores ({flops:.3e} flop, {nbytes:.3e} B), "
          f"{flops / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.3f} ms (median of 5)", flush=True)
    del q, u, mask, keep, g
    torch.cuda.empty_cache()
    return dict(name="aa_fused_bwd_bf16", route="cuda",
                source="trajsde_tpu_torch/csrc/aa_fused_bwd.cu",
                replaces="trajsde_tpu/ops/pallas/aa_fused.py:343", compute_dtype="bfloat16",
                launches=None, max_abs_err=max_abs, max_rel_err=worst[0], mean_rel_err=worst[1],
                ms=ms, plain_ms=plain_ms, bound_ms=route, bound_by=route_by, route_ms=route,
                cuda_core_bound_ms=cores, cuda_core_bound_by=cores_by, f32_kernel_ms=f32_ms,
                shape=list(shape), library_ms=None)


def _bf16_fused_serve(model, card: str) -> dict:
    """T3: the engine over ``FLAGSHIP_BF16_FUSED`` answers buckets 1 and
    128: K3b and K1 once a batch, K3 never; mean|pi| against ``FLAGSHIP``'s;
    the distance from dense ``FLAGSHIP_BF16`` with pinned noise."""
    engine = ServingEngine(model, num_actors=NUM_ACTORS, num_lanes=NUM_LANES, device="cuda",
                           engine="kernel", seed=SEED)
    requests = _requests(np.random.default_rng(SEED + 54))
    engine.predict(requests[1])
    zero_counts()
    results = {n: engine.predict(requests[n]) for n in (1, TRAIN_BATCH)}
    served, served_bf16 = _counts(), _bf16_counts()
    engine.close()
    for n, res in results.items():
        _check_results(res, n, model)
    print(f"[bf16-fused] T3 FLAGSHIP_BF16_FUSED through the kernel engine at buckets 1 and "
          f"{TRAIN_BATCH}: launches {served}, {served_bf16}", flush=True)
    check(served == {"sde_rollout": 2, "sde_rollout_bwd": 0, "aa_fused": 0, "aa_fused_bwd": 0,
                     "aa_attention": 0, "vpu_probe": 0}
          and served_bf16 == {"aa_fused_bf16": 2, "aa_fused_bwd_bf16": 0},
          "the fused bf16 engine did not launch K3b and K1 once a batch and nothing else")
    f32 = build_model(FLAGSHIP, device="cuda", seed=SEED)
    dense = build_model(FLAGSHIP_BF16, device="cuda", seed=SEED)
    sd, s32 = model.state_dict(), f32.state_dict()
    check(list(sd) == list(s32) and all(torch.equal(sd[k], s32[k]) for k in sd),
          "the fused bf16 and the f32 model do not share one parameter tree")
    scene = _train_batch(np.random.default_rng(SEED + 41), TRAIN_BATCH).to("cuda")
    o16, o32 = (make_serving_fn(m, "cuda")(
        scene, SEED, generator=torch.Generator(device="cuda").manual_seed(SEED + 43))
        for m in (model, f32))
    for k in ("loc", "pi"):
        check(o16[k].dtype == torch.float32 and bool(torch.isfinite(o16[k]).all()),
              f"the fused bf16 model's served {k} is not finite f32")
    pi16, pi32 = float(o16["pi"].abs().mean()), float(o32["pi"].abs().mean())
    pi_rel = abs(pi16 - pi32) / pi32
    B, Th, D = TRAIN_BATCH, model.encoder.historical_steps, model.encoder.embed_dim
    K, Tf = model.decoder.num_modes, model.decoder.future_steps
    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    en = torch.randn((Th, B, NUM_ACTORS + 1, D), generator=gen, device="cuda")
    tw = torch.randn((B, 1, Th, 2), generator=gen, device="cuda")
    de = torch.randn((Tf, B, K, NUM_ACTORS, D), generator=gen, device="cuda")
    with torch.inference_mode():
        pf = model(scene, enc_noise=en, twin_noise=tw, dec_noise=de)
        pd = dense(scene, enc_noise=en, twin_noise=tw, dec_noise=de)
    valid = ~scene.padding_mask[:, None, :, -Tf:, None].expand_as(pd["loc"])
    d = (pf["loc"] - pd["loc"])[valid].abs()
    ref = pd["loc"][valid].abs()
    loc_max, loc_mean = float(d.max() / ref.max()), float(d.mean() / ref.mean())
    print(f"[bf16-fused] T3 {card}: mean|pi| {pi16:.5f} vs {pi32:.5f} for FLAGSHIP (f32), "
          f"relative {pi_rel:.4f} (tol {TOL_BF16_PI}); pinned noise, the models' own forward: "
          f"loc vs dense FLAGSHIP_BF16 max|diff| / max|dense| {loc_max:.3e}, mean|diff| / "
          f"mean|dense| {loc_mean:.3e} over the valid steps", flush=True)
    check(pi_rel <= TOL_BF16_PI, "the fused bf16 model's mean|pi| is not the f32 model's")
    return dict(launches=served, bf16_launches=served_bf16, pi_rel=pi_rel, loc_max=loc_max,
                loc_mean=loc_mean)


def _bf16_fused_train(model, card: str) -> dict:
    """T4: BF16_FUSED_STEPS train steps of ``FLAGSHIP_BF16_FUSED`` on one
    batch of BF16_FUSED_BATCH (the decoder as the YAML writes it, its
    rollout the plain loop): K3b and K4b once a step and nothing else, the
    loss falls; the step in turns beside dense ``FLAGSHIP_BF16``'s with
    peak memory."""
    batch = _train_batch(np.random.default_rng(SEED + 3), BF16_FUSED_BATCH).to("cuda")
    want = {"sde_rollout": 0, "sde_rollout_bwd": 0, "aa_fused": 0, "aa_fused_bwd": 0,
            "aa_attention": 0, "vpu_probe": 0}
    steps, out = {}, {}
    for tag, cfg, m, bf in (("fused", FLAGSHIP_BF16_FUSED, model, 1),
                            ("dense", FLAGSHIP_BF16,
                             build_model(FLAGSHIP_BF16, device="cuda", seed=SEED), 0)):
        state = create_train_state(m, cfg["training_specific"], steps_per_epoch=1, seed=SEED)
        step = make_train_step(m, state.optimizer, state.scheduler, build_losses(cfg),
                               torch.device("cuda"))
        losses, launched = [], {}
        for i in range(BF16_FUSED_STEPS):
            zero_counts()
            logs = step(batch, i, SEED)
            launched = {k: launched.get(k, 0) + v for k, v in
                        dict(_counts(), **_bf16_counts()).items()}
            losses.append(float(logs["train/total"]))
            check(np.isfinite(losses[-1]) and logs["train/step_skipped"] == 0.0,
                  f"[bf16-fused] non-finite {tag} train step {i}")
        n = BF16_FUSED_STEPS
        check(launched == dict(want, aa_fused_bf16=n * bf, aa_fused_bwd_bf16=n * bf),
              f"[bf16-fused] {n} {tag} train steps launched {launched}")
        check(losses[-1] < losses[0], f"[bf16-fused] the {tag} loss did not fall: {losses}")
        check(_all_f32(m, state.optimizer), f"[bf16-fused] a {tag} parameter, gradient or AdamW "
              "moment is not f32")
        print(f"[bf16-fused] T4 {tag} FLAGSHIP_BF16{'_FUSED' if bf else ''}: {n} train steps on "
              f"one batch of {BF16_FUSED_BATCH}: loss " + " ".join(f"{x:.4f}" for x in losses)
              + f"; launches {launched}", flush=True)
        out[tag] = dict(losses=losses, launches=launched)
        counter = [n]

        def again(step=step, counter=counter):
            step(batch, counter[0], SEED)
            counter[0] += 1

        steps[tag] = again
    times, peaks = _in_turns(steps)
    _print_turns(card, f"train step at batch {BF16_FUSED_BATCH} (FLAGSHIP_BF16_FUSED, K3b + K4b, "
                 "vs dense FLAGSHIP_BF16)", times, peaks, tag="bf16-fused")
    out.update(ms=times, peak_gib=peaks)
    return out


def phase_bf16_fused(card: str, checks: dict) -> tuple:
    """T. bf16 inside the fused AA kernels (see the module's docstring);
    returns (K3b's and K4b's kernels lines, T3's and T4's numbers)."""
    t_phase = time.perf_counter()
    model = build_model(FLAGSHIP_BF16_FUSED, device="cuda", seed=SEED)
    aa = model.encoder.aa_encoder
    check(aa.fused and aa.chain_dtype == "bfloat16" and aa.ln_mm,
          "FLAGSHIP_BF16_FUSED's AA encoder is not fused in bf16 with ln_mm")
    base = build_model(BASELINE_TRAIN, device="cuda", seed=SEED)
    k3b = _bf16_fused_fwd_kernel(_packed(model), _packed(base))
    del base
    k4b = _bf16_fused_bwd_kernel(_packed(model), checks)
    torch.cuda.empty_cache()
    serve = _bf16_fused_serve(model, card)
    torch.cuda.empty_cache()
    train = _bf16_fused_train(model, card)
    k3b["launches"] = serve["bf16_launches"]["aa_fused_bf16"]
    k4b["launches"] = train["fused"]["launches"]["aa_fused_bwd_bf16"]
    for entry, name in ((k3b, "aa_fused_bf16"), (k4b, "aa_fused_bwd_bf16")):
        entry["launches_by_path"] = {"bf16_fused_serve": serve["bf16_launches"][name],
                                     "bf16_fused_train": train["fused"]["launches"][name],
                                     "bf16_dense_train": train["dense"]["launches"][name]}
    del model
    torch.cuda.empty_cache()
    print(f"[bf16-fused] phase T: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k3b, k4b, serve, train


def _chain_keys() -> dict:
    """U1. K1 and K2 reading the rollout keys from device memory (the
    chained step's form) against the same launches with the host's keys,
    at the training shape (61,440 rows x 60 steps): bit for bit; the keys
    of another seed draw other bits."""
    model = build_model(FLAGSHIP_TRAIN, device="cuda", seed=SEED)
    dec, rows = model.decoder, train_rows(model)
    T, D = dec.future_steps, dec.local_channels
    w = K1.pack_params({k: v.contiguous()
                        for k, v in K1.rollout_params_from_module(dec.sde_rollout).items()})
    t0s, dts = dec.time_grid(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    y0 = torch.relu(torch.randn((rows, D), generator=gen, device="cuda"))
    ct = torch.randn((T, rows, D), generator=gen, device="cuda")
    seeds = (K1.mix_seed(SEED, 3), 13)
    zero_counts()
    for seed in seeds:
        keys = K1.rollout_keys(seed, "cuda")
        ys = K1.sde_rollout_packed(y0, w, t0s, dts, seed, T)
        ys_keys = K1.sde_rollout_packed(y0, w, t0s, dts, keys, T)
        bwd = K1.sde_rollout_bwd(y0, ys, ct, w, t0s, dts, seed, T)
        bwd_keys = K1.sde_rollout_bwd(y0, ys, ct, w, t0s, dts, keys, T)
        torch.cuda.synchronize()
        check(torch.equal(ys, ys_keys), f"K1 with the keys of seed {seed} in device memory "
              "differs from K1 with the host's keys")
        check(torch.equal(bwd[0], bwd_keys[0]) and torch.equal(bwd[1], bwd_keys[1]),
              f"K2 with the keys of seed {seed} in device memory differs from K2 with the "
              "host's keys")
    other = K1.sde_rollout_packed(y0, w, t0s, dts, K1.rollout_keys(seeds[0] + 1, "cuda"), T)
    check(not torch.equal(other, ys), "the keys of another seed drew the same increments")
    launches = _counts()
    check(launches["sde_rollout"] == 2 * len(seeds) + 1
          and launches["sde_rollout_bwd"] == 2 * len(seeds), f"U1 launched {launches}")
    print(f"[chain] U1: K1 and K2 with device keys equal the host-key launches bit for bit at "
          f"{rows:,} rows x {T} steps, seeds {seeds} (keys "
          + ", ".join(str(K1.seed_keys(s)) for s in seeds) + "); another seed's keys draw "
          f"other increments; launches {launches}", flush=True)
    return dict(rows=rows, seeds=list(seeds), launches=launches)


def _state_bits(state) -> dict:
    """The weights, AdamW's moments and counts, and the schedule of
    ``state`` (copies)."""
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "optimizer": copy.deepcopy(state.optimizer.state_dict()),
            "scheduler": state.scheduler.state_dict()}


def _same_bits(a: dict, b: dict) -> list:
    """The entries of two :func:`_state_bits` that differ."""
    bad = [k for k in a["model"] if not torch.equal(a["model"][k], b["model"][k])]
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    if sa.keys() != sb.keys():
        return bad + ["optimizer state keys"]
    bad += [f"state {i} {k}" for i in sa for k in sa[i]
            if not torch.equal(sa[i][k].cpu(), sb[i][k].cpu())]
    if a["optimizer"]["param_groups"] != b["optimizer"]["param_groups"]:
        bad.append("param_groups")
    if a["scheduler"] != b["scheduler"]:
        bad.append("scheduler")
    return bad


def _logs_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(a.nan_to_num(), b.nan_to_num()))


def _all_counts() -> dict:
    """Every kernel's launch count: K1-K6 (``_counts``), K3b and K4b."""
    return dict(_counts(), **_bf16_counts())


def _chain_want(cfg, updates: int) -> dict:
    """The launches of ``updates`` chained (or eager) updates of ``cfg``: K1
    and K2 once an update with a fused decoder, K3 and K4 (K3b and K4b in
    bf16) with a fused AA encoder, K3 (K3b) twice under ``encoder.remat``
    (forward and recompute), nothing else."""
    enc = cfg["encoder"]["kwargs"]
    fused_aa = bool(enc.get("fused"))
    fused_dec = bool(cfg["decoder"]["kwargs"].get("fused"))
    bf16 = build_dtype(cfg) == "bfloat16"
    aa = updates * (fused_aa and not bf16)
    aab = updates * (fused_aa and bf16)
    fwd = 2 if enc.get("remat") else 1
    return {"sde_rollout": updates * fused_dec, "sde_rollout_bwd": updates * fused_dec,
            "aa_fused": fwd * aa, "aa_fused_bwd": aa, "aa_attention": 0, "vpu_probe": 0,
            "aa_fused_bf16": fwd * aab, "aa_fused_bwd_bf16": aab}


def _launched(launches: dict) -> dict:
    """The kernels of ``launches`` that ran."""
    return {k: v for k, v in launches.items() if v}


def _traced(fn) -> dict:
    """``fn`` run once under ``torch.profiler``, device activity only (CPU
    op events doubled an eager step's profiled time): its host ms, the
    device's busy ms, each kernel's runs in the trace
    (``ops.traced_launches``), the kernel instantiations it names (e.g.
    ``aa_fused_kernel<8, true>``), the counters' launches in that call, and
    the seconds the whole took.  The device events are read from the raw
    kineto results in one pass: ``prof.events()`` and ``key_averages()``
    give the same busy time and names, but took 20-60 s on an eager bf16
    chain's 72,000 device events."""
    from torch.profiler import ProfilerActivity, profile

    t_all = time.perf_counter()
    torch.cuda.synchronize()
    zero_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    counted = _all_counts()
    busy_ns, names = 0, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            names.append(e.name())
            busy_ns += 0 if e.is_async() else e.duration_ns()
    busy = busy_ns / 1e6
    seen = sorted({m.group(0) for n in set(names) for rx in ops.TRACE_NAMES.values()
                   if re.search(rx, n) and (m := re.search(r"\w+<[^>]*>", n))})
    return dict(profiled_wall_ms=wall, busy_ms=busy,
                idle_share=1.0 - busy / wall if busy > 0 else None,
                traced=ops.traced_launches(names), counted=counted, kernel_names=seen,
                seconds=time.perf_counter() - t_all)


def _chain_pair(cfg, batches: list, chains: int, tag: str, nan_at=None,
                trace: bool = False, twin=None) -> dict:
    """A graphed chained step and the uncaptured one (the same function run
    as it is), each on its own copy of the seeded ``cfg`` model, over
    ``chains`` chains of ``batches`` (the second with a NaN planted in
    update ``nan_at``): every chain's logs and the states after it bit for
    bit, a capped AA block's ``aa_overflow_edges`` None after each, and the
    graphed path's launches per chain; with ``trace`` the graphed path's
    last chain (replays only) runs under the profiler (:func:`_traced`).
    ``twin``: a config of the same weights (e.g. ``cfg`` without remat)
    whose graphed chain must give the graphed chain's bits too.  Returns
    the steps and states, the launches, the skips and the trace."""
    losses = build_losses(cfg)
    out = {}
    for mode in ("plain", "graphed") + (("twin",) if twin is not None else ()):
        model = build_model(twin if mode == "twin" else cfg, device="cuda", seed=SEED)
        state = create_train_state(model, cfg["training_specific"], steps_per_epoch=64,
                                   seed=SEED)
        step = ChainedStep(model, state.optimizer, state.scheduler, losses,
                           torch.device("cuda"), accum_steps=1, graphs=mode != "plain")
        out[mode] = dict(state=state, step=step, bits=[], logs=[], launches=[], skipped=[])
    for c in range(chains):
        chain = list(batches)
        if nan_at is not None and c == chains - 1:
            bad = dataclasses.replace(chain[nan_at], x=chain[nan_at].x.clone())
            bad.x[0, 1, 3, 0] = float("nan")
            chain[nan_at] = bad
        for mode, r in out.items():
            def run():
                r["skipped"].append(r["step"](chain, r["state"].step,
                                              r["state"].seed)["train/step_skipped"])
            if trace and mode == "graphed" and c == chains - 1:
                r["trace"] = _traced(run)
            else:
                zero_counts()
                run()
            r["state"].step += len(chain)
            r["launches"].append(_all_counts())
            r["logs"].append(r["step"].chain_logs.clone())
            r["bits"].append(_state_bits(r["state"]))
            aa = getattr(r["state"].model.encoder, "aa_encoder", None)
            check(getattr(aa, "aa_overflow_edges", None) is None,
                  f"[chain {tag}] {mode}: aa_overflow_edges is not None after chain {c + 1}")
        plain, graphed = out["plain"], out["graphed"]
        bad = _same_bits(plain["bits"][-1], graphed["bits"][-1])
        check(not bad, f"[chain {tag}] chain {c + 1}: the graphed chain's state differs from the "
              f"uncaptured chain's at {bad[:5]} ({len(bad)} entries)")
        check(_logs_equal(plain["logs"][-1], graphed["logs"][-1]),
              f"[chain {tag}] chain {c + 1}: the graphed chain's logs differ from the "
              "uncaptured chain's")
        if twin is not None:
            bad = _same_bits(out["twin"]["bits"][-1], graphed["bits"][-1])
            check(not bad and _logs_equal(out["twin"]["logs"][-1], graphed["logs"][-1]),
                  f"[chain {tag}] chain {c + 1}: the graphed chain differs from the twin "
                  f"build's graphed chain at {bad[:5]} ({len(bad)} entries) or in its logs")
    return out


def _chain_builds(builds: dict, small: list, label: str, twins: dict = None) -> dict:
    """U2 / U7 / U10 / U11: each build's graphed chain of 2 on ``small`` (two
    batches of CHAIN_BUILD_BATCH) against the uncaptured one, twice, bit for
    bit (and against the graphed chain of its twin build in ``twins``, if
    any), with its launches a chain (:func:`_chain_want`), and the second
    graphed chain, replays only, traced: each kernel as often in the trace
    as its counter, as the build launches it.  A capped block's
    ``aa_overflow_edges`` is None after each chain.  Each build's steps,
    graphs and pool are released before the next."""
    out = {}
    for name, cfg in builds.items():
        t0 = time.perf_counter()
        pair = _chain_pair(cfg, small, 2, name, trace=True, twin=(twins or {}).get(name))
        graphed = pair["graphed"]
        want = _chain_want(cfg, 2)
        check(graphed["launches"] == [want, want],
              f"[chain {name}] launched {graphed['launches']}, not {want} a chain")
        traced = graphed["trace"]["traced"]
        check(traced == graphed["launches"][-1] == want,
              f"[chain {name}] the traced graphed chain ran {traced} by the trace, the counters "
              f"added {graphed['launches'][-1]}, the build launches {want}")
        step = graphed["step"]
        out[name] = dict(launches=graphed["launches"][0], traced=traced,
                         kernel_names=graphed["trace"]["kernel_names"],
                         capture_s=step.capture_s[0], pool_gib=step.pool_bytes / 2**30,
                         graph_nodes=step.graph_nodes[0], seconds=time.perf_counter() - t0)
        twin = " and the twin build's graphed chains" if name in (twins or {}) else ""
        print(f"[chain] {label} {name} at batch {CHAIN_BUILD_BATCH}: 2 graphed chains of 2 equal "
              f"the uncaptured ones{twin} bit for bit; launches per chain "
              f"{_launched(want) or 'none'}, "
              f"the second chain's trace {_launched(traced) or 'none'} (as "
              f"{graphed['trace']['kernel_names']}); aa_overflow_edges None after each; capture "
              f"{step.capture_s[0]:.2f} s, the graph's nodes {step.graph_nodes[0]}, its pool "
              f"{out[name]['pool_gib']:.2f} GiB; {out[name]['seconds']:.1f} s", flush=True)
        del pair, graphed, step
        torch.cuda.empty_cache()
    return out


def _vs_eager(got: dict, after: dict, start: dict, grads: dict, dtype: str) -> dict:
    """A chain's weights ``got`` against the eager steps' ``after`` (both
    from ``start``): the largest difference outside the key-bias entries
    (``optim.noise_entries``) and on them, and ``optim.chain_eager_gap`` in
    ``dtype``'s measure beside the same measure of a chain that left a
    trained leaf where it started (the least over the leaves that
    ``grads``, the eager steps' last gradient, trains) and of an update of
    the wrong sign."""
    noise = noise_entries(after)
    dist, leaf = largest_gap(got, after, noise)
    gap, gap_leaf = chain_eager_gap(got, after, start, dtype)
    trained = [n for n, g in grads.items() if g is not None and g.abs().max() > 0
               and noise.get(n) != slice(None)]
    unchanged = min(chain_eager_gap({k: start[k]}, {k: after[k]}, {k: start[k]}, dtype)[0]
                    for k in trained)
    flipped = chain_eager_gap({k: 2 * v - after[k] for k, v in start.items()}, after, start,
                              dtype)[0]
    return dict(max_weight_diff=dist, leaf=leaf,
                noise_diff=largest_gap(got, after, noise, inside=True)[0], gap=gap,
                gap_leaf=gap_leaf, unchanged=unchanged, flipped=flipped,
                noise_entries=sorted(noise))


def _chain_graph(card: str, batches: list, small: list) -> dict:
    """U2-U4 on ``FLAGSHIP_H100`` at TRAIN_BATCH, dropout live: U2 two
    graphed chains of CHAIN (the first's update 1 runs uncaptured while the
    graph is captured, the rest replay) against the uncaptured chained
    function from the same state, bit for bit, K1-K4 once per update; U3 the
    first chain against CHAIN eager steps: update 1's logs bit-equal, every
    weight outside the key-bias entries (``optim.noise_entries``, whose
    eager gradient must read below ``NOISE_GRAD`` and every other leaf's
    above it) within ``chain_eager_bound``, which a leaf left unchanged and
    a chain of the wrong sign must fail; U4 a third chain with a NaN planted
    in update 2: one skip, the same bits in both paths.  First the other
    f32 builds' graphed chain of 2 on ``small`` (two batches of
    CHAIN_BUILD_BATCH)."""
    builds = _chain_builds(CHAIN_BUILDS, small, "U2")
    cfg = FLAGSHIP_H100
    out = _chain_pair(cfg, batches, 3, "FLAGSHIP_H100", nan_at=1)
    graphed = out["graphed"]
    want = _chain_want(cfg, CHAIN)
    check(all(n == want for n in graphed["launches"]),
          f"[chain] the graphed chains launched {graphed['launches']}, not K1-K4 once per "
          f"update ({want})")
    check(graphed["skipped"] == [0.0, 0.0, 1.0] == out["plain"]["skipped"],
          f"[chain] skips {graphed['skipped']} / {out['plain']['skipped']}, not 0, 0, 1")
    check(graphed["state"].scheduler.last_epoch == 3 * CHAIN - 1,
          f"[chain] the schedule reads {graphed['state'].scheduler.last_epoch} after one skip")
    check(len(graphed["step"].captured) == 1, "the chain captured more than one graph")
    print(f"[chain] U2 FLAGSHIP_H100 batch {TRAIN_BATCH}: 2 graphed chains of {CHAIN} equal the "
          f"uncaptured chained step bit for bit (weights, moments, counts, schedule, every "
          f"update's logs); launches per chain {_launched(graphed['launches'][0])}; capture "
          f"{graphed['step'].capture_s[0]:.2f} s (warm-up update included), the graph's pool "
          f"{graphed['step'].pool_bytes / 2**30:.2f} GiB; U4: a NaN in "
          f"update 2 of chain 3: skips {graphed['skipped']}, the same bits, schedule at "
          f"{graphed['state'].scheduler.last_epoch}", flush=True)

    # U3: the first chain against CHAIN eager steps from the same seeded state
    model = build_model(cfg, device="cuda", seed=SEED)
    state = create_train_state(model, cfg["training_specific"], steps_per_epoch=64, seed=SEED)
    eager = make_train_step(model, state.optimizer, state.scheduler, build_losses(cfg),
                            torch.device("cuda"))
    eager_logs = torch.stack([torch.stack(list(eager(b, k, SEED).values())[:3])
                              for k, b in enumerate(batches)])
    grads = {n: p.grad for n, p in model.named_parameters()}
    after = model.state_dict()
    on_noise, least, least_leaf = grad_split(grads, noise_entries(after))
    check(0.0 < on_noise < NOISE_GRAD <= least,
          f"[chain] U3: the key-bias entries' eager gradient reads up to {on_noise:.3e} and the "
          f"least leaf outside them ({least_leaf}) {least:.3e}: not below and above "
          f"NOISE_GRAD {NOISE_GRAD}")
    start = build_model(cfg, device="cuda", seed=SEED).state_dict()
    bound = chain_eager_bound(cfg["training_specific"]["lr"], CHAIN)
    r = _vs_eager(graphed["bits"][0]["model"], after, start, grads, build_dtype(cfg))
    chain_logs = graphed["logs"][0][:, :3]
    log_rel = ((chain_logs - eager_logs).abs() / eager_logs.abs()).max().item()
    print(f"[chain] U3: chain of {CHAIN} vs {CHAIN} eager steps: max |weight difference| "
          f"{r['max_weight_diff']:.3e} at {r['leaf']} outside the {len(r['noise_entries'])} "
          f"key-bias entries (bound {bound:.3e} = chain_eager_bound(lr, {CHAIN})), "
          f"{r['noise_diff']:.3e} on them; their eager |gradient| up to {on_noise:.3e}, the least "
          f"leaf outside {least:.3e} ({least_leaf}); a leaf left unchanged lies at least "
          f"{r['unchanged']:.3e} from the eager steps', a chain of the wrong sign "
          f"{r['flipped']:.3e}; update 1's logs bit-equal, the rest within {log_rel:.2e} relative",
          flush=True)
    check(torch.equal(chain_logs[0], eager_logs[0]),
          "[chain] U3: update 1's logs differ from the eager step's")
    check(r["max_weight_diff"] <= bound, f"[chain] U3: {r['leaf']} lies "
          f"{r['max_weight_diff']:.3e} from the eager steps' (bound {bound:.3e})")
    check(r["unchanged"] > bound and r["flipped"] > bound,
          f"[chain] U3: the bound {bound:.3e} passes an unchanged leaf ({r['unchanged']:.3e}) or "
          f"a chain of the wrong sign ({r['flipped']:.3e})")
    out["u3"] = dict(r, bound=bound, grad_noise=on_noise, grad_least=least, log_rel=log_rel)
    out["eager"] = dict(state=state, step=eager)
    out["builds"] = builds
    return out


def _chain_cli(d: str) -> dict:
    """U5. ``train_torch.main --chain CHAIN`` on phase I's npz files under
    phase J's ``FLAGSHIP_H100`` config: one epoch (FILE_BATCHES updates, one
    chain; K1-K4 once per update, K1 and K3 once per eval batch; one train
    record), its weights after the epoch within ``chain_eager_bound`` of
    phase J's eager epoch on the same files and seed outside the key-bias
    entries, then a resume under ``--chain 1``."""
    import train_torch

    cfg_path = os.path.join(d, "h100.json")
    logdir = os.path.join(d, "logs")
    common = ["-c", cfg_path, "-n", "chain", "--logdir", logdir, "--epochs", "1", "--seed",
              str(SEED)]
    n_eval = -(-CLI_VAL_SCENES // TRAIN_BATCH)
    want = dict(_chain_want(FLAGSHIP_H100, FILE_BATCHES), sde_rollout=FILE_BATCHES + n_eval,
                aa_fused=FILE_BATCHES + n_eval)
    out = {}
    for tag, extra in (("chain", ["--chain", str(CHAIN)]), ("resume", None)):
        if extra is None:
            board = CheckpointManager(os.path.join(logdir, "chain", "checkpoints"))
            extra = ["--chain", "1", "--ckpt", board.latest()["path"]]
        zero_counts()
        t0 = time.perf_counter()
        state, trainer = train_torch.main(common + extra)
        wall = time.perf_counter() - t0
        launches = _all_counts()
        steps = FILE_BATCHES * (2 if tag == "resume" else 1)
        check(state.step == steps, f"[chain cli {tag}] ended at step {state.step}, not {steps}")
        check(launches == want, f"[chain cli {tag}] launched {launches}, not {want}")
        epoch = trainer.epoch_logs[-1]
        check(epoch["train/steps_skipped"] == 0.0, f"[chain cli {tag}] a step was skipped")
        vals = {k: v for k, v in epoch.items() if k.startswith("val/")}
        check(vals and all(np.isfinite(v) for v in vals.values()),
              f"[chain cli {tag}] non-finite val metrics {vals}")
        with open(os.path.join(logdir, "chain", "metrics.jsonl")) as f:
            records = [r["step"] for r in map(json.loads, f) if "train/total" in r]
        out[tag] = dict(launches=launches, wall_s=wall, records=records, val=vals,
                        ms_per_update=1e3 / epoch["perf/steps_per_s"])
        print(f"[chain] U5 train_torch.py {' '.join(extra[:2])} {tag}: step {state.step}, "
              f"launches {_launched(launches)}, train records at steps {records}, "
              f"{out[tag]['ms_per_update']:.1f} ms an update over the epoch (capture "
              f"included on the first), val " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
              + f"; {wall:.1f} s", flush=True)
        if tag == "chain":
            check(records == [FILE_BATCHES], f"[chain cli] train records at {records}, not one "
                  f"after the chain of {FILE_BATCHES}")
            eager_path = os.path.join(logdir, "cli", "checkpoints", f"step_{FILE_BATCHES:08d}")
            check(os.path.isdir(eager_path), f"[chain cli] phase J's eager checkpoint "
                  f"{eager_path} is missing: nothing to hold the chained epoch against")
            eager = torch.load(os.path.join(eager_path, "state.pt"), map_location="cuda",
                               weights_only=True)["model"]
            chained = state.model.state_dict()
            noise = noise_entries(eager)
            dist, leaf = largest_gap(chained, eager, noise)
            noise_dist = largest_gap(chained, eager, noise, inside=True)[0]
            bound = chain_eager_bound(FLAGSHIP_H100["training_specific"]["lr"], FILE_BATCHES)
            # the chain's last gradient at the entry that lies furthest, beside
            # its leaf's largest: whether that entry's gradient is rounding noise
            grad = state.model.get_parameter(leaf).grad
            at = (chained[leaf] - eager[leaf]).abs().argmax()
            grads = ("not kept" if grad is None else
                     f"{grad.flatten()[at].abs().item():.3e} there, {grad.abs().max().item():.3e} "
                     f"its leaf's largest")
            out["vs_eager_epoch"] = dict(max_weight_diff=dist, leaf=leaf, bound=bound,
                                         noise_diff=noise_dist, grads=grads)
            print(f"[chain] U5: the chained epoch's weights vs phase J's eager epoch on the "
                  f"same files and seed: max |difference| {dist:.3e} at {leaf} outside the "
                  f"key-bias entries (bound {bound:.3e}), {noise_dist:.3e} on them; the chain's "
                  f"last |gradient| {grads}", flush=True)
            check(dist <= bound, f"[chain cli] {leaf} of the chained epoch lies {dist:.3e} "
                  f"from phase J's eager epoch (bound {bound:.3e})")
    return out


def _turns_and_trace(fns: dict, rounds: int, updates: int) -> dict:
    """In ``rounds`` alternating rounds, each of ``fns`` (``updates``
    updates each): ms per update by CUDA events and by the host clock (each
    synchronized) and peak memory; then one call of each under the
    profiler (:func:`_traced`: the idle share, the kernels in the trace
    beside the counters)."""
    times = {k: {"cuda": [], "host": [], "peak_gib": []} for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms, host = _timed(fn)
            times[k]["cuda"].append(ms / updates)
            times[k]["host"].append(host / updates)
            times[k]["peak_gib"].append(torch.cuda.max_memory_allocated() / 2**30)
    out = {k: dict(v, cuda_median=statistics.median(v["cuda"]),
                   host_median=statistics.median(v["host"])) for k, v in times.items()}
    for k, fn in fns.items():
        out[k].update(_traced(fn))
    return out


def _turns_line(out: dict, fns) -> str:
    return ("ms per update (CUDA events / host clock): " + "; ".join(
        f"{k} " + ", ".join(f"{c:.2f}/{h:.2f}" for c, h in zip(v["cuda"], v["host"]))
        + f" (medians {v['cuda_median']:.2f}/{v['host_median']:.2f}), peak "
        + ", ".join(f"{p:.2f}" for p in v["peak_gib"]) + " GiB"
        for k, v in ((k, out[k]) for k in fns))
        + "; under torch.profiler: " + "; ".join(
            f"{k} {out[k]['profiled_wall_ms']:.1f} ms, busy {out[k]['busy_ms']:.1f} ms, idle "
            + (f"{out[k]['idle_share']:.3f}" if out[k]["idle_share"] is not None
               else "not measured (no device events)") for k in fns))


def _chain_turns(card: str, graph: dict, batches: list) -> dict:
    """U6. In CHAIN_ROUNDS alternating rounds, CHAIN eager updates against
    one graphed chain of CHAIN on the same batches (:func:`_turns_and_trace`);
    K1-K4's kernels counted by name in the profiled graphed chain's trace
    must run each once per update, as many times as its replays added to
    the counters."""
    state_g, chained = graph["graphed"]["state"], graph["graphed"]["step"]
    state_e, eager = graph["eager"]["state"], graph["eager"]["step"]

    def run_eager():
        for b in batches:
            eager(b, state_e.step, state_e.seed)
            state_e.step += 1

    def run_chain():
        chained(batches, state_g.step, state_g.seed)
        state_g.step += len(batches)

    fns = {"eager": run_eager, "chained": run_chain}
    out = _turns_and_trace(fns, CHAIN_ROUNDS, CHAIN)
    traced, counted = out["chained"]["traced"], out["chained"]["counted"]
    check(traced == counted == _chain_want(FLAGSHIP_H100, CHAIN),
          f"[chain] U6: the profiled graphed chain of {CHAIN} ran {traced} by the trace, and the "
          f"counters added {counted}: not K1-K4 once an update")
    out["capture_s"] = chained.capture_s[0]
    out["pool_gib"] = chained.pool_bytes / 2**30
    out["reserved_gib"] = torch.cuda.memory_reserved() / 2**30
    print(f"[chain] U6 {card}: FLAGSHIP_H100 at batch {TRAIN_BATCH}, {CHAIN} updates a round, "
          f"{CHAIN_ROUNDS} rounds in turns; " + _turns_line(out, fns)
          + f"; in the profiled graphed chain's trace {_launched(traced)} (as "
          f"{out['chained']['kernel_names']}), the counters {_launched(counted)}; capture "
          f"{out['capture_s']:.2f} s; the graph's "
          f"pool {out['pool_gib']:.2f} GiB (the chained update's activations: replays allocate "
          f"nothing else, so its peak reads low); reserved in all {out['reserved_gib']:.2f} GiB",
          flush=True)
    return out


def _chain_wide(card: str, full: list, builds: dict = None, label: str = "U8",
                chain: int = CHAIN, rounds: int = CHAIN_WIDE_ROUNDS, nan: bool = True,
                uncaptured: bool = False) -> dict:
    """U8 (and U10 / U11 at full width). Each of ``builds`` (CHAIN_WIDE:
    name -> (config, batch)) with dropout live, from one seed:
    a graphed chain of ``chain`` against ``chain`` eager steps on the same
    batches (update 1's logs bit-equal, every weight outside the key-bias
    entries within ``chain_eager_bound`` for the build's dtype, which a
    trained leaf left unchanged and a chain of the wrong sign fail; the
    launches; with ``uncaptured``, also the same chain run uncaptured, whose
    logs and state the graphed chain's must equal bit for bit); with
    ``nan`` then a chain with a NaN planted in update 2,
    skipped in both paths; then the two in ``rounds`` alternating rounds
    with the idle share, the build's kernels counted by name in the
    profiled graphed chain's trace, equal to the counters, the graph's
    nodes and pool and the capture's seconds; each part's seconds.
    ``full``: U2's CHAIN batches of TRAIN_BATCH, which a path at that batch
    reuses.  Each build is released before the next."""
    out = {}
    for name, (cfg, batch) in (builds or CHAIN_WIDE).items():
        t0 = time.perf_counter()
        split = {}

        def lap(part):
            torch.cuda.synchronize()
            split[part] = time.perf_counter() - t0 - sum(split.values())

        rng = np.random.default_rng(SEED + 71)
        batches = (list(full[:chain]) if batch == TRAIN_BATCH else
                   [_train_batch(rng, batch).to("cuda") for _ in range(chain)])
        losses, lr = build_losses(cfg), cfg["training_specific"]["lr"]
        states = [create_train_state(build_model(cfg, device="cuda", seed=SEED),
                                     cfg["training_specific"], steps_per_epoch=64, seed=SEED)
                  for _ in range(3 if uncaptured else 2)]
        state_e, state_g = states[:2]
        start = {k: v.clone() for k, v in state_e.model.state_dict().items()}
        eager = make_train_step(state_e.model, state_e.optimizer, state_e.scheduler, losses,
                                torch.device("cuda"))
        chained = ChainedStep(state_g.model, state_g.optimizer, state_g.scheduler, losses,
                              torch.device("cuda"), accum_steps=1)
        want = _chain_want(cfg, chain)
        lap("models and batches")
        zero_counts()
        eager_logs = torch.stack([torch.stack([logs[n] for n in chained.names]) for logs in
                                  (eager(b, k, SEED) for k, b in enumerate(batches))])
        check(_all_counts() == want, f"[chain {name}] {chain} eager steps launched "
              f"{_all_counts()}, not {want}")
        grads = {n: p.grad for n, p in state_e.model.named_parameters()}
        after = {k: v.clone() for k, v in state_e.model.state_dict().items()}
        lap(f"{chain} eager steps")
        zero_counts()
        chained(batches, 0, SEED)
        launches = _all_counts()
        lap("the graphed chain (capture included)")
        check(launches == want, f"[chain {name}] the graphed chain launched {launches}, not "
              f"{want}")
        if uncaptured:
            state_u = states[2]
            plain = ChainedStep(state_u.model, state_u.optimizer, state_u.scheduler, losses,
                                torch.device("cuda"), accum_steps=1, graphs=False)
            plain(batches, 0, SEED)
            bad = _same_bits(_state_bits(state_u), _state_bits(state_g))
            check(not bad and _logs_equal(plain.chain_logs, chained.chain_logs),
                  f"[chain {name}] {label}: the graphed chain differs from the uncaptured one at "
                  f"{bad[:5]} ({len(bad)} entries) or in its logs")
            print(f"[chain] {label} {name} at batch {batch}: the graphed chain of {chain} equals "
                  "the uncaptured one bit for bit (weights, moments, counts, schedule, logs)",
                  flush=True)
            del plain, state_u, states[2]
            lap("the uncaptured chain")
        chain_logs = chained.chain_logs[:, :-1]
        check(torch.equal(chain_logs[0], eager_logs[0]),
              f"[chain {name}] {label}: update 1's logs differ from the eager step's")
        log_rel = ((chain_logs - eager_logs).abs() / eager_logs.abs()).max().item()
        dtype = build_dtype(cfg)
        r = _vs_eager(state_g.model.state_dict(), after, start, grads, dtype)
        lap("the weights' comparison")
        bound = chain_eager_bound(lr, chain, dtype)
        print(f"[chain] {label} {name} at batch {batch}: a graphed chain of {chain} vs {chain} "
              f"eager steps: max |weight difference| {r['max_weight_diff']:.3e} "
              f"({r['max_weight_diff'] / lr:.4f} lr) at {r['leaf']} outside the "
              f"{len(r['noise_entries'])} key-bias entries, {r['noise_diff']:.3e} on them; "
              f"chain_eager_gap ({dtype}) {r['gap']:.3e} at {r['gap_leaf']} (bound "
              f"{bound:.3e}), a trained leaf left unchanged at least {r['unchanged']:.3e}, a "
              f"chain of the wrong sign {r['flipped']:.3e}; update 1's logs bit-equal, the rest "
              f"within {log_rel:.2e} relative; launches {_launched(launches)}", flush=True)
        check(r["gap"] <= bound, f"[chain {name}] {label}: {r['gap_leaf']} lies {r['gap']:.3e} "
              f"from the eager steps' by chain_eager_gap (bound {bound:.3e})")
        check(r["unchanged"] > bound and r["flipped"] > bound,
              f"[chain {name}] {label}: the bound {bound:.3e} passes an unchanged leaf "
              f"({r['unchanged']:.3e}) or a chain of the wrong sign ({r['flipped']:.3e})")
        skipped_g, step = None, [chain, chain]
        if nan:   # a NaN planted in update 2: skipped in both paths
            bad = dataclasses.replace(batches[1], x=batches[1].x.clone())
            bad.x[0, 1, 3, 0] = float("nan")
            nan_chain = [batches[0], bad] + batches[2:]
            chained(nan_chain, chain, SEED)
            skipped_e = [eager(b, chain + k, SEED)["train/step_skipped"]
                         for k, b in enumerate(nan_chain)]
            skipped_g = chained.chain_logs[:, -1].tolist()
            want_skips = [0.0, 1.0] + [0.0] * (chain - 2)
            check(skipped_g == skipped_e == want_skips and state_g.scheduler.last_epoch
                  == state_e.scheduler.last_epoch == 2 * chain - 1,
                  f"[chain {name}] {label}: the planted NaN: chained skips {skipped_g}, eager "
                  f"{skipped_e}, schedules {state_g.scheduler.last_epoch} / "
                  f"{state_e.scheduler.last_epoch}")
            lap("the planted NaN, both paths")
            step = [2 * chain, 2 * chain]

        def run_eager():
            for b in batches:
                eager(b, step[0], SEED)
                step[0] += 1

        def run_chain():
            chained(batches, step[1], SEED)
            step[1] += chain

        fns = {"eager": run_eager, "chained": run_chain}
        turns = _turns_and_trace(fns, rounds, chain)
        traced, counted = turns["chained"]["traced"], turns["chained"]["counted"]
        check(traced == counted == want,
              f"[chain {name}] {label}: the profiled graphed chain ran {traced} by the trace; the "
              f"counters added {counted}, the build launches {want} a chain")
        profiled = {k: turns[k]["seconds"] for k in fns}
        lap(f"{rounds} rounds in turns and one profiled call of each")
        out[name] = dict(batch=batch, launches=launches, traced=traced, u8=dict(r, bound=bound,
                         log_rel=log_rel), skipped=skipped_g, turns=turns,
                         capture_s=chained.capture_s[0], pool_gib=chained.pool_bytes / 2**30,
                         graph_nodes=chained.graph_nodes[0], chain=chain,
                         seconds=time.perf_counter() - t0, split_s=split, profiled_s=profiled)
        print(f"[chain] {label} {card}: {name} at batch {batch}, {chain} updates a round, "
              f"{rounds} rounds in turns; " + _turns_line(turns, fns)
              + f"; in the profiled graphed chain's trace {_launched(traced) or 'none'} (as "
              f"{turns['chained']['kernel_names']}), the counters {_launched(counted) or 'none'}; "
              + (f"the NaN in update 2 skipped in both paths ({skipped_g}); " if nan
                 else "")
              + f"capture {chained.capture_s[0]:.2f} s, the graph's nodes "
              f"{chained.graph_nodes[0]}, its pool {out[name]['pool_gib']:.2f} GiB; "
              f"{out[name]['seconds']:.1f} s: " + ", ".join(f"{k} {v:.1f} s"
                                                          for k, v in split.items())
              + " (the profiled calls, trace processing included: "
              + ", ".join(f"{k} {v:.1f} s" for k, v in profiled.items()) + ")", flush=True)
        del states, state_e, state_g, eager, chained, batches, start, after, grads, fns
        torch.cuda.empty_cache()
    return out


def _chain_cli_fast(d: str) -> dict:
    """U9. ``train_torch.main`` on a JSON copy of ``_tpu_fast.yml``
    (``FLAGSHIP_BF16_CAPPED``, its batch of 128) over phase I's npz files and
    J's validation scenes: one epoch with ``--chain 1``, then one with
    ``--chain CHAIN`` from the same seed (FILE_BATCHES updates, one chain):
    no kernel launches (dense AA, scan decoder), no skip, finite val
    metrics, one train record a chain, and the chained epoch's weights
    within ``chain_eager_bound`` (bf16) of the eager epoch's outside the
    key-bias entries."""
    import train_torch

    cfg = copy.deepcopy(FLAGSHIP_BF16_CAPPED)
    kw = cfg["datamodule_specific"]["kwargs"]
    kw.update(nu_dir=os.path.join(d, "npz", "nuScenes"),
              Argo_dir=os.path.join(d, "npz", "Argoverse"), num_workers=2)
    check(kw["train_batch_size"] == TRAIN_BATCH and build_dtype(cfg) == "bfloat16"
          and cfg["encoder"]["kwargs"]["neighbor_cap"] == CAP,
          "FLAGSHIP_BF16_CAPPED is not the _tpu_fast recipe at batch 128")
    path = os.path.join(d, "tpu_fast.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    logdir = os.path.join(d, "logs")
    want = _chain_want(cfg, FILE_BATCHES)
    out, weights = {}, {}
    for tag, chain in (("eager", 1), ("chain", CHAIN)):
        zero_counts()
        t0 = time.perf_counter()
        state, trainer = train_torch.main(["-c", path, "-n", f"fast_{tag}", "--logdir", logdir,
                                           "--epochs", "1", "--seed", str(SEED), "--chain",
                                           str(chain)])
        wall = time.perf_counter() - t0
        launches = _all_counts()
        check(state.step == FILE_BATCHES, f"[chain fast {tag}] ended at step {state.step}")
        check(launches == want, f"[chain fast {tag}] launched {launches}, not {want}")
        epoch = trainer.epoch_logs[-1]
        check(epoch["train/steps_skipped"] == 0.0, f"[chain fast {tag}] a step was skipped")
        vals = {k: v for k, v in epoch.items() if k.startswith("val/")}
        check(vals and all(np.isfinite(v) for v in vals.values()),
              f"[chain fast {tag}] non-finite val metrics {vals}")
        with open(os.path.join(logdir, f"fast_{tag}", "metrics.jsonl")) as f:
            records = [r["step"] for r in map(json.loads, f) if "train/total" in r]
        check(records == (list(range(1, FILE_BATCHES + 1)) if chain == 1 else [FILE_BATCHES]),
              f"[chain fast {tag}] train records at {records}")
        weights[tag] = {k: v.clone() for k, v in state.model.state_dict().items()}
        out[tag] = dict(launches=launches, wall_s=wall, records=records, val=vals,
                        ms_per_update=1e3 / epoch["perf/steps_per_s"])
        print(f"[chain] U9 train_torch.py -c tpu_fast.json --chain {chain}: step {state.step}, "
              f"launches {_launched(launches) or 'none'}, train records at {records}, "
              f"{out[tag]['ms_per_update']:.1f} ms an update over the epoch, val "
              + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()) + f"; {wall:.1f} s",
              flush=True)
        del state, trainer
    start = build_model(cfg, device="cuda", seed=SEED).state_dict()
    noise = noise_entries(weights["eager"])
    dist, leaf = largest_gap(weights["chain"], weights["eager"], noise)
    gap, gap_leaf = chain_eager_gap(weights["chain"], weights["eager"], start, build_dtype(cfg))
    bound = chain_eager_bound(cfg["training_specific"]["lr"], FILE_BATCHES, build_dtype(cfg))
    out["vs_eager_epoch"] = dict(max_weight_diff=dist, leaf=leaf, gap=gap, gap_leaf=gap_leaf,
                                 bound=bound,
                                 noise_diff=largest_gap(weights["chain"], weights["eager"], noise,
                                                        inside=True)[0])
    print(f"[chain] U9: the chained epoch's weights vs the eager epoch's: max |difference| "
          f"{dist:.3e} at {leaf} outside the key-bias entries, "
          f"{out['vs_eager_epoch']['noise_diff']:.3e} on them; chain_eager_gap (bf16) {gap:.3e} "
          f"at {gap_leaf} (bound {bound:.3e})", flush=True)
    check(gap <= bound, f"[chain fast] {gap_leaf} of the chained epoch lies {gap:.3e} from the "
          f"eager epoch's by chain_eager_gap (bound {bound:.3e})")
    return out


def phase_chain(d: str, card: str) -> dict:
    """U. The chained train step (``train_torch.py --chain``): U1 the device
    keys of K1 / K2, U2-U4 the graphed chain of ``FLAGSHIP_H100`` (and U2 of
    the other f32 builds), U5 the command line on J's files, U6 eager
    against chained in turns, U7 every other shipped build's graphed chain,
    U8 the full-width bf16 paths, U9 ``_tpu_fast.yml``'s command line."""
    t_phase = time.perf_counter()
    keys = _chain_keys()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 61)
    batches = [_train_batch(rng, TRAIN_BATCH).to("cuda") for _ in range(CHAIN)]
    small = [_train_batch(rng, CHAIN_BUILD_BATCH).to("cuda") for _ in range(2)]
    graph = _chain_graph(card, batches, small)
    torch.cuda.empty_cache()
    cli = _chain_cli(d)
    torch.cuda.empty_cache()
    turns = _chain_turns(card, graph, batches)
    # chain_train's launches: as the trace of a graphed chain saw them
    launches = turns["chained"]["traced"]
    out = dict(keys=keys, launches=launches, u3=graph["u3"], cli=cli, turns=turns)
    builds = graph["builds"]
    del graph
    torch.cuda.empty_cache()
    t_more = time.perf_counter()
    builds.update(_chain_builds(CHAIN_MORE_BUILDS, small, "U7"))
    print(f"[chain] U7: {time.perf_counter() - t_more:.1f} s", flush=True)
    torch.cuda.empty_cache()
    out["wide"] = _chain_wide(card, batches)
    torch.cuda.empty_cache()
    out["fast_cli"] = _chain_cli_fast(d)
    out["builds"] = builds
    torch.cuda.empty_cache()
    out["remat"], out["adaptive"] = _chain_options(card, batches, small)
    print(f"[chain] phase U: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def _chain_options(card: str, batches: list, small: list) -> tuple:
    """U10 and U11: ``encoder.remat`` and ``encoder.adaptive`` under
    ``--chain``.  U10: each of CHAIN_REMAT_BUILDS with remat, U2's check at
    CHAIN_BUILD_BATCH (K3 / K3b twice an update, forward and recompute, in
    the trace and the counters), its graphed chain also the graphed chain of
    the same build without remat bit for bit; then ``FLAGSHIP_H100`` with
    remat at TRAIN_BATCH as U8 (no NaN), a chain of CHAIN against eager in
    CHAIN_WIDE_ROUNDS rounds.  U11, after U10's pools are freed: the
    adaptive ``FLAGSHIP_H100`` at TRAIN_BATCH the same way, chains of
    ADAPTIVE_CHAIN, its graphed chain also its uncaptured chain's bits; then
    each of CHAIN_ADAPTIVE_BUILDS adaptive as U10's builds (no twin).  Each
    graph's node count is printed."""
    t0 = time.perf_counter()
    remat = {n: _remat(c) for n, c in CHAIN_REMAT_BUILDS.items()}
    out_r = dict(builds=_chain_builds(remat, small, "U10", twins=CHAIN_REMAT_BUILDS))
    torch.cuda.empty_cache()
    out_r["wide"] = _chain_wide(card, batches, {"FLAGSHIP_H100+remat": (
        _remat(FLAGSHIP_H100), TRAIN_BATCH)}, "U10", nan=False)
    out_r["seconds"] = time.perf_counter() - t0
    print(f"[chain] U10: {out_r['seconds']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out_a = dict(wide=_chain_wide(card, batches, {"FLAGSHIP_H100+adaptive": (
        _adaptive(FLAGSHIP_H100), TRAIN_BATCH)}, "U11", chain=ADAPTIVE_CHAIN, nan=False,
        uncaptured=True))
    torch.cuda.empty_cache()
    adaptive = {n: _adaptive(_remat(c) if n.endswith("+remat") else c)
                for n, c in CHAIN_ADAPTIVE_BUILDS.items()}
    out_a["builds"] = _chain_builds(adaptive, small, "U11")
    out_a["seconds"] = time.perf_counter() - t0
    print(f"[chain] U11: {out_a['seconds']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return out_r, out_a


def main() -> None:
    t_start = time.perf_counter()
    card = phase_device()
    checks = phase_build()
    model = build_model(FLAGSHIP, device="cuda", seed=SEED)
    engine = ServingEngine(model, num_actors=NUM_ACTORS, num_lanes=NUM_LANES, device="cuda",
                           seed=SEED)
    fwd = phase_kernels(model, engine.buckets)
    served, dense_k3, dense_k4, dense_ms = phase_serve(engine, model)
    phase_splice(model)
    # the same seeded weights with encoder.fused: true (one parameter tree)
    fused_model = build_model(FLAGSHIP_FUSED, device="cuda", seed=SEED)
    k3 = phase_fused_kernel(fused_model)
    fused_engine = ServingEngine(fused_model, num_actors=NUM_ACTORS, num_lanes=NUM_LANES,
                                 device="cuda", seed=SEED)
    served_fused, k3_served, fused_k4, fused_ms = phase_serve(fused_engine, fused_model,
                                                              "serve-fused")
    print("[serve-fused] second calls, fused vs dense encoder (phase 4, this run): "
          + "; ".join(f"batch {n} {fused_ms[n]:.1f} vs {dense_ms[n]:.1f} ms" for n in BATCHES),
          flush=True)
    k3_ood, k4_ood = phase_fused_splice(model, fused_model)
    k5 = phase_aa_attention(model, checks["one_term_k5"])
    k6 = phase_vpu_probe()
    engine.close()
    fused_engine.close()
    del engine, model, fused_engine, fused_model
    torch.cuda.empty_cache()
    train_model = build_model(FLAGSHIP_TRAIN, device="cuda", seed=SEED)
    bwd = phase_backward(train_model, train_rows(train_model))
    del train_model
    torch.cuda.empty_cache()
    trained = phase_train(FLAGSHIP_TRAIN, TRAIN_BATCH)
    phase_train_splice()
    torch.cuda.empty_cache()
    k4 = phase_fused_backward()
    trained_fused = phase_train(FLAGSHIP_TRAIN_FUSED, TRAIN_BATCH, "train-fused")
    print(f"[train-fused] fused vs dense AA encoder (phase 7, this run): "
          f"{trained_fused['ms']:.1f} vs {trained['ms']:.1f} ms/step, "
          f"{trained_fused['scenes_per_s']:.1f} vs {trained['scenes_per_s']:.1f} scenes/s, peak "
          f"{trained_fused['peak_gib']:.2f} vs {trained['peak_gib']:.2f} GiB", flush=True)
    phase_fused_train_splice()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        from_files = phase_train_from_files(trained_fused["ms"], d)
        torch.cuda.empty_cache()
        cli = phase_cli(d, from_files, card)
        torch.cuda.empty_cache()
        engine_k = phase_engine(d, card)
        torch.cuda.empty_cache()
        baseline = phase_baseline(card, checks)
        torch.cuda.empty_cache()
        capped = phase_capped(card)
        accum = phase_accum(d, card)
        torch.cuda.empty_cache()
        bf16 = phase_bf16(card, capped["overflow_edges"])
        torch.cuda.empty_cache()
        multi = phase_multigpu(d, card)
        torch.cuda.empty_cache()
        exported = phase_export(d, card)
        torch.cuda.empty_cache()
        converted = phase_converted(d, card)
        torch.cuda.empty_cache()
        chain = phase_chain(d, card)
        torch.cuda.empty_cache()
    k3b, k4b, bf16_serve, bf16_train = phase_bf16_fused(card, checks)
    torch.cuda.empty_cache()
    adaptive = phase_adaptive(card)
    torch.cuda.empty_cache()
    remat = phase_remat(card)
    k3.update(baseline["k3"])
    k4.update(baseline["k4"])
    # launches: the count on the kernel's own main path (serving for K1,
    # training for K2, fused serving for K3, fused-encoder training for K4);
    # launches_by_path: every path's
    train, train_fused = trained["launches"], trained_fused["launches"]
    fwd["launches"], bwd["launches"] = served, train["sde_rollout_bwd"]
    k3["launches"], k4["launches"] = k3_served, train_fused["aa_fused_bwd"]
    fwd["launches_by_path"] = {"serve": served, "serve_fused": served_fused,
                               "train": train["sde_rollout"],
                               "train_fused": train_fused["sde_rollout"]}
    bwd["launches_by_path"] = {"serve": 0, "serve_fused": 0, "train": train["sde_rollout_bwd"],
                               "train_fused": train_fused["sde_rollout_bwd"]}
    k3["launches_by_path"] = {"serve_fused": k3_served, "ood": k3_ood, "serve": dense_k3,
                              "train": train["aa_fused"], "train_fused": train_fused["aa_fused"]}
    k4["launches_by_path"] = {"train_fused": train_fused["aa_fused_bwd"], "serve": dense_k4,
                              "serve_fused": fused_k4, "ood": k4_ood,
                              "train": train["aa_fused_bwd"]}
    # K5 and K6 run on their own paths (the op, the probe); phases 4 and B
    # checked that serving launches neither
    k5["launches_by_path"] = {"aa_attention": k5["launches"], "serve": 0, "serve_fused": 0,
                              "train": train["aa_attention"],
                              "train_fused": train_fused["aa_attention"]}
    k6["launches_by_path"] = {"probe": k6["launches"], "serve": 0, "serve_fused": 0,
                              "train": train["vpu_probe"], "train_fused": train_fused["vpu_probe"]}
    # phase J: the CLI's own paths (train_torch.py's first run, test_torch.py plain)
    for entry, name in ((fwd, "sde_rollout"), (bwd, "sde_rollout_bwd"), (k3, "aa_fused"),
                        (k4, "aa_fused_bwd"), (k5, "aa_attention"), (k6, "vpu_probe")):
        entry["launches_by_path"]["cli_train"] = cli["train"]["launches"][name]
        entry["launches_by_path"]["cli_test"] = cli["test plain"]["launches"][name]
        # phase K: the micro-batcher's submitted scenes, and serve_torch.py
        entry["launches_by_path"]["engine_submit"] = engine_k["submit"]["launches"][name]
        entry["launches_by_path"]["serve_cli"] = engine_k["serve_cli"]["launches"][name]
        # phase L: the baseline's forward, train steps and scan engine, dense and fused
        for tag, prefix in (("dense", "baseline"), ("fused", "baseline_fused")):
            paths, b = entry["launches_by_path"], baseline[tag]
            paths[f"{prefix}_forward"] = b["forward_launches"][name]
            paths[f"{prefix}_train"] = b["train_launches"][name]
            paths[f"{prefix}_engine"] = b["engine"]["launches"][name]
        # phase M: a train step at cap 24, and the --accum 2 --async-ckpt CLI's epoch
        entry["launches_by_path"]["capped_train"] = capped["step_launches"][name]
        entry["launches_by_path"]["accum_cli_train"] = accum["cli_train"]["launches"][name]
        # phase N: bf16 served at bucket 128, a bf16 train step, a bf16 step at cap 24
        entry["launches_by_path"]["bf16_serve"] = bf16["serve"]["launches"][name]
        entry["launches_by_path"]["bf16_train"] = bf16["train"]["launches"][name]
        entry["launches_by_path"]["bf16_capped_train"] = bf16["capped"]["launches"][name]
        # phase O: adaptive: true served at bucket 128, and an adaptive train step
        entry["launches_by_path"]["adaptive_serve"] = adaptive["serve"]["launches"][name]
        entry["launches_by_path"]["adaptive_train"] = adaptive["train"]["launches"][name]
        # phase P: a remat train step of each build
        for tag, r in remat.items():
            entry["launches_by_path"][f"remat_{tag.replace(' ', '_')}_train"] = \
                r["step_launches"][name]
        # phase Q: train_torch.py --multihost --zero1 on one NCCL rank, and rank 0
        # of the two-rank run
        entry["launches_by_path"]["multi_cli_train"] = multi["one_rank"]["launches"][name]
        entry["launches_by_path"]["multi_two_ranks_rank0"] = \
            multi["two_ranks"]["launches"][name]
        # phase R: the artifact served 1 + 128 scenes in a process of its own,
        # and serve_torch.py --from-export
        entry["launches_by_path"]["exported_serve"] = exported["launches"][name]
        entry["launches_by_path"]["exported_cli"] = exported["cli"]["launches"][name]
        # phase S: test_torch.py --serving --ood on a converted reference checkpoint
        entry["launches_by_path"]["converted_eval"] = converted["launches"][name]
        # phase T: FLAGSHIP_BF16_FUSED served at buckets 1 and 128, its train
        # steps at 64 and dense FLAGSHIP_BF16's
        entry["launches_by_path"]["bf16_fused_serve"] = bf16_serve["launches"][name]
        entry["launches_by_path"]["bf16_fused_train"] = bf16_train["fused"]["launches"][name]
        entry["launches_by_path"]["bf16_dense_train"] = bf16_train["dense"]["launches"][name]
    # phase U: a graphed chain of FLAGSHIP_H100, each build's graphed chain
    # of 2 (U2, U7) and the full-width bf16 chains (U8), each as its trace
    # saw it; train_torch.py --chain's epoch and the _tpu_fast.yml --chain
    # epoch (U9) by the counters
    for entry, name in ((fwd, "sde_rollout"), (bwd, "sde_rollout_bwd"), (k3, "aa_fused"),
                        (k4, "aa_fused_bwd"), (k5, "aa_attention"), (k6, "vpu_probe"),
                        (k3b, "aa_fused_bf16"), (k4b, "aa_fused_bwd_bf16")):
        paths = entry["launches_by_path"]
        paths["chain_train"] = chain["launches"].get(name, 0)
        paths["chain_cli_train"] = chain["cli"]["chain"]["launches"][name]
        for build, b in chain["builds"].items():
            paths[f"chain_{build.lower()}"] = b["traced"][name]
        for build, w in chain["wide"].items():
            paths[f"chain_wide_{build.lower()}"] = w["traced"][name]
        paths["chain_fast_cli"] = chain["fast_cli"]["chain"]["launches"][name]
        # U10 / U11: the full-width remat and adaptive FLAGSHIP_H100 chains, and
        # each small build's, as their traces saw them
        for option in ("remat", "adaptive"):
            (wide,) = chain[option]["wide"].values()
            paths[f"chain_{option}"] = wide["traced"][name]
            for build, b in chain[option]["builds"].items():
                paths[f"chain_{option}_{build.lower().replace('+', '_')}"] = b["traced"][name]
    print(f"[done] {time.perf_counter() - t_start:.1f} s; K1 launches: {served} serving + "
          f"{served_fused} fused serving + {train['sde_rollout']} training + "
          f"{train_fused['sde_rollout']} fused-encoder training; K2 launches: "
          f"{bwd['launches']} training + {train_fused['sde_rollout_bwd']} fused-encoder training; "
          f"K3 launches: {k3_served} fused serving + {k3_ood} OOD + {train_fused['aa_fused']} "
          f"fused-encoder training; K4 launches: {k4['launches']} fused-encoder training; "
          f"K5 launches: {k5['launches']} on its op's path; K6 launches: {k6['launches']} on "
          f"the probe's path; K1-K4 launches training from files: "
          + ", ".join(f"{fmt} {r['launches']['aa_fused_bwd']} each"
                      for fmt, r in from_files.items())
          + f"; the CLI's train_torch.py epoch: {cli['train']['launches']}, test_torch.py: "
          f"{cli['test plain']['launches']}; the engine's {SUBMITTED} submitted scenes: "
          f"{engine_k['submit']['launches']} for {engine_k['submit']['batches']} batches; "
          f"serve_torch.py: {engine_k['serve_cli']['launches']}; "
          + "; ".join(f"the {tag} baseline's forward, {BASELINE_STEPS} train steps and scan "
                      f"engine: {b['forward_launches']}, {b['train_launches']}, "
                      f"{b['engine']['launches']}"
                      for tag, b in ((t, baseline[t]) for t in ("dense", "fused")))
          + f"; a train step at cap {CAP}: {capped['step_launches']}; the --accum 2 CLI's "
          f"epoch: {accum['cli_train']['launches']}; bf16 bucket {TRAIN_BATCH}, train step and "
          f"step at cap {CAP}: {bf16['serve']['launches']}, {bf16['train']['launches']}, "
          f"{bf16['capped']['launches']}; adaptive bucket {TRAIN_BATCH} and train step: "
          f"{adaptive['serve']['launches']}, {adaptive['train']['launches']}; a remat train "
          f"step: " + ", ".join(f"{tag} {r['step_launches']}" for tag, r in remat.items())
          + f"; --multihost --zero1 on one rank: {multi['one_rank']['launches']}; each of two "
          f"ranks ({multi['two_ranks']['backend']}) over {2 * MULTI_STEPS} updates: "
          f"{multi['two_ranks']['launches']}; the exported FLAGSHIP_H100 over 1 + "
          f"{TRAIN_BATCH} scenes and serve_torch.py --from-export over {CLI_VAL_SCENES}: "
          f"{exported['launches']}, {exported['cli']['launches']}; test_torch.py --serving "
          f"--ood on the converted checkpoint: {converted['launches']}; FLAGSHIP_BF16_FUSED "
          f"served at buckets 1 and {TRAIN_BATCH}: {bf16_serve['launches']}, "
          f"{bf16_serve['bf16_launches']}, and {BF16_FUSED_STEPS} train steps at "
          f"{BF16_FUSED_BATCH}: {bf16_train['fused']['launches']}; a graphed chain of {CHAIN} "
          f"FLAGSHIP_H100 updates: {_launched(chain['launches'])}; train_torch.py --chain "
          f"{CHAIN}'s epoch: {_launched(chain['cli']['chain']['launches'])}; graphed chains of 2 "
          f"at {CHAIN_BUILD_BATCH}: " + ", ".join(f"{b} {_launched(r['launches']) or 'none'}"
                                                  for b, r in chain["builds"].items())
          + f"; graphed chains of {CHAIN} at full width: "
          + ", ".join(f"{b} {_launched(r['launches']) or 'none'}"
                      for b, r in chain["wide"].items())
          + f"; the _tpu_fast.yml --chain {CHAIN} epoch: "
          f"{_launched(chain['fast_cli']['chain']['launches']) or 'none'}; graphed chains of 2 "
          f"at {CHAIN_BUILD_BATCH} with remat (U10) and adaptive (U11): "
          + ", ".join(f"{b} {_launched(r['launches']) or 'none'}"
                      for o in ("remat", "adaptive") for b, r in chain[o]["builds"].items())
          + "; at full width: " + ", ".join(
              f"{b} (a chain of {r['chain']}) {_launched(r['launches'])}"
              for o in ("remat", "adaptive") for b, r in chain[o]["wide"].items()), flush=True)
    print(card)
    print(json.dumps({"kernels": [fwd, bwd, k3, k4, k5, k6, k3b, k4b]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
