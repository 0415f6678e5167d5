"""trajsde_tpu_torch — the PyTorch/CUDA port of ``trajsde_tpu``.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find.  It imports neither JAX nor anything of
``trajsde_tpu``; the tests hold it against the JAX package on the CPU.

It serves and trains the flagship neural-SDE model:

  data/      grid constants, ``SceneBatch``, synthetic scenes, flips,
             packing, packed shards, the dataset, batch loader and
             datamodule
  models/    encoder / aggregator / decoder / prediction model
  ops/       kernel wrappers and their plain versions (the decoder
             rollout forward and backward, the fused AA pair chain forward
             and backward, ``aa_attention``, the elementwise-rate probe;
             CUDA C++ in ``csrc/``, built by nvcc at first use)
  losses.py  L2, DiffBCE, Laplace NLL
  train/     metrics, AdamW + cosine, train/eval steps, the pinned
             prefetch to the card, ``Trainer``, checkpoints
  serving.py the serving forward with the rollout kernel spliced in
  server.py  the synchronous ``ServingEngine``
  bridge.py  flax parameter tree <-> ``state_dict``; packed AA weights
  config.py  component registry, the flagship configurations, the loss
             and metric builders

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
