"""Host-side utilities: the reference-checkpoint converter, endpoint
clustering and scene plots (``trajsde_tpu/utils``)."""
