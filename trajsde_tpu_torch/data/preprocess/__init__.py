"""Offline preprocessors: raw Argoverse v1 CSVs and nuScenes samples ->
per-scene ``.npz`` files that the loader reads (``trajsde_tpu/data/preprocess``).

    python -m trajsde_tpu_torch.data.preprocess.argoverse --raw-dir CSV_DIR --out-dir OUT
    python -m trajsde_tpu_torch.data.preprocess.nuscenes --dataroot ROOT --out-dir OUT \\
        [--split train] [--version v1.0-trainval]

numpy only; pandas and the datasets' devkits are imported where they are used.
"""
