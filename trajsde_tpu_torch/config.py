"""Component registry and experiment configuration
(``trajsde_tpu/registry.py`` and ``trajsde_tpu/config.py``).

The YAML schema of the JAX package resolves through the same
name -> constructor registry, aliases included, and kwargs a constructor
does not take are dropped (so the JAX package's TPU knobs, such as the
decoder's ``rollout_rows``, ``rollout_unroll``, ``scan_unroll`` and
``packed``, are ignored).  ``FLAGSHIP`` holds the model, training, loss,
metric and datamodule sections of
``configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec.yml`` as a dict, so a
machine without PyYAML can build and train the flagship model;
``FLAGSHIP_TRAIN`` is the same model with ``decoder.fused: true``,
whose rollout runs through kernels K1 and K2, and ``FLAGSHIP_FUSED`` the
same model with ``encoder.fused: true``, whose AA pair chain runs through
kernel K3 (the JAX package's TPU tiling knobs of that path, ``rows_fwd`` and
``rows_bwd``, are dropped like the decoder's; ``ln_mm``, default True as in
the JAX package, reaches the encoder and changes the chain's LayerNorm
statistics in bf16).
``FLAGSHIP_TRAIN_FUSED`` is ``FLAGSHIP_TRAIN`` with ``encoder.fused: true``
as well: its training step runs K3 and K4 for the AA block and K1 and K2
for the decoder rollout.  ``FLAGSHIP_H100`` is
``configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_h100.yml``, the config the
CLIs train and evaluate on one H100 (the file's comments give the
measurements behind each choice).  ``BASELINE`` is the paper's HiVT
baseline, ``configs/nusargo/hivt_nuSArgo_trmenc_mlpdec.yml`` (a transformer
temporal encoder and a one-shot MLP decoder, no SDE), and
``BASELINE_TRAIN`` the same with ``encoder.fused: true`` (K3 and K4 at the
baseline's 4 heads on the card; their plain versions on the CPU).
``FLAGSHIP_BF16`` is ``configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_tpu.yml``:
the flagship with ``dtype: bfloat16`` on the encoder, the aggregator and the
decoder (bf16 compute over f32 parameters; the rollout kernels still run in
f32).  ``FLAGSHIP_BF16_CAPPED`` is
``configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_tpu_fast.yml`` as written (the
same with ``neighbor_cap: 24`` on the dense AA block), and
``FLAGSHIP_CAPPED`` the same recipe with its three dtypes set to ``float32``.
``FLAGSHIP_BF16_FUSED`` is ``FLAGSHIP_BF16`` with ``encoder.fused: true``, the
memory-constrained fallback that ``_tpu.yml`` names: its AA pair chain runs
in bf16 through kernels K3b (forward) and K4b (backward); the decoder is the
YAML's.
"""
from __future__ import annotations

import copy
import inspect
import json
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from trajsde_tpu_torch.data.loader import DataModuleNuArgoMix
from trajsde_tpu_torch.device import resolve_device
from trajsde_tpu_torch.losses import LOSS_REGISTRY
from trajsde_tpu_torch.models.aggregator import GlobalInteractor
from trajsde_tpu_torch.models.decoders import MLPDecoder, SDEDecoder
from trajsde_tpu_torch.models.layers import GRUUnit
from trajsde_tpu_torch.models.local_encoder import LocalEncoder
from trajsde_tpu_torch.models.prediction import PredictionModel, PredictionModelSDENet
from trajsde_tpu_torch.models.sde_encoder import LocalEncoderSDESep
from trajsde_tpu_torch.train.metrics import TransferMetric, make_metrics

REGISTRY = {cls.__name__: cls for cls in (
    LocalEncoderSDESep, GlobalInteractor, SDEDecoder, PredictionModelSDENet,
    LocalEncoder, MLPDecoder, PredictionModel,
)}
# reference module names -> native names (components and losses)
ALIASES = {"LocalEncoderSDESepPara2": "LocalEncoderSDESep", "LaplaceNLL": "LaplaceNLLLoss"}

_METRIC_ARGS = {"dataset": "nuScenes", "end_idcs": [59, 29], "sources": [0, 1]}

FLAGSHIP: Dict[str, Any] = {
    "training_specific": {
        "hivt_optimizer": True, "nodecay": False, "lr": 0.001, "weight_decay": 0.0007,
        "T_max": 100, "max_epochs": 100,
    },
    "model_specific": {
        "module_name": "PredictionModelSDENet",
        "kwargs": {
            "dataset": "nuScenes", "ref_time": 20, "historical_steps": 21,
            "future_steps": 60, "num_modes": 10, "rotate": True, "parallel": True,
            "only_agent": False, "is_gtabs": True,
        },
    },
    "encoder": {
        "module_name": "LocalEncoderSDESepPara2",
        "kwargs": {
            "max_past_t": 2, "historical_steps": 21, "node_dim": 2, "edge_dim": 2,
            "embed_dim": 64, "num_heads": 8, "dropout": 0.1, "local_radius": 50,
            "parallel": True, "input_diff": True, "minimum_step": 0.1, "ref_time": 20,
            "run_backwards": True, "adjoint": False, "rtol": 0.001, "atol": 0.001,
            "method": "euler", "adaptive": False, "sde_layers": 2,
        },
    },
    "aggregator": {
        "module_name": "GlobalInteractor",
        "kwargs": {
            "historical_steps": 21, "embed_dim": 64, "edge_dim": 2, "num_modes": 10,
            "num_heads": 8, "num_layers": 3, "dropout": 0.1, "rotate": True,
        },
    },
    "decoder": {
        "module_name": "SDEDecoder",
        "kwargs": {
            "local_channels": 64, "global_channels": 64, "future_steps": 60,
            "num_modes": 10, "max_fut_t": 6, "uncertain": True, "min_scale": 0.001,
            "min_stepsize": 0.1, "method": "euler",
        },
    },
    "losses_module": ["L2", "DiffBCE"],
    "loss_weights": [1, 1],
    "loss_args": [{"reduction": "mean"}, {"reduction": "mean"}],
    "metrics_module": ["ADE_T", "FDE_T", "MR_T"],
    "metric_args": [dict(_METRIC_ARGS) for _ in range(3)],
    "datamodule_specific": {
        "module_name": "DataModuleNuArgoMix",
        "kwargs": {
            "nu_dir": "data/preprocessed/nuScenes", "Argo_dir": "data/preprocessed/Argoverse",
            "train_batch_size": 128, "val_batch_size": 128, "num_actors": 48,
            "num_lanes": 192, "shuffle": True,
            "tr_dataset_args": {"type": "grid", "nus": True, "Argo": True, "ref_time": 20,
                                "random_flip": True, "is_gtabs": True},
            "val_dataset_args": {"type": "grid", "nus": True, "Argo": False, "ref_time": 20,
                                 "random_flip": False, "is_gtabs": True},
            "test_dataset_args": {"type": "grid", "nus": True, "Argo": False, "ref_time": 20,
                                  "random_flip": False, "is_gtabs": True},
        },
    },
}

FLAGSHIP_TRAIN: Dict[str, Any] = copy.deepcopy(FLAGSHIP)
FLAGSHIP_TRAIN["decoder"]["kwargs"]["fused"] = True

FLAGSHIP_FUSED: Dict[str, Any] = copy.deepcopy(FLAGSHIP)
FLAGSHIP_FUSED["encoder"]["kwargs"]["fused"] = True

FLAGSHIP_TRAIN_FUSED: Dict[str, Any] = copy.deepcopy(FLAGSHIP_TRAIN)
FLAGSHIP_TRAIN_FUSED["encoder"]["kwargs"]["fused"] = True

# the shipped model in f32 with both fused paths (K1-K4) and the loader's
# worker count, as configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_h100.yml
FLAGSHIP_H100: Dict[str, Any] = copy.deepcopy(FLAGSHIP_TRAIN_FUSED)
FLAGSHIP_H100["datamodule_specific"]["kwargs"]["num_workers"] = 2

# configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_tpu.yml: the flagship in bf16
# mixed precision on its three components
FLAGSHIP_BF16: Dict[str, Any] = copy.deepcopy(FLAGSHIP)
for _sec in ("encoder", "aggregator", "decoder"):
    FLAGSHIP_BF16[_sec]["kwargs"]["dtype"] = "bfloat16"

# configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_tpu_fast.yml as written: each
# receiver's 24 nearest in-radius senders on the dense AA path, in bf16
FLAGSHIP_BF16_CAPPED: Dict[str, Any] = copy.deepcopy(FLAGSHIP_BF16)
FLAGSHIP_BF16_CAPPED["encoder"]["kwargs"]["neighbor_cap"] = 24

# configs/nusargo/hivt_nuSArgo_sdesepenc_sdedec_tpu.yml with its fallback
# encoder.fused: true: the AA pair chain in bf16 through K3b / K4b
FLAGSHIP_BF16_FUSED: Dict[str, Any] = copy.deepcopy(FLAGSHIP_BF16)
FLAGSHIP_BF16_FUSED["encoder"]["kwargs"]["fused"] = True

# the _tpu_fast recipe in f32, the cap's f32 record beside the bf16 one
FLAGSHIP_CAPPED: Dict[str, Any] = copy.deepcopy(FLAGSHIP_BF16_CAPPED)
for _sec in ("encoder", "aggregator", "decoder"):
    FLAGSHIP_CAPPED[_sec]["kwargs"]["dtype"] = "float32"


# the HiVT baseline (transformer temporal encoder, one-shot MLP decoder):
# configs/nusargo/hivt_nuSArgo_trmenc_mlpdec.yml as a dict
BASELINE: Dict[str, Any] = {
    "training_specific": {
        "hivt_optimizer": True, "nodecay": True, "lr": 0.0005, "weight_decay": 0.0001,
        "T_max": 64, "max_epochs": 64,
    },
    "model_specific": {
        "module_name": "PredictionModel",
        "kwargs": {
            "dataset": "nuScenes", "ref_time": 20, "historical_steps": 21,
            "future_steps": 60, "num_modes": 10, "rotate": True, "parallel": True,
            "only_agent": False, "is_gtabs": True, "ts_drop": False,
        },
    },
    "encoder": {
        "module_name": "LocalEncoder",
        "kwargs": {
            "historical_steps": 21, "node_dim": 2, "edge_dim": 2, "embed_dim": 64,
            "num_heads": 4, "dropout": 0.1, "num_temporal_layers": 4, "local_radius": 50,
            "parallel": True, "input_diff": True,
        },
    },
    "aggregator": {
        "module_name": "GlobalInteractor",
        "kwargs": {
            "historical_steps": 21, "embed_dim": 64, "edge_dim": 2, "num_modes": 10,
            "num_heads": 4, "num_layers": 3, "dropout": 0.1, "rotate": True,
        },
    },
    "decoder": {
        "module_name": "MLPDecoder",
        "kwargs": {
            "local_channels": 64, "global_channels": 64, "future_steps": 60,
            "num_modes": 10, "uncertain": True, "min_scale": 0.001,
        },
    },
    "losses_module": ["L2"],
    "loss_weights": [1],
    "loss_args": [{"reduction": "mean"}],
    "metrics_module": ["ADE_T", "FDE_T", "MR_T"],
    "metric_args": [dict(_METRIC_ARGS) for _ in range(3)],
    "datamodule_specific": copy.deepcopy(FLAGSHIP["datamodule_specific"]),
}
BASELINE["datamodule_specific"]["kwargs"].update(train_batch_size=512, val_batch_size=512)

# the baseline with its AA pair chain through K3 (forward) and K4 (backward)
# at 4 heads on the card, their plain versions on the CPU
BASELINE_TRAIN: Dict[str, Any] = copy.deepcopy(BASELINE)
BASELINE_TRAIN["encoder"]["kwargs"]["fused"] = True


def resolve(name: str):
    name = ALIASES.get(name, name)
    if name not in REGISTRY:
        raise KeyError(f"unknown component {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def build(name: str, kwargs: Dict[str, Any]):
    """Instantiate a component, dropping kwargs its constructor rejects."""
    ctor = resolve(name)
    params = inspect.signature(ctor).parameters
    return ctor(**{k: v for k, v in kwargs.items() if k in params})


def load_config(path: str) -> Dict[str, Any]:
    """A config file as a dict: ``.json`` through ``json`` (no PyYAML
    needed), anything else through PyYAML."""
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f)
        import yaml

        return yaml.safe_load(f)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init of the JAX package's initialisers: xavier-uniform
    weights and zero biases, normal(0.1) for the GRU gates, normal(0.02)
    for the tokens and the position embedding, LayerNorm ones/zeros.  Draws on the CPU, so the
    weights do not depend on the device."""
    gen = torch.Generator().manual_seed(int(seed))
    gru_linears = {id(m) for g in model.modules() if isinstance(g, GRUUnit)
                   for m in g.modules() if isinstance(m, nn.Linear)}
    for m in model.modules():
        if isinstance(m, nn.Linear):
            w = torch.empty(m.weight.shape)
            if id(m) in gru_linears:
                w.normal_(0.0, 0.1, generator=gen)
            else:
                fan_out, fan_in = m.weight.shape
                bound = (6.0 / (fan_in + fan_out)) ** 0.5
                w.uniform_(-bound, bound, generator=gen)
            m.weight.copy_(w)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith(("bos_token", "hidden", "padding_token", "cls_token", "pos_embed")):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


def build_model(cfg: Dict[str, Any] = FLAGSHIP, device="cuda", seed: int = 0) -> nn.Module:
    """The composed prediction model of a config (``FLAGSHIP``, ``BASELINE``
    or a loaded YAML dict), initialised from ``seed``, on ``device``, in
    eval mode."""
    dev = resolve_device(device)
    parts = {sec: build(cfg[sec]["module_name"], dict(cfg[sec].get("kwargs", {})))
             for sec in ("encoder", "aggregator", "decoder")}
    model_cfg = cfg["model_specific"]
    model = resolve(model_cfg["module_name"])(
        rotate=model_cfg.get("kwargs", {}).get("rotate", True), **parts
    )
    return init_weights(model, seed).to(dev).eval()


def build_dtype(cfg: Dict[str, Any]) -> str:
    """``"bfloat16"`` when the config's encoder, aggregator or decoder
    computes in bf16, else ``"float32"``."""
    return ("bfloat16" if any(cfg[sec].get("kwargs", {}).get("dtype") == "bfloat16"
                              for sec in ("encoder", "aggregator", "decoder")) else "float32")


def build_datamodule(cfg: Dict[str, Any], seed: int = 0, **overrides) -> DataModuleNuArgoMix:
    """The port's ``DataModuleNuArgoMix`` of the config's
    ``datamodule_specific.kwargs``, with ``train.py``'s precedence: an
    override that is not None wins over the config, and ``seed`` is a
    default that a seed in the config wins over."""
    section = cfg.get("datamodule_specific", {})
    name = section.get("module_name", "DataModuleNuArgoMix")
    if name != "DataModuleNuArgoMix":
        raise KeyError(f"unknown datamodule {name!r}; known: ['DataModuleNuArgoMix']")
    kwargs = dict(section.get("kwargs", {}))
    kwargs.update({k: v for k, v in overrides.items() if v is not None})
    kwargs.setdefault("seed", seed)
    return DataModuleNuArgoMix(**kwargs)


def build_losses(cfg: Dict[str, Any]) -> List[Tuple[str, float, Any]]:
    """``[(name, weight, fn)]`` of the config's ``losses_module`` /
    ``loss_weights`` / ``loss_args`` (``fn(y, output, counts=None) -> scalar``,
    ``counts`` the global batch's normalizers under data parallelism).  The
    three lists must align one to one; a reference name (``LaplaceNLL``)
    resolves through ``ALIASES`` and keeps its listed name.  No loss of the
    port takes arguments, so ``loss_args`` is checked and not read."""
    names = cfg.get("losses_module", [])
    weights = cfg.get("loss_weights", [1.0] * len(names))
    args = cfg.get("loss_args", [{}] * len(names))
    if len(weights) != len(names) or len(args) != len(names):
        raise ValueError(f"losses_module has {len(names)} entries but loss_weights has "
                         f"{len(weights)} / loss_args has {len(args)}: the lists must align "
                         "one-to-one")
    unknown = [n for n in names if ALIASES.get(n, n) not in LOSS_REGISTRY]
    if unknown:
        raise KeyError(f"unknown losses {unknown}; known: {sorted(LOSS_REGISTRY)}")
    return [(n, float(w), LOSS_REGISTRY[ALIASES.get(n, n)]) for n, w in zip(names, weights)]


def build_metrics(cfg: Dict[str, Any]) -> List[TransferMetric]:
    """The metric accumulators of ``metrics_module`` / ``metric_args``; a
    config without ``metric_args`` gives each metric ``{}``."""
    names = cfg.get("metrics_module", [])
    args = cfg.get("metric_args", [{}] * len(names))
    if len(names) != len(args):
        raise ValueError(f"metrics_module has {len(names)} entries but metric_args has "
                         f"{len(args)}: the lists must align one-to-one")
    return make_metrics(names, args)
