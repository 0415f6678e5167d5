"""Model composition: encoder -> aggregator -> decoder (+ target rotation)
(``trajsde_tpu/models/prediction.py``): the baseline and the SDE family."""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from trajsde_tpu_torch.data.scene import SceneBatch, rotate_into


class PredictionModel(nn.Module):
    """The baseline composition (registry name ``PredictionModel``):
    ``forward`` returns the decoder's dict plus ``y``, the future targets
    rotated into each actor's frame.  It has no OOD ensemble, so it takes
    no ``ood``."""

    def __init__(self, encoder: nn.Module, aggregator: nn.Module, decoder: nn.Module,
                 rotate: bool = True):
        super().__init__()
        self.encoder = encoder
        self.aggregator = aggregator
        self.decoder = decoder
        self.rotate = rotate

    def rotated_y(self, scene: SceneBatch) -> Optional[torch.Tensor]:
        if scene.y is None or not self.rotate:
            return scene.y
        return rotate_into(scene.y, scene.rotate_mat()[:, :, None])

    def forward(self, scene: SceneBatch, generator: Optional[torch.Generator] = None,
                rollout_seed: Union[int, torch.Tensor, None] = None) -> Dict[str, Any]:
        """Dropout draws from ``generator`` (encoder, aggregator, then
        decoder); ``rollout_seed`` is taken, as every model's forward takes
        it from the trainer, and unused: nothing here rolls out."""
        local_embed = self.encoder(scene, generator=generator)
        global_embed = self.aggregator(scene, local_embed, generator)
        out = self.decoder(scene, local_embed, global_embed, generator=generator)
        out["y"] = self.rotated_y(scene)
        return out


class PredictionModelSDENet(PredictionModel):
    """Registry name ``PredictionModelSDENet``.

    ``forward`` returns the decoder's dict plus ``y`` (future targets
    rotated into each actor's frame) and the encoder's diffusion
    discrimination tensors; ``ood=True`` routes through
    ``encoder.forward_ood`` and attaches per-actor ``stds`` instead.
    """

    def forward(
        self,
        scene: SceneBatch,
        ood: bool = False,
        enc_noise: Optional[torch.Tensor] = None,
        twin_noise: Optional[torch.Tensor] = None,
        dec_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        rollout_seed: Union[int, torch.Tensor, None] = None,
    ) -> Dict[str, Any]:
        """``enc_noise [Th, B, A+1, D]``, ``twin_noise [B, 1, Th, 2]`` and
        ``dec_noise [Tf, B, F, A, D]`` pin the draws; the rest come from
        ``generator`` (encoder, aggregator, then decoder), and a fused
        decoder seeds its rollout kernel with ``rollout_seed``."""
        if ood:
            local_embed, stds = self.encoder.forward_ood(scene, generator=generator)
        else:
            local_embed, diff_in, diff_out, label_in, label_out = self.encoder(
                scene, sde_noise=enc_noise, twin_noise=twin_noise, generator=generator
            )
        global_embed = self.aggregator(scene, local_embed, generator)
        out = self.decoder(scene, local_embed, global_embed, sde_noise=dec_noise,
                           generator=generator, rollout_seed=rollout_seed)
        out["y"] = self.rotated_y(scene)
        if ood:
            out["stds"] = stds
        else:
            out["diff_in"], out["diff_out"] = diff_in, diff_out
            out["label_in"], out["label_out"] = label_in, label_out
        return out
