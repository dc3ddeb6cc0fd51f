"""Configuration of the serving path and the train step.

Copies of what the port reads from the JAX package's
``vcagan/configs/base.py`` (``AudioConfig``, ``ModelConfig``, the fields of
``DataConfig`` and ``TrainConfig`` that the train step reads), kept here so
that the port imports nothing of that package.  Defaults reproduce the
reference GRID recipe.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """640-pt FFT at 16 kHz with hop 160 -> 321 linear bins, 100 mel
    frames/s, i.e. exactly 4 mel frames per 25-fps video frame."""

    sample_rate: int = 16_000
    n_fft: int = 640
    hop_length: int = 160
    win_length: int = 640
    n_mels: int = 80
    f_min: float = 55.0
    f_max: float = 7500.0  # 7600.0 for LRS
    preemphasis: float = 0.97
    griffin_lim_iters: int = 60
    mel_inversion_scale: float = 1000.0

    @property
    def n_linear(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def mel_per_video_frame(self) -> int:
        return self.sample_rate // 25 // self.hop_length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model family hyper-parameters (reference topology by default)."""

    # visual front
    stem_channels: int = 64
    resnet_layers: Tuple[int, int, int, int] = (2, 2, 2, 2)
    feature_dim: int = 512
    gru_hidden: int = 512
    gru_layers: int = 2
    gru_dropout: float = 0.3
    frontend_dropout: float = 0.3
    # generator
    noise_dim: int = 128
    mel_base_bins: int = 20  # coarse-scale freq bins; x2 per stage -> 20/40/80
    attention_dim: int = 256
    attention_inner: int = 1280  # 20 * 64
    # postnet
    postnet_channels: int = 256
    linear_bins: int = 321
    # discriminators
    disc_base_channels: int = 32
    disc_max_channels: int = 512
    sync_temp: float = 1.0
    # numerics
    use_bfloat16: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The batch's shape: video windows of ``window_size`` frames at
    ``crop_size``^2 (``vcagan/configs/base.py:71-80``; 50 frames for LRS)."""

    window_size: int = 40
    crop_size: int = 112


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The optimisation fields of ``vcagan/configs/base.py:126-171`` that the
    train step reads (GRID defaults; LRS: no amsgrad, milestones (100, 150),
    sync_dis_weight 0.5, recon on normalised mels)."""

    batch_size: int = 88
    lr: float = 1e-4
    weight_decay: float = 1e-5
    lr_milestones: Tuple[int, ...] = (500, 800)
    lr_gamma: float = 0.1
    amsgrad: bool = True
    recon_weight: float = 50.0
    sync_dis_weight: float = 1.0
    recon_on_denormalized: bool = True
