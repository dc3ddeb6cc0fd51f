"""Configuration of the port: serving, the train step and the GRID and LRS
loops.

A copy of the JAX package's ``vcagan/configs/base.py`` (the fields that
nothing reads are left out), kept here so that the port imports nothing of
that package.  Defaults reproduce the reference GRID recipe;
``lrs_config`` the LRS2/LRS3 one.
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
    """Dataset and windowing parameters (``vcagan/configs/base.py:77-123``):
    video windows of ``window_size`` frames at ``crop_size``^2 (50 frames
    for LRS).  ``host_crop``, ``host_gray`` and ``host_resize`` move the
    static crop, the luma and the resize to the host, before the copy to
    the device; ``collate_process`` collates in a worker process
    (``vcagan_torch/data/prefetch.py`` ``ProcessEpoch``) instead of a
    producer thread."""

    data_root: str = "Data_dir"
    dataset: str = "GRID"  # GRID | LRS2 | LRS3
    subject: str = "overlap"  # overlap | unseen | s# | four (GRID only)
    window_size: int = 40
    max_v_timesteps: int = 75  # 160 for LRS
    augmentations: bool = True
    crop_size: int = 112
    grid_crop_box: Tuple[int, int, int, int] = (59, 95, 195, 231)
    host_crop: bool = True
    host_gray: bool = True
    host_resize: bool = False
    collate_process: bool = False
    pixel_mean: float = 0.4136
    pixel_std: float = 0.1700
    erase_size: int = 56
    synthetic_clips: int = 64  # clips of the synthetic source, when the corpus is absent


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation and loop parameters (``vcagan/configs/base.py:126-171``;
    GRID defaults; LRS: no amsgrad, milestones (100, 150), sync_dis_weight
    0.5, recon on normalised mels).  ``remat`` (remat sites, comma-separated)
    and ``d_phase`` ("ref" or "batched") go to ``make_train_step``
    (``vcagan_torch/train/step.py``)."""

    batch_size: int = 88
    epochs: int = 1000
    lr: float = 1e-4
    weight_decay: float = 1e-5
    seed: int = 1
    eval_step: int = 720
    start_epoch: int = 0
    lr_milestones: Tuple[int, ...] = (500, 800)
    lr_gamma: float = 0.1
    amsgrad: bool = True
    recon_weight: float = 50.0
    sync_dis_weight: float = 1.0
    recon_on_denormalized: bool = True
    checkpoint_dir: str = "./data/checkpoints/GRID"
    workers: int = 6
    remat: str = "none"
    d_phase: str = "ref"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process layout, one device a rank (``vcagan_torch.parallel``):
    ``model_parallel`` ranks a model group, over which the four attention
    projections are split by column; the world over it is the data axis."""

    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class VCAGANConfig:
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def grid_config(**overrides) -> VCAGANConfig:
    """The reference GRID recipe, with dotted-path overrides such as
    ``grid_config(**{"train.lr": 3e-4})``."""
    return _apply(VCAGANConfig(), overrides)


def lrs_config(dataset: str = "LRS2", **overrides) -> VCAGANConfig:
    """The reference LRS recipe (train_LRS.py defaults,
    ``vcagan/configs/base.py:204-219``): batch 16, 200 epochs, 50-frame
    windows, up to 160 frames, f_max 7600, plain Adam with milestones
    (100, 150), sync D-loss weight 0.5, L1 on normalised mels."""
    cfg = VCAGANConfig(
        audio=AudioConfig(f_max=7600.0),
        data=DataConfig(dataset=dataset, window_size=50, max_v_timesteps=160),
        train=TrainConfig(
            batch_size=16,
            epochs=200,
            lr_milestones=(100, 150),
            amsgrad=False,
            sync_dis_weight=0.5,
            recon_on_denormalized=False,
            checkpoint_dir=f"./data/checkpoints/{dataset}",
        ),
    )
    return _apply(cfg, overrides)


def _apply(cfg: VCAGANConfig, overrides: dict) -> VCAGANConfig:
    """Apply dotted-path overrides, e.g. _apply(cfg, {"train.lr": 3e-4})."""
    for key, value in overrides.items():
        parts = key.split(".")
        if len(parts) == 1:
            cfg = dataclasses.replace(cfg, **{parts[0]: value})
        else:
            sub = getattr(cfg, parts[0])
            sub = dataclasses.replace(sub, **{parts[1]: value})
            cfg = dataclasses.replace(cfg, **{parts[0]: sub})
    return cfg
