"""Device-side input pipeline: raw collated batches -> the model's ``Batch``.

Port of ``vcagan/data/device_pipeline.py:30-87``.  Everything heavy that the
reference's DataLoader workers did per frame in Python runs here as tensor
ops over the whole batch: the clip transform (resize, flip, luma,
normalise, erase), STFT framing, DFT and mel projection, normalisation and
pad masking.

The cheap scalar audio chain (full-clip peak-normalise, pre-emphasis,
clamp, reflect pad) runs on the host (``vcagan_torch.data.audio_host``),
which hands this pipeline ``raw["aud_cond"]``: a slice of the
reflect-padded, conditioned full clip, positioned so that framing it
without padding gives the full clip's centred STFT frames of the window
(reference: vid_aud_grid.py:140-161).
"""

from __future__ import annotations

from typing import Optional

import torch

from vcagan_torch.configs import AudioConfig, DataConfig
from vcagan_torch.data.transforms import AugmentDraws, augment_draws, prepare_clips
from vcagan_torch.dsp.audio import mel_normalize
from vcagan_torch.dsp.pipeline import MelPipeline
from vcagan_torch.dsp.stft import stft_magnitude
from vcagan_torch.runtime import resolve_device
from vcagan_torch.tracing import span
from vcagan_torch.train.step import Batch


def make_device_pipeline(
    audio_config: Optional[AudioConfig] = None,
    data_config: Optional[DataConfig] = None,
    augment: bool = False,
    device=None,
):
    """Returns ``process(raw, generator=None, draws=None) -> Batch`` on
    ``device`` (CUDA unless ``device="cpu"``).

    ``raw`` is a ``GridDataset`` batch, as numpy arrays or tensors:
    video_raw (B, W, H, W, C) uint8, aud_cond (B, 4W*hop + n_fft)
    conditioned audio, vid_len, mel_len.  With ``augment`` each clip's flip
    and erase patch come from ``draws`` (``AugmentDraws``) or, where none
    are given, from ``generator``.  A call is traced as the span
    ``train.input`` (``vcagan_torch.tracing``)."""
    acfg = audio_config or AudioConfig()
    dcfg = data_config or DataConfig()
    dev = resolve_device(device)
    pipe = MelPipeline(acfg)

    def process(raw: dict, generator: Optional[torch.Generator] = None,
                draws: Optional[AugmentDraws] = None) -> Batch:
        with span("train.input"):
            video_raw = torch.as_tensor(raw["video_raw"], device=dev)
            b, w = video_raw.shape[:2]
            if augment and draws is None:
                draws = augment_draws(b, generator, dev)
            video = prepare_clips(
                video_raw,
                draws if augment else None,
                crop_box=None if dcfg.host_crop else dcfg.grid_crop_box,
                out_size=dcfg.crop_size,
                erase_size=dcfg.erase_size,
            )  # (B, W, crop, crop, 1)

            # The segment gives 4W + 1 frames; the window is the first 4W (the
            # reference's mel[:, :, 4st:4st+4W], vid_aud_grid.py:182).
            aud = torch.as_tensor(raw["aud_cond"], device=dev)
            mag, _ = stft_magnitude(aud, pipe.stft_params, center=False)
            n_mel = w * acfg.mel_per_video_frame
            mel = mel_normalize(pipe.compress_mel(mag)[:, :n_mel])
            spec = mag[:, :n_mel]

            # the reference pads the normalised mel and the spectrogram with 0
            # (vid_aud_grid.py:160-161); mel_len is its num_a_frames
            mel_len = torch.as_tensor(raw["mel_len"], device=dev)
            pad = (torch.arange(n_mel, device=dev)[None, :] >= mel_len[:, None])[:, :, None]
            return Batch(
                video=video,
                mel=mel.masked_fill(pad, 0.0).transpose(1, 2),  # (B, 80, 4W)
                spec=spec.masked_fill(pad, 0.0).transpose(1, 2),  # (B, 321, 4W)
                vid_len=torch.as_tensor(raw["vid_len"], device=dev),
                mel_len=mel_len,
            )

    return process
