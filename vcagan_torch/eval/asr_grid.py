"""GRID ASR content accuracy of generated artifacts.

Port of ``vcagan/eval/asr_grid.py`` (reference ASR_model/GRID/test.py +
src/data/vid_aud_GRID_test.py): globs the ``<sub>/<file>.npz`` mels (or
wavs) that ``python -m vcagan_torch.cli.test`` writes, reads the
transcripts from GRID ``.align`` files (SIL/SP skipped), runs the character
recognizer and reports greedy-decode WER/CER.

Mels are loaded on the host, as a data loader would (a wav goes through
the port's forward DSP chain on the CPU); each batch then runs on the
model's device.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from vcagan_torch.configs import AudioConfig
from vcagan_torch.dsp import MelPipeline, mel_denormalize
from vcagan_torch.eval.asr_models import ASRModel
from vcagan_torch.eval.text import greedy_decode_batch
from vcagan_torch.io.wav import read_wav


def read_align_words(path: str) -> List[str]:
    """GRID .align -> spoken words, SIL/SP removed
    (reference vid_aud_GRID_test.py:74-82)."""
    words = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 3 and parts[2] not in ("SIL", "SP", "sil", "sp"):
                words.append(parts[2])
    return words


def list_generated(data_dir: str, wav: bool = False) -> List[str]:
    ext = "*.wav" if wav else "*.npz"
    return sorted(glob.glob(os.path.join(data_dir, "*", ext)))


def pad_or_crop(mel: np.ndarray, frames: int) -> Tuple[np.ndarray, int]:
    """(80, T) -> (80, frames), zero-padded or cropped; and min(T, frames)."""
    t = mel.shape[-1]
    if t < frames:
        mel = np.pad(mel, ((0, 0), (0, frames - t)))
    return mel[:, :frames], min(t, frames)


def load_mel_from_npz(path: str, max_mel_frames: int) -> Tuple[np.ndarray, int]:
    """Generated npz -> denormalised log-mel (80, T), padded with 0.0
    (reference vid_aud_GRID_test.py:106-117)."""
    with np.load(path) as data:
        mel = np.asarray(data["mel"])  # (1, 80, T) normalised [-1, 1]
    mel = mel.reshape(mel.shape[-2], mel.shape[-1])
    return pad_or_crop(mel_denormalize(torch.from_numpy(mel)).numpy(), max_mel_frames)


def mel_from_wav(path: str, pipeline: MelPipeline) -> np.ndarray:
    """A wav -> its log-mel (80, T): peak-normalise, pre-emphasise, clamp,
    centred STFT, mel projection, log."""
    _, wav = read_wav(path)
    wav = pipeline.condition_waveform(torch.from_numpy(np.asarray(wav, np.float32))[None])
    mel, _ = pipeline.mel_spectrogram(wav)  # (1, T, 80)
    return mel[0].T.numpy()


def load_mel_from_wav(path: str, pipeline: MelPipeline,
                      max_mel_frames: int) -> Tuple[np.ndarray, int]:
    return pad_or_crop(mel_from_wav(path, pipeline), max_mel_frames)


def evaluate(
    data_dir: str,
    gt_path: str,
    model: ASRModel,
    wav: bool = False,
    batch_size: int = 16,
    max_timesteps: int = 75,
    audio_config: Optional[AudioConfig] = None,
) -> Tuple[float, float]:
    """Returns (WER, CER) over every generated artifact in ``data_dir``,
    the mean of the batches' means as in the JAX package; ``model`` a
    ``GridASR`` (``load_asr("grid", ...)``)."""
    pipeline = MelPipeline(audio_config or AudioConfig())
    device = next(model.parameters()).device
    max_mel = max_timesteps * 4

    files = list_generated(data_dir, wav)
    if not files:
        raise FileNotFoundError(f"no generated {'wav' if wav else 'npz'} under {data_dir}")

    wers, cers = [], []
    for start in range(0, len(files), batch_size):
        chunk = files[start : start + batch_size]
        mels, labels = [], []
        for path in chunk:
            sub_dir, fname = os.path.split(path)
            sub = os.path.basename(sub_dir)
            align = os.path.join(
                gt_path, sub.split("_")[0], "align",
                os.path.splitext(fname)[0] + ".align",
            )
            words = read_align_words(align) if os.path.exists(align) else []
            labels.append(" ".join(words).upper())
            if wav:
                mel, _ = load_mel_from_wav(path, pipeline, max_mel)
            else:
                mel, _ = load_mel_from_npz(path, max_mel)
            mels.append(mel)
        # the model takes the same log-domain mel the reference feeds it
        logits = model(torch.from_numpy(np.stack(mels)).to(device))
        w, c, _ = greedy_decode_batch(logits.cpu().numpy(), labels)
        wers.append(w)
        cers.append(c)
    return float(np.mean(wers)), float(np.mean(cers))
