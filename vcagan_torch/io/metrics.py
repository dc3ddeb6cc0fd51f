"""Scalar/metric logging.

A copy of ``vcagan/io/metrics.py``.  The reference logs to TensorBoard via
torch's SummaryWriter (reference: train.py:126,249-254).  This writes a
JSONL event stream (always) and mirrors scalars, images and audio to
TensorBoard when ``torch.utils.tensorboard`` imports (it needs the
``tensorboard`` package); the figures (spectrograms, waveforms) only where
``matplotlib`` is installed as well, which the JAX package's copy assumes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time
from typing import Mapping


class MetricWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._file = open(self.path, "a", buffering=1)
        self._tb = None
        self._figures = importlib.util.find_spec("matplotlib") is not None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._tb = None

    def scalars(self, tag_values: Mapping[str, float], step: int) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in tag_values.items()})
        self._file.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in tag_values.items():
                self._tb.add_scalar(k, float(v), step)

    def spectrogram(self, tag: str, mel, step: int) -> None:
        """Log a (F, T) spectrogram as an image (reference logs matplotlib
        renders of g1/g2/g3/gt each 100 steps, train.py:255-274)."""
        if self._tb is None or not self._figures:
            return
        self._tb.add_image(tag, plot_spectrogram_to_numpy(mel), step)

    def audio(self, tag: str, wav, step: int, sample_rate: int = 16_000) -> None:
        if self._tb is None:
            return
        import numpy as np

        self._tb.add_audio(
            tag, np.asarray(wav, dtype=np.float32)[None, :], step,
            sample_rate=sample_rate,
        )

    def waveform(self, tag: str, wav, step: int) -> None:
        """Log a waveform figure (reference logs wav_tr/wav_pred/wav_spec
        line plots during validation, train.py:406-448)."""
        if self._tb is None or not self._figures:
            return
        self._tb.add_image(tag, plot_waveform_to_numpy(wav), step)

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()


def plot_waveform_to_numpy(wav) -> "np.ndarray":
    """(L,) waveform -> (3, H, W) uint8 RGB line plot."""
    import numpy as np

    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    wav = np.asarray(wav).reshape(-1)
    fig, ax = plt.subplots(figsize=(15, 2.5))
    ax.plot(wav, linewidth=0.5)
    ax.set_ylim(-1.05, 1.05)
    ax.set_xlabel("Samples")
    plt.tight_layout()
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
    plt.close(fig)
    return data.transpose(2, 0, 1)


def plot_spectrogram_to_numpy(mel) -> "np.ndarray":
    """(F, T) array -> (3, H, W) uint8 RGB render
    (reference vid_aud_grid.py:250-268)."""
    import numpy as np

    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    mel = np.asarray(mel)
    if mel.ndim == 3:
        mel = mel.reshape(mel.shape[-2], mel.shape[-1])
    fig, ax = plt.subplots(figsize=(15, 4))
    im = ax.imshow(mel, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.tight_layout()
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
    plt.close(fig)
    return data.transpose(2, 0, 1)
