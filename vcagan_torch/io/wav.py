"""Minimal PCM16 wav writer/reader (a copy of ``vcagan/io/wav.py``).

The reference writes PCM_16 via soundfile (reference: test.py:159); scipy's
wavfile provides the same container.
"""

from __future__ import annotations

import numpy as np
import scipy.io.wavfile as wavfile


def write_wav(path: str, wav: np.ndarray, sample_rate: int = 16_000) -> None:
    wav = np.asarray(wav, np.float32)
    wav = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sample_rate, (wav * 32767.0).astype(np.int16))


def read_wav(path: str) -> tuple[int, np.ndarray]:
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    return sr, data
