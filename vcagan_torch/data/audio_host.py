"""Host-side full-clip audio conditioning (numpy/scipy), numerically
faithful to the reference's per-item chain.  A copy of
``vcagan/data/audio_host.py``.

The reference conditions the FULL clip — peak-normalize x0.9, scipy-lfilter
pre-emphasis, clamp — computes mel/spec over the full clip (centered STFT,
reflect padding), and only then crops the training window out of the mel
(reference: vid_aud_grid.py:140-152,171-188; vid_aud_lrs2.py:150-201).
Window peak != clip peak and window-edge reflect padding != the true
neighbouring samples, so windowing the raw audio first (as round 1 did) is
measurably different.  Here the cheap scalar chain runs on host exactly as
the reference does, and the heavy part (framing, DFT, mel projection) stays
on-device: :func:`stft_segment` slices the reflect-padded conditioned clip
so that NON-centered device framing reproduces the full-clip CENTERED
frames of the chosen window bit-for-bit.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter


def condition_clip(audio: np.ndarray, preemph: float = 0.97) -> np.ndarray:
    """Full-clip peak-normalize x0.9 -> pre-emphasize -> clamp [-1, 1].

    Identical ops (including scipy lfilter) to reference
    vid_aud_grid.py:142-144 / vid_aud_lrs2.py:152-154.
    """
    return preemphasize_clamp(peak_normalize_clip(audio), preemph)


def preemphasize_clamp(normed: np.ndarray, preemph: float = 0.97) -> np.ndarray:
    """The pre-emphasis + clamp tail of the conditioning chain, on an
    already peak-normalized clip (the LRS datasets keep the normalized
    waveform as the metric ground truth, so they run the two halves
    separately — vid_aud_lrs2.py:152-154)."""
    aud = lfilter([1.0, -preemph], [1.0], normed)
    return np.clip(aud, -1.0, 1.0).astype(np.float32)


def peak_normalize_clip(audio: np.ndarray) -> np.ndarray:
    """audio / max|audio| * 0.9 (the LRS datasets mutate the returned
    waveform in place before pre-emphasis, vid_aud_lrs2.py:152)."""
    peak = float(np.abs(audio).max())
    return (audio / max(peak, 1e-8) * 0.9).astype(np.float32)


def full_frame_count(n_samples: int, hop: int = 160) -> int:
    """Centered-STFT frame count over a full clip (reference stft.py:70-98:
    reflect pad n_fft//2 each side, stride hop)."""
    return n_samples // hop + 1


def stft_segment(
    cond: np.ndarray,
    start_frame: int,
    n_frames: int,
    n_fft: int = 640,
    hop: int = 160,
) -> np.ndarray:
    """Slice the conditioned clip so device-side VALID framing reproduces
    full-clip CENTERED frames [start_frame, start_frame + n_frames).

    Centered frame k of the full clip covers reflect-padded samples
    [k*hop, k*hop + n_fft).  Reflect-padding here (around the TRUE clip
    edges, as the reference does) and slicing keeps window-interior frames
    AND true-edge frames exact; samples past the clip end are zero — they
    only back frames beyond the clip's real frame count, which the device
    pipeline masks to the reference pad value anyway.

    Known deviation: clips shorter than n_fft//2 + 1 samples are zero-padded
    to pad+1 BEFORE reflecting, so the reflection wraps around padded zeros
    rather than the true clip edge.  Only sub-321-sample (20 ms) clips hit
    this — the same degenerate inputs the reference swaps for an all-zero
    guard clip anyway (vid_aud_grid.py:137-139), so the deviation is
    unobservable in practice.
    """
    pad = n_fft // 2
    if cond.shape[0] < pad + 1:  # reflect needs len > pad (degenerate clips)
        cond = np.pad(cond, (0, pad + 1 - cond.shape[0]))
    padded = np.pad(cond, (pad, pad), mode="reflect")
    need = (n_frames - 1) * hop + n_fft
    seg = padded[start_frame * hop : start_frame * hop + need]
    if seg.shape[0] < need:
        seg = np.pad(seg, (0, need - seg.shape[0]))
    return seg.astype(np.float32)
