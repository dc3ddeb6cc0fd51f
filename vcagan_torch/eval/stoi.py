"""Batched STOI / ESTOI on the device.

Port of ``vcagan/eval/stoi.py:36-250``, the algorithm of
``vcagan_torch.eval.stoi_np`` (pystoi's conventions) over a whole batch:
16 -> 10 kHz polyphase resampling, framing, removal of silent frames (kept
frames compacted to the front by one stable sort and one gather),
one-third-octave band envelopes and 30-frame segment correlations.  The
number of frames that survive is data-dependent; shapes stay fixed and
masks carry the per-clip counts.  The reference scores each clip with
pystoi on the CPU (reference: train.py:392-404).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from vcagan_torch.eval import stoi_np as ref

# pystoi's epsilon (float64 machine epsilon); in fp32 it decides only
# all-zero frames and segments, as it does in pystoi
_EPS = float(np.finfo(np.float64).eps)
_UP, _DOWN = 5, 8  # 16 kHz -> 10 kHz


@functools.lru_cache(maxsize=1)
def _resample_filter() -> np.ndarray:
    """The FIR low-pass of the 16 -> 10 kHz resampling (up 5, down 8):
    pystoi's Octave-compatible window, unit DC gain, times ``up``, as
    ``scipy.signal.resample_poly`` applies an explicit window."""
    h = ref.resample_window_oct(_UP, _DOWN)
    return (h / np.sum(h) * _UP).astype(np.float32)


def _resample_16k_to_10k(x: torch.Tensor) -> torch.Tensor:
    """(B, L) at 16 kHz -> (B, ceil(5L / 8)) at 10 kHz: zeros stuffed
    between the samples, the centred filter, every 8th output."""
    taps = _constants(x.device)[2]
    half = taps.shape[0] // 2
    b, n = x.shape
    up = x.new_zeros(b, (n - 1) * _UP + 1)
    up[:, ::_UP] = x
    out = F.conv1d(up[:, None], taps[None, None], stride=_DOWN, padding=half)[:, 0]
    return out[:, : -(-n * _UP // _DOWN)]


def _frame(x: torch.Tensor) -> torch.Tensor:
    """(B, L) -> (B, M, 256) with pystoi's framing, which leaves out the
    frame that starts at exactly L - 256."""
    m = len(ref._frame_starts(x.shape[-1]))
    return x.unfold(-1, ref.N_FRAME, ref.N_FRAME // 2)[:, :m]


@functools.lru_cache(maxsize=4)
def _constants(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """On ``device``, copied there once: pystoi's Hann window
    hann(N + 2)[1:-1], the (15, 257) band matrix and the resampling filter
    reversed (``conv1d`` correlates)."""
    n = np.arange(1, ref.N_FRAME + 1)
    win = (0.5 - 0.5 * np.cos(2 * np.pi * n / (ref.N_FRAME + 1))).astype(np.float32)
    obm = ref._third_octave_matrix().astype(np.float32)
    taps = _resample_filter()[::-1].copy()
    return tuple(torch.from_numpy(a).to(device) for a in (win, obm, taps))


def _compact_silent_frames(xf, yf, win, frame_ok=None):
    """Keep the frames whose clean energy lies within 40 dB of the clean
    signal's loudest and move them to the front, in order; zero the rest.
    ``frame_ok`` (B, M), optional, leaves out frames past a clip's true
    length before the maximum is taken.  Returns (xk, yk, counts)."""
    energy_db = 20.0 * torch.log10(torch.linalg.vector_norm(xf * win, dim=-1) + _EPS)
    if frame_ok is not None:
        energy_db = energy_db.masked_fill(~frame_ok, -torch.inf)
    keep = energy_db > energy_db.amax(dim=-1, keepdim=True) - ref.DYN_RANGE
    counts = keep.sum(dim=-1)
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)[:, :, None]
    kept = torch.arange(xf.shape[1], device=xf.device)[None, :, None] < counts[:, None, None]
    xk = torch.take_along_dim(xf * win, order, dim=1) * kept
    yk = torch.take_along_dim(yf * win, order, dim=1) * kept
    return xk, yk, counts


def _overlap_add_50(frames: torch.Tensor) -> torch.Tensor:
    """(B, M, N) -> (B, N/2 * (M + 1)) by 50%-overlap-add."""
    b, m, n = frames.shape
    hop = n // 2
    total = frames.new_zeros(b, m + 1, hop)
    total[:, :m] += frames[:, :, :hop]
    total[:, 1:] += frames[:, :, hop:]
    return total.reshape(b, -1)


def _band_envelopes(sig: torch.Tensor, win: torch.Tensor, obm: torch.Tensor) -> torch.Tensor:
    spec = torch.fft.rfft(_frame(sig) * win, ref.NFFT, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.sqrt(torch.einsum("jf,bmf->bjm", obm, power))  # (B, 15, M)


def _segments(x: torch.Tensor) -> torch.Tensor:
    """(B, 15, M) -> (B, M - 29, 15, 30) sliding 30-frame segments (none
    where M < 30)."""
    if x.shape[-1] < ref.N_SEG:
        return x.new_zeros(x.shape[0], 0, x.shape[1], ref.N_SEG)
    return x.unfold(-1, ref.N_SEG, 1).transpose(1, 2)


def _stoi_front(clean, degraded, input_rate, lengths):
    """The front end both metrics share: resample, frame, compact the
    silent frames, overlap-add, band envelopes, 30-frame segments.
    Returns (Xs, Ys, valid): (B, S, 15, 30) twice and (B, S) bool."""
    x, y = clean.float(), degraded.float()
    if input_rate == 16_000:
        x, y = _resample_16k_to_10k(x), _resample_16k_to_10k(y)
    win, obm, _ = _constants(x.device)
    xf, yf = _frame(x), _frame(y)
    frame_ok = None
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=x.device)
        l10 = lengths if input_rate == 10_000 else -(-lengths * _UP // _DOWN)
        hop = ref.N_FRAME // 2
        m_valid = torch.where(l10 > ref.N_FRAME, (l10 - ref.N_FRAME + hop - 1) // hop, 0)
        frame_ok = torch.arange(xf.shape[1], device=x.device)[None, :] < m_valid[:, None]
    xk, yk, counts = _compact_silent_frames(xf, yf, win, frame_ok)
    X = _band_envelopes(_overlap_add_50(xk), win, obm)
    Y = _band_envelopes(_overlap_add_50(yk), win, obm)
    Xs, Ys = _segments(X), _segments(Y)
    # c kept frames overlap-add to 256 + 128 (c - 1) samples, which
    # pystoi's framing turns into c - 1 band frames; segment s covers band
    # frames [s, s + 30)
    slots = torch.arange(Xs.shape[1], device=x.device)[None, :]
    valid = slots + ref.N_SEG <= (counts - 1)[:, None]
    return Xs, Ys, valid


def _mean_over_valid(d_seg: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The mean of the valid segments' scores; pystoi's 1e-5 where a clip
    has fewer than 30 band frames."""
    score = (d_seg * valid).sum(dim=1) / valid.sum(dim=1).clamp(min=1)
    return torch.where(valid.any(dim=1), score, torch.full_like(score, 1e-5))


def _estoi_tail(Xs, Ys, valid):
    def rownorm(a, dim):
        a = a - a.mean(dim=dim, keepdim=True)
        return a / (torch.linalg.vector_norm(a, dim=dim, keepdim=True) + _EPS)

    xn = rownorm(rownorm(Xs, -1), -2)
    yn = rownorm(rownorm(Ys, -1), -2)
    return _mean_over_valid((xn * yn).sum(dim=(-1, -2)) / ref.N_SEG, valid)


def _stoi_tail(Xs, Ys, valid):
    c = 10.0 ** (-ref.BETA / 20.0)
    alpha = torch.linalg.vector_norm(Xs, dim=-1, keepdim=True) / (
        torch.linalg.vector_norm(Ys, dim=-1, keepdim=True) + _EPS)
    yc = torch.minimum(alpha * Ys, Xs * (1 + c))
    xm = Xs - Xs.mean(dim=-1, keepdim=True)
    ym = yc - yc.mean(dim=-1, keepdim=True)
    corr = (xm * ym).sum(dim=-1) / (
        torch.linalg.vector_norm(xm, dim=-1) * torch.linalg.vector_norm(ym, dim=-1) + _EPS)
    return _mean_over_valid(corr.mean(dim=-1), valid)


def _check_rate(input_rate: int) -> None:
    if input_rate not in (16_000, 10_000):
        raise ValueError(f"input_rate must be 16000 or 10000, not {input_rate}")


@torch.no_grad()
def stoi_estoi_batch(clean: torch.Tensor, degraded: torch.Tensor, input_rate: int = 16_000,
                     lengths: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(STOI, ESTOI), each (B,), of (B, L) waveform pairs; the front end,
    nearly all the cost, is computed once for both."""
    _check_rate(input_rate)
    Xs, Ys, valid = _stoi_front(clean, degraded, input_rate, lengths)
    return _stoi_tail(Xs, Ys, valid), _estoi_tail(Xs, Ys, valid)


@torch.no_grad()
def stoi_batch(clean: torch.Tensor, degraded: torch.Tensor, extended: bool = False,
               input_rate: int = 16_000, lengths: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """STOI (ESTOI with ``extended``) of (B, L) waveform pairs -> (B,).

    ``lengths`` (B,), optional: each clip's true length in input-rate
    samples, for zero-padded batches of clips of several lengths; frames
    that start at or past ``true_len - 256`` (at 10 kHz) are left out as
    pystoi's framing of the trimmed clip leaves them out."""
    _check_rate(input_rate)
    Xs, Ys, valid = _stoi_front(clean, degraded, input_rate, lengths)
    return (_estoi_tail if extended else _stoi_tail)(Xs, Ys, valid)
