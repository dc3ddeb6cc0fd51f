"""STOI / ESTOI reference implementation (numpy, single pair).

Short-Time Objective Intelligibility (Taal et al., ICASSP 2011) and the
extended variant (Jensen & Taal, TASLP 2016), implemented to follow the
pystoi package's exact conventions — the library the reference scores with
(reference: train.py:393-396; pystoi is not installed in this image, so
the metric stack is native here).  Serves as the oracle for the batched
torch implementation in ``vcagan_torch.eval.stoi``.  A copy of the JAX
package's ``vcagan/eval/stoi_np.py``, kept here so that the port imports
nothing of that package.

pystoi conventions reproduced here (each is a measurable deviation from
the "obvious" implementation):

- resampling to 10 kHz uses pystoi's Octave-compatible polyphase design
  (``utils._resample_window_oct``): 60 dB-rejection Kaiser-apodized sinc,
  length ``2*ceil((60-8)/(28.714*w))+1`` with roll-off ``w`` a tenth of the
  stopband cutoff ``1/(2*max(p,q))`` — NOT scipy's default kaiser(5.0)
  firwin
- framing uses ``range(0, len(x) - framelen, hop)``: a frame starting at
  exactly ``len(x) - framelen`` is EXCLUDED (pystoi ``utils.stft`` /
  ``utils.remove_silent_frames``)
- the Hann window is ``hann(N+2)[1:-1]`` (symmetric, endpoints dropped)
- the one-third-octave band matrix snaps band edges to the nearest FFT bin
  of ``linspace(0, fs, nfft+1)[:nfft//2+1]`` and fills ``[lo_bin, hi_bin)``
  (pystoi ``utils.thirdoct``)
- silent frames are those more than 40 dB below the loudest CLEAN frame;
  both signals are rebuilt by 50%-overlap-add of the kept frames
- fewer than 30 band frames -> score 1e-5 (pystoi warns and returns 1e-5,
  which the reference averages into its metric like any other value)
- EPS is machine epsilon (2.22e-16)

Parameters: fs 10 kHz, 256-sample frames, 50% overlap, 512-pt FFT, 15
one-third-octave bands from 150 Hz, 30-frame segments, -15 dB SDR clip.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np

FS = 10_000
N_FRAME = 256
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N_SEG = 30
BETA = -15.0
DYN_RANGE = 40.0
EPS = np.finfo(np.float64).eps


@functools.lru_cache(maxsize=8)
def resample_window_oct(p: int, q: int) -> np.ndarray:
    """Octave-compatible anti-aliasing window (pystoi
    ``utils._resample_window_oct``): Kaiser-apodized ideal sinc at 60 dB
    stopband rejection."""
    g = np.gcd(p, q)
    p, q = p // g, q // g
    log10_rejection = -3.0
    stopband_cutoff_f = 1.0 / (2 * max(p, q))
    roll_off_width = stopband_cutoff_f / 10.0
    rejection_db = -20.0 * log10_rejection  # 60 dB
    l = int(np.ceil((rejection_db - 8.0) / (28.714 * roll_off_width)))
    t = np.arange(-l, l + 1)
    ideal = 2 * p * stopband_cutoff_f * np.sinc(2 * stopband_cutoff_f * t)
    if 21.0 <= rejection_db <= 50.0:
        beta = 0.5842 * (rejection_db - 21.0) ** 0.4 + 0.07886 * (
            rejection_db - 21.0
        )
    elif rejection_db > 50.0:
        beta = 0.1102 * (rejection_db - 8.7)
    else:
        beta = 0.0
    return np.kaiser(2 * l + 1, beta) * ideal


def resample_oct(x: np.ndarray, p: int, q: int) -> np.ndarray:
    """pystoi ``utils.resample_oct``: polyphase resample with the Octave
    window (normalized to unit DC gain; scipy re-applies the ``up`` gain)."""
    from scipy.signal import resample_poly

    h = resample_window_oct(p, q)
    return resample_poly(x, p, q, window=h / np.sum(h))


def _resample_to_10k(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == FS:
        return x
    g = np.gcd(FS, fs)
    return resample_oct(x, FS // g, fs // g)


@functools.lru_cache(maxsize=1)
def _third_octave_matrix() -> np.ndarray:
    """(15, 257) one-third-octave band matrix (pystoi ``utils.thirdoct``)."""
    f = np.linspace(0, FS, NFFT + 1)[: NFFT // 2 + 1]
    k = np.arange(NUMBAND, dtype=np.float64)
    lo = MINFREQ * 2.0 ** ((2 * k - 1) / 6.0)
    hi = MINFREQ * 2.0 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((NUMBAND, len(f)))
    for j in range(NUMBAND):
        lo_idx = int(np.argmin((f - lo[j]) ** 2))
        hi_idx = int(np.argmin((f - hi[j]) ** 2))
        obm[j, lo_idx:hi_idx] = 1.0
    return obm


def _frame_starts(n_samples: int) -> range:
    """pystoi framing: ``range(0, len(x) - framelen, hop)`` — the frame at
    exactly ``len - framelen`` is excluded."""
    return range(0, n_samples - N_FRAME, N_FRAME // 2)


def _frames(x: np.ndarray) -> np.ndarray:
    starts = np.asarray(_frame_starts(len(x)), dtype=np.int64)
    if len(starts) == 0:
        return np.zeros((0, N_FRAME))
    idx = starts[:, None] + np.arange(N_FRAME)[None, :]
    return x[idx]


def _hann() -> np.ndarray:
    # hann(N+2)[1:-1]: symmetric window with the zero endpoints dropped
    n = np.arange(1, N_FRAME + 1)
    return 0.5 - 0.5 * np.cos(2 * np.pi * n / (N_FRAME + 1))


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    """Drop frames where the CLEAN signal is > 40 dB below its loudest
    frame; rebuild both signals by 50%-overlap-add of kept frames."""
    win = _hann()
    xf = _frames(x) * win
    yf = _frames(y) * win
    if len(xf) == 0:
        return x, y
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + EPS)
    mask = energies > (energies.max() - DYN_RANGE)
    xf, yf = xf[mask], yf[mask]
    hop = N_FRAME // 2
    n_out = N_FRAME + hop * (len(xf) - 1) if len(xf) else 0
    x_out = np.zeros(n_out)
    y_out = np.zeros(n_out)
    for i in range(len(xf)):
        x_out[i * hop : i * hop + N_FRAME] += xf[i]
        y_out[i * hop : i * hop + N_FRAME] += yf[i]
    return x_out, y_out


def _band_decomposition(x: np.ndarray) -> np.ndarray:
    """(L,) -> (15, M) one-third-octave band envelope."""
    win = _hann()
    frames = _frames(x) * win
    spec = np.fft.rfft(frames, NFFT, axis=1)  # (M, 257)
    power = np.abs(spec) ** 2
    return np.sqrt(_third_octave_matrix() @ power.T)  # (15, M)


def _prepare(clean, degraded, fs):
    x = _resample_to_10k(np.asarray(clean, np.float64), fs)
    y = _resample_to_10k(np.asarray(degraded, np.float64), fs)
    n = min(len(x), len(y))
    x, y = _remove_silent_frames(x[:n], y[:n])
    return _band_decomposition(x), _band_decomposition(y)


def stoi_np(clean: np.ndarray, degraded: np.ndarray, fs: int = 10_000) -> float:
    """Classic STOI in [~0, 1]."""
    X, Y = _prepare(clean, degraded, fs)
    m_total = X.shape[1]
    if m_total < N_SEG:
        warnings.warn("not enough STOI frames; returning 1e-5 (pystoi behavior)")
        return 1e-5

    c = 10 ** (-BETA / 20.0)
    d_sum, count = 0.0, 0
    for m in range(N_SEG, m_total + 1):
        Xs = X[:, m - N_SEG : m]  # (15, 30)
        Ys = Y[:, m - N_SEG : m]
        alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (
            np.linalg.norm(Ys, axis=1, keepdims=True) + EPS
        )
        Ys_n = np.minimum(alpha * Ys, Xs * (1 + c))
        xm = Xs - Xs.mean(axis=1, keepdims=True)
        ym = Ys_n - Ys_n.mean(axis=1, keepdims=True)
        corr = (xm * ym).sum(axis=1) / (
            np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + EPS
        )
        d_sum += corr.sum()
        count += NUMBAND
    return float(d_sum / count)


def estoi_np(clean: np.ndarray, degraded: np.ndarray, fs: int = 10_000) -> float:
    """Extended STOI (row+column normalized segment correlation)."""
    X, Y = _prepare(clean, degraded, fs)
    m_total = X.shape[1]
    if m_total < N_SEG:
        warnings.warn("not enough STOI frames; returning 1e-5 (pystoi behavior)")
        return 1e-5

    d_sum, count = 0.0, 0
    for m in range(N_SEG, m_total + 1):
        Xs = X[:, m - N_SEG : m]
        Ys = Y[:, m - N_SEG : m]
        # row (time) normalization
        Xr = Xs - Xs.mean(axis=1, keepdims=True)
        Xr = Xr / (np.linalg.norm(Xr, axis=1, keepdims=True) + EPS)
        Yr = Ys - Ys.mean(axis=1, keepdims=True)
        Yr = Yr / (np.linalg.norm(Yr, axis=1, keepdims=True) + EPS)
        # column (band) normalization
        Xc = Xr - Xr.mean(axis=0, keepdims=True)
        Xc = Xc / (np.linalg.norm(Xc, axis=0, keepdims=True) + EPS)
        Yc = Yr - Yr.mean(axis=0, keepdims=True)
        Yc = Yc / (np.linalg.norm(Yc, axis=0, keepdims=True) + EPS)
        d_sum += float((Xc * Yc).sum() / N_SEG)
        count += 1
    return float(d_sum / count)
