"""Griffin-Lim on the card, fp32: a round in four launches, two hand-written
Hopper kernels around cuFFT.

``griffin_lim_cuda`` computes what ``vcagan_torch.dsp.griffin_lim`` (the FFT
form) computes, with the same draws and the same fp32 rounding points, in
the launches of ``vcagan_torch/csrc/griffin_lim.cu``:

1. cuFFT's c2r of the spectrum into raw frames (the buffer is the call's
   own, so the c2r may overwrite it; ``torch.fft.irfft`` copies its input
   first and scales in a pass of its own);
2. ``gl_reframe``: from the raw frames straight to the next STFT's windowed
   frames; for output frame t and sample n, the re-padded position
   q = t hop + n, the trimmed position s = q - n_fft / 2 reflected at both
   ends of the clip's signal (length L = hop (T - 1)), the four frames that
   overlap there scaled by 1 / n_fft and windowed, summed, times the
   window-sum-square correction, times the analysis window at n;
3. cuFFT's r2c of those frames;
4. ``gl_project``: spectrum <- mag * z * rsqrt(zr^2 + zi^2 + 1e-16), in place.

Before the rounds one ``gl_project`` makes the spectrum mag * (cos a, sin a)
from the initial phase a (drawn as ``griffin_lim`` draws it); after them one
c2r and one ``gl_overlap_add`` write the trimmed, corrected waveform.  So a
call of R rounds is 4 R + 3 launches (``kernel_launches``), counted in
``griffin_lim.launches`` beside one ``griffin_lim.calls``
(``vcagan_torch.tracing``).

It takes fp32 magnitudes (B, T, n_fft / 2 + 1) on a CUDA device, any B and
T >= 4, with n_fft = 4 hop = win and hop a multiple of 4 (every
``AudioConfig`` of both packages); anything else raises.  CPU tensors keep ``griffin_lim``, which is also the
oracle.  ``griffin_lim_reference`` is the plain twin of the fused round, in
PyTorch: the same gather and projection on ``torch.fft``'s transforms.
Forward only.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import threading

import torch

from vcagan_torch import tracing
from vcagan_torch.dsp.griffin_lim import random_phase
from vcagan_torch.dsp.stft import STFTParams, _wss_correction, window
from vcagan_torch.kernels import _build, refuse_grad

OVERLAP = 4  # frames over each sample: n_fft = 4 hop
TILE = 16  # output frames a gl_reframe block
MAX_SMEM = 232448  # bytes of shared memory a block may use on an H100
PLAN_CACHE = 16  # cuFFT plan pairs kept (one a batch of B T transforms and device)


def _check_params(params: STFTParams, t: int) -> None:
    if params.n_fft != OVERLAP * params.hop_length:
        raise ValueError(f"the Griffin-Lim kernel takes n_fft = {OVERLAP} hop, got n_fft "
                         f"{params.n_fft} and hop {params.hop_length}")
    if params.hop_length % 4:
        raise ValueError(f"the Griffin-Lim kernel takes a hop that is a multiple of 4 (it moves "
                         f"four samples at once), got {params.hop_length}")
    if params.win_length != params.n_fft:
        raise ValueError(f"the Griffin-Lim kernel takes win_length = n_fft, got "
                         f"{params.win_length} and {params.n_fft}")
    if t < OVERLAP:
        raise ValueError(f"the Griffin-Lim kernel takes T >= {OVERLAP} frames (the reflect pad "
                         f"of n_fft / 2 needs a longer signal), got {t}")


# ---- the plain twin


@functools.lru_cache(maxsize=16)
def _gather_index(t: int, params: STFTParams):
    """For each sample q of the re-padded signal, (T + 3) hop of them: the
    four raw-frame positions f n_fft + m (k = 0..3, frame f = j - k of the
    block j = p / hop, m = p - f hop, p = reflect(q - pad) + pad), whether
    frame f exists, the position m in the window, and p (into the
    correction).  Int64 / bool CPU tensors."""
    hop, n_fft, pad = params.hop_length, params.n_fft, params.n_fft // 2
    length = hop * (t - 1)
    s = torch.arange((t + 3) * hop) - pad
    s = torch.where(s < 0, -s, torch.where(s >= length, 2 * (length - 1) - s, s))
    p = s + pad
    j, r = p // hop, p % hop
    k = torch.arange(OVERLAP)
    f = j[:, None] - k  # (Q, 4)
    m = r[:, None] + k * hop
    valid = (f >= 0) & (f < t)
    return torch.where(valid, f * n_fft + m, 0), valid, m, p


def _signal(frames: torch.Tensor, params: STFTParams, keep: slice = slice(None)) -> torch.Tensor:
    """The samples ``keep`` of the re-padded, corrected signal of frames
    (B, T, n_fft) of ``torch.fft.irfft`` (scaled): at each, the gather of the
    four overlapping frames, windowed and added in overlap_add's order of
    the shifted adds, times the correction."""
    b, t, _ = frames.shape
    idx, valid, m, p = (x[keep].to(frames.device) for x in _gather_index(t, params))
    win = window(params, frames.device, frames.dtype)
    corr = _wss_correction(t, params, frames.device, frames.dtype)
    terms = frames.reshape(b, -1)[:, idx] * win[m] * valid  # (B, Q, 4)
    acc = terms[..., 0]
    for k in range(1, OVERLAP):
        acc = acc + terms[..., k]
    return acc * corr[p]


def reframe_reference(frames: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """``gl_reframe`` in PyTorch: frames (B, T, n_fft) of ``torch.fft.irfft``
    (scaled) -> the next STFT's windowed frames (B, T, n_fft)."""
    _check_params(params, frames.shape[1])
    return (_signal(frames, params).unfold(-1, params.n_fft, params.hop_length)
            * window(params, frames.device, frames.dtype))


def overlap_add_reference(frames: torch.Tensor, params: STFTParams) -> torch.Tensor:
    """``gl_overlap_add`` in PyTorch: scaled frames (B, T, n_fft) -> the
    trimmed, corrected waveform (B, hop (T - 1)): the re-padded signal's
    samples pad .. pad + L, which the reflection leaves where they are."""
    pad = params.n_fft // 2
    return _signal(frames, params, slice(pad, pad + params.hop_length * (frames.shape[1] - 1)))


def project_reference(z: torch.Tensor, magnitudes: torch.Tensor) -> torch.Tensor:
    """``gl_project`` in PyTorch: mag * z * rsqrt(zr^2 + zi^2 + 1e-16)."""
    zr, zi = z.real, z.imag
    inv_norm = torch.rsqrt(zr * zr + zi * zi + 1e-16)
    return torch.complex(magnitudes * (zr * inv_norm), magnitudes * (zi * inv_norm))


def _initial_phase(magnitudes, init_phase, generator) -> torch.Tensor:
    """The angles ``griffin_lim`` starts from, drawn with the same call."""
    if init_phase is None:
        return random_phase(magnitudes.shape, generator, magnitudes.device, magnitudes.dtype)
    return init_phase.to(magnitudes.dtype)


def griffin_lim_reference(
    magnitudes: torch.Tensor,
    params: STFTParams,
    n_iters: int = 60,
    init_phase: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Plain twin of ``griffin_lim_cuda``: the fused round's gather and
    projection around ``torch.fft``'s transforms, in the magnitudes' dtype
    (fp32 or float64), on any device; (B, T, n_bins) -> (B, hop (T - 1))."""
    _check_params(params, magnitudes.shape[1])
    angles = _initial_phase(magnitudes, init_phase, generator)
    spec = torch.complex(magnitudes * torch.cos(angles), magnitudes * torch.sin(angles))
    for _ in range(n_iters):
        frames = torch.fft.irfft(spec, n=params.n_fft, dim=-1)
        z = torch.fft.rfft(reframe_reference(frames, params), n=params.n_fft, dim=-1)
        spec = project_reference(z, magnitudes)
    return overlap_add_reference(torch.fft.irfft(spec, n=params.n_fft, dim=-1), params)


# ---- the plan


def _smem_bytes(tile: int, params: STFTParams) -> int:
    """The window and the (tile + 3) hop samples of a gl_reframe block, fp32."""
    return 4 * ((tile + OVERLAP - 1) * params.hop_length + params.n_fft)


@dataclasses.dataclass(frozen=True)
class GriffinLimPlan:
    """One call: B clips of T frames, ``rounds`` rounds, gl_reframe blocks
    of ``tile`` output frames of one clip with ``smem`` bytes of shared
    memory."""

    b: int
    t: int
    n_fft: int
    hop: int
    rounds: int
    tile: int
    smem: int

    def ints(self) -> list[int]:
        """What the C entry point takes, in its order."""
        return [self.b, self.t, self.n_fft, self.hop, self.rounds, self.tile, self.smem]


def plan_griffin_lim(b: int, t: int, params: STFTParams, rounds: int) -> GriffinLimPlan:
    """The plan of a call on (B, T, n_bins) magnitudes: gl_reframe blocks of
    ``TILE`` frames, or T where fewer.  Raises on what the kernels do not
    take."""
    _check_params(params, t)
    if b < 1 or rounds < 0:
        raise ValueError(f"the Griffin-Lim kernel takes B >= 1 and rounds >= 0, got {b}, {rounds}")
    tile = min(TILE, t)
    smem = _smem_bytes(tile, params)
    if smem > MAX_SMEM:
        raise ValueError(f"a gl_reframe block of {tile} frames needs {smem} bytes of shared "
                         f"memory, over {MAX_SMEM}")
    if b * -(-t // tile) > 2**31 - 1:
        raise ValueError(f"B = {b} x {t} frames is more gl_reframe blocks than a grid holds")
    return GriffinLimPlan(b, t, params.n_fft, params.hop_length, rounds, tile, smem)


def kernel_launches(plan: GriffinLimPlan) -> int:
    """The launches of one call of ``plan``: the first gl_project; c2r,
    gl_reframe, r2c and gl_project a round; the last c2r and
    gl_overlap_add (cuFFT's transforms at these sizes are one kernel each)."""
    return 4 * plan.rounds + 3


# ---- the kernels


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first use)."""
    lib = _build.load("griffin_lim")
    lib.vcagan_gl_make_plans.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_ulonglong)]
    lib.vcagan_gl_make_plans.restype = ctypes.c_int
    lib.vcagan_gl_destroy_plans.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.vcagan_gl_destroy_plans.restype = ctypes.c_int
    lib.vcagan_griffin_lim.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_float, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.vcagan_griffin_lim.restype = ctypes.c_int
    lib.vcagan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vcagan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _error(lib, err: int) -> str:
    if err < 0:
        return f"cuFFT error {-err}"
    return lib.vcagan_cuda_error_string(err).decode()


class _FFTPlans:
    """A c2r and an r2c plan of ``batch`` transforms on one device, and the
    workspace they share (allocated through PyTorch, so that it counts in
    its memory statistics)."""

    def __init__(self, lib, n_fft: int, batch: int, device: torch.device):
        handles, work = (ctypes.c_int * 2)(), ctypes.c_ulonglong()
        err = lib.vcagan_gl_make_plans(n_fft, batch, device.index, handles, ctypes.byref(work))
        if err != 0:
            raise RuntimeError(f"cuFFT plans of {batch} x {n_fft} points failed ({err}): "
                               f"{_error(lib, err)}")
        self.lib, self.handles, self.device = lib, handles, device
        self.work = torch.empty(max(work.value, 1), dtype=torch.uint8, device=device)

    def destroy(self) -> None:
        torch.cuda.synchronize(self.device)  # no queued transform still uses them
        self.lib.vcagan_gl_destroy_plans(self.handles)


_PLANS: "collections.OrderedDict[tuple, _FFTPlans]" = collections.OrderedDict()
_PLANS_LOCK = threading.Lock()


def _fft_plans(lib, n_fft: int, batch: int, device: torch.device) -> _FFTPlans:
    """The cached plans of ``batch`` transforms, the least recently used pair
    destroyed past ``PLAN_CACHE``."""
    key = (n_fft, batch, device.index)
    with _PLANS_LOCK:
        plans = _PLANS.get(key)
        if plans is None:
            plans = _PLANS[key] = _FFTPlans(lib, n_fft, batch, device)
            while len(_PLANS) > PLAN_CACHE:
                _PLANS.popitem(last=False)[1].destroy()
        _PLANS.move_to_end(key)
        return plans


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned, as the kernels read it (a copy
    where it is not)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def griffin_lim_cuda(
    magnitudes: torch.Tensor,
    params: STFTParams,
    n_iters: int = 60,
    init_phase: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """(B, T, n_bins) fp32 magnitudes on a CUDA device -> (B, hop (T - 1))
    waveforms, on the current stream; ``init_phase`` (B, T, n_bins) replaces
    the random phase drawn from ``generator``, as in ``griffin_lim``.
    Raises on any input the kernels do not take and on a launch error."""
    refuse_grad("griffin_lim", magnitudes=magnitudes)
    if magnitudes.device.type != "cuda":
        raise ValueError(f"magnitudes must lie on a CUDA device, got {magnitudes.device}")
    if magnitudes.dtype != torch.float32 or magnitudes.dim() != 3:
        raise ValueError(f"magnitudes must be float32 (B, T, n_bins), got {magnitudes.dtype} "
                         f"{tuple(magnitudes.shape)}")
    b, t, bins = magnitudes.shape
    plan = plan_griffin_lim(b, t, params, n_iters)  # raises on what the kernels refuse
    if bins != params.n_bins:
        raise ValueError(f"magnitudes must have {params.n_bins} bins, got {bins}")
    if init_phase is not None and (tuple(init_phase.shape) != tuple(magnitudes.shape)
                                   or init_phase.device != magnitudes.device):
        raise ValueError(f"init_phase must be {tuple(magnitudes.shape)} on {magnitudes.device}, "
                         f"got {tuple(init_phase.shape)} on {init_phase.device}")
    device = magnitudes.device
    mag = _aligned(magnitudes)
    angle = _aligned(_initial_phase(mag, init_phase, generator))
    win = window(params, device, torch.float32)
    corr = _wss_correction(t, params, device, torch.float32)
    spec = torch.empty((b, t, bins), dtype=torch.complex64, device=device)
    frames = torch.empty((b, t, params.n_fft), dtype=torch.float32, device=device)
    framed = torch.empty_like(frames)
    out = torch.empty((b, params.hop_length * (t - 1)), dtype=torch.float32, device=device)
    lib = _lib()
    fft = _fft_plans(lib, params.n_fft, b * t, device)
    ints = plan.ints()
    err = lib.vcagan_griffin_lim(
        mag.data_ptr(), angle.data_ptr(), spec.data_ptr(), frames.data_ptr(), framed.data_ptr(),
        out.data_ptr(), win.data_ptr(), corr.data_ptr(), 1.0 / params.n_fft,
        (ctypes.c_int * len(ints))(*ints), len(ints), fft.handles, fft.work.data_ptr(),
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"griffin_lim launch failed ({err}): {_error(lib, err)}; plan {plan}")
    tracing.count("griffin_lim.calls")
    tracing.count("griffin_lim.launches", kernel_launches(plan))
    return out

