"""Video clip transforms: a whole batch of clips at once on the device, and
the host-side luma and resize that run before the copy to the device.

Port of ``vcagan/data/transforms.py``.  The reference runs crop, resize,
flip, grayscale, normalise and random erase per frame in PIL
(reference: vid_aud_grid.py:94-121); here one batch (B, W, H, W, C) goes
through as tensor ops.  The per-clip draws (a flip bit and the erase
patch's two offsets) come from a ``torch.Generator`` through
:func:`augment_draws`, or are handed in.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vcagan_torch.parallel.mesh import draw_rows

GRID_CROP = (59, 95, 195, 231)  # (x0, y0, x1, y1), reference vid_aud_grid.py:99
PIXEL_MEAN = 0.4136
PIXEL_STD = 0.1700
ERASE_LOW, ERASE_HIGH = -10, 67  # erase start in [-10, 66] (reference vid_aud_grid.py:116-118)
_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)


def host_luma_u8(video: np.ndarray) -> np.ndarray:
    """uint8 RGB frames -> uint8 ITU-R 601 luma (..., 1) on the host
    (``DataConfig.host_gray``): a third of the bytes to copy.  One uint8
    rounding (<= 0.5/255) from the device's float luma, below the
    reference's own PIL quantisation."""
    y = np.rint(video[..., :3].astype(np.float32) @ _LUMA)
    return np.clip(y, 0.0, 255.0).astype(np.uint8)[..., None]


@functools.lru_cache(maxsize=16)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """The (out_size, in_size) matrix of an antialiased bilinear resize
    along one axis, as ``jax.image.resize(..., "bilinear")`` computes it
    (``jax._src.image.scale.compute_weight_mat``): output pixel i samples
    the input at s = (i + 0.5) * in/out - 0.5 with the triangle kernel
    max(0, 1 - |s - j| / k), widened by k = in/out when downscaling (the
    antialias) and k = 1 otherwise; each row is normalised to sum 1, and
    rows whose sample lies outside [-0.5, in - 0.5] are zero.  An axis that
    keeps its size is left as it is (the identity).  Returned read-only: the
    same array goes to every caller."""
    if in_size == out_size:
        w = np.eye(in_size, dtype=np.float32)
    else:
        f32 = np.float32
        inv_scale = f32(1.0 / (out_size / in_size))
        kernel_scale = max(inv_scale, f32(1.0))
        # XLA fuses the product and the subtraction into one rounding; the
        # float64 product of two float32 values is exact, so this rounds once
        sample = ((np.arange(out_size, dtype=f32) + f32(0.5)).astype(np.float64)
                  * np.float64(inv_scale) - 0.5).astype(f32)
        x = np.abs(sample[:, None] - np.arange(in_size, dtype=f32)[None, :]) / kernel_scale
        w = np.maximum(f32(0.0), f32(1.0) - x)
        total = w.sum(axis=1, keepdims=True, dtype=f32)
        w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                     w / np.where(total != 0, total, f32(1.0)), f32(0.0))
        inside = (sample >= -0.5) & (sample <= in_size - 0.5)
        w = np.where(inside[:, None], w, f32(0.0)).astype(f32)
    w.setflags(write=False)
    return w


# Constants on the device, copied there once: a copy from pageable host
# memory on every batch would make the host wait for the device.
@functools.lru_cache(maxsize=16)
def _resize_matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_weights(in_size, out_size).copy()).to(device)


@functools.lru_cache(maxsize=4)
def _luma(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_LUMA).to(device)


def host_resize_u8(video: np.ndarray, out_size: int) -> np.ndarray:
    """uint8 frames (T, H, W, C) -> uint8 (T, out, out, C) on the host
    (``DataConfig.host_resize``) with the device resize's weights, rounded
    back to uint8 for the copy."""
    wh = _resize_weights(video.shape[1], out_size)
    ww = _resize_weights(video.shape[2], out_size)
    x = video.astype(np.float32)
    x = np.einsum("oh,thwc->towc", wh, x, optimize=True)
    x = np.einsum("pw,towc->topc", ww, x, optimize=True)
    return np.clip(np.rint(x), 0.0, 255.0).astype(np.uint8)


class AugmentDraws(NamedTuple):
    """Per clip: flip (B,) bool, and the erase patch's top-left corner
    x0, y0 (B,) int64 in [-10, 66]."""

    flip: torch.Tensor
    x0: torch.Tensor
    y0: torch.Tensor


def augment_draws(batch: int, generator: torch.Generator, device) -> AugmentDraws:
    """A flip bit and two erase offsets for each of ``batch`` clips (drawn
    for the global batch under a data-parallel layout, ``draw_rows``)."""

    def draw(n):
        flip = torch.rand(n, generator=generator, device=device) < 0.5
        x0, y0 = (torch.randint(ERASE_LOW, ERASE_HIGH, (n,), generator=generator, device=device)
                  for _ in range(2))
        return AugmentDraws(flip, x0, y0)

    return draw_rows(draw, batch)


def prepare_clips(
    frames: torch.Tensor,
    draws: Optional[AugmentDraws] = None,
    crop_box: Optional[Tuple[int, int, int, int]] = GRID_CROP,
    out_size: int = 112,
    erase_size: int = 56,
) -> torch.Tensor:
    """Raw frames (B, T, H, W, C) uint8 or float, C = 1 or 3 -> (B, T,
    out_size, out_size, 1) float32, normalised.

    /255 (uint8), the fixed box crop (``crop_box=None``: the host already
    cut it), the antialiased bilinear resize to ``out_size``^2 as two
    products with :func:`_resize_weights`, then with ``draws`` the clip's
    horizontal flip; luma, normalise, and with ``draws`` a zeroed
    ``erase_size``^2 patch at the same place in every frame of the clip."""
    x = frames.float()
    if frames.dtype == torch.uint8:
        x = x / 255.0
    if crop_box is not None:
        x0, y0, x1, y1 = crop_box
        x = x[:, :, y0:y1, x0:x1, :]
    h, w = x.shape[2:4]
    if (h, w) != (out_size, out_size):
        wh = _resize_matrix(h, out_size, x.device)
        ww = _resize_matrix(w, out_size, x.device)
        x = torch.einsum("oh,bthwc->btowc", wh, x)
        x = torch.einsum("pw,btowc->btopc", ww, x)
    if draws is not None:
        x = torch.where(draws.flip[:, None, None, None, None], x.flip(3), x)
    if x.shape[-1] == 3:
        x = (x * _luma(x.device)).sum(-1, keepdim=True)
    x = (x - PIXEL_MEAN) / PIXEL_STD
    if draws is not None:
        rows = torch.arange(out_size, device=x.device)
        ys = rows[None, :] - draws.y0[:, None]  # (B, out)
        xs = rows[None, :] - draws.x0[:, None]
        in_y = (ys >= 0) & (ys < erase_size)
        in_x = (xs >= 0) & (xs < erase_size)
        patch = in_y[:, :, None] & in_x[:, None, :]  # (B, out, out)
        x = x.masked_fill(patch[:, None, :, :, None], 0.0)
    return x
