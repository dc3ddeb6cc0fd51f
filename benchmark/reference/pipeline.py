"""Plain PyTorch reference of the two device input pipelines: raw collated
batches -> (video, mel, spec, vid_len, mel_len).

GRID (``grid``): host-cropped grey frames /255, an antialiased bilinear
resize to 112^2, a horizontal flip and a 56^2 erase patch a clip,
normalised by the corpus's pixel mean and std; log-mels of the window
(audio framed without centring: the host positioned it), zero past
``mel_len``.  LRS (``lrs``): an 80^2 crop around each frame's lip centre
moved by a jitter a clip, resized, normalised and flipped; the spec
normalised per clip over its real frames; -1 past ``mel_len``.

The draws come from the generator in the order the benchmark hands them
to both sides: GRID a flip uniform, then the erase's x and y offsets; LRS
the jitter, then the flip uniform.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import dsp

PIXEL_MEAN, PIXEL_STD = 0.4136, 0.1700
ERASE = 56
ERASE_RANGE = (-10, 67)
JITTER = 5


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in): output pixel i samples the input at (i + 0.5) n_in /
    n_out - 0.5 with a triangle of width max(1, n_in / n_out), each row
    normalised to 1 (float64 here)."""
    if n_in == n_out:
        return np.eye(n_in)
    scale = n_in / n_out
    width = max(scale, 1.0)
    pos = (np.arange(n_out) + 0.5) * scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(pos[:, None] - np.arange(n_in)[None, :]) / width)
    w = w / w.sum(axis=1, keepdims=True)
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0)


def resize(x: torch.Tensor, out: int = 112) -> torch.Tensor:
    """(B, T, H, W, 1) -> (B, T, out, out, 1)."""
    wh = torch.as_tensor(resize_weights(x.shape[2], out), dtype=x.dtype, device=x.device)
    ww = torch.as_tensor(resize_weights(x.shape[3], out), dtype=x.dtype, device=x.device)
    return torch.einsum("oh,pw,bthwc->btopc", wh, ww, x)


def _normalize(x):
    return (x - PIXEL_MEAN) / PIXEL_STD


def _flip(x, flip):
    return torch.where(flip[:, None, None, None, None], x.flip(3), x)


def grid(raw: dict, generator: torch.Generator):
    b, w = raw["video_raw"].shape[:2]
    dev = raw["video_raw"].device
    flip = torch.rand(b, generator=generator, device=dev) < 0.5
    x0, y0 = (torch.randint(*ERASE_RANGE, (b,), generator=generator, device=dev)
              for _ in range(2))
    x = _normalize(_flip(resize(raw["video_raw"].double() / 255.0).float(), flip))
    rows = torch.arange(112, device=dev)
    in_y = ((rows[None] - y0[:, None]) >= 0) & ((rows[None] - y0[:, None]) < ERASE)
    in_x = ((rows[None] - x0[:, None]) >= 0) & ((rows[None] - x0[:, None]) < ERASE)
    x = x.masked_fill((in_y[:, :, None] & in_x[:, None, :])[:, None, :, :, None], 0.0)

    mag = dsp.stft(raw["aud_cond"], center=False).abs()
    n_mel = 4 * w
    mel = dsp.mel_normalize(dsp.log_mel(mag, 7500.0))[:, :n_mel]
    pad = (torch.arange(n_mel, device=dev)[None] >= raw["mel_len"][:, None])[:, :, None]
    return (x, mel.masked_fill(pad, 0.0).transpose(1, 2),
            mag[:, :n_mel].masked_fill(pad, 0.0).transpose(1, 2),
            raw["vid_len"], raw["mel_len"])


def lrs(raw: dict, generator: torch.Generator):
    frames, centers = raw["video_raw"], raw["centers"]
    b, t, h, w = frames.shape[:4]
    dev = frames.device
    jitter = torch.randint(-JITTER, JITTER + 1, (b,), generator=generator, device=dev)
    flip = torch.rand(b, generator=generator, device=dev) < 0.5
    pad = 48
    padded = frames.new_zeros((b, t, h + 2 * pad, w + 2 * pad, 1))
    padded[:, :, pad:pad + h, pad:pad + w] = frames
    cx = (centers[..., 0].long() + jitter[:, None]).clamp(-8, w + 8) - 40 + pad
    cy = (centers[..., 1].long() + jitter[:, None]).clamp(-8, h + 8) - 40 + pad
    r = torch.arange(80, device=dev)
    rows = cy.clamp(0, h + 2 * pad - 80)[..., None] + r
    cols = cx.clamp(0, w + 2 * pad - 80)[..., None] + r
    bi = torch.arange(b, device=dev)[:, None, None, None]
    ti = torch.arange(t, device=dev)[None, :, None, None]
    crops = padded[bi, ti, rows[..., :, None], cols[..., None, :]]
    x = _flip(_normalize(resize(crops.double() / 255.0).float()), flip)

    mag = dsp.stft(raw["aud_cond"], center=False).abs()
    n_mel = 4 * t
    mel = dsp.mel_normalize(dsp.log_mel(mag, 7600.0))[:, :n_mel]
    spec = mag[:, :n_mel]
    valid = (torch.arange(n_mel, device=dev)[None] < raw["mel_len"][:, None])[:, :, None]
    lo = torch.where(valid, spec, torch.inf).amin(dim=(1, 2), keepdim=True)
    hi = torch.where(valid, spec, -torch.inf).amax(dim=(1, 2), keepdim=True)
    unit = (spec - lo) / torch.clamp(hi - lo, min=1e-8)
    spec = dsp.mel_normalize(torch.log(torch.clamp(unit, min=1e-5)))
    return (x, mel.masked_fill(~valid, -1.0).transpose(1, 2),
            spec.masked_fill(~valid, -1.0).transpose(1, 2), raw["vid_len"], raw["mel_len"])


PIPELINES = {"grid": grid, "lrs": lrs}
