"""LRS2 / LRS3 data: clip lists joined with per-frame lip-centre tables,
variable-length clips, dynamic per-frame lip crops on the device, and the
LRS spectrogram normalisation.

Port of ``vcagan/data/lrs.py`` (reference: vid_aud_lrs2.py,
vid_aud_lrs3.py), less its multi-host slicing:

- file lists joined with per-frame lip-centre tables (vid_aud_lrs2.py:40-85;
  LRS3 uses 3 partition crop files and the SVTS unseen splits,
  vid_aud_lrs3.py:27-85)
- an 80x80 crop around the stored lip centre with a +/-5 px train jitter,
  resized to 112^2 (build_tensor, vid_aud_lrs2.py:87-120): on the device,
  for a whole batch at once, as a gather of the 80x80 windows and the
  resize of ``vcagan_torch.data.transforms`` (``jax.image.resize``'s
  weights); with ``host_crop`` the host ships only a 96^2 superset around
  each frame's clipped centre
- long clips cut at max_v_timesteps (vid_aud_lrs2.py:163-169)
- the LRS spec chain: per-clip min-max -> log compression -> [-1, 1]
  (vid_aud_lrs2.py:176-178), inverted with the x14 global scale
  (denormalize_spec, vid_aud_lrs2.py:290-296)
- variable-length batches padded with -1.0 (collate_fn,
  vid_aud_lrs2.py:203-233); evaluation batches bucketed to a few static
  lengths
- one numpy rng draws the shuffle and then one row of window starts per
  batch, so a seed gives the JAX package's raw batches byte for byte

When the corpus is absent, ``SyntheticLRSSource`` provides clips of 30-90
frames with lip-centre tracks.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from vcagan_torch.configs import AudioConfig, DataConfig
from vcagan_torch.data import audio_host
from vcagan_torch.data.grid import decode_video, load_audio
from vcagan_torch.data.splits import load_crop_table
from vcagan_torch.data.synthetic import SyntheticLipSpeech
from vcagan_torch.data.transforms import host_luma_u8, prepare_clips
from vcagan_torch.dsp.audio import dynamic_range_compression, mel_denormalize, mel_normalize
from vcagan_torch.dsp.pipeline import MelPipeline
from vcagan_torch.dsp.stft import stft_magnitude
from vcagan_torch.parallel.mesh import draw_rows
from vcagan_torch.runtime import resolve_device
from vcagan_torch.tracing import span
from vcagan_torch.train.step import Batch

SPEC_DENORM_SCALE = 14.0  # reference vid_aud_lrs2.py:295
JITTER = 5  # the train crop's shift, in [-5, 5] px (``vcagan/data/lrs.py:569``)
SUP_MARGIN = 8  # > max |train jitter|; matches crop_resize_dynamic's pad


def lrs_normalize_spec(spec: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-clip min-max -> log -> [-1, 1] (reference vid_aud_lrs2.py:176-178).

    spec: (B, T, 321) linear magnitudes; min/max per clip over all bins.
    ``valid`` (B, T) bool restricts the min/max to real (unpadded) frames:
    the reference normalises the windowed spec before padding, so padding
    never enters the statistics."""
    if valid is not None:
        m = valid[:, :, None]
        lo = torch.where(m, spec, torch.inf).amin(dim=(1, 2), keepdim=True)
        hi = torch.where(m, spec, -torch.inf).amax(dim=(1, 2), keepdim=True)
    else:
        lo = spec.amin(dim=(1, 2), keepdim=True)
        hi = spec.amax(dim=(1, 2), keepdim=True)
    unit = (spec - lo) / torch.clamp(hi - lo, min=1e-8)
    return mel_normalize(dynamic_range_compression(unit))


def lrs_denormalize_spec(spec_norm: torch.Tensor) -> torch.Tensor:
    """[-1, 1] log-spec -> linear magnitudes scaled by 14 (reference
    inverse_spec chain, vid_aud_lrs2.py:257-272)."""
    return torch.exp(mel_denormalize(spec_norm)) * SPEC_DENORM_SCALE


def _windows(x: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, size: int) -> torch.Tensor:
    """The size^2 window at (y0, x0) of every frame: x (B, T, H, W, C),
    y0 and x0 (B, T) -> (B, T, size, size, C), one gather.  The starts are
    clamped into the frame as ``jax.lax.dynamic_slice`` clamps them."""
    b, t, h, w = x.shape[:4]
    r = torch.arange(size, device=x.device)
    rows = y0.long().clamp(0, h - size)[..., None] + r  # (B, T, size)
    cols = x0.long().clamp(0, w - size)[..., None] + r
    bi = torch.arange(b, device=x.device)[:, None, None, None]
    ti = torch.arange(t, device=x.device)[None, :, None, None]
    return x[bi, ti, rows[..., :, None], cols[..., None, :]]


def crop_resize_dynamic(
    frames: torch.Tensor,
    centers: torch.Tensor,
    jitter: torch.Tensor,
    out_size: int = 112,
    half: int = 40,
) -> torch.Tensor:
    """Per-frame 2*half-square crops around the lip centres, resized and
    normalised: frames (B, T, H, W, C) uint8 or float, centers (B, T, 2)
    int (x, y), jitter (B,) int (one shift a clip, as the reference draws)
    -> (B, T, out_size, out_size, 1) float32.  Out-of-bounds crops read
    zero padding (PIL crop semantics); ``vcagan/data/lrs.py:70-104``."""
    b, t, h, w, c = frames.shape
    pad = half + 8  # covers +/-5 jitter and degenerate centres near edges
    padded = frames.new_zeros((b, t, h + 2 * pad, w + 2 * pad, c))
    padded[:, :, pad:pad + h, pad:pad + w] = frames
    j = jitter.long()[:, None]
    cx = (centers[..., 0].long() + j).clamp(-8, w + 8)
    cy = (centers[..., 1].long() + j).clamp(-8, h + 8)
    crops = _windows(padded, cy - half + pad, cx - half + pad, 2 * half)
    return prepare_clips(crops, None, crop_box=None, out_size=out_size)


def precrop_superset(
    video: np.ndarray,
    coords: np.ndarray,
    half: int = 40,
    margin: int = SUP_MARGIN,
):
    """Host half of DataConfig.host_crop for LRS: cut a (2*(half+margin))^2
    zero-padded superset around each frame's CLIPPED lip centre so only
    ~96^2 pixels cross the host->device link instead of the full frame.

    clip() is 1-Lipschitz, so the device's jittered window position
    ``clip(c + j)`` (|j| <= 5 < margin) never strays more than ``margin``
    from ``clip(c)``: the 2*half window always lies inside the superset,
    with the zero padding of crop_resize_dynamic's whole-frame pad.
    Returns (superset (T', S, S, C) uint8, clipped centres (T', 2) int32)
    with T' = min(len(video), len(coords))."""
    t = min(video.shape[0], coords.shape[0])
    h, w = video.shape[1:3]
    s = half + margin
    cm = np.stack(
        [
            np.clip(coords[:t, 0], -margin, w + margin),
            np.clip(coords[:t, 1], -margin, h + margin),
        ],
        axis=1,
    ).astype(np.int32)
    out = np.zeros((t, 2 * s, 2 * s, video.shape[3]), video.dtype)
    for i in range(t):
        x0, y0 = int(cm[i, 0]) - s, int(cm[i, 1]) - s
        ys0, ys1 = max(y0, 0), min(y0 + 2 * s, h)
        xs0, xs1 = max(x0, 0), min(x0 + 2 * s, w)
        if ys1 > ys0 and xs1 > xs0:
            out[i, ys0 - y0 : ys1 - y0, xs0 - x0 : xs1 - x0] = video[i, ys0:ys1, xs0:xs1]
    return out, cm


def crop_resize_dynamic_sup(
    sup: torch.Tensor,
    centers: torch.Tensor,
    centers_m: torch.Tensor,
    hw: torch.Tensor,
    jitter: torch.Tensor,
    out_size: int = 112,
    half: int = 40,
    margin: int = SUP_MARGIN,
) -> torch.Tensor:
    """crop_resize_dynamic over host-precropped supersets (the host_crop
    path, ``vcagan/data/lrs.py:149-186``).

    sup (B, T, S, S, C) from precrop_superset; centers: the ORIGINAL (B, T, 2)
    (x, y); centers_m: the clipped centres the supersets were cut around;
    hw (B, 2): each clip's original (h, w), the jitter's clip bounds.
    Reads the exact pixels (and zero padding) the full-frame path would."""
    j = jitter.long()[:, None]
    h, w = hw[:, 0:1].long(), hw[:, 1:2].long()
    cx = torch.minimum((centers[..., 0].long() + j).clamp(min=-margin), w + margin)
    cy = torch.minimum((centers[..., 1].long() + j).clamp(min=-margin), h + margin)
    y0 = cy - centers_m[..., 1].long() + margin
    x0 = cx - centers_m[..., 0].long() + margin
    crops = _windows(sup, y0, x0, 2 * half)
    return prepare_clips(crops, None, crop_box=None, out_size=out_size)


class LRSClipSource:
    """LRS2/LRS3 clips with lip-centre tables."""

    def __init__(self, config: DataConfig, mode: str, splits_dir: str = "./data"):
        self.config = config
        self.mode = mode
        self.dataset = config.dataset
        self.crops: Dict[str, List[int]] = {}
        self.files: List[str] = []
        self._build(splits_dir)

    def _build(self, splits_dir: str):
        base = os.path.join(splits_dir, self.dataset)
        if self.dataset == "LRS2":
            crop_dir = os.path.join(base, "LRS2_crop")
            partitions = ["main"] + (["pretrain"] if self.mode == "train" else [])
            for part in partitions:
                table_path = os.path.join(crop_dir, f"preprocess_{part}.txt")
                if os.path.exists(table_path):
                    self.crops.update(load_crop_table(table_path, part))
            list_name = {"train": "train.txt", "val": "val.txt", "test": "test.txt"}[self.mode]
            names = []
            with open(os.path.join(base, list_name)) as f:
                for line in f:
                    entry = line.strip().split()[0] if line.strip() else ""
                    if entry:
                        names.append(f"main/{entry}")
            if self.mode == "train":
                pre = os.path.join(base, "pretrain.txt")
                if os.path.exists(pre):
                    with open(pre) as f:
                        names += [f"pretrain/{line.strip()}" for line in f if line.strip()]
            self.files = [n for n in names if n in self.crops]
            self.audio_tree = "LRS2-BBC_audio"
            self.video_tree = "LRS2-BBC"
        else:  # LRS3
            crop_dir = os.path.join(base, "LRS3_crop")
            for part in ("pretrain", "trainval", "test"):
                table_path = os.path.join(crop_dir, f"preprocess_{part}.txt")
                if os.path.exists(table_path):
                    self.crops.update(load_crop_table(table_path, part))
            with open(os.path.join(base, f"lrs3_unseen_{self.mode}.txt")) as f:
                names = [line.strip() for line in f if line.strip()]
            self.files = [n for n in names if n in self.crops]
            self.audio_tree = "LRS3-TED_audio"
            self.video_tree = "LRS3-TED"

    def __len__(self) -> int:
        return len(self.files)

    def frame_count(self, idx: int) -> int:
        """Video frame count from the crop table (one (x, y) row a frame),
        known without decoding (the reference asserts crop/frame agreement
        at vid_aud_lrs2.py:192, so this equals the decoded length)."""
        return len(self.crops[self.files[idx]]) // 2

    def clip(self, idx: int):
        name = self.files[idx]
        root = self.config.data_root
        video = decode_video(os.path.join(root, name + ".mp4"))
        audio = load_audio(
            os.path.join(root.replace(self.video_tree, self.audio_tree), name + ".wav")
        )
        coords = np.asarray(self.crops[name], np.int32).reshape(-1, 2)
        return video, audio, coords

    def name(self, idx: int) -> str:
        return self.files[idx]


class SyntheticLRSSource:
    """Synthetic variable-length clips with lip-centre tracks: the JAX
    package's clips byte for byte, each rendered once and kept (about 18 MB
    a 90-frame clip)."""

    def __init__(
        self,
        num_clips: int = 8,
        min_frames: int = 30,
        max_frames: int = 90,
        lengths=None,
    ):
        self._rng = np.random.default_rng(7)
        if lengths is not None:  # explicit per-clip frame counts (tests)
            self._lengths = np.asarray(lengths, np.int64)
        else:
            self._lengths = self._rng.integers(min_frames, max_frames + 1, num_clips)
        self._cache: dict = {}

    def __len__(self):
        return len(self._lengths)

    def frame_count(self, idx: int) -> int:
        return int(self._lengths[idx])

    def clip(self, idx: int):
        if idx in self._cache:
            return self._cache[idx]
        t = int(self._lengths[idx])
        gen = SyntheticLipSpeech(num_clips=len(self._lengths), video_frames=t, cache=False)
        video, audio = gen.clip(idx)
        # lip centre track: mouth at (0.5 W, 0.68 H) with small wander
        cx = (video.shape[2] * 0.5 + 3 * np.sin(np.arange(t) / 7)).astype(np.int32)
        cy = np.full(t, int(video.shape[1] * 0.68), np.int32)
        self._cache[idx] = video, audio, np.stack([cx, cy], axis=1)
        return self._cache[idx]

    def name(self, idx: int) -> str:
        return f"synthetic/{idx:05d}"


class LRSDataset:
    """Variable-length batching with shape bucketing."""

    BUCKETS = (40, 80, 120, 160)  # video-frame buckets for eval collation

    def __init__(
        self,
        source,
        audio_config: AudioConfig,
        data_config: DataConfig,
        mode: str = "train",
        seed: int = 0,
        workers: int = 0,
    ):
        self.source = source
        self.audio = audio_config
        self.data = data_config
        self.mode = mode
        self.sample_window = mode == "train"
        self.rng = np.random.default_rng(seed)
        self._pool = None
        if workers and workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=workers)

    def close(self) -> None:
        """Shut down the decode worker pool (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):  # best-effort backstop for ephemeral datasets
        try:
            self.close()
        except Exception:
            pass

    def _fetch(self, idx: int):
        """Decode and full-clip conditioning (the parallelisable part).
        Returns (video, audio, coords, normed, cond, centers_m, hw): with
        host_crop, ``video`` is the 96^2 per-frame superset around the
        clipped centres ``centers_m`` and ``hw`` the original frame size
        (the device's jitter clip bounds); otherwise centers_m is None."""
        video, audio, coords = self.source.clip(int(idx))
        hw = video.shape[1:3]
        cm = None
        if self.data.host_crop:
            video, cm = precrop_superset(video, coords)
        if self.data.host_gray and video.shape[-1] == 3:
            video = host_luma_u8(video)
        normed = audio_host.peak_normalize_clip(audio)
        cond = audio_host.preemphasize_clamp(normed, self.audio.preemphasis)
        return video, audio, coords, normed, cond, cm, hw

    def _fetch_all(self, idxs):
        if self._pool is not None:
            return list(self._pool.map(self._fetch, idxs))
        return [self._fetch(i) for i in idxs]

    def __len__(self) -> int:
        return len(self.source)

    def _bucket(self, n: int) -> int:
        for b in self.BUCKETS:
            if n <= b and b <= self.data.max_v_timesteps:
                return b
        return self.data.max_v_timesteps

    def epoch(
        self,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        process_slice: Optional[slice] = None,
        sort_by_length: bool = False,
    ) -> Iterator[dict]:
        """Raw batches, as ``GridDataset.epoch`` (``drop_last=False`` pads
        the tail batch by wrapping earlier clips and marks the real count in
        ``n_valid``; ``process_slice``: this rank's slice of each global
        batch).  An evaluation batch's length is the bucket of its longest
        clip, from the source's frame counts, over the GLOBAL batch before
        slicing (``vcagan/data/lrs.py:380-440``): BatchNorm's statistics
        include the padded frames, so a bucket of the rank's own clips would
        change the numbers, not only the shapes.

        ``sort_by_length`` (evaluation only, ignored under shuffle): order
        the clips by frame count, so each batch lands in the smallest bucket
        that fits it.  Identity is kept in each raw batch's ``idx``."""
        n = len(self.source)
        if n == 0 or (drop_last and n < batch_size):
            raise ValueError(
                f"dataset has {n} clips < batch_size {batch_size}: "
                "every epoch would yield zero batches"
            )
        sl = process_slice if process_slice is not None else slice(None)
        order = np.arange(n)
        if shuffle:
            self.rng.shuffle(order)
        elif sort_by_length:
            counts = np.asarray([self.source.frame_count(int(i)) for i in order])
            order = order[np.argsort(counts, kind="stable")]

        def _starts_u():
            return self.rng.random(batch_size)[sl] if self.sample_window else None

        def _bucket_of(idxs) -> Optional[int]:
            if self.sample_window:
                return None  # the fixed training window
            longest = min(max(self.source.frame_count(int(i)) for i in idxs),
                          self.data.max_v_timesteps)
            return self._bucket(longest)

        for start in range(0, n - batch_size + 1, batch_size):
            idxs = order[start : start + batch_size]
            yield self._collate(idxs[sl], starts_u=_starts_u(), bucket=_bucket_of(idxs))
        rem = n % batch_size
        if not drop_last and rem:
            idxs = np.concatenate([order[n - rem :], np.resize(order, batch_size - rem)])
            local_valid = int((np.arange(batch_size)[sl] < rem).sum())  # as GridDataset's
            yield self._collate(idxs[sl], n_valid=local_valid, starts_u=_starts_u(),
                                bucket=_bucket_of(idxs))

    def _collate(
        self,
        idxs,
        n_valid: Optional[int] = None,
        starts_u: Optional[np.ndarray] = None,
        bucket: Optional[int] = None,
    ) -> dict:
        """Host half, faithful to the reference per-item chain
        (vid_aud_lrs2.py:150-201): the FULL clip is peak-normalised (the
        returned waveform too: the LRS datasets normalise ``audio`` in
        place, :152), pre-emphasised, clamped, and the window is cut out of
        the full-clip mel/spec; ``mel_len`` carries ``num_a_frames``.  A
        clip shorter than the window is padded: its frames with zeros, its
        lip centres by repeating the last one.

        ``starts_u``: per-item uniforms mapped to window starts, as in
        ``GridDataset._collate``; epoch() draws one row a batch."""
        mel_per = self.audio.mel_per_video_frame
        hop = self.audio.hop_length
        n_fft = self.audio.n_fft
        clips = self._fetch_all(idxs)
        if self.sample_window and starts_u is None:
            starts_u = self.rng.random(len(idxs))

        if self.sample_window:
            w = self.data.window_size
        elif bucket is not None:
            w = bucket
        else:
            w = self._bucket(min(max(v.shape[0] for v, *_ in clips), self.data.max_v_timesteps))
        seg_frames = w * mel_per + 1

        videos, wavs, segs, centers, vid_lens, mel_lens = [], [], [], [], [], []
        centers_m, vid_hw = [], []
        for j, (video, audio, coords, normed, cond, cm, hw) in enumerate(clips):
            t = min(video.shape[0], coords.shape[0])
            video, coords = video[:t], coords[:t]
            if self.sample_window:
                n_starts = max(t - w, 0) + 1
                st = min(int(starts_u[j] * n_starts), n_starts - 1)
            else:
                st = 0
            video = video[st : st + w]
            coords = coords[st : st + w]
            if cm is not None:
                cm = cm[st : st + w]
            n = video.shape[0]
            vid_lens.append(n)
            if n < w:
                video = np.concatenate([video, np.zeros((w - n,) + video.shape[1:], video.dtype)])
                coords = np.concatenate([coords, np.repeat(coords[-1:], w - n, axis=0)])
                if cm is not None:
                    cm = np.concatenate([cm, np.repeat(cm[-1:], w - n, axis=0)])
            if cm is not None:
                centers_m.append(cm)
                vid_hw.append(hw)

            segs.append(audio_host.stft_segment(cond, st * mel_per, seg_frames, n_fft, hop))
            full = audio_host.full_frame_count(audio.shape[0], hop)
            mel_lens.append(max(min(full - st * mel_per, w * mel_per), 0))

            a0 = st * mel_per * hop
            wav = normed[a0 : a0 + w * mel_per * hop]
            need = w * mel_per * hop
            if wav.shape[0] < need:
                wav = np.concatenate([wav, np.zeros(need - wav.shape[0], np.float32)])
            videos.append(video)
            wavs.append(wav.astype(np.float32))
            centers.append(coords)
        raw = {
            "video_raw": np.stack(videos),
            "centers": np.stack(centers),
            "aud_cond": np.stack(segs),
            "wav": np.stack(wavs),
            "vid_len": np.asarray(vid_lens, np.int32),
            "mel_len": np.asarray(mel_lens, np.int32),
            "n_valid": np.int32(len(idxs) if n_valid is None else n_valid),
            # the clips' ids: names stay right under sort_by_length and shuffles
            "idx": np.asarray(idxs, np.int32),
        }
        if centers_m:
            raw["centers_m"] = np.stack(centers_m)
            raw["vid_hw"] = np.asarray(vid_hw, np.int32)
        return raw


def make_lrs_dataset(
    config_data: DataConfig,
    config_audio: AudioConfig,
    mode: str,
    splits_dir: str = "./data",
    seed: int = 0,
    workers: int = 0,
) -> LRSDataset:
    """The corpus's clips where its split and crop tables list any, else
    ``data.synthetic_clips`` synthetic clips, with a warning that names the
    root.  (The JAX Trainer falls back to 8 synthetic clips,
    ``vcagan/train/loop.py:137``, fewer than the recipe's batch of 16.)"""
    source = None
    try:
        source = LRSClipSource(config_data, mode, splits_dir)
        if len(source) == 0:
            source = None
    except (FileNotFoundError, OSError):
        source = None
    if source is None:
        warnings.warn(
            f"{config_data.dataset} corpus not found under {config_data.data_root} ({mode} "
            f"split and crop tables of {splits_dir}): {mode} runs on "
            f"{config_data.synthetic_clips} synthetic clips",
            stacklevel=2,
        )
        source = SyntheticLRSSource(num_clips=config_data.synthetic_clips)
    return LRSDataset(source, config_audio, config_data, mode, seed, workers)


class LRSDraws(NamedTuple):
    """Per clip: the crop's jitter (B,) int64 in [-5, 5] and a flip (B,) bool."""

    jitter: torch.Tensor
    flip: torch.Tensor


def lrs_augment_draws(batch: int, generator: Optional[torch.Generator], device) -> LRSDraws:
    """A jitter and a flip bit for each of ``batch`` clips (drawn for the
    global batch under a data-parallel layout, ``draw_rows``)."""

    def draw(n):
        jitter = torch.randint(-JITTER, JITTER + 1, (n,), generator=generator, device=device)
        flip = torch.rand(n, generator=generator, device=device) < 0.5
        return LRSDraws(jitter, flip)

    return draw_rows(draw, batch)


def make_lrs_device_pipeline(audio_config: AudioConfig, augment: bool = False, device=None):
    """Returns ``process(raw, generator=None, draws=None) -> Batch`` on
    ``device`` (CUDA unless ``device="cpu"``): the dynamic lip crops and the
    LRS spec chain over the host-conditioned full-clip audio
    (``vcagan/data/lrs.py:547-606``).

    ``raw`` is an ``LRSDataset`` batch, as numpy arrays or tensors; one
    made with ``DataConfig.host_crop`` holds 96^2 supersets with
    ``centers_m`` and ``vid_hw``, and is cropped as such.
    With ``augment`` each clip's jitter and flip come from ``draws``
    (``LRSDraws``) or, where none are given, from ``generator``.  A call is
    traced as the span ``train.input`` (``vcagan_torch.tracing``)."""
    dev = resolve_device(device)
    pipe = MelPipeline(audio_config)

    def as_tensor(x):
        return torch.as_tensor(x, device=dev)

    def process(raw: dict, generator: Optional[torch.Generator] = None,
                draws: Optional[LRSDraws] = None) -> Batch:
        with span("train.input"):
            video_raw, centers = as_tensor(raw["video_raw"]), as_tensor(raw["centers"])
            b, w = video_raw.shape[:2]
            if augment and draws is None:
                draws = lrs_augment_draws(b, generator, dev)
            jitter = draws.jitter if augment else torch.zeros(b, dtype=torch.long, device=dev)
            if "centers_m" in raw:
                video = crop_resize_dynamic_sup(video_raw, centers, as_tensor(raw["centers_m"]),
                                                as_tensor(raw["vid_hw"]), jitter)
            else:
                video = crop_resize_dynamic(video_raw, centers, jitter)
            if augment:
                video = torch.where(draws.flip[:, None, None, None, None], video.flip(3), video)

            mag, _ = stft_magnitude(as_tensor(raw["aud_cond"]), pipe.stft_params, center=False)
            n_mel = w * audio_config.mel_per_video_frame
            mel = mel_normalize(pipe.compress_mel(mag)[:, :n_mel])
            mel_len = as_tensor(raw["mel_len"])
            valid = torch.arange(n_mel, device=dev)[None, :] < mel_len[:, None]
            spec = lrs_normalize_spec(mag[:, :n_mel], valid)
            # pad with the reference's -1.0 (vid_aud_lrs2.py:181-182)
            pad = ~valid[:, :, None]
            return Batch(
                video=video,
                mel=mel.masked_fill(pad, -1.0).transpose(1, 2),  # (B, 80, 4W)
                spec=spec.masked_fill(pad, -1.0).transpose(1, 2),  # (B, 321, 4W)
                vid_len=as_tensor(raw["vid_len"]),
                mel_len=mel_len,
            )

    return process
