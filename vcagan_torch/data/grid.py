"""GRID dataset: host-side decode and windowing, raw batches for the
device-side input pipeline.

A copy of ``vcagan/data/grid.py`` (less its multi-host slicing), which
replaces the reference's torch ``MultiDataset`` + DataLoader worker pool
(reference: vid_aud_grid.py:24-170) with a thin host loader:

- decode: cv2 video frames + wav audio (the preprocessing emits 16 kHz wav
  next to each clip); ``cv2`` is imported only when a clip is decoded
- per-clip python work is file IO, the full-clip audio conditioning and
  window selection; the transform (resize/flip/normalise/erase) and the
  mel pipeline run batched on the device (``vcagan_torch.data
  .device_pipeline``)
- one numpy rng draws the shuffle and then one row of window starts per
  batch, so a seed gives the JAX package's raw batches byte for byte

When the real corpus is absent, ``SyntheticLipSpeech``
(``vcagan_torch.data.synthetic``) provides structurally identical clips.
"""

from __future__ import annotations

import os
import warnings
from typing import Iterator, List, Optional, Tuple

import numpy as np

from vcagan_torch.configs import AudioConfig, DataConfig
from vcagan_torch.data import audio_host
from vcagan_torch.data.splits import grid_file_list
from vcagan_torch.data.synthetic import SyntheticLipSpeech
from vcagan_torch.data.transforms import host_luma_u8, host_resize_u8


def decode_video(path: str) -> np.ndarray:
    """mp4/mpg -> (T, H, W, 3) uint8 via OpenCV."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames)


def load_audio(path: str, sample_rate: int = 16_000) -> np.ndarray:
    """wav -> float32 mono in [-1, 1].  (The reference loads flac via
    librosa; this framework's preprocessing emits wav.)"""
    import scipy.io.wavfile as wavfile

    sr, data = wavfile.read(path)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    if sr != sample_rate:
        from scipy.signal import resample_poly
        from math import gcd

        g = gcd(sr, sample_rate)
        data = resample_poly(data, sample_rate // g, sr // g).astype(np.float32)
    return data


def audio_path_for(video_path: str) -> str:
    """<...>/video/<f>.mp4 -> <...>/audio/<f>.wav (reference swaps
    'video'->'audio' and .mp4->.flac, vid_aud_grid.py:130)."""
    base = video_path.replace("/video/", "/audio/")
    return os.path.splitext(base)[0] + ".wav"


class GridClipSource:
    """Real-corpus clip source with the reference's split semantics."""

    def __init__(self, config: DataConfig, mode: str, splits_dir: str = "./data"):
        self.config = config
        self.mode = mode
        self.files = grid_file_list(
            config.data_root, mode, config.subject, splits_dir
        )

    def __len__(self) -> int:
        return len(self.files)

    def clip(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        path = self.files[idx]
        video = decode_video(path)
        audio = load_audio(audio_path_for(path))
        return video, audio

    def name(self, idx: int) -> str:
        return os.path.splitext(
            os.path.relpath(self.files[idx], self.config.data_root)
        )[0]


class GridDataset:
    """Batched iterator producing model-ready numpy arrays.

    The device-side half (transform + mel) lives in
    ``vcagan_torch.data.device_pipeline``; this class handles file lists,
    shuffling, window sampling, and padding to static shapes.
    """

    def __init__(
        self,
        source,
        audio_config: Optional[AudioConfig] = None,
        data_config: Optional[DataConfig] = None,
        mode: str = "train",
        seed: int = 0,
        workers: int = 0,
    ):
        self.source = source
        self.audio = audio_config or AudioConfig()
        self.data = data_config or DataConfig()
        self.mode = mode
        self.sample_window = mode == "train"
        self.rng = np.random.default_rng(seed)
        self.max_frames = (
            self.data.window_size if self.sample_window else self.data.max_v_timesteps
        )
        # cv2 decode and scipy lfilter release the GIL, so a thread pool
        # genuinely parallelizes the per-clip fetch (the reference uses
        # 6-10 DataLoader worker processes, train.py:139-146)
        self._pool = None
        if workers and workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=workers)

    def close(self) -> None:
        """Shut down the decode worker pool (idempotent).  Long-lived
        callers (Trainer) cache datasets instead of rebuilding them per
        validation, but anything ephemeral should close explicitly."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):  # best-effort backstop for ephemeral datasets
        try:
            self.close()
        except Exception:
            pass

    def _fetch(self, idx: int):
        """Decode + full-clip conditioning for one clip (the parallelizable
        part; window sampling stays on the epoch thread so rng draws are
        identical with any worker count)."""
        video, audio = self.source.clip(int(idx))
        if self.data.host_crop:
            # cut the static crop box out of the raw uint8 frames here so
            # only the 136x136 region crosses the host->device link (the
            # device pipeline skips its crop, transforms.prepare_clips
            # crop_box=None); slice-then-resize is bit-identical to the
            # reference's crop-then-resize (vid_aud_grid.py:99)
            x0, y0, x1, y1 = self.data.grid_crop_box
            video = video[:, y0:y1, x0:x1]
        if self.data.host_gray and video.shape[-1] == 3:
            video = host_luma_u8(video)
        cond = audio_host.condition_clip(audio, self.audio.preemphasis)
        return video, audio, cond

    def _fetch_all(self, idxs):
        if self._pool is not None:
            return list(self._pool.map(self._fetch, idxs))
        return [self._fetch(i) for i in idxs]

    def __len__(self) -> int:
        return len(self.source)

    def epoch(
        self,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        process_slice: Optional[slice] = None,
    ) -> Iterator[dict]:
        """Yield raw (host-side) batches; the caller feeds them through the
        device pipeline.

        ``drop_last=False`` pads the tail partial batch by wrapping earlier
        samples and marks the real count in ``batch["n_valid"]`` — eval
        drivers use this so every sample is scored (the reference's
        DataLoader never drops, train.py:139-146).  With ``drop_last=True``
        (training), a dataset smaller than the batch is a loud error, not a
        silent zero-step epoch.

        ``process_slice`` (data-parallel ranks, ``vcagan/data/grid.py:183-230``):
        ``batch_size`` is the GLOBAL batch, and this rank decodes and
        yields only its slice of each batch.  Every rank seeds the same
        rng, and the shuffle and the window-start draws are made for the
        whole global batch before slicing, so the ranks' slices
        concatenate to the single-process batch.
        """
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

        def _starts_u():
            return self.rng.random(batch_size)[sl] if self.sample_window else None

        for start in range(0, n - batch_size + 1, batch_size):
            yield self._collate(order[start : start + batch_size][sl], starts_u=_starts_u())
        rem = n % batch_size
        if not drop_last and rem:
            idxs = np.concatenate(
                [order[n - rem :], np.resize(order, batch_size - rem)]
            )
            # the real clips hold global positions [0, rem): a slice of
            # padding only counts 0
            local_valid = int((np.arange(batch_size)[sl] < rem).sum())
            yield self._collate(idxs[sl], n_valid=local_valid, starts_u=_starts_u())

    def _collate(
        self,
        idxs: List[int],
        n_valid: Optional[int] = None,
        starts_u: Optional[np.ndarray] = None,
    ) -> dict:
        """Host half of the input pipeline, numerically faithful to the
        reference per-item chain (vid_aud_grid.py:126-170):

        - condition the FULL clip (peak-norm x0.9, lfilter pre-emphasis,
          clamp) — NOT the window (vid_aud_grid.py:142-144)
        - slice the reflect-padded conditioned clip so device framing
          reproduces the full-clip centered STFT frames of the window
        - return the RAW window audio as the metric ground truth
          (extract_window receives the unconditioned ``audio`` tensor,
          vid_aud_grid.py:152,164)
        - ``mel_len`` carries the reference's ``num_a_frames``: the count
          of real mel frames in the window (vid_aud_grid.py:159)

        ``starts_u``: per-item uniforms in [0, 1) mapped to the window
        start (``st = floor(u * (t - w + 1))``, uniform over the valid
        range).  epoch() draws one row per batch; a direct _collate call
        draws them from self.rng.
        """
        w = self.max_frames
        mel_per = self.audio.mel_per_video_frame
        hop = self.audio.hop_length
        n_fft = self.audio.n_fft
        seg_frames = w * mel_per + 1  # device drops the extra centered frame
        if self.sample_window and starts_u is None:
            starts_u = self.rng.random(len(idxs))
        videos, wavs, segs, vid_lens, mel_lens = [], [], [], [], []
        for j, (video, audio, cond) in enumerate(self._fetch_all(idxs)):
            t = video.shape[0]
            if self.sample_window:
                n_starts = max(t - w, 0) + 1
                st = min(int(starts_u[j] * n_starts), n_starts - 1)
            else:
                st = 0
            video = video[st : st + w]
            if (
                self.data.host_resize
                and self.data.host_crop  # resize is only what remains
                and video.dtype == np.uint8
                and video.shape[1:3]
                != (self.data.crop_size, self.data.crop_size)
            ):
                # resize only the WINDOWED frames (w, not the full clip)
                # with the device kernel's exact weights
                video = host_resize_u8(video, self.data.crop_size)
            vid_lens.append(video.shape[0])
            if video.shape[0] < w:
                pad = np.zeros((w - video.shape[0],) + video.shape[1:], video.dtype)
                video = np.concatenate([video, pad])
            videos.append(video)

            segs.append(
                audio_host.stft_segment(
                    cond, st * mel_per, seg_frames, n_fft, hop
                )
            )
            full = audio_host.full_frame_count(audio.shape[0], hop)
            mel_lens.append(
                max(min(full - st * mel_per, w * mel_per), 0)
            )

            a0 = st * mel_per * hop
            wav = audio[a0 : a0 + w * mel_per * hop].astype(np.float32)
            need = w * mel_per * hop
            if wav.shape[0] < need:
                wav = np.concatenate([wav, np.zeros(need - wav.shape[0], np.float32)])
            wavs.append(wav)
        return {
            "video_raw": np.stack(videos),  # (B, W, H, W, 3) uint8
            "aud_cond": np.stack(segs),  # (B, W*4*160 + n_fft) float32
            "wav": np.stack(wavs),  # (B, W*4*160) float32, raw
            "vid_len": np.asarray(vid_lens, np.int32),
            "mel_len": np.asarray(mel_lens, np.int32),
            "n_valid": np.int32(len(idxs) if n_valid is None else n_valid),
        }


def make_grid_dataset(
    config_data: DataConfig,
    config_audio: AudioConfig,
    mode: str,
    splits_dir: str = "./data",
    seed: int = 0,
    workers: int = 0,
) -> GridDataset:
    """Real corpus if present, synthetic fixtures otherwise (with a
    warning that names the root, so a mistyped ``--grid`` shows)."""
    use_synthetic = False
    try:
        source = GridClipSource(config_data, mode, splits_dir)
        # The split lists ship with the repo, so they resolve even when the
        # corpus itself is absent — verify the first clip is on disk.
        if len(source) == 0 or not os.path.exists(source.files[0]):
            use_synthetic = True
    except (FileNotFoundError, OSError):
        use_synthetic = True
    if use_synthetic:
        warnings.warn(
            f"GRID corpus not found under {config_data.data_root} ({mode} split of "
            f"{splits_dir}): {mode} runs on {config_data.synthetic_clips} synthetic clips",
            stacklevel=2,
        )
        # data.synthetic_clips (64 by default) clips, memoized (~14 MB
        # each); a recipe needs at least batch_size of them for an epoch
        source = SyntheticLipSpeech(num_clips=config_data.synthetic_clips)
    return GridDataset(source, config_audio, config_data, mode, seed, workers)
