"""Synthetic lip-speech fixtures: procedurally coupled video + audio.

A copy of ``vcagan/data/synthetic.py``, the source that the GRID loader
falls back to when the corpus is absent: a moving "mouth" ellipse whose
aperture follows the amplitude envelope of a synthetic glottal-pulse audio
signal, so the whole chain (decode -> window -> transform -> mel -> GAN
step -> vocode -> metrics) runs end to end.  Its clips are byte-identical
to the JAX package's; the frames are drawn all at once instead of one by
one.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLipSpeech:
    """Deterministic synthetic (video, audio) clip source."""

    num_clips: int = 8
    video_frames: int = 75
    fps: int = 25
    sample_rate: int = 16_000
    height: int = 256
    width: int = 256
    # clips are deterministic in idx, so they are memoized (~14 MB per
    # 75-frame clip)
    cache: bool = True
    _cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def __len__(self) -> int:
        return self.num_clips

    def clip(self, idx: int):
        """Returns (video uint8 (T, H, W, 3), audio float32 (L,))."""
        if self.cache and idx in self._cache:
            return self._cache[idx]
        out = self._render(idx)
        if self.cache:
            self._cache[idx] = out
        return out

    def _render(self, idx: int):
        rng = np.random.default_rng(1000 + idx)
        t_frames = self.video_frames
        n_samples = t_frames * self.sample_rate // self.fps

        # audio: vowel-like glottal pulses with per-clip f0 and a slow
        # amplitude envelope (2-4 "words")
        f0 = 90.0 + 60.0 * rng.random()
        t = np.arange(n_samples) / self.sample_rate
        n_words = rng.integers(2, 5)
        env = np.zeros(n_samples, np.float32)
        for w in range(n_words):
            c = (w + 0.5 + 0.3 * rng.standard_normal()) / n_words
            width = 0.08 + 0.08 * rng.random()
            env += np.exp(-0.5 * ((t / t[-1] - c) / width) ** 2)
        env = env / max(env.max(), 1e-6)
        carrier = np.zeros(n_samples, np.float32)
        for harm in range(1, 7):
            carrier += np.sin(2 * np.pi * f0 * harm * t) / harm
        audio = (env * carrier * 0.4).astype(np.float32)
        audio += 0.005 * rng.standard_normal(n_samples).astype(np.float32)

        # video: face-like blob with a mouth ellipse opening with the
        # envelope.  The ellipse's test is a per-frame row term plus a fixed
        # column term, each computed as the one-frame-at-a-time original
        # computes it, so every frame is drawn at once with the same bytes.
        frame_env = env[:: n_samples // t_frames][:t_frames]
        yy, xx = np.mgrid[0 : self.height, 0 : self.width]
        cy, cx = self.height * 0.45, self.width * 0.5
        face = np.exp(
            -(((yy - cy) / (self.height * 0.35)) ** 2 + ((xx - cx) / (self.width * 0.28)) ** 2)
        )
        mouth_cy, mouth_cx = self.height * 0.68, self.width * 0.5
        aperture = 4.0 + 14.0 * frame_env  # (T,)
        rows = ((yy[:, :1][None] - mouth_cy) / aperture[:, None, None]) ** 2  # (T, H, 1)
        cols = ((xx[:1] - mouth_cx) / (self.width * 0.09)) ** 2  # (1, W)
        mouth = (rows + cols[None]) < 1.0  # (T, H, W)
        frame = (120 * face).astype(np.uint8)
        video = np.where(mouth, np.uint8(30), frame[None]).astype(np.uint8)
        return np.repeat(video[..., None], 3, axis=-1), audio
