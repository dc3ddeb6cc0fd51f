"""GRID face alignment + audio conditioning CLI — counterpart of
preprocess/Preprocess.py (reference: Preprocess.py:91-133).

Per clip: load 98-point facial landmarks, estimate a similarity transform
to the reference face template (Umeyama closed form, replacing skimage's
SimilarityTransform.estimate), warp every frame, write an aligned 256^2 mp4
plus a 55 Hz high-pass-filtered 16 kHz wav (7th-order Butterworth filtfilt,
reference Preprocess.py:109-114).

A copy of the jax-free ``vcagan/cli/preprocess_grid.py`` with the same argv:
``python -m vcagan_torch.cli.preprocess_grid``.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform (2x3) mapping src -> dst points."""
    src_mean = src.mean(0)
    dst_mean = dst.mean(0)
    src_c = src - src_mean
    dst_c = dst - dst_mean
    cov = dst_c.T @ src_c / len(src)
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u @ vt))
    diag = np.diag([1.0, d])
    scale = np.trace(np.diag(s) @ diag) / (src_c ** 2).sum() * len(src)
    rot = u @ diag @ vt
    m = scale * rot
    t = dst_mean - m @ src_mean
    return np.concatenate([m, t[:, None]], axis=1)


def highpass_audio(wav: np.ndarray, sr: int = 16_000, fc: float = 55.0) -> np.ndarray:
    from scipy import signal

    b, a = signal.butter(7, fc / (sr / 2), "high")
    return signal.filtfilt(b, a, wav).astype(np.float32)


def align_clip(
    frames: np.ndarray,
    landmarks: np.ndarray,
    ref_landmarks: np.ndarray,
    out_size: int = 256,
) -> np.ndarray:
    """frames (T, H, W, 3) + landmarks (T, 98, 2) -> aligned (T, 256, 256, 3)."""
    import cv2

    assert frames.shape[0] == landmarks.shape[0], "landmark/frame count mismatch"
    out = np.zeros((frames.shape[0], out_size, out_size, 3), frames.dtype)
    for i in range(frames.shape[0]):
        m = umeyama_similarity(landmarks[i].astype(np.float64), ref_landmarks)
        out[i] = cv2.warpAffine(frames[i], m, (out_size, out_size))
    return out


def default_ref_face() -> str:
    """The vendored landmark template (byte-identical copy of the
    reference's preprocess/Ref_face.txt), resolved repo-relative."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(os.path.join(here, "..", "..", "data", "Ref_face.txt"))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--grid", default="GRID_dir", help="root with extracted frames")
    p.add_argument("--landmarks", required=False, default=None,
                   help="root with per-clip 98-pt landmark .npy/.txt files")
    p.add_argument("--ref_face", required=False, default=default_ref_face(),
                   help="reference face template (vendored Ref_face.txt, or a "
                        "plain 98 x,y table)")
    p.add_argument("--out", default=None)
    p.add_argument("--jobs", type=int, default=3)
    return p.parse_args(argv)


def load_ref_face(path: str) -> np.ndarray:
    """Load the 98-pt reference landmarks.

    Two formats are accepted:
    - the reference's packed track file (``Ref_face.txt``): one line of
      ``name:x y,x y,...|x y,...`` frames; frame index 6 of the first line
      is the template (reference Preprocess.py:38-49)
    - a plain whitespace table of 98 "x y" rows (np.loadtxt-able)
    """
    with open(path) as f:
        first = f.readline()
    if "|" in first or ":" in first:
        frame = first.split(":")[-1].split("|")[6]
        pts = [[float(v) for v in p.split()] for p in frame.split(",")]
        return np.asarray(pts, dtype=float)
    pts = np.loadtxt(path)
    return pts.reshape(-1, 2)


def process_clip(clip_dir: str, args, ref) -> str:
    import cv2

    from vcagan_torch.data.grid import load_audio
    from vcagan_torch.io.wav import write_wav

    pngs = sorted(glob.glob(os.path.join(clip_dir, "*.png")))
    if not pngs:
        return f"skip {clip_dir} (no frames)"
    rel = os.path.relpath(clip_dir, args.grid)
    lm_path = os.path.join(args.landmarks, rel + ".npy")
    if not os.path.exists(lm_path):
        return f"skip {rel} (no landmarks)"
    landmarks = np.load(lm_path)
    frames = np.stack([cv2.imread(p)[:, :, ::-1] for p in pngs])
    aligned = align_clip(frames, landmarks, ref)

    out_root = args.out or args.grid
    vid_dir = os.path.join(out_root, os.path.dirname(rel), "video")
    aud_dir = os.path.join(out_root, os.path.dirname(rel), "audio")
    os.makedirs(vid_dir, exist_ok=True)
    os.makedirs(aud_dir, exist_ok=True)
    name = os.path.basename(rel)

    writer = cv2.VideoWriter(
        os.path.join(vid_dir, name + ".mp4"),
        cv2.VideoWriter_fourcc(*"mp4v"),
        25,
        (aligned.shape[2], aligned.shape[1]),
    )
    for frame in aligned:
        writer.write(frame[:, :, ::-1])
    writer.release()

    wav_path = os.path.join(clip_dir, "audio.wav")
    if os.path.exists(wav_path):
        wav = load_audio(wav_path)
        write_wav(os.path.join(aud_dir, name + ".wav"), highpass_audio(wav))
    return f"done {rel}"


def main(argv=None):
    from concurrent.futures import ThreadPoolExecutor

    args = parse_args(argv)
    if args.landmarks is None:
        print("need --landmarks root")
        return
    if not os.path.exists(args.ref_face):
        print(f"ref_face template not found: {args.ref_face}")
        return
    ref = load_ref_face(args.ref_face)
    clip_dirs = sorted(
        {os.path.dirname(p) for p in glob.glob(os.path.join(args.grid, "*", "*", "*.png"))}
    )
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        for msg in pool.map(lambda c: process_clip(c, args, ref), clip_dirs):
            print(msg)


if __name__ == "__main__":
    main()
