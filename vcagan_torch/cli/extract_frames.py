"""GRID frame/audio extraction CLI — counterpart of
preprocess/Extract_frames.py (reference: Extract_frames.py:13-27).

Per .mpg: decode 25-fps frames to PNG and a mono 16 kHz wav.  Frames decode
through OpenCV natively; audio demux uses ffmpeg when available (the only
audio path out of an MPEG container in this toolchain) and is skipped with
a warning otherwise.  Resumable: directories that already hold >= 75 PNGs
are skipped, like the reference.

A copy of the jax-free ``vcagan/cli/extract_frames.py`` with the same argv:
``python -m vcagan_torch.cli.extract_frames``.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--grid", default="GRID_dir", help="root with <sub>/*.mpg")
    p.add_argument("--out", default=None, help="output root (default: in place)")
    p.add_argument("--jobs", type=int, default=3)
    p.add_argument("--min_frames", type=int, default=75)
    return p.parse_args(argv)


def extract_one(mpg: str, out_root: str, min_frames: int) -> str:
    import cv2

    rel = os.path.splitext(os.path.relpath(mpg, os.path.dirname(os.path.dirname(mpg))))[0]
    frame_dir = os.path.join(out_root, rel)
    os.makedirs(frame_dir, exist_ok=True)
    if len(glob.glob(os.path.join(frame_dir, "*.png"))) >= min_frames:
        return f"skip {rel}"

    cap = cv2.VideoCapture(mpg)
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        idx += 1
        cv2.imwrite(os.path.join(frame_dir, f"{idx:02d}.png"), frame)
    cap.release()

    wav_path = os.path.join(frame_dir, "audio.wav")
    if shutil.which("ffmpeg"):
        subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "error", "-i", mpg,
             "-ac", "1", "-ar", "16000", wav_path],
            check=False,
        )
    else:
        print(f"[warn] ffmpeg unavailable; no audio extracted for {rel}")
    return f"done {rel} ({idx} frames)"


def main(argv=None):
    args = parse_args(argv)
    out_root = args.out or args.grid
    mpgs = sorted(glob.glob(os.path.join(args.grid, "*", "*.mpg")))
    if not mpgs:
        print(f"no .mpg files under {args.grid}")
        return
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        for msg in pool.map(
            lambda m: extract_one(m, out_root, args.min_frames), mpgs
        ):
            print(msg)


if __name__ == "__main__":
    main()
