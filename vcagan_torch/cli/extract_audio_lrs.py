"""LRS2/LRS3 audio extraction CLI — counterpart of
preprocess/Extract_audio_LRS.py (reference: Extract_audio_LRS.py:19-31).

Per mp4: extract a mono 16 kHz wav into the mirrored *_audio tree,
parallelized, resumable (existing wavs skipped).  Requires ffmpeg for MPEG
audio demux; fails with a clear message otherwise.

A copy of the jax-free ``vcagan/cli/extract_audio_lrs.py`` with the same argv:
``python -m vcagan_torch.cli.extract_audio_lrs``.
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
    p.add_argument("--data", default="LRS_dir", help="LRS2-BBC / LRS3-TED root")
    p.add_argument("--out", default=None, help="audio tree root (default <data>_audio)")
    p.add_argument("--jobs", type=int, default=3)
    return p.parse_args(argv)


def extract_one(mp4: str, data_root: str, out_root: str) -> str:
    rel = os.path.splitext(os.path.relpath(mp4, data_root))[0]
    wav = os.path.join(out_root, rel + ".wav")
    if os.path.exists(wav):
        return f"skip {rel}"
    os.makedirs(os.path.dirname(wav), exist_ok=True)
    subprocess.run(
        ["ffmpeg", "-y", "-loglevel", "error", "-i", mp4,
         "-ac", "1", "-ar", "16000", wav],
        check=False,
    )
    return f"done {rel}"


def main(argv=None):
    args = parse_args(argv)
    if not shutil.which("ffmpeg"):
        raise SystemExit("ffmpeg is required for MPEG audio demux")
    out_root = args.out or (args.data.rstrip("/") + "_audio")
    mp4s = sorted(glob.glob(os.path.join(args.data, "**", "*.mp4"), recursive=True))
    if not mp4s:
        print(f"no mp4 files under {args.data}")
        return
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        for msg in pool.map(
            lambda m: extract_one(m, args.data, out_root), mp4s
        ):
            print(msg)


if __name__ == "__main__":
    main()
