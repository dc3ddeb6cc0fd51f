"""GRID and LRS split-list resolution.

A copy of ``vcagan/data/splits.py``: the reference's file-list semantics
(reference: vid_aud_grid.py:40-92, vid_aud_lrs2.py:40-85,
vid_aud_lrs3.py:27-85) against the same plain-text split files, whose
location is configurable (the reference hardcodes ``./data``), and the
parser of the LRS per-frame lip-crop tables.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple


def grid_file_list(
    grid_root: str,
    mode: str,
    subject: str,
    splits_dir: str = "./data",
    check_exists: bool = True,
) -> List[str]:
    """GRID clip paths for (mode, subject).

    subject semantics (reference vid_aud_grid.py:40-92):
    - 'overlap': overlap_{train,val}.txt; entries 'mpg_6000/<sub>/<file>'
      become '<sub>/<file>.mp4' under grid_root (val list also serves test)
    - 'unseen': unseen_splits.txt lines '<mode>/<sub>/<fname>' ->
      '<sub>/video/<fname>.mp4', kept only if the file exists
    - 's#' or 'four': {train,val,test}_4.txt filtered by subject prefix
      ('four' keeps all four speakers)
    """
    assert mode in ("train", "val", "test")
    files: List[str] = []

    def split_path(name: str) -> str:
        return os.path.join(splits_dir, name)

    if subject == "overlap":
        name = "overlap_train.txt" if mode == "train" else "overlap_val.txt"
        with open(split_path(name)) as f:
            for line in f:
                entry = line.strip().replace("mpg_6000/", "")
                if entry:
                    files.append(os.path.join(grid_root, entry + ".mp4"))
    elif subject == "unseen":
        with open(split_path("unseen_splits.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or mode not in line:
                    continue
                _, sub, fname = line.split("/")
                path = os.path.join(grid_root, f"{sub}/video/{fname}.mp4")
                if not check_exists or os.path.exists(path):
                    files.append(path)
    else:  # 's#' single speaker or 'four'
        name = {"train": "train_4.txt", "val": "val_4.txt", "test": "test_4.txt"}[mode]
        with open(split_path(name)) as f:
            for line in f:
                entry = line.strip()
                if not entry:
                    continue
                if subject == "four" or entry.split("/")[0] == subject:
                    files.append(os.path.join(grid_root, entry))
    return files


def lrs_file_list(
    data_root: str,
    dataset: str,
    mode: str,
    splits_dir: str = "./data",
) -> List[Tuple[str, str]]:
    """LRS2/LRS3 (video_relpath, partition) pairs.

    Reference semantics: LRS2 joins split files with per-frame crop files
    under data/LRS2/LRS2_crop (vid_aud_lrs2.py:40-85); LRS3 uses the SVTS
    unseen splits data/LRS3/lrs3_unseen_{mode}.txt (vid_aud_lrs3.py:27-85).
    Returns relative paths; the dataset object joins with the corpus root
    and the crop-coordinate tables.
    """
    assert mode in ("train", "val", "test")
    entries: List[Tuple[str, str]] = []
    if dataset == "LRS3":
        split_file = os.path.join(splits_dir, "LRS3", f"lrs3_unseen_{mode}.txt")
        with open(split_file) as f:
            for line in f:
                line = line.strip()
                if line:
                    # SVTS split lines carry their crop partition as the
                    # first path component (pretrain/test/trainval),
                    # reference vid_aud_lrs3.py:70-76.
                    entries.append((line, line.split("/")[0]))
    elif dataset == "LRS2":
        name = {"train": "train.txt", "val": "val.txt", "test": "test.txt"}[mode]
        split_file = os.path.join(splits_dir, "LRS2", name)
        with open(split_file) as f:
            for line in f:
                line = line.strip().split()[0] if line.strip() else ""
                if line:
                    entries.append((line, "main"))
        if mode == "train":
            pretrain = os.path.join(splits_dir, "LRS2", "pretrain.txt")
            if os.path.exists(pretrain):
                with open(pretrain) as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            entries.append((line, "pretrain"))
    else:
        raise ValueError(f"unknown LRS dataset {dataset}")
    return entries


def load_crop_table(path: str, partition: str) -> Dict[str, List[int]]:
    """Parse a per-frame lip-crop coordinate file.

    Format (reference vid_aud_lrs2.py:45-53): one clip per line,
    ``<relpath>.mp4 x/y/x/y/...`` — alternating per-frame lip-center
    coordinates.  Keys are '<partition>/<relpath>'.
    """
    table: Dict[str, List[int]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or "." not in line:
                continue
            relpath, rest = line.split(".", 1)
            coord_str = rest[4:]  # strip 'mp4 '
            coords = [int(float(v)) for v in coord_str.split("/") if v]
            table[f"{partition}/{relpath}"] = coords
    return table
