"""GRID split-list resolution.

A copy of ``grid_file_list`` from ``vcagan/data/splits.py``: the
reference's file-list semantics (reference: vid_aud_grid.py:40-92) against
the same plain-text split files, whose location is configurable (the
reference hardcodes ``./data``).  The LRS lists come with LRS training.
"""

from __future__ import annotations

import os
from typing import List


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
