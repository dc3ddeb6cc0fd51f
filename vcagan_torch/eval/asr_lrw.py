"""LRW word-classification accuracy of generated artifacts.

Port of ``vcagan/eval/asr_lrw.py`` (reference ASR_model/LRW/test.py +
src/data/vid_aud_lrw_test.py): globs ``<class>/<split>/<class>_<n>.npz``
(or wav), the label is the filename's word prefix, clips are 29 video
frames (116 mel frames), 500-way classification; reports ACC and
WER = 1 - ACC.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from vcagan_torch.configs import AudioConfig
from vcagan_torch.dsp import MelPipeline
from vcagan_torch.eval.asr_grid import load_mel_from_npz, mel_from_wav, pad_or_crop
from vcagan_torch.eval.asr_models import ASRModel

LRW_MEL_FRAMES = 116  # 29 video frames x 4 (reference vid_aud_lrw_test.py:76)


def load_class_list(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip().upper() for line in f if line.strip()]


def evaluate(
    data_dir: str,
    class_list: List[str],
    model: ASRModel,
    wav: bool = False,
    batch_size: int = 32,
    audio_config: Optional[AudioConfig] = None,
) -> Tuple[float, float]:
    """Returns (accuracy, wer = 1 - accuracy); ``model`` an
    ``LRWClassifier`` over ``class_list`` (``load_asr("lrw", ...)``)."""
    word2int = {w: i for i, w in enumerate(class_list)}
    pipeline = MelPipeline(audio_config or AudioConfig())
    device = next(model.parameters()).device

    ext = "*.wav" if wav else "*.npz"
    files = sorted(glob.glob(os.path.join(data_dir, "*", "*", ext)))
    if not files:
        raise FileNotFoundError(f"no generated artifacts under {data_dir}")

    correct, total = 0, 0
    for start in range(0, len(files), batch_size):
        chunk = files[start : start + batch_size]
        mels, targets = [], []
        for path in chunk:
            word = os.path.split(path)[-1].split("_")[0].upper()
            targets.append(word2int[word])
            if wav:
                mel, _ = pad_or_crop(mel_from_wav(path, pipeline), LRW_MEL_FRAMES)
            else:
                mel, _ = load_mel_from_npz(path, LRW_MEL_FRAMES)
            mels.append(mel)
        logits = model(torch.from_numpy(np.stack(mels)).to(device))
        preds = logits.argmax(dim=-1).cpu().numpy()
        correct += int((preds == np.asarray(targets)).sum())
        total += len(chunk)
    acc = correct / max(total, 1)
    return acc, 1.0 - acc
