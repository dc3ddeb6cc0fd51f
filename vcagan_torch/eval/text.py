"""Character vocab, greedy CTC-style decoding, and WER/CER (a copy of the
jax-free ``vcagan/eval/text.py``).

The reference ASR decode path (ASR_model/GRID/test.py:160-193): greedy
argmax per step, collapse of repeated characters, blank removal,
edit-distance WER/CER.  The reference's editdistance dependency is replaced
by a native Levenshtein.  ``greedy_decode_batch`` takes logits on the host
(a numpy array: pass ``.cpu().numpy()``).
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

# ['_',' ','A'..'Z'] (reference vid_aud_GRID_test.py:20-21); '_' is blank
GRID_VOCAB = ["_", " "] + [chr(c) for c in range(ord("A"), ord("Z") + 1)]
INT2CHAR = {i: c for i, c in enumerate(GRID_VOCAB)}
CHAR2INT = {c: i for i, c in enumerate(GRID_VOCAB)}


def encode_text(text: str) -> List[int]:
    return [CHAR2INT[c] for c in text.upper() if c in CHAR2INT]


def tokens_to_text(tokens: Sequence[int]) -> str:
    return "".join(INT2CHAR[int(t)] for t in tokens)


def collapse_prediction(raw: str) -> str:
    """Squeeze runs: multi-space -> one, repeated chars -> one, drop blanks
    (reference test.py:166-173)."""
    out = re.sub(" +", " ", raw)
    out = re.compile(r"(.)\1{1,}", re.DOTALL).sub(r"\1", out)
    return out.replace("_", "")


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance over arbitrary token sequences."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def wer_cer(label: str, prediction: str) -> Tuple[float, float]:
    """(WER, CER) for a label/greedy-prediction pair, with the reference's
    repeat-collapse applied to the prediction."""
    label = label.replace("_", "")
    pred = collapse_prediction(prediction)
    cer = levenshtein(pred, label) / max(len(label), 1)
    wer = levenshtein(pred.split(" "), label.split(" ")) / max(
        len(label.split(" ")), 1
    )
    return wer, cer


def greedy_decode_batch(
    logits, labels: Sequence[str]
) -> Tuple[float, float, List[Tuple[str, str]]]:
    """logits: (B, S, vocab) array -> mean (WER, CER, [(label, pred)])."""
    import numpy as np

    tokens = np.argmax(np.asarray(logits), axis=-1)  # (B, S)
    wers, cers, pairs = [], [], []
    for b in range(tokens.shape[0]):
        raw = tokens_to_text(tokens[b])
        w, c = wer_cer(labels[b], raw)
        wers.append(w)
        cers.append(c)
        pairs.append((labels[b], collapse_prediction(raw)))
    return float(np.mean(wers)), float(np.mean(cers)), pairs
