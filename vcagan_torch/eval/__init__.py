"""Metrics and scorers: STOI/ESTOI on the device, the numpy STOI and PESQ,
and the ASR scorers of generated speech (the GRID character recognizer
with greedy decoding and WER/CER, the LRW word classifier)."""
from vcagan_torch.eval.asr_models import GridASR, LRWClassifier, load_asr
from vcagan_torch.eval.text import greedy_decode_batch, wer_cer

__all__ = ["GridASR", "LRWClassifier", "greedy_decode_batch", "load_asr", "wer_cer"]
