"""Command-line entry points of the port, each ``python -m
vcagan_torch.cli.<name>`` with the argv of ``python -m vcagan.cli.<name>``:
training (``train``, ``train_lrs``), evaluation (``test``, ``test_lrs``),
the ASR scorers (``asr_grid``, ``asr_lrw``) and preprocessing
(``extract_frames``, ``preprocess_grid``, ``extract_audio_lrs``)."""

__all__ = ["asr_grid", "asr_lrw", "extract_audio_lrs", "extract_frames", "preprocess_grid",
           "test", "test_lrs", "train", "train_lrs"]
