"""The vocoder's mean device ms a batch: CUDA events around
``MelPipeline.inverse_spec`` (Griffin-Lim, de-emphasis), over the batches of the traced window's last stretch."""


def read(data):
    ms = data.get("spans", {}).get("vocoder")
    return sum(ms) / len(ms) if ms else None
