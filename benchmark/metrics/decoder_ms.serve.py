"""The decoder's mean device ms a batch: CUDA events around the
synthesizer's ``gen`` call (two attentions inside), over the batches of the traced window's last stretch."""


def read(data):
    ms = data.get("spans", {}).get("decoder")
    return sum(ms) / len(ms) if ms else None
