"""The visual front's mean device ms a batch: CUDA events around the
synthesizer's ``v_front`` call, over the batches of the traced window's last stretch."""


def read(data):
    ms = data.get("spans", {}).get("v_front")
    return sum(ms) / len(ms) if ms else None
