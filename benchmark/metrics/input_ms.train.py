"""The device input pipeline's mean ms a step: CUDA events around its
call, over the steps of the traced window's last stretch."""


def read(data):
    ms = data.get("spans", {}).get("input")
    return sum(ms) / len(ms) if ms else None
