"""The generator side's train-mode forward, mean ms a step: from the
step's start to its "gen_forward" mark (CUDA events)."""


def read(data):
    ms = data.get("spans", {}).get("gen_forward")
    return sum(ms) / len(ms) if ms else None
