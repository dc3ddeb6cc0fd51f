"""The D phase, mean ms a step: from the "gen_forward" mark to
"d_update" (discriminators, losses, R1's double backward, the D update)."""


def read(data):
    ms = data.get("spans", {}).get("d_phase")
    return sum(ms) / len(ms) if ms else None
