"""The G phase, mean ms a step: from the "d_update" mark to
"g_update" (G losses, the G backward, the G update)."""


def read(data):
    ms = data.get("spans", {}).get("g_phase")
    return sum(ms) / len(ms) if ms else None
