"""The share of a steady sub-window of the serving loop in which no
operation ran on the card (torch.profiler; no spans in it), in %."""


def read(data):
    tr = data.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
