"""The card's peak allocated memory over set-up and the serving window
(torch.cuda.max_memory_allocated), in GB."""


def read(data):
    peak = data.get("counters", {}).get("memory_peak_bytes")
    return peak / 1e9 if peak else None
