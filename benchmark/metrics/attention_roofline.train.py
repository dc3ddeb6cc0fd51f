"""The attention's share of its roofline on the train step's forward
call, as ``attention_roofline.serve`` reads it, in %."""


def read(data):
    least = data.get("counters", {}).get("attention.least_s")
    ms = data.get("spans", {}).get("attention")
    if not least or not ms:
        return None
    return 100.0 * least / (sum(ms) / 1e3)
