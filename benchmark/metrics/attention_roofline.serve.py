"""The attention's share of its roofline: the least time of q k^T,
softmax and v at each call's shapes (masked keys not counted; inputs read
and outputs written once at 3.35 TB/s, products at 495/3 TFLOP/s), over
the calls' time by CUDA events, in %."""


def read(data):
    least = data.get("counters", {}).get("attention.least_s")
    ms = data.get("spans", {}).get("attention")
    if not least or not ms:
        return None
    return 100.0 * least / (sum(ms) / 1e3)
