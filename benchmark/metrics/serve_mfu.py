"""The serving loop's model FLOPs (the plain reference's products and
convolutions counted at each batch's shape, Griffin-Lim as its FFT form)
over the first half of a traced window, where nothing is added to the
loop (no spans, no profiler), against 989 TFLOP/s (bf16 dense), in %."""


def read(data):
    c = data.get("counters", {})
    if not c.get("clean_flops") or not c.get("clean_s"):
        return None
    return 100.0 * c["clean_flops"] / c["clean_s"] / 989e12
