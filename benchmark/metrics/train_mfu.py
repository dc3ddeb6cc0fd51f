"""The train loop's model FLOPs (forward, backward and R1's double
backward of the plain reference's step, counted at the cell's shape, times
the steps) over the first half of a traced window, where nothing is added
to the loop (no spans, no profiler), against 989 TFLOP/s (bf16 dense), in %."""


def read(data):
    c = data.get("counters", {})
    if not c.get("clean_flops") or not c.get("clean_s"):
        return None
    return 100.0 * c["clean_flops"] / c["clean_s"] / 989e12
