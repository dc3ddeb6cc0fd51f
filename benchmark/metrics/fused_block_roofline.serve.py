"""The fused block kernel's share of its roofline: the least time of
the identity blocks' work at the shapes they were called with (two 3x3
convolutions, PReLU and residual; inputs read and outputs written once, at
3.35 TB/s and the tensor cores' rate for the compute dtype), over their
time by CUDA events around each of those blocks, in %."""


def read(data):
    least = data.get("counters", {}).get("fused_block.least_s")
    ms = data.get("spans", {}).get("fused_block")
    if not least or not ms:
        return None
    return 100.0 * least / (sum(ms) / 1e3)
