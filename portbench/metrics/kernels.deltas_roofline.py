"""``kernels.deltas_roofline``: the least time the window's delta traffic
needs on the card, over the summed time of every kernel in the traced
window, in percent.

The least time is bytes over the H100's 3.35 TB/s (NVIDIA's data sheet,
SXM): every byte of every datagram the peers sent inside the window is
read once, and each entry's target lane pair (16 B) and ``elapsed`` word
(8 B) are read once and written once. The work is counted from the
traffic, not from any kernel's design; a join has no arithmetic to speak
of, so the bytes bound it. No reading where the trace holds no kernel."""

HBM_BYTES_PER_S = 3.35e12
TARGET_BYTES = 2 * (16 + 8)


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["kernel_s"] <= 0:
        return None
    p = ctx["peers"]
    least_s = (p["tx_bytes"] + p["tx_entries"] * TARGET_BYTES) / HBM_BYTES_PER_S
    return 100.0 * least_s / tr["kernel_s"]
