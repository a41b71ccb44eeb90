"""``ack_p95_ms``: the 95th percentile, over every interval due inside
the window, of the time from its due tick to the first acknowledgement of
it reaching its peer (the kernel's receive timestamp), retransmits and
waits for room in the peer's window included; host clock."""


def read(ctx):
    lat = ctx["peers"]["latency_ms"]
    return lat["p95"] if lat["n"] else None
