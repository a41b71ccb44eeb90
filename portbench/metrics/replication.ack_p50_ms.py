"""``replication.ack_p50_ms``: the median of the latencies that
``ack_p95_ms`` takes the tail of, a steadier reading of the same path."""


def read(ctx):
    lat = ctx["peers"]["latency_ms"]
    return lat["p50"] if lat["n"] else None
