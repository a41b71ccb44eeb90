"""``ingest.planes_per_launch``: the mean plane count P of the node's raw
``decode_fold`` launches inside the window, from its ``ingest_raw_planes``
histogram (one datagram a plane)."""


def read(ctx):
    c = ctx["counters"]
    return c["raw_planes"] / c["raw_launches"] if c.get("raw_launches") else None
