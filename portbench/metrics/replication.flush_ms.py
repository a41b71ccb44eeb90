"""``replication.flush_ms``: the node's delta flush tick, in ms: the mean,
over every ``DeltaPlane.flush`` (each 20 ms), of its whole time: building
every peer's datagrams (data, retransmits, acks) under ``DeltaPlane._mu``
and then handing each to the socket. The node's ``delta_flush_ns``
histogram, its exact sum over its count, read once the run has ended: it
covers the node's whole run in this process (the bind pass, the warm-up,
the window and the drain), of which the window is nearly all; reading it
at the window's edges would take a change to ``kinds/deltas.py``.
Nothing where the program keeps no such histogram."""

import sys


def read(ctx):
    hist = sys.modules.get("patrol_tpu_torch.utils.histogram")
    h = dict(hist.HISTOGRAMS.items()).get("delta_flush_ns") if hist else None
    if h is None or not h.count:
        return None
    return h.total / h.count / 1e6
