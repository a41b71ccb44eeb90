"""``replication.ack_hold_ms``: the node's own share of an ack's latency,
in ms: the mean, over every interval sequence number the node
acknowledged, of the time from the pickup of the datagram that carried the
interval (the rx thread's return from ``recv``) to the flush handing the
datagram that carries its ack to the socket. The node's
``delta_ack_hold_ns`` histogram, its exact sum over its count, read once
the run has ended: it covers the node's whole run in this process (the
bind pass, the warm-up, the window and the drain), of which the window is
nearly all. Nothing where the program keeps no such histogram."""

import sys


def read(ctx):
    hist = sys.modules.get("patrol_tpu_torch.utils.histogram")
    h = dict(hist.HISTOGRAMS.items()).get("delta_ack_hold_ns") if hist else None
    if h is None or not h.count:
        return None
    return h.total / h.count / 1e6
