"""``replication.rx_queue_ms``: the time a datagram waits in the node's
socket before its rx thread picks it up, in ms: the mean, over every
datagram the native rx thread received, of its pickup (CLOCK_REALTIME)
less the kernel's receive timestamp (``SO_TIMESTAMP``, to the µs). The
node's ``delta_rx_queue_ns`` histogram, its exact sum over its count,
read once the run has ended: it covers the node's whole run in this
process, of which the window is nearly all. Nothing where the program
keeps no such histogram."""

import sys


def read(ctx):
    hist = sys.modules.get("patrol_tpu_torch.utils.histogram")
    h = dict(hist.HISTOGRAMS.items()).get("delta_rx_queue_ns") if hist else None
    if h is None or not h.count:
        return None
    return h.total / h.count / 1e6
