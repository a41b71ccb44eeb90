"""``replication.mu_wait_ms``: how long the node's rx thread waits, a
receive batch, to take ``DeltaPlane._mu`` for the batch's ack bookkeeping
(the flush tick holds the lock while it builds every peer's datagrams),
in ms: the mean of the node's ``delta_mu_wait_ns`` histogram, one record
a batch, its exact sum over its count, read once the run has ended: it
covers the node's whole run in this process (the bind pass, the warm-up,
the window and the drain), of which the window is nearly all; reading it
at the window's edges would take a change to ``kinds/deltas.py``.
Nothing where the program keeps no such histogram."""

import sys


def read(ctx):
    hist = sys.modules.get("patrol_tpu_torch.utils.histogram")
    h = dict(hist.HISTOGRAMS.items()).get("delta_mu_wait_ns") if hist else None
    if h is None or not h.count:
        return None
    return h.total / h.count / 1e6
