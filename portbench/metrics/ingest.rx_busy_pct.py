"""``ingest.rx_busy_pct``: how close the node's rx thread is to being the
wall, in percent: of the rx thread's time while datagrams arrive, the
share it spends handling receive batches. The node's ``rx_batch_ns``
histogram (each batch from its ``recv``'s return to the end of its
handling: decode, walk, acks, directory pass, copy and launch) over that
plus its ``rx_wait_ns`` (each such batch's wait in ``recv`` for its first
datagram; a poll that times out empty is no batch), their exact sums read
once the run has ended: the node's whole run in this process, of which
the window is nearly all of the traffic. Nothing where the program keeps
no such histograms."""

import sys


def read(ctx):
    hist = sys.modules.get("patrol_tpu_torch.utils.histogram")
    hs = dict(hist.HISTOGRAMS.items()) if hist else {}
    busy, wait = hs.get("rx_batch_ns"), hs.get("rx_wait_ns")
    if busy is None or wait is None or not busy.count:
        return None
    return 100.0 * busy.total / (busy.total + wait.total)
