"""``ingest.directory_ms``: the directory pass of a raw ``decode_fold``
launch, in ms: the hashed lookup of every entry's name in the node's
directory and the binding of the names it misses. The mean of the node's
``ingest_directory_ns`` histogram, one record a launch, its exact sum
over its count, read once the run has ended: it covers the node's whole
run in this process, the bind pass of every key included, of which the
window is most; reading it at the window's edges would take a change to
``kinds/deltas.py``. Nothing where the program keeps no such histogram."""

import sys


def read(ctx):
    hist = sys.modules.get("patrol_tpu_torch.utils.histogram")
    h = dict(hist.HISTOGRAMS.items()).get("ingest_directory_ns") if hist else None
    if h is None or not h.count:
        return None
    return h.total / h.count / 1e6
