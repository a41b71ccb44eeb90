"""``replication.resend_pct``: of the intervals the simulated peers sent
inside the window, the share that were retransmits (the node's ack came
later than the peer's timer, or never), in percent. The peers' own counts:
the benchmark's load keeps them on the host, timed by the host's clock,
with the timer every member of the configuration runs; the node counts no
retransmit it receives."""


def read(ctx):
    p = ctx["peers"]
    sent = p["fresh"] + p["resent"]
    return 100.0 * p["resent"] / sent if sent else None
