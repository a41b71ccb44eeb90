"""Simulated replication peers: a child process that sends dv2 intervals.

    python3 portbench/peers.py --sockets K [--cpu N]

Imports neither torch nor the program. It binds K UDP sockets on
127.0.0.1 (one simulated peer each, so the node under test sees K peers)
and prints their ports as one JSON line. It then reads one JSON line of
settings from standard input (the node's address, each socket's peer
index and lane, the seed and the traffic) and runs every peer from one
thread:

* each peer keeps at most ``window`` intervals unacknowledged; it sends
  its bind pass (``streams.Stream``) in a closed loop, and then random
  intervals, either in a closed loop (the next one whenever the node's
  ack vectors free a place) or, where the traffic gives
  ``intervals_per_tick``, open-loop on a schedule: a burst of that many
  intervals at each of its ticks, as a node's flush tick sends them. The
  ticks' gaps are the same set for every seed (evenly spaced over
  ``tick_ms``), in an order drawn from the seed; an interval that the
  window holds back goes as soon as it frees a place, and its latency
  still counts from its tick;
* an interval unacknowledged past the retransmit timeout is sent again,
  the same datagram with the same ``seq`` (its values are absolute, so
  a late copy is a no-op); the timer is the port's own peer's
  (``net/delta.py``: RFC 6298 over the acks' round trip in flush ticks,
  samples only from intervals sent once, doubled for each retransmit
  round until the next sample, rounded up to whole ticks), with the
  floor and ceiling in ticks that the configuration states for every
  member;
* each peer keeps two windows of datagrams encoded ahead, a chunk of
  intervals a turn of the loop, and on a schedule only where the next
  tick is further off than a chunk takes, so that no send waits on numpy;
* an interval's latency runs from its tick (in a closed loop: its first
  send) to the arrival of the first ack of it, read from the kernel's
  receive timestamp, so that it holds nothing of this process's own
  delays in reading;
* once every peer's bind pass is acknowledged the process prints
  ``{"event": "bound"}`` (in a closed loop it keeps sending); the next
  line on standard input gives the measured window ``[t0, t1]`` on the
  monotonic clock, which every process on the host shares, and a
  schedule starts ``warm_s`` before ``t0``;
* at ``t1`` the peers stop taking new intervals (on a schedule: they
  still send those whose tick lies before ``t1``) and send again what is
  unacknowledged until all of it is acknowledged, for at most
  ``drain_s``; then the process prints its counts and the latencies'
  percentiles over the intervals of the window as one JSON line and
  exits.

A datagram that the node never acknowledges counts as failed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import selectors
import socket
import struct
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import dv2, streams  # noqa: E402

SOCK_BUF = 4 << 20
# Intervals encoded a turn of the loop (a new block of key draws,
# streams.BLOCK intervals, is drawn whole when a chunk enters it).
CHUNK = 16
# The kernel's receive timestamp (SO_TIMESTAMPNS; CLOCK_REALTIME).
SO_TIMESTAMPNS = 35
CMSG_TS = socket.CMSG_SPACE(16)


class Peer:
    """One simulated peer: its socket, its stream and its unacked intervals."""

    def __init__(self, sock, stream, node, window, timer, cap_nt, per_tick=None):
        self.sock, self.stream, self.node = sock, stream, node
        self.cap_nt = cap_nt
        self.window = window
        # Open loop: ``per_tick`` intervals at each tick of ``ticks``
        # (monotonic seconds, set with the window); None: a closed loop.
        self.per_tick = per_tick
        self.ticks = None
        self.tick_s, self.retx_ticks, self.retx_max_ticks = timer
        self.next_i = 0
        # Datagrams encoded ahead of need, so that encoding a block never
        # sits between an ack and the next send.
        self.ready = {}  # interval -> datagram bytes
        self.encoded_hi = 0
        # seq -> [interval, bytes, first sent, last sent, sends, due]
        self.unacked = {}
        self.srtt = None  # in ticks
        self.rttvar = 0.0
        self.backoff = 0
        self.bound_left = stream.n_bind
        # Counts over the measured window.
        self.w_acked_entries = 0
        self.w_fresh = 0
        self.w_resent = 0
        self.w_tx_bytes = 0
        self.w_tx_entries = 0
        self.w_latency = []  # seconds, intervals due inside the window

    def rto(self) -> float:
        """The port's own retransmit timer (``net/delta.py``
        ``_timeout_locked``), in seconds: in ticks, the floor until the
        first sample, then srtt + max(1, 4 rttvar), doubled for each
        retransmit round since the last sample, rounded up, between the
        floor and the ceiling."""
        floor = self.retx_ticks
        base = floor if self.srtt is None else self.srtt + max(1.0, 4.0 * self.rttvar)
        ticks = min(max(math.ceil(base * (1 << self.backoff)), floor),
                    max(floor, self.retx_max_ticks))
        return ticks * self.tick_s

    def schedule(self, start: float, seconds: float, tick_ms, q: int, npeers: int,
                 seed: int) -> None:
        """Ticks from ``start`` over ``seconds``: gaps evenly spaced over
        ``tick_ms`` = [lo, hi] (the same set for every seed) in an order
        drawn from (seed, q); peer q's ticks start q / npeers of a mean
        gap late."""
        lo, hi = (float(x) / 1000.0 for x in tick_ms)
        mean = (lo + hi) / 2
        gaps = np.linspace(lo, hi, max(1, int(seconds / mean)))
        gaps = np.random.default_rng([seed, 6, q]).permutation(gaps)
        self.ticks = start + mean * q / npeers + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])

    def due_at(self, i: int) -> float:
        """When interval ``i`` is due: the bind pass at once, then its
        tick (inf past the schedule, or before it is set)."""
        j = i - self.stream.n_bind
        if j < 0:
            return 0.0
        if self.ticks is None or j // self.per_tick >= len(self.ticks):
            return float("inf")
        return float(self.ticks[j // self.per_tick])

    def encode_block(self) -> None:
        """Encode the next chunk of intervals (up to ``CHUNK``, the bind
        pass's last chunk shorter) into ``ready``."""
        st = self.stream
        lo = self.encoded_hi
        if lo < st.n_bind:
            hi = min(lo + CHUNK, st.n_bind)
        else:
            hi = lo + CHUNK
        idx = np.arange(lo, hi)
        keys = st.names(lo, hi)
        added, taken, elapsed = st.values(idx[:, None], keys)
        raw = dv2.encode(st.lane, idx + 1, streams.name_bytes(keys), st.lane,
                         self.cap_nt, added, taken, elapsed)
        self.ready.update((int(j), raw[k].tobytes()) for k, j in enumerate(idx))
        self.encoded_hi = hi

    def wants_block(self) -> bool:
        """Fewer than two windows of intervals are encoded ahead."""
        return self.encoded_hi - self.next_i < 2 * self.window

    def datagram(self, i: int) -> bytes:
        while i >= self.encoded_hi:
            self.encode_block()
        return self.ready.pop(i)

    def send(self, data: bytes) -> bool:
        try:
            self.sock.sendto(data, self.node)
            return True
        except (BlockingIOError, InterruptedError):
            return False

    def fill(self, now: float, fresh: bool, t0: float, t1: float) -> None:
        """Send what is due while the window has room: in a closed loop
        the next interval while ``fresh``; on a schedule every interval
        whose tick has come and lies before ``t1``."""
        while len(self.unacked) < self.window:
            i = self.next_i
            if self.per_tick is None or i < self.stream.n_bind:
                if not fresh:
                    return
                due = now
            else:
                due = self.due_at(i)
                if due > now or due >= t1:
                    return
            data = self.datagram(i)
            if not self.send(data):
                self.ready[i] = data
                return
            self.next_i += 1
            self.unacked[i + 1] = [i, data, now, now, 1, due]
            if t0 <= now < t1:
                self.w_fresh += 1
                self.w_tx_bytes += len(data)
                self.w_tx_entries += self.stream.entries

    def resend(self, now: float, t0: float, t1: float) -> None:
        """One retransmit round: every interval unacknowledged for the
        timeout goes again; a round that resends doubles the timeout."""
        timeout = self.rto()
        resent = False
        for rec in self.unacked.values():
            if now - rec[3] >= timeout and self.send(rec[1]):
                resent = True
                rec[3] = now
                rec[4] += 1
                if t0 <= now < t1:
                    self.w_resent += 1
                    self.w_tx_bytes += len(rec[1])
                    self.w_tx_entries += self.stream.entries
        if resent:
            self.backoff = min(self.backoff + 1, 6)

    def pending(self, t1: float) -> bool:
        """Anything left to send or to be acknowledged once fresh
        intervals have stopped at ``t1``."""
        if self.unacked:
            return True
        return self.per_tick is not None and self.due_at(self.next_i) < t1

    def next_due(self) -> float:
        """When the next unsent interval is due: inf in a closed loop, and
        while the window is full, as then only an ack frees a place."""
        if (self.per_tick is None or self.next_i < self.stream.n_bind
                or len(self.unacked) >= self.window):
            return float("inf")
        return self.due_at(self.next_i)

    def on_acks(self, acks, now: float, t0: float, t1: float) -> None:
        for seq in acks:
            rec = self.unacked.pop(seq, None)
            if rec is None:
                continue
            if t0 <= rec[5] < t1:
                self.w_latency.append(now - rec[5])
            if rec[0] < self.stream.n_bind:
                self.bound_left -= 1
            if rec[4] == 1:
                rtt = (now - rec[2]) / self.tick_s
                if self.srtt is None:
                    self.srtt, self.rttvar = rtt, rtt / 2
                else:
                    self.rttvar = 0.75 * self.rttvar + 0.25 * abs(self.srtt - rtt)
                    self.srtt = 0.875 * self.srtt + 0.125 * rtt
                self.backoff = 0
            if t0 <= now < t1:
                self.w_acked_entries += self.stream.entries


def percentiles(seconds) -> dict:
    """Latency percentiles in milliseconds, and their count."""
    if not seconds:
        return {"n": 0}
    ms = np.asarray(seconds, np.float64) * 1000.0
    p50, p95, p99 = np.percentile(ms, [50, 95, 99])
    return {"n": int(ms.size), "p50": float(p50), "p95": float(p95), "p99": float(p99),
            "max": float(ms.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sockets", type=int, required=True)
    ap.add_argument("--cpu", type=int, help="run on this CPU alone")
    args = ap.parse_args(argv)
    if args.cpu is not None:
        os.sched_setaffinity(0, {args.cpu})
    socks = []
    for _ in range(args.sockets):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, SOCK_BUF)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, SOCK_BUF)
        s.setsockopt(socket.SOL_SOCKET, SO_TIMESTAMPNS, 1)
        s.bind(("127.0.0.1", 0))
        s.setblocking(False)
        socks.append(s)
    print(json.dumps({"ports": [s.getsockname()[1] for s in socks]}), flush=True)
    cfg = json.loads(sys.stdin.readline())
    node = (cfg["node"][0], int(cfg["node"][1]))
    timer = (cfg["tick_s"], int(cfg["retx_ticks"]), int(cfg["retx_max_ticks"]))
    per_tick = cfg.get("per_tick")
    peers = []
    for s, p in zip(socks, cfg["peers"]):
        st = streams.Stream(cfg["seed"], p["q"], cfg["npeers"], p["lane"], cfg["keys"],
                            cfg["entries"], cfg["dist"], cfg.get("zipf_s", 0.99))
        peers.append(Peer(s, st, node, cfg["window"], timer, int(cfg["cap_nt"]), per_tick))
    sel = selectors.DefaultSelector()
    for p in peers:
        sel.register(p.sock, selectors.EVENT_READ, p)
    stdin = sys.stdin.buffer.raw if hasattr(sys.stdin.buffer, "raw") else sys.stdin.buffer
    os.set_blocking(stdin.fileno(), False)
    sel.register(stdin, selectors.EVENT_READ, None)
    inbox = b""
    inf = float("inf")
    t0 = t1 = inf
    drain_s = float(cfg["drain_s"])
    bound_said = False
    # The kernel stamps a datagram on CLOCK_REALTIME; this moves it to
    # the monotonic clock that the window and the ticks are on.
    real_minus_mono = time.time() - time.monotonic()
    prep_s = 0.0  # the longest a chunk took to encode, decaying
    while True:
        now = time.monotonic()
        fresh = now < t1
        for p in peers:
            p.fill(now, fresh, t0, t1)
            p.resend(now, t0, t1)
        # One chunk a turn, so that acks keep being read, and on a
        # schedule only while the next tick is further off than that.
        next_due = min(p.next_due() for p in peers)
        behind = None
        if fresh and next_due - now > 1.5 * prep_s + 0.0005:
            behind = next((p for p in peers if p.wants_block()), None)
        if behind is not None:
            t_prep = time.monotonic()
            behind.encode_block()
            prep_s = max(0.99 * prep_s, time.monotonic() - t_prep)
        if not bound_said and all(p.bound_left == 0 for p in peers):
            bound_said = True
            print(json.dumps({"event": "bound"}), flush=True)
        if now >= t1 and (not any(p.pending(t1) for p in peers) or now >= t1 + drain_s):
            break
        wait = 0.002 if behind is None else 0.0
        wait = max(0.0, min(wait, next_due - time.monotonic()))
        for key, _ in sel.select(timeout=wait):
            if key.data is None:
                chunk = stdin.read(65536)
                if chunk is None:
                    continue
                if not chunk:
                    sel.unregister(stdin)
                    if t1 == inf:
                        return 3  # the harness went away before the window
                inbox += chunk
                if b"\n" in inbox:
                    line, inbox = inbox.split(b"\n", 1)
                    win = json.loads(line)
                    t0, t1 = float(win["t0"]), float(win["t1"])
                    if per_tick is not None:
                        start = t0 - float(cfg["warm_s"])
                        for p, m in zip(peers, cfg["peers"]):
                            p.schedule(start, t1 - start, cfg["tick_ms"], m["q"], len(peers),
                                       cfg["seed"])
                continue
            p = key.data
            while True:
                try:
                    data, anc, _, _ = p.sock.recvmsg(65536, CMSG_TS)
                except (BlockingIOError, InterruptedError):
                    break
                at = time.monotonic()
                for level, kind, raw in anc:
                    if level == socket.SOL_SOCKET and kind == SO_TIMESTAMPNS and len(raw) >= 16:
                        sec, nsec = struct.unpack("qq", raw[:16])
                        at = sec + nsec * 1e-9 - real_minus_mono
                acks = dv2.acks_of(data)
                if acks:
                    p.on_acks(acks, at, t0, t1)
    out = {
        "sent_intervals": [p.next_i for p in peers],
        "unacked": sum(len(p.unacked) for p in peers),
        "acked_entries": sum(p.w_acked_entries for p in peers),
        "fresh": sum(p.w_fresh for p in peers),
        "resent": sum(p.w_resent for p in peers),
        "tx_bytes": sum(p.w_tx_bytes for p in peers),
        "tx_entries": sum(p.w_tx_entries for p in peers),
        "latency_ms": percentiles([x for p in peers for x in p.w_latency]),
    }
    print(json.dumps(out), flush=True)
    for s in socks:
        s.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
