"""The delta plane's retransmit timer under paced takes on two nodes.

    python -m patrol_tpu_torch.scripts.delta_timer [--device cuda|cpu] \\
        [--timer fixed adaptive] [--retransmit-ticks N] [--buckets 1000000] \\
        [--lanes 64] [--takes 20000] [--out rows.jsonl]

For each timer named, two port nodes (``Command`` in this process, each
on its own event-loop thread, the asyncio UDP backend, wire mode
``delta``, frozen clocks) are
peered over loopback, and takes over 2,000 names, split across them, go
in chunks of 500 through ``submit_take``: a chunk waits for its tickets
and then for both delta planes to hold no unacked interval (at most
``--drain-s``; a chunk that does not drain ends the run of that timer).
``fixed`` holds the timeout at ``retransmit_ticks`` (the JAX package's
timer: ``max_retransmit_ticks = 0``); ``adaptive`` is the plane's
default, the RFC 6298 timer floored at ``retransmit_ticks``.

One JSON row per chunk: seconds of takes and of drain, interval
retransmits and data datagrams sent by each node, the most unacked
intervals seen while draining, each node's smoothed ack round trip and
timeout (flush ticks), the mean host time to apply a received datagram
(``replication_rx_apply_ns``, both nodes), the worst and mean delay of a
callback on each node's event loop (sampled every 20 ms), and the
datagrams the kernel dropped at each node's socket (the ``drops``
column of ``/proc/net/udp``, since the run began; None where there is
no such file). Then one summary per timer. The device is CUDA unless
``--device cpu`` is given; without a card, CUDA raises. :func:`main` returns the summaries.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from patrol_tpu_torch.command import Command
from patrol_tpu_torch.models.limiter import NANO, LimiterConfig
from patrol_tpu_torch.ops.rate import Rate
from patrol_tpu_torch.utils import histogram as hist

NAMES, CHUNK, SEED = 2000, 500, 13
RATE = Rate(freq=50, per_ns=3600 * NANO)


class _Node:
    """A Command on its own asyncio loop thread until closed."""

    def __init__(self, cmd: Command):
        self.cmd = cmd
        self.loop = asyncio.new_event_loop()
        self.stop_ev: Optional[asyncio.Event] = None
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        deadline = time.monotonic() + 300
        while not cmd.started.is_set():
            if self.error is not None:
                raise self.error
            if time.monotonic() > deadline:
                raise TimeoutError("the Command did not start serving")
            time.sleep(0.01)

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)

        async def main():
            self.stop_ev = asyncio.Event()
            await self.cmd.run(self.stop_ev)

        try:
            self.loop.run_until_complete(main())
        except BaseException as exc:  # surfaced by close()
            self.error = exc
        finally:
            self.loop.close()

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.stop_ev.set)
        self.thread.join(60)
        if self.error is not None:
            raise self.error


class _LoopLag:
    """Every 20 ms, the delay until each node's loop runs a callback."""

    def __init__(self, nodes: Sequence[_Node]):
        self.nodes = nodes
        self.samples: List[List[float]] = [[] for _ in nodes]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(0.02):
            for k, node in enumerate(self.nodes):
                t = time.perf_counter()
                node.loop.call_soon_threadsafe(
                    lambda k=k, t=t: self.samples[k].append(time.perf_counter() - t)
                )

    def take(self) -> List[List[float]]:
        """[worst, mean] ms per node since the last call."""
        out = []
        for k, s in enumerate(self.samples):
            self.samples[k] = []
            out.append([1e3 * max(s, default=0.0), 1e3 * sum(s) / max(len(s), 1)])
        return out

    def close(self) -> None:
        self._stop.set()
        self._thread.join(1)


def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _udp_drops(ports: Sequence[int]) -> Optional[List[int]]:
    """Kernel drop counts of the UDP sockets bound to ``ports``."""
    try:
        with open("/proc/net/udp") as f:
            lines = f.read().splitlines()[1:]
    except OSError:
        return None
    drops = {}
    for line in lines:
        cols = line.split()
        drops[int(cols[1].rsplit(":", 1)[1], 16)] = int(cols[-1])
    return [drops.get(p, 0) for p in ports]


def _since(before: Optional[List[int]], now: Optional[List[int]]) -> Optional[List[int]]:
    return None if before is None or now is None else [b - a for a, b in zip(before, now)]


def _rx_apply() -> tuple:
    h = hist.RX_APPLY
    with h._mu:
        return sum(map(sum, h._counts)), sum(h._sums)


def run_timer(args, timer: str, emit) -> Dict:
    """Paced takes on two fresh nodes with one timer → its summary."""
    ports = [_free_udp_port() for _ in range(2)]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    cfg = LimiterConfig(buckets=args.buckets, nodes=args.lanes)
    nodes: List[_Node] = []
    try:
        for a in addrs:
            nodes.append(_Node(Command(
                api_addr="127.0.0.1:0", node_addr=a, peer_addrs=addrs,
                clock=lambda: 1_700_000_000 * NANO, config=cfg,
                handle_signals=False, warmup=True, device=args.device,
                wire_mode="delta", udp_backend="asyncio",
            )))
        planes = [n.cmd.replicator.delta for n in nodes]
        deadline = time.perf_counter() + 30
        while not all(len(p.capable_peers()) == 1 for p in planes):
            if time.perf_counter() > deadline:
                raise TimeoutError("the dv2 capability handshake did not complete")
            time.sleep(0.05)
        for p in planes:
            if args.retransmit_ticks is not None:
                p.retransmit_ticks = args.retransmit_ticks
            if timer == "fixed":
                p.max_retransmit_ticks = 0
        names = [f"c{i}" for i in range(NAMES)]
        pick = np.random.default_rng(SEED).integers(0, NAMES, args.takes).tolist()
        lag = _LoopLag(nodes)
        drops0 = _udp_drops(ports)
        t0 = time.perf_counter()
        rows = []
        try:
            for ci, lo in enumerate(range(0, len(pick), CHUNK)):
                st0 = [p.stats() for p in planes]
                rx0 = _rx_apply()
                tc = time.perf_counter()
                tickets = [
                    nodes[j % 2].cmd.repo.submit_take(names[pick[j]], RATE, 1)
                    for j in range(lo, min(lo + CHUNK, len(pick)))
                ]
                for t in tickets:
                    if not t.wait(60):
                        raise TimeoutError("a take ticket never completed")
                tt = time.perf_counter()
                most = 0
                while True:
                    unacked = sum(p.stats()["wire_intervals_unacked"] for p in planes)
                    most = max(most, unacked)
                    if not unacked or time.perf_counter() > tt + args.drain_s:
                        break
                    time.sleep(0.005)
                td = time.perf_counter()
                st1 = [p.stats() for p in planes]
                rx1 = _rx_apply()
                peers = [next(iter(p.lag_stats().values())) for p in planes]
                row = {
                    "timer": timer, "chunk": ci, "takes_s": tt - tc, "drain_s": td - tt,
                    "drained": not unacked, "most_unacked": most,
                    "retransmits": [b["wire_interval_retransmits"] - a["wire_interval_retransmits"]
                                    for a, b in zip(st0, st1)],
                    "data_datagrams": [b["wire_delta_packets_tx"] - a["wire_delta_packets_tx"]
                                       for a, b in zip(st0, st1)],
                    "srtt_ticks": [s["srtt_ticks"] for s in peers],
                    "timeout_ticks": [s["retransmit_timeout_ticks"] for s in peers],
                    "rx_apply_ms": (rx1[1] - rx0[1]) / 1e6 / max(rx1[0] - rx0[0], 1),
                    "loop_lag_ms": lag.take(),
                    "udp_drops": _since(drops0, _udp_drops(ports)),
                }
                rows.append(row)
                emit(row)
                if not row["drained"]:
                    break
        finally:
            lag.close()
        return {
            "timer": timer, "seconds": time.perf_counter() - t0,
            "chunks": len(rows), "drained": all(r["drained"] for r in rows),
            "retransmits": sum(sum(r["retransmits"]) for r in rows),
            "data_datagrams": sum(sum(r["data_datagrams"]) for r in rows),
            "max_drain_s": max(r["drain_s"] for r in rows),
            "srtt_ticks": rows[-1]["srtt_ticks"],
            "rx_apply_ms": sum(r["rx_apply_ms"] for r in rows) / len(rows),
            "udp_drops": _since(drops0, _udp_drops(ports)),
        }
    finally:
        for n in nodes:
            n.close()


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timer", nargs="+", default=["fixed", "adaptive"],
                    choices=("fixed", "adaptive"))
    ap.add_argument("--retransmit-ticks", type=int, default=None,
                    help="the timer's floor (default: PATROL_DELTA_RETX_TICKS)")
    ap.add_argument("--buckets", type=int, default=1_000_000)
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--takes", type=int, default=20_000)
    ap.add_argument("--drain-s", type=float, default=30.0)
    ap.add_argument("--out", default=None, help="append the per-chunk rows here")
    args = ap.parse_args(argv)
    card = ""
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    out = open(args.out, "a") if args.out else None

    def emit(row):
        if out is not None:
            out.write(json.dumps(row) + "\n")
            out.flush()

    try:
        summaries = []
        for timer in args.timer:
            s = run_timer(args, timer, emit)
            s["card"] = card or "cpu"
            print(json.dumps(s), flush=True)
            summaries.append(s)
        return summaries
    finally:
        if out is not None:
            out.close()


if __name__ == "__main__":
    main(sys.argv[1:])
