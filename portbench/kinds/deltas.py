"""Traffic of ``"kind": "deltas"``: simulated peers' dv2 fan-in into one node.

The node under test is one ``patrol_tpu_torch`` ``Command`` (the
configuration's fronts, UDP backend and wire mode, ``cuda:0``) whose
member list holds ``members - 1`` simulated peers. The peers run in one
child process (``portbench/peers.py``) on a CPU of its own, which imports
neither torch nor the program; each holds a lane and a stream of intervals
(``portbench/streams.py``), and retransmits on the timer that the
configuration states for every member.

Set-up: start the peers, then the node, then the bind pass (every key of
the configuration once), then ``warm_s`` seconds of the traffic (a closed
loop, or the schedule of ``intervals_per_tick`` intervals a tick), so
that the window opens on a load already at its pace. The window lasts
``--seconds``; then the peers drain, the node's planes are read back
(``snapshot_planes``: device rows with every host-resident one joined in),
the node is stopped, and the plane reference (``portbench/reference``)
judges every key the peers sent.
"""

from __future__ import annotations

import json
import os
import select
import socket
import subprocess
import sys
import time

import numpy as np

from portbench import dv2, streams
from portbench.node import Node
from portbench.reference import fold

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# After the window: how long the peers resend what is unacknowledged
# before it counts as failed. Before it: how long binding every key may take.
DRAIN_S = 60.0
BIND_TIMEOUT_S = 240.0


def free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class PeerProc:
    """The peer process, and the lines it prints. Where there are three
    CPUs or more it takes the last one this process may use and the node
    the rest, so that the load and the node do not take turns on a core."""

    def __init__(self, sockets: int):
        cpus = sorted(os.sched_getaffinity(0))
        pin = []
        if len(cpus) >= 3:
            os.sched_setaffinity(0, set(cpus[:-1]))
            pin = ["--cpu", str(cpus[-1])]
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "peers.py"), "--sockets", str(sockets)] + pin,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        try:
            self.ports = json.loads(self.line(60))["ports"]
        except BaseException:
            self.close()
            raise

    def line(self, timeout_s: float) -> str:
        ready, _, _ = select.select([self.proc.stdout], [], [], timeout_s)
        if not ready:
            raise TimeoutError("the peer process did not answer")
        got = self.proc.stdout.readline()
        if not got:
            raise RuntimeError(f"the peer process exited (code {self.proc.poll()})")
        return got

    def send(self, obj: dict) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(30)


def counters(hist_mod) -> dict:
    """The node's raw ``decode_fold`` launches and the planes they took,
    from its ``ingest_raw_planes`` histogram (every lane of it)."""
    lat = hist_mod.RAW_PLANES.to_lattice()
    return {"raw_launches": sum(sum(lane) for lane in lat["counts"]),
            "raw_planes": sum(lat["sums"])}


def wait_quiet(cmd, hist_mod, quiet_s: float = 0.5, timeout_s: float = 60.0) -> None:
    """Wait until the node's receive path has gone quiet. The node
    acknowledges an interval once its rx thread has walked it, before the
    thread's ``decode_fold`` for it has run, so the last acknowledgements
    can reach a peer before the last fold; the state is read once nothing
    has been received or launched for ``quiet_s``, and the engine's queues
    have drained."""

    def mark():
        return (cmd.replicator.delta.stats()["wire_delta_rx_packets"],
                sum(sum(lane) for lane in hist_mod.RAW_PLANES.to_lattice()["counts"]))

    deadline = time.monotonic() + timeout_s
    last, since = mark(), time.monotonic()
    while time.monotonic() - since < quiet_s:
        if time.monotonic() > deadline:
            raise RuntimeError("the node's receive path did not go quiet")
        time.sleep(0.05)
        now = mark()
        if now != last:
            last, since = now, time.monotonic()
    if not cmd.engine.flush(timeout_s):
        raise RuntimeError("the node did not flush")


def wait_ae_idle(cmd, hist_mod, quiet_s: float = 0.5, timeout_s: float = 180.0) -> None:
    """Wait until the node's anti-entropy worker has finished the digest
    exchange it starts toward each peer it hears from first (one job a
    peer, each digesting up to 2,048 bound buckets): a set-up cost of
    meeting the peers, which a node in steady state does not pay."""
    ae = cmd.replicator.antientropy

    def mark():
        return (sum(sum(lane) for lane in hist_mod.AE_JOB.to_lattice()["counts"]),
                ae.stats()["ae_packets_tx"])

    deadline = time.monotonic() + timeout_s
    last, since = mark(), time.monotonic()
    while time.monotonic() - since < quiet_s or last[0] < ae.stats()["ae_triggers"]:
        if time.monotonic() > deadline:
            raise RuntimeError("the node's anti-entropy exchange did not finish")
        time.sleep(0.05)
        now = mark()
        if now != last:
            last, since = now, time.monotonic()


def read_state(engine, keys: int):
    """The node's planes and the row of every key (-1: unbound), and the
    count of rows bound to no key of the streams (or to one twice)."""
    pn, elapsed = engine.snapshot_planes()
    cap = np.array(engine.directory.cap_base_nt, np.int64, copy=True)
    row_of_key = np.full(keys, -1, np.int64)
    stray = 0
    for row in range(pn.shape[0]):
        name = engine.directory.name_of(row)
        if name is None:
            continue
        k = streams.key_of(name)
        if 0 <= k < keys and row_of_key[k] < 0:
            row_of_key[k] = row
        else:
            stray += 1
    return pn, elapsed, cap, row_of_key, stray


def steps(t_start: float, marks: dict) -> dict:
    """Seconds of each set-up step, in order, from the process's start."""
    out, last = {}, t_start
    for name, t in marks.items():
        out[name] = t - last
        last = t
    return out


def run(cell) -> dict:
    import torch
    from patrol_tpu_torch.command import Command
    from patrol_tpu_torch.models.limiter import LimiterConfig
    from patrol_tpu_torch.utils import histogram as hist_mod

    from portbench import trace as trace_mod

    cfg, tr = cell.config, cell.traffic
    npeers = int(cfg["members"]) - 1
    keys = int(cfg["keys"])
    entries = dv2.capacity(int(tr["datagram_bytes"]), streams.NAME_LEN)
    env = cfg["env"]
    marks = {"imports": time.monotonic()}
    peers = PeerProc(npeers)
    marks["peers_started"] = time.monotonic()
    node = None
    try:
        node_addr = f"127.0.0.1:{free_udp_port()}"
        peer_addrs = [f"127.0.0.1:{p}" for p in peers.ports]
        lane_of = {a: i for i, a in enumerate(sorted(peer_addrs + [node_addr]))}
        cmd = Command(
            api_addr="127.0.0.1:0", node_addr=node_addr, peer_addrs=peer_addrs + [node_addr],
            config=LimiterConfig(buckets=int(cfg["buckets"]), nodes=int(cfg["node_lanes"])),
            handle_signals=False, warmup=True, device=cell.device, wire_mode=cfg["wire_mode"],
            udp_backend=cfg["udp_backend"], http_front=cfg["http_front"], shutdown_timeout_s=30,
        )
        if cell.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        node = Node(cmd)
        marks["node_serving"] = time.monotonic()
        engine = cmd.engine
        plan = [{"q": q, "lane": lane_of[f"127.0.0.1:{p}"]} for q, p in enumerate(peers.ports)]
        peers.send({
            "node": ["127.0.0.1", int(node_addr.rsplit(":", 1)[1])], "peers": plan,
            "npeers": npeers, "keys": keys, "entries": entries, "seed": cell.seed,
            "dist": tr["keys"], "zipf_s": tr.get("zipf_s", 0.99),
            "window": int(tr["window_intervals"]), "cap_nt": int(cfg["cap_nt"]),
            "per_tick": tr.get("intervals_per_tick"), "tick_ms": tr.get("tick_ms"),
            "warm_s": float(tr["warm_s"]),
            "tick_s": float(env["PATROL_DELTA_FLUSH_MS"]) / 1000.0,
            "retx_ticks": int(env["PATROL_DELTA_RETX_TICKS"]),
            "retx_max_ticks": int(cfg["retransmit_max_ticks"]),
            "drain_s": DRAIN_S,
        })
        got = json.loads(peers.line(BIND_TIMEOUT_S))
        if got.get("event") != "bound":
            raise RuntimeError(f"the peer process said {got}")
        marks["keys_bound"] = time.monotonic()
        wait_ae_idle(cmd, hist_mod)
        marks["anti_entropy_done"] = time.monotonic()
        t0 = time.monotonic() + float(tr["warm_s"])
        t1 = t0 + cell.seconds
        peers.send({"t0": t0, "t1": t1})
        time.sleep(max(0.0, t0 - time.monotonic()))
        setup_s = time.monotonic() - cell.t_start
        marks["window_open"] = time.monotonic()
        c0 = counters(hist_mod)
        window = None
        if cell.trace:
            window = trace_mod.Window(torch)
            window.start()
        time.sleep(max(0.0, t1 - time.monotonic()))
        summary = window.stop() if window is not None else None
        c1 = counters(hist_mod)
        stats = json.loads(peers.line(DRAIN_S + 30))
        wait_quiet(cmd, hist_mod)
        device = {
            "platform": "gpu" if cell.device == "cuda" else cell.device,
            "kind": torch.cuda.get_device_name(0) if cell.device == "cuda" else "cpu",
            "count": int(cell.workload["chips"]),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
            if cell.device == "cuda" else 0,
        }
        if summary is not None:
            device["busy_s"] = summary["busy_s"]
            device["window_s"] = summary["window_s"]
        state = read_state(engine, keys)
        node.close()
        node = None
        engine = cmd = None
        if cell.device == "cuda":
            torch.cuda.empty_cache()
    finally:
        if node is not None:
            node.close()
        peers.close()
    sent = stats["sent_intervals"]
    agg = {k: stats[k] for k in ("unacked", "acked_entries", "fresh", "resent", "tx_bytes",
                                 "tx_entries", "latency_ms")}
    lanes = int(cfg["node_lanes"])
    done = [(streams.Stream(cell.seed, m["q"], npeers, m["lane"], keys, entries, tr["keys"],
                            tr.get("zipf_s", 0.99)), n) for m, n in zip(plan, sent)]
    pn, elapsed, cap, row_of_key, stray = state
    want = fold.expected(cell.seed, done, keys, lanes, int(cfg["cap_nt"]))
    got = fold.compare(want, pn, elapsed, cap, row_of_key, stray, agg["unacked"])
    ctx = {
        "window_s": t1 - t0,
        "setup_s": setup_s,
        "setup_steps": steps(cell.t_start, marks),
        "peers": agg,
        "counters": {k: c1[k] - c0[k] for k in c1},
        "trace": summary,
        "device": device,
        "attempted": int(sum(sent)),
        "failed": agg["unacked"],
        "checks": {k: {"value": v, "limit": fold.LIMITS[k]} for k, v in got.items()},
    }
    if cell.control:
        low = fold.expected(cell.seed, done, keys, lanes, int(cfg["cap_nt"]), dtype=np.float64)
        keyed = np.where(want["touched"], np.arange(keys), -1)
        ctx["control"] = fold.compare(want, low["pn"], low["elapsed"], low["cap"], keyed, 0, 0)
        ctx["faults"] = {
            kind: fold.compare(want, f["pn"], f["elapsed"], f["cap"],
                               np.where(f["touched"], np.arange(keys), -1), 0, 0)
            for kind, f in fold.faulted(cell.seed, done, keys, lanes, int(cfg["cap_nt"])).items()}
    return ctx
