"""UDP replication of the port, over loopback, against itself and against
the JAX package.

Nodes run in this process on the CPU (``device="cpu"``, the kernels'
plain versions), each ``Command`` on its own event-loop thread, with
ephemeral ports and FROZEN clocks: with ``now == created`` no take is ever
refilled, so the converged lane planes are exact and every take a node
admitted is one token in its own lane, whichever node later holds the
state. Convergence is checked by bounded polling of ``repo.snapshot(name)``
on every node; every wait has a deadline, and each test holds a time
budget of its own.

* two port nodes converge in each wire mode (``delta``, ``aggregate``,
  ``compat``), incast rehydrates a node that missed the traffic, and a
  lost interval log falls back to anti-entropy and heals;
* a mixed cluster — one ``patrol_tpu`` node, one ``patrol_tpu_torch``
  node — converges to equal snapshots, with no faults and under a seeded
  ``faultnet`` drop/dup/reorder schedule (``tests/test_chaos.py``'s
  delta-wire schedule);
* a reference-semantics v1 peer (``net/v1node.py``) interoperates with a
  port node.

The traffic is kept to a few dozen names: the asyncio raw path walks each
datagram in numpy on the receiving loop, and on a slow shared CPU a flood
can outrun the JAX package's fixed retransmit timer (see ROADMAP §C).
"""

import asyncio
import dataclasses
import socket
import threading
import time

import numpy as np
import pytest

from patrol_tpu.command import Command as JCommand
from patrol_tpu.models.limiter import LimiterConfig as JConfig
from patrol_tpu.ops.rate import Rate as JRate
from patrol_tpu.runtime import engine as jengine_mod
from patrol_tpu_torch.command import Command as TCommand
from patrol_tpu_torch.models.limiter import NANO
from patrol_tpu_torch.models.limiter import LimiterConfig as TConfig
from patrol_tpu_torch.net.faultnet import FaultNet
from patrol_tpu_torch.net.v1node import V1Node
from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.ops.rate import Rate as TRate
from patrol_tpu_torch.runtime import engine as tengine_mod
from patrol_tpu_torch.utils import profiling

BUCKETS, NODES = 128, 4
FROZEN = 1_000 * NANO
BUDGET_S = 90.0


def free_port(kind=socket.SOCK_DGRAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Node:
    """Runs one Command on its own event-loop thread until closed."""

    def __init__(self, cmd, timeout=60.0):
        self.cmd = cmd
        self.loop = asyncio.new_event_loop()
        self.stop_ev = None
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        deadline = time.monotonic() + timeout
        while not cmd.started.is_set():
            assert self.error is None, self.error
            assert time.monotonic() < deadline, "node did not start"
            time.sleep(0.01)

    def _run(self):
        asyncio.set_event_loop(self.loop)

        async def main():
            self.stop_ev = asyncio.Event()
            await self.cmd.run(self.stop_ev)

        try:
            self.loop.run_until_complete(main())
        except BaseException as exc:  # surfaced by the starter
            self.error = exc

    def drain(self, timeout=30.0):
        """Wait until every completion of the node's engine has fanned out
        and every datagram it queued on its event loop has been sent: the
        loop runs callbacks in order, so a no-op scheduled now returns after
        the sends queued before it."""
        assert self.cmd.engine.flush(timeout), "engine did not drain"
        asyncio.run_coroutine_threadsafe(asyncio.sleep(0), self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.stop_ev.set)
        self.thread.join(30)
        assert not self.thread.is_alive(), "node did not shut down"


def port_cmd(addr, addrs, **kw):
    # These cases run the asyncio backend and the asyncio HTTP front
    # (``auto`` takes the native ones when the host library loads;
    # tests/test_torch_native_replication.py and
    # tests/test_torch_native_http.py run those).
    kw.setdefault("udp_backend", "asyncio")
    kw.setdefault("http_front", "python")
    return TCommand(
        api_addr="127.0.0.1:0", node_addr=addr, peer_addrs=addrs,
        clock=lambda: FROZEN, config=TConfig(BUCKETS, NODES),
        handle_signals=False, shutdown_timeout_s=5.0, device="cpu", **kw,
    )


def jax_cmd(addr, addrs, **kw):
    return JCommand(
        api_addr=f"127.0.0.1:{free_port(socket.SOCK_STREAM)}", node_addr=addr,
        peer_addrs=addrs, clock=lambda: FROZEN, config=JConfig(BUCKETS, NODES),
        handle_signals=False, shutdown_timeout_s=5.0, http_front="python",
        udp_backend="asyncio", **kw,
    )


@pytest.fixture
def budget():
    """The test's time budget: every wait inside stays bounded, and the
    test fails if the whole of it ran past the budget."""
    t0 = time.monotonic()
    yield t0 + BUDGET_S
    assert time.monotonic() - t0 < BUDGET_S, "test ran past its time budget"


def snap(cmd, name):
    """A node's view of a bucket as plain tuples (comparable across the two
    packages' ``WireState`` classes)."""
    return [dataclasses.astuple(s) for s in cmd.repo.snapshot(name)]


def wait_capable(cmds, deadline):
    while not all(
        len(c.replicator.delta.capable_peers()) == len(c.replicator.peers) for c in cmds
    ):
        assert time.monotonic() < deadline, "dv2 capability handshake did not complete"
        time.sleep(0.02)


def converge(cmds, names, deadline, retrigger=False):
    """Poll until every node holds the same non-empty snapshot of every
    name and no delta interval is unacked; → the converged snapshots."""
    next_trigger = 0.0
    while True:
        if retrigger and time.monotonic() >= next_trigger:
            next_trigger = time.monotonic() + 1.0
            for c in cmds:
                for peer in c.replicator.peers:
                    c.replicator.antientropy.trigger(peer, force=True)
        for c in cmds:
            c.engine.flush(10)
        views = [{n: snap(c, n) for n in names} for c in cmds]
        pending = sum(
            c.replicator.delta.stats()["wire_intervals_unacked"] for c in cmds
        )
        if all(v == views[0] for v in views) and all(views[0].values()) and not pending:
            return views[0]
        assert time.monotonic() < deadline, "nodes did not converge"
        time.sleep(0.05)


def drive_takes(cmds, names, n, rate_of, seed):
    """``n`` takes round-robin over the nodes, names drawn from a seed;
    → tokens admitted."""
    rng = np.random.default_rng(seed)
    admitted = 0
    for j, i in enumerate(rng.integers(0, len(names), n).tolist()):
        cmd = cmds[j % len(cmds)]
        _, ok = cmd.repo.take(names[i], rate_of(cmd), 1)
        admitted += ok
    return admitted


def taken_tokens(view):
    # Field 7 of a WireState tuple is lane_taken_nt.
    return sum(st[7] for states in view.values() for st in states) // NANO


def _port_rate(cmd):
    return TRate(freq=100, per_ns=3600 * NANO)


@pytest.mark.parametrize("wire_mode", ["delta", "aggregate", "compat"])
def test_two_port_nodes_converge(wire_mode, budget):
    addrs = [f"127.0.0.1:{free_port()}" for _ in range(2)]
    nodes = []
    try:
        for a in addrs:
            nodes.append(Node(port_cmd(a, addrs, wire_mode=wire_mode)))
        cmds = [n.cmd for n in nodes]
        if wire_mode == "delta":
            wait_capable(cmds, budget)
        launches0 = profiling.COUNTERS.get("ingest_raw_device_dispatches")
        names = [f"m{i}" for i in range(24)]
        admitted = drive_takes(cmds, names, 120, _port_rate, seed=1)
        view = converge(cmds, names, budget)
        assert admitted == 120  # 100-token buckets, 5 takes a name on average
        assert taken_tokens(view) == admitted
        stats = [c.replicator.stats() for c in cmds]
        assert all(s["replication_rx_packets"] > 0 for s in stats)
        dv2 = [s["wire_delta_rx_packets"] for s in stats]
        if wire_mode == "delta":
            # Every dv2 datagram went through the raw decode+fold path.
            assert all(r > 0 for r in dv2)
            assert profiling.COUNTERS.get("ingest_raw_device_dispatches") > launches0
        else:
            assert dv2 == [0, 0]
    finally:
        for n in nodes:
            n.close()


def _incast_case(budget, loop_lag_s=0.0):
    addrs = [f"127.0.0.1:{free_port()}" for _ in range(2)]
    first = Node(port_cmd(addrs[0], addrs))
    r0 = first.cmd.replicator
    ae = r0.antientropy
    second = None
    try:
        # The second node is down while the first spends: its broadcasts
        # are lost. Anti-entropy on peer heal would also bring the bucket
        # over (both packages do; see test_antientropy_binds_a_fresh_node),
        # so the first node runs without it: it sends no digest and ignores
        # the fresh node's, and only incast can bring the state over.
        r0.antientropy = None
        if loop_lag_s:
            # A busy host: the first node's loop runs late, after the takes
            # have queued their broadcasts on it.
            first.loop.call_soon_threadsafe(time.sleep, loop_lag_s)
        replies = []
        reply_incast = r0._reply_incast

        def spy(name, addr, multi_ok=False):
            replies.append(name)
            return reply_incast(name, addr, multi_ok)

        r0._reply_incast = spy
        for _ in range(5):
            assert first.cmd.repo.take("cold", _port_rate(None), 1)[1]
        # The broadcasts are sent, and lost, before the second node binds
        # its port: a loop that sent them late would deliver them to it.
        first.drain()
        second = Node(port_cmd(addrs[1], addrs))
        fresh = second.cmd
        assert fresh.engine.directory.lookup("cold") is None
        remaining, ok = fresh.repo.take("cold", _port_rate(None), 1)
        assert ok and remaining == 99  # served on its own view first
        view = converge([first.cmd, fresh], ["cold"], budget)
        assert taken_tokens(view) == 6
        lanes = {st[4]: st[7] for st in view["cold"]}
        assert lanes == {first.cmd.replicator.slots.self_slot: 5 * NANO,
                         fresh.replicator.slots.self_slot: NANO}
        # Incast delivered it: the first node answered the request, and the
        # fresh node fetched nothing by anti-entropy.
        assert "cold" in replies
        assert fresh.replicator.stats()["ae_fetches_tx"] == 0
    finally:
        if second is not None:
            second.close()
        first.close()
        ae.close()


def test_incast_rehydrates_a_fresh_node(budget):
    _incast_case(budget)


@pytest.mark.parametrize("loop_lag_s", [0.004, 0.008])
def test_incast_holds_under_a_lagging_loop(loop_lag_s, budget):
    """The set-up's own check: with the first node's loop held back by a
    few milliseconds (about the fresh node's start-up), its queued
    broadcasts would land on the fresh node once it binds, unless the set-up
    waits for them to be sent first."""
    _incast_case(budget, loop_lag_s)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_antientropy_binds_a_fresh_node(package, budget):
    """The reference behaviour the incast test steers around: a node that
    starts after its peer spent learns the bucket from the peer's
    anti-entropy digest on heal, with no take of its own, in either
    package."""
    make = {"jax": jax_cmd, "port": port_cmd}[package]
    rate = {"jax": JRate, "port": TRate}[package](freq=100, per_ns=3600 * NANO)
    addrs = [f"127.0.0.1:{free_port()}" for _ in range(2)]
    first = Node(make(addrs[0], addrs))
    second = None
    try:
        for _ in range(5):
            assert first.cmd.repo.take("cold", rate, 1)[1]
        second = Node(make(addrs[1], addrs))
        fresh = second.cmd
        while fresh.engine.directory.lookup("cold") is None:
            assert time.monotonic() < budget, "anti-entropy did not bind the bucket"
            time.sleep(0.01)
        view = converge([first.cmd, fresh], ["cold"], budget)
        assert taken_tokens(view) == 5
        assert fresh.replicator.stats()["ae_fetches_tx"] >= 1
    finally:
        if second is not None:
            second.close()
        first.close()


# A tests/test_chaos.py delta-wire schedule: seeded drop/dup/reorder on
# every link.
CHAOS = dict(drop=0.3, dup=0.3, reorder=0.3)


@pytest.mark.parametrize("faults", [False, True], ids=["clean", "faultnet"])
def test_mixed_cluster_converges(monkeypatch, faults, budget):
    # Host fast path off on the JAX node: every take rides its device
    # queue, as on the port, so bucket creation races no host lanes.
    monkeypatch.setattr(jengine_mod, "HOST_FASTPATH", False)
    monkeypatch.setattr(tengine_mod, "HOST_FASTPATH", False)
    addrs = [f"127.0.0.1:{free_port()}" for _ in range(2)]
    nodes = []
    try:
        nodes.append(Node(jax_cmd(addrs[0], addrs)))
        nodes.append(Node(port_cmd(addrs[1], addrs)))
        cmds = [n.cmd for n in nodes]
        wait_capable(cmds, budget)
        rates = {id(cmds[0]): JRate(freq=100, per_ns=3600 * NANO),
                 id(cmds[1]): TRate(freq=100, per_ns=3600 * NANO)}
        names = [f"x{i}" for i in range(16)]
        # Prime every bucket on both nodes, converged, before any fault.
        for c in cmds:
            for nm in names:
                assert c.repo.take(nm, rates[id(c)], 1)[1]
        converge(cmds, names, budget)
        nets = []
        if faults:
            for i, c in enumerate(cmds):
                fn = FaultNet(seed=77 + i, self_addr=c.node_addr)
                fn.link(**CHAOS)
                c.replicator.faultnet = fn
                nets.append(fn)
        admitted = 2 * len(names) + drive_takes(
            cmds, names, 64, lambda c: rates[id(c)], seed=2
        )
        for fn in nets:
            fn.heal()
            fn.link()  # clean links; held packets still release
        view = converge(cmds, names, budget, retrigger=faults)
        assert admitted == 2 * len(names) + 64
        assert taken_tokens(view) == admitted
        stats = [c.replicator.stats() for c in cmds]
        assert all(s["wire_delta_rx_packets"] > 0 for s in stats)
        if faults:
            assert sum(fn.dropped + fn.duplicated + fn.reordered for fn in nets) > 0
    finally:
        for c in cmds if nodes else ():
            c.replicator.faultnet = None
        for n in nodes:
            n.close()


def test_v1_reference_peer_interoperates(budget):
    addrs = sorted(f"127.0.0.1:{free_port()}" for _ in range(2))
    v1 = V1Node(addrs[1], [addrs[0]], clock=lambda: FROZEN)
    node = None
    try:
        node = Node(port_cmd(addrs[0], addrs))
        cmd = node.cmd
        # The v1 peer never answers the dv2 advert: it stays on the
        # classic per-state plane.
        assert cmd.repo.take("mix", _port_rate(None), 2)[1]
        while True:
            b, existed = v1.repo.get_bucket("mix")
            if existed and b.taken_nt >= 2 * NANO:
                break
            assert time.monotonic() < budget, "the v1 peer did not learn the take"
            time.sleep(0.02)
        assert b.taken_nt == 2 * NANO
        assert cmd.replicator.delta.capable_peers() == []
        # The other way: the v1 peer's scalar state reaches the port node,
        # attributed to the v1 peer's lane by deficit attribution.
        v1_slot = cmd.replicator.slots.resolve(v1.addr)
        assert v1.take("mix", _port_rate(None), 3)[1]
        while True:
            cmd.engine.flush(10)
            lanes = {st.origin_slot: st.lane_taken_nt for st in cmd.repo.snapshot("mix")}
            if lanes.get(v1_slot):
                break
            assert time.monotonic() < budget, "the port node did not learn the v1 state"
            time.sleep(0.02)
        assert lanes == {cmd.replicator.slots.self_slot: 2 * NANO, v1_slot: 3 * NANO}
        # A stray dv2 datagram at the v1 peer is read as an incast request
        # for the reserved channel name: never merged.
        rx_before = v1.rx_packets
        data, _ = wire.encode_delta_packet(0, 1, (), [wire.DeltaEntry("ghost", 0, 0, 5, 5, 0)])
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.sendto(data, v1.addr)
        while v1.rx_packets == rx_before:
            assert time.monotonic() < budget, "the v1 peer did not receive the datagram"
            time.sleep(0.02)
        assert "ghost" not in v1.repo._buckets
    finally:
        if node is not None:
            node.close()
        v1.close()


def test_interval_loss_falls_back_to_full_state_and_heals(budget):
    """tests/test_chaos.py's fallback schedule on two port nodes: the first
    node hears nothing, so its interval log overflows; the delta plane
    drops it, hands repair to anti-entropy, and the nodes reconverge once
    the link heals."""
    addrs = [f"127.0.0.1:{free_port()}" for _ in range(2)]
    nodes = []
    try:
        for a in addrs:
            nodes.append(Node(port_cmd(a, addrs)))
        cmds = [n.cmd for n in nodes]
        wait_capable(cmds, budget)
        for c in cmds:
            c.replicator.health.configure(probe_interval_s=0.15, alive_ttl_s=0.5, backoff_cap_s=0.4)
            c.replicator.antientropy.min_interval_s = 0.5
        r0 = cmds[0].replicator
        r0.delta.retransmit_ticks = 10**9  # never resend: only the fallback repairs
        r0.delta.max_unacked_intervals = 2
        fn = FaultNet(seed=3, self_addr=cmds[0].node_addr)
        fn.link(drop=1.0)  # the first node hears nothing: every ack is lost
        r0.faultnet = fn
        takes = 0
        while r0.delta.stats()["wire_fullstate_fallbacks"] == 0:
            assert time.monotonic() < budget, "the interval log never overflowed"
            assert cmds[0].repo.take("fallback", _port_rate(None), 1)[1]
            takes += 1
            time.sleep(0.05)
        r0.faultnet = None
        view = converge(cmds, ["fallback"], budget, retrigger=True)
        assert taken_tokens(view) == takes
    finally:
        for n in nodes:
            n.close()
