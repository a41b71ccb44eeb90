"""A v1-semantics (reference-behavior) Patrol node, for mixed-cluster interop.

This is a thin UDP node around the exact-semantics host model
(:mod:`patrol_tpu_torch.runtime.bucket`): scalar CRDT state per bucket, field-wise
scalar max merge (bucket.go:240-263), lazy capacity init folded into
``added`` (bucket.go:194-196), full-state v1 wire packets with NO trailer —
exactly what a reference Go node puts on the wire (repo.go:20-169).

Two purposes:

1. **Interop proof.** `tests/test_interop.py` runs a loopback cluster of one
   TPU node and one of these and asserts both directions converge to the
   reference's observable admission behavior — the contract that lets a
   patrol_tpu node join an existing reference deployment.
2. **Migration bridge.** Operators can run this pure-host node where no
   accelerator exists, speaking the same protocol as both worlds.

Every state change broadcasts full state to all peers; a zero-state packet
is an incast request answered by unicast (repo.go:78-90). Single receive
thread, like the reference's single Receive goroutine (repo.go:54-92).
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import List, Optional, Sequence, Tuple

from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.ops.rate import Rate
from patrol_tpu_torch.runtime.bucket import Bucket, ClockFn, LocalRepo, system_clock
from patrol_tpu_torch.net.replication import parse_addr, _resolve

log = logging.getLogger("patrol.v1node")

Addr = Tuple[str, int]


class V1Node:
    """Reference-semantics node: LocalRepo + scalar merge + v1 UDP wire."""

    def __init__(
        self,
        node_addr: str,
        peer_addrs: Sequence[str] = (),
        clock: ClockFn = system_clock,
    ):
        self.clock = clock
        self.repo = LocalRepo(clock)
        host, port = parse_addr(node_addr)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        self.sock.settimeout(0.1)  # the reference's cancellable read deadline
        self.peers: List[Addr] = [
            _resolve(p) for p in dict.fromkeys(peer_addrs) if p != node_addr
        ]
        self.rx_packets = 0
        self.tx_packets = 0
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._receive_loop, name="patrol-v1-rx", daemon=True
        )
        self._thread.start()

    @property
    def addr(self) -> Addr:
        return self.sock.getsockname()[:2]

    # -- the reference hot path (api.go:51-86, in-process form) --------------

    def take(self, name: str, rate: Rate, count: int = 1) -> Tuple[int, bool]:
        """get-or-create → Take at clock() → broadcast full state, exactly
        the reference's /take flow including broadcast-on-failure
        (api.go:67-85, README.md:41-43)."""
        bucket, _ = self.repo.get_bucket(name)
        remaining, ok = bucket.take(self.clock(), rate, count)
        self.repo.upsert_bucket(bucket)
        self._broadcast(bucket)
        return remaining, ok

    def tokens(self, name: str) -> int:
        bucket, existed = self.repo.get_bucket(name)
        return bucket.tokens() if existed else 0

    def request_state(self, name: str) -> None:
        """Broadcast an incast request (zero-state packet, repo.go:99-103)."""
        data = wire.encode(wire.WireState(name=name, added=0.0, taken=0.0, elapsed_ns=0))
        for peer in self.peers:
            self.sock.sendto(data, peer)
            self.tx_packets += 1

    # -- wire ----------------------------------------------------------------

    def _to_wire(self, b: Bucket) -> wire.WireState:
        # v1 packet: float64 tokens, no trailer — byte-for-byte what a
        # reference node emits (bucket.go:51-68).
        return wire.WireState(
            name=b.name,
            added=b.added_nt / wire.NANO,
            taken=b.taken_nt / wire.NANO,
            elapsed_ns=b.elapsed_ns,
        )

    def _broadcast(self, b: Bucket) -> None:
        if b.is_zero():
            return  # zero state on the wire is the incast request marker
        data = wire.encode(self._to_wire(b))
        for peer in self.peers:
            try:
                self.sock.sendto(data, peer)
                self.tx_packets += 1
            except OSError:
                pass

    def _receive_loop(self) -> None:
        """One packet per iteration, scalar merge on receipt — the
        reference's Receive loop shape (repo.go:54-92)."""
        buf = bytearray(wire.PACKET_SIZE)
        while not self._stopped.is_set():
            try:
                n, addr = self.sock.recvfrom_into(buf)
            except socket.timeout:
                continue
            except OSError:
                if self._stopped.is_set():
                    return
                continue
            self.rx_packets += 1
            try:
                remote = wire.decode(bytes(buf[:n]))
            except ValueError:
                continue
            if not remote.is_zero():
                # State update: get-or-create, scalar max merge
                # (repo.go:78-80 → bucket.go:240-263). Trailer bytes from v2
                # peers are ignored, like the reference decoder.
                local, _ = self.repo.get_bucket(remote.name)
                local.merge(
                    Bucket(
                        name=remote.name,
                        added_nt=remote.added_nt,
                        taken_nt=remote.taken_nt,
                        elapsed_ns=max(remote.elapsed_ns, 0),
                    )
                )
            else:
                # Incast request: unicast our state back if non-zero
                # (repo.go:86-90).
                local, existed = self.repo.get_bucket(remote.name)
                if existed and not local.is_zero():
                    try:
                        self.sock.sendto(wire.encode(self._to_wire(local)), addr)
                        self.tx_packets += 1
                    except OSError:
                        pass

    def close(self) -> None:
        self._stopped.set()
        self._thread.join(timeout=2)
        self.sock.close()


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run a standalone v1-semantics node: the migration bridge for hosts
    without an accelerator, speaking the reference protocol on the wire.

    python -m patrol_tpu_torch.net.v1node --node-addr H:P [--peer-addr H:P]...
    """
    import argparse
    import time

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--node-addr", default="127.0.0.1:16000")
    p.add_argument("--peer-addr", action="append", default=[], dest="peer_addrs")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    node = V1Node(args.node_addr, args.peer_addrs)
    log.info(
        "v1 node serving on %s (%d peers)", args.node_addr, len(node.peers)
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        node.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
