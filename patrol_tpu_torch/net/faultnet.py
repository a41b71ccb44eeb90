"""faultnet — a deterministic, seedable fault-injection transport shim.

The chaos story before this module was one ad-hoc hook: ``drop_addr``, a
boolean predicate bolted onto each replication backend, good for exactly
one fault (symmetric partition) and impossible to replay. This module
replaces it with a *scripted* wire: per-link drop / duplicate / reorder /
delay / corrupt probabilities plus timed partition+heal schedules, all
driven by per-link ``random.Random`` streams derived from one seed — the
same seed replays the same fault schedule packet-for-packet, which is what
lets the chaos suite assert *bit-exact* convergence to the no-fault
fixpoint instead of "eventually something converged".

One interface, both backends. Faults are applied at the RECEIVE side of
each node (``Replicator.datagram_received`` / the native rx loop), which
on a loopback cluster is observationally identical to faults on the wire:

* :meth:`FaultNet.filter` — called per received datagram; returns the
  list of payloads to deliver *now* (``[]`` = dropped, two entries =
  duplicated, a mangled copy = corrupted). Reordered/delayed packets are
  held internally.
* :meth:`FaultNet.due` — releases held (delayed / reorder-stranded)
  packets whose time has come; rx loops call it on their idle tick.

Corruption model: real UDP corruption is caught by the kernel checksum
and dropped; what reaches userspace of a corrupt packet in practice is a
*truncated or garbled* datagram. ``corrupt`` therefore mangles packets
into forms the wire codec must REJECT (truncation below the fixed
header + bit flips) — the suite asserts they are counted as rx errors and
never merged, so corruption schedules still converge bit-exactly.
Valid-but-hostile packets (decodable garbage) are a separate test class
(ingest clamps, trailer checksums) and deliberately not part of the
convergence schedule.

Partitions: :meth:`partition` takes node-address groups; a packet is
dropped while the schedule is active and the sender's group differs from
this node's. Timed schedules (``after_s`` / ``duration_s``) heal
themselves; :meth:`heal` heals immediately. Per-node attachment means a
cluster-wide partition is scripted by giving every node the same groups
(see tests/test_chaos.py helpers).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Addr = Tuple[str, int]

# How long a reorder-held packet waits for a successor on its link before
# due() releases it anyway — a held packet must never be a silent drop.
REORDER_TTL_S = 0.2


def _as_addr(a) -> Addr:
    if isinstance(a, tuple):
        return (a[0], int(a[1]))
    host, _, port = str(a).rpartition(":")
    return (host or "127.0.0.1", int(port))


def _link_seed(seed: int, addr: Addr) -> int:
    # FNV-1a over the address bytes, mixed with the net seed: per-link
    # streams are independent of arrival interleaving across links.
    h = 0xCBF29CE484222325
    for b in f"{addr[0]}:{addr[1]}".encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h ^ (seed * 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF)


class LinkFaults:
    """Fault probabilities for one link (or the default for all links)."""

    __slots__ = ("drop", "dup", "reorder", "delay_s", "corrupt")

    def __init__(
        self,
        drop: float = 0.0,
        dup: float = 0.0,
        reorder: float = 0.0,
        delay_s: float = 0.0,
        corrupt: float = 0.0,
    ):
        self.drop = drop
        self.dup = dup
        self.reorder = reorder
        self.delay_s = delay_s
        self.corrupt = corrupt

    def any(self) -> bool:
        return bool(
            self.drop or self.dup or self.reorder or self.delay_s or self.corrupt
        )


class _LinkState:
    __slots__ = ("rng", "faults", "held_reorder", "held_delay")

    def __init__(self, rng: random.Random, faults: LinkFaults):
        self.rng = rng
        self.faults = faults
        # (payload, release_not_before) — released by the next packet on
        # this link or by due() after REORDER_TTL_S.
        self.held_reorder: List[Tuple[bytes, float]] = []
        self.held_delay: List[Tuple[bytes, float]] = []


class FaultNet:
    """Per-node scripted fault injection. Thread-safe: the asyncio loop,
    the native rx thread, and test threads may all poke it."""

    def __init__(self, seed: int = 0, self_addr=None, clock=time.monotonic):
        self.seed = seed
        self.self_addr: Optional[Addr] = _as_addr(self_addr) if self_addr else None
        self.clock = clock
        self._mu = threading.Lock()
        self._default = LinkFaults()
        self._links: Dict[Addr, _LinkState] = {}
        self._link_cfg: Dict[Addr, LinkFaults] = {}
        # Partition schedule: (group_of: addr→gid, start, end|None).
        self._partition: Optional[Tuple[Dict[Addr, int], float, Optional[float]]] = None
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0
        self.delayed = 0
        self.corrupted = 0
        self.partition_dropped = 0

    # -- scripting -----------------------------------------------------------

    def link(self, peer=None, **faults) -> "FaultNet":
        """Script faults for one peer address (or, with ``peer=None``, the
        default applied to every link). Returns self for chaining."""
        cfg = LinkFaults(**faults)
        with self._mu:
            if peer is None:
                self._default = cfg
                # Live default-configured links adopt the new default in
                # place (rng stream and held packets survive a re-script);
                # explicit per-link configs win.
                for a, st in self._links.items():
                    if a not in self._link_cfg:
                        st.faults = cfg
            else:
                addr = _as_addr(peer)
                self._link_cfg[addr] = cfg
                self._links.pop(addr, None)
        return self

    def partition(
        self,
        *groups: Sequence,
        after_s: float = 0.0,
        duration_s: Optional[float] = None,
    ) -> "FaultNet":
        """Script a (possibly timed) partition between address groups.
        While active, packets from an address whose group differs from
        this node's are dropped. Addresses in no group are unaffected."""
        group_of: Dict[Addr, int] = {}
        for gid, group in enumerate(groups):
            for a in group:
                group_of[_as_addr(a)] = gid
        now = self.clock()
        end = None if duration_s is None else now + after_s + duration_s
        with self._mu:
            self._partition = (group_of, now + after_s, end)
        return self

    def heal(self) -> "FaultNet":
        with self._mu:
            self._partition = None
        return self

    # -- transport interface -------------------------------------------------

    @property
    def active(self) -> bool:
        """Any fault currently scripted (feeds the ``faultnet_active``
        health stat, so an operator can see a forgotten chaos config)."""
        with self._mu:
            if self._partition is not None:
                return True
            if self._default.any():
                return True
            return any(c.any() for c in self._link_cfg.values())

    def _state(self, addr: Addr) -> _LinkState:
        st = self._links.get(addr)
        if st is None:
            cfg = self._link_cfg.get(addr, self._default)
            st = _LinkState(random.Random(_link_seed(self.seed, addr)), cfg)
            self._links[addr] = st
        return st

    def _partitioned(self, addr: Addr, now: float) -> bool:
        part = self._partition
        if part is None or self.self_addr is None:
            return False
        group_of, start, end = part
        if now < start:
            return False
        if end is not None and now >= end:
            self._partition = None  # timed schedule healed itself
            return False
        mine = group_of.get(self.self_addr)
        theirs = group_of.get(addr)
        return mine is not None and theirs is not None and mine != theirs

    def _mangle(self, data: bytes, rng: random.Random) -> bytes:
        """Deterministic detectable corruption: truncate below the fixed
        25-byte wire header and flip a byte — every codec must reject it
        (ShortBufferError), never merge it."""
        n = rng.randrange(0, 25) if len(data) >= 25 else len(data)
        out = bytearray(data[:n])
        if out:
            i = rng.randrange(len(out))
            out[i] ^= 1 + rng.randrange(255)
        return bytes(out)

    def filter(self, data: bytes, addr, now: Optional[float] = None) -> List[bytes]:
        """Apply the link's scripted faults to one received datagram.
        Returns payloads to deliver immediately, oldest first."""
        a = _as_addr(addr)
        t = self.clock() if now is None else now
        with self._mu:
            if self._partitioned(a, t):
                self.partition_dropped += 1
                return []
            st = self._state(a)
            f, rng = st.faults, st.rng
            out: List[bytes] = []
            # A new packet on the link releases any reorder-held one
            # BEHIND itself (that's the reorder) and any due delays.
            if st.held_delay:
                ready = [p for p, due in st.held_delay if due <= t]
                st.held_delay = [(p, d) for p, d in st.held_delay if d > t]
                out.extend(ready)
            if not f.any():
                out.append(data)
                return out
            if f.drop and rng.random() < f.drop:
                self.dropped += 1
                out.extend(p for p, _ in st.held_reorder)
                st.held_reorder = []
                return out
            if f.corrupt and rng.random() < f.corrupt:
                self.corrupted += 1
                data = self._mangle(data, rng)
            if f.delay_s and rng.random() < 0.5:
                self.delayed += 1
                st.held_delay.append((data, t + f.delay_s))
                out.extend(p for p, _ in st.held_reorder)
                st.held_reorder = []
                return out
            if f.reorder and rng.random() < f.reorder and not st.held_reorder:
                self.reordered += 1
                st.held_reorder.append((data, t + REORDER_TTL_S))
                return out
            out.append(data)
            if st.held_reorder:  # deliver the held packet AFTER this one
                out.extend(p for p, _ in st.held_reorder)
                st.held_reorder = []
            if f.dup and rng.random() < f.dup:
                self.duplicated += 1
                out.append(data)
            return out

    def due(self, now: Optional[float] = None) -> List[Tuple[bytes, Addr]]:
        """Release held packets whose delay lapsed (or whose reorder wait
        timed out). Rx loops call this on their idle tick so a held packet
        is never a silent drop."""
        t = self.clock() if now is None else now
        out: List[Tuple[bytes, Addr]] = []
        with self._mu:
            for addr, st in self._links.items():
                if st.held_delay:
                    ready = [p for p, due in st.held_delay if due <= t]
                    st.held_delay = [(p, d) for p, d in st.held_delay if d > t]
                    out.extend((p, addr) for p in ready)
                if st.held_reorder:
                    ready = [p for p, due in st.held_reorder if due <= t]
                    st.held_reorder = [
                        (p, d) for p, d in st.held_reorder if d > t
                    ]
                    out.extend((p, addr) for p in ready)
        return out

    def stats(self) -> dict:
        with self._mu:
            held = sum(
                len(st.held_reorder) + len(st.held_delay)
                for st in self._links.values()
            )
        return {
            "faultnet_dropped": self.dropped,
            "faultnet_duplicated": self.duplicated,
            "faultnet_reordered": self.reordered,
            "faultnet_delayed": self.delayed,
            "faultnet_corrupted": self.corrupted,
            "faultnet_partition_dropped": self.partition_dropped,
            "faultnet_held": held,
        }
