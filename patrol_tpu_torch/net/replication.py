"""UDP replication backend (reference: ``ReplicatedRepo``, repo.go:20-169).

Protocol (identical on the wire): every state change broadcasts the sender's
full bucket state as one ≤256-byte datagram to every peer; a *zero-state*
packet is an incast request — receivers that know the bucket unicast their
state back (repo.go:78-90). No acks, no ordering, no retries: loss tolerance
comes from the CRDT (every later broadcast subsumes a lost one).

Differences by design:

* Received deltas are not merged one-at-a-time on the receive thread
  (the reference's throughput ceiling, repo.go:54-92); they are queued into
  the device engine and scatter-max-merged in microbatches.
* Outgoing packets carry the v2 origin-slot trailer so the receiver can
  address the sender's PN lane; packets from reference nodes (no trailer)
  fall back to a sender-address→slot table.
* The reference resolves each peer address on every broadcast in a goroutine
  per peer (repo.go:142-151) — and checks a shadowed error, attempting sends
  with a nil address on resolve failure (known bug, SURVEY §2). Here peers
  are resolved at startup, unresolvable peers are *excluded from the send
  list and re-resolved with backoff* (never sent to with a junk address,
  never allowed to crash the broadcast loop), and sends are synchronous
  nonblocking ``sendto`` calls on the event loop.

Resilience layer (this module + net/antientropy.py + net/faultnet.py):

* :class:`PeerHealth` — per-peer liveness from rx traffic plus lightweight
  probe pings on a reserved-name control channel, exponential backoff with
  jitter on unanswered probes, and DNS re-resolution scheduling for
  unresolvable/unreachable peers. Shared by both backends.
* Control channel: zero-state packets whose name starts with
  ``CTRL_PREFIX`` (``\\x00pt!``). On the wire they are ordinary v1 incast
  requests for names no real bucket can have (the API rejects ``\\x00``
  names long before the directory) — a reference node looks the bucket up,
  misses, and stays silent, so the channel is invisible to v1 peers.
  Carried over it: probe pings/acks (liveness) and the anti-entropy
  digest/fetch exchange (net/antientropy.py).
* Fault injection: an optional :class:`patrol_tpu_torch.net.faultnet.FaultNet`
  filters every received datagram (deterministic seeded drop / dup /
  reorder / delay / corrupt + timed partition schedules). The legacy
  ``drop_addr`` predicate is kept for the simple symmetric-partition case.
"""

from __future__ import annotations

import asyncio
import itertools
import random
import socket
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.utils import histogram as hist
from patrol_tpu_torch.utils import profiling
from patrol_tpu_torch.utils import trace as trace_mod

Addr = Tuple[str, int]

# Reserved-name control channel. No legal bucket name starts with NUL
# (net/api.py rejects control bytes in names), so these never collide
# with user buckets; on v1 peers they read as incast requests for unknown
# buckets and are silently ignored.
CTRL_PREFIX = "\x00pt!"
PROBE_NAME = CTRL_PREFIX + "probe"
PROBE_ACK_NAME = CTRL_PREFIX + "probe-ack"


def parse_addr(addr: str) -> Addr:
    host, _, port = addr.rpartition(":")
    return (host or "127.0.0.1", int(port))


def _is_ip(host: str) -> bool:
    try:
        socket.inet_aton(host)
        return True
    except OSError:
        return False


def _resolve(addr: str) -> Addr:
    host, port = parse_addr(addr)
    try:
        infos = socket.getaddrinfo(host, port, socket.AF_INET, socket.SOCK_DGRAM)
        return infos[0][4][:2]
    except socket.gaierror:
        return (host, port)


class _Peer:
    __slots__ = (
        "addr_str", "addr", "resolved", "last_rx", "ever_heard",
        "probes_sent", "failures", "next_probe_at", "backoff_s",
        "reresolves", "next_resolve_at",
    )

    def __init__(self, addr_str: str, addr: Addr, resolved: bool):
        self.addr_str = addr_str
        self.addr = addr
        self.resolved = resolved
        self.last_rx = 0.0
        self.ever_heard = False
        self.probes_sent = 0
        self.failures = 0  # consecutive probes (or resolves) unanswered
        self.next_probe_at = 0.0
        self.backoff_s = 0.0
        self.reresolves = 0
        self.next_resolve_at = 0.0


class PeerHealth:
    """Per-peer replication health, shared by both backends.

    Liveness is passive-first: ANY datagram from a peer marks it alive for
    ``alive_ttl_s``. When a peer has been silent past ``probe_interval_s``
    the owner backend sends a probe ping (a reserved-name zero-state
    packet, one datagram; patrol peers ack, reference peers ignore it);
    consecutive unanswered probes back off exponentially with jitter up to
    ``backoff_cap_s``, so a dead peer costs O(log) traffic, not a steady
    ping stream. Unresolvable peers (startup resolve failure, or repeated
    probe failure on a hostname peer) are scheduled for re-resolution on
    the same backoff — the reference's shadowed-error resolve bug class
    (SURVEY §2) made nil-address *sends*; here the peer simply drops out
    of the fan-out until DNS answers, and is reported via ``stats()``.

    Liveness NEVER gates data broadcasts: a reference (v1) peer answers no
    probes yet must keep receiving state. Only unresolved peers are
    excluded from the fan-out (there is no address to send to).

    Suspect demotion (elastic membership, ROADMAP 3b): a peer whose
    consecutive unanswered probes reach ``suspect_after`` is demoted to a
    *suspect* state — an observable signal (``stats()['peer_suspect']``,
    :meth:`is_suspect`) for operators and the membership plane. Suspicion
    gates NOTHING on the data path: a suspect peer keeps receiving
    broadcasts and its rx keeps being merged (its next datagram instantly
    heals it). Only an explicit admin ``remove`` retires a lane.

    Thread-safety: mutated by the owner backend's single rx/health
    context; ``stats()`` readers take the same lock.
    """

    def __init__(
        self,
        clock=time.monotonic,
        seed: int = 0,
        probe_interval_s: float = 1.0,
        alive_ttl_s: float = 3.0,
        backoff_cap_s: float = 15.0,
        reresolve_after: int = 2,
        suspect_after: int = 3,
    ):
        self.clock = clock
        self.probe_interval_s = probe_interval_s
        self.alive_ttl_s = alive_ttl_s
        self.backoff_cap_s = backoff_cap_s
        self.reresolve_after = reresolve_after
        self.suspect_after = suspect_after
        self._rng = random.Random(seed)
        self._mu = threading.Lock()
        self.peers: Dict[Addr, _Peer] = {}
        self.rx_from_peers = 0
        self.heals = 0  # dead→alive transitions observed

    def add_peer(self, addr_str: str, addr: Addr, resolved: bool) -> _Peer:
        p = _Peer(addr_str, addr, resolved)
        with self._mu:
            self.peers[addr] = p
        return p

    def remove_peer(self, addr: Addr) -> None:
        """Forget a departed peer (membership leave): stops probing it.
        Late datagrams from the address still ingest fine — on_rx simply
        finds no health entry."""
        with self._mu:
            self.peers.pop(addr, None)

    def is_suspect(self, addr: Addr) -> bool:
        with self._mu:
            p = self.peers.get(addr)
            return p is not None and p.resolved and p.failures >= self.suspect_after

    def configure(
        self,
        probe_interval_s: Optional[float] = None,
        alive_ttl_s: Optional[float] = None,
        backoff_cap_s: Optional[float] = None,
    ) -> None:
        """Re-tune intervals at runtime (chaos tests shrink them); resets
        every peer's probe schedule so the new cadence applies now."""
        with self._mu:
            if probe_interval_s is not None:
                self.probe_interval_s = probe_interval_s
            if alive_ttl_s is not None:
                self.alive_ttl_s = alive_ttl_s
            if backoff_cap_s is not None:
                self.backoff_cap_s = backoff_cap_s
            for p in self.peers.values():
                p.next_probe_at = 0.0
                p.backoff_s = min(p.backoff_s, self.backoff_cap_s)

    def on_rx(self, addr: Addr) -> Optional[Addr]:
        """Record traffic from ``addr``. Returns the address when the peer
        transitioned quiet→alive (first contact, or silence past the
        alive TTL) — the caller's anti-entropy trigger."""
        with self._mu:
            p = self.peers.get(addr)
            if p is None:
                return None
            now = self.clock()
            was_dead = (not p.ever_heard) or (now - p.last_rx > self.alive_ttl_s)
            p.last_rx = now
            p.ever_heard = True
            p.failures = 0
            p.backoff_s = 0.0
            p.next_probe_at = now + self.probe_interval_s
            self.rx_from_peers += 1
            if was_dead:
                self.heals += 1
                return addr
            return None

    def tick(self) -> Tuple[List[Addr], List[_Peer]]:
        """Advance the probe/backoff schedule. Returns (addresses to probe
        now, peers whose address should be re-resolved now). The caller
        sends the probes / runs the resolves — this class never touches
        sockets or DNS itself."""
        probes: List[Addr] = []
        resolves: List[_Peer] = []
        with self._mu:
            now = self.clock()
            for p in self.peers.values():
                if not p.resolved:
                    if now >= p.next_resolve_at:
                        p.failures += 1
                        p.backoff_s = self._backoff(p.failures)
                        p.next_resolve_at = now + p.backoff_s
                        resolves.append(p)
                    continue
                if now - p.last_rx <= self.probe_interval_s:
                    continue  # recently heard; no probe needed
                if now < p.next_probe_at:
                    continue
                p.probes_sent += 1
                p.failures += 1
                p.backoff_s = self._backoff(p.failures)
                p.next_probe_at = now + p.backoff_s
                probes.append(p.addr)
                if (
                    p.failures >= self.reresolve_after
                    and not _is_ip(parse_addr(p.addr_str)[0])
                ):
                    resolves.append(p)
        if probes:
            profiling.COUNTERS.inc("peer_probes_tx", len(probes))
        return probes, resolves

    def _backoff(self, failures: int) -> float:
        """Exponential with jitter: base × 2^(n−1), jittered ×[0.75, 1.25],
        capped. Jitter keeps a cluster's probes to a dead peer from
        synchronizing into bursts."""
        base = self.probe_interval_s * (2 ** min(failures - 1, 8))
        return min(base, self.backoff_cap_s) * (0.75 + 0.5 * self._rng.random())

    def mark_resolved(self, p: _Peer, new_addr: Addr) -> None:
        """Adopt a (re)resolved address for a peer: re-key the map, reset
        the failure schedule. Caller updates slot tables / fan-out lists."""
        with self._mu:
            self.peers.pop(p.addr, None)
            p.addr = new_addr
            p.resolved = True
            p.failures = 0
            p.backoff_s = 0.0
            p.next_probe_at = 0.0
            p.reresolves += 1
            self.peers[new_addr] = p
        profiling.COUNTERS.inc("peer_reresolves")

    def alive_count(self) -> int:
        with self._mu:
            now = self.clock()
            return sum(
                1
                for p in self.peers.values()
                if p.ever_heard and now - p.last_rx <= self.alive_ttl_s
            )

    def stats(self) -> dict:
        with self._mu:
            now = self.clock()
            alive = 0
            backoff_ms = 0
            unresolved = 0
            probes = 0
            reresolves = 0
            suspect = 0
            for p in self.peers.values():
                probes += p.probes_sent
                reresolves += p.reresolves
                if not p.resolved:
                    unresolved += 1
                elif p.failures >= self.suspect_after:
                    suspect += 1
                if p.ever_heard and now - p.last_rx <= self.alive_ttl_s:
                    alive += 1
                else:
                    backoff_ms = max(backoff_ms, int(p.backoff_s * 1000))
        return {
            "peer_alive": alive,
            "peer_backoff_ms": backoff_ms,
            "peer_unresolved": unresolved,
            "peer_suspect": suspect,
            "peer_probes_tx": probes,
            "peer_reresolves": reresolves,
            "peer_heals": self.heals,
        }


def _encode_with_fallback(st: wire.WireState) -> bytes:
    """Encode a state, dropping the v2 trailer for names in
    (lane-limit, v1-limit]: receivers fall back to the sender-address slot
    table and scalar (deficit-attribution) semantics, which converge
    because the header ``added``/``taken`` stay capacity-included. Names
    beyond the v1 limit can't exist (rejected at the API)."""
    try:
        return wire.encode(st)
    except wire.NameTooLargeError:
        return wire.encode(
            wire.WireState(
                name=st.name,
                added=st.added,
                taken=st.taken,
                elapsed_ns=st.elapsed_ns,
            )
        )


class ReplyGate:
    """Responder-side incast reply pacing: ONE reply burst per (bucket,
    requester) per TTL. Bounds the cold-start storm amplification: a
    flagship-shape 256-lane bucket answers a multi
    request with ⌈lanes / lanes-per-packet⌉ ≈ 22 packets (ops/wire.py
    pack_multi), so M repeated requests inside one convergence RTT would
    otherwise emit 22×M. The requester side already dedups
    (repo._maybe_incast); this closes the other half — a buggy, hostile,
    or simply slow-converging requester re-asking in a tight loop.

    NOT thread-safe by design: each replication backend owns one gate and
    drives it from its single rx context (asyncio loop / native rx
    thread)."""

    def __init__(self, ttl_s: float = 0.2, cap: int = 4096):
        self.ttl_s = ttl_s
        self.cap = cap
        self.suppressed = 0
        self._seen: Dict[tuple, float] = {}

    def allow(self, name: str, addr) -> bool:
        now = time.monotonic()
        key = (name, addr)
        if self._seen.get(key, 0.0) > now:
            self.suppressed += 1
            return False
        # pop-then-insert so dict position tracks GRANT time: a re-granted
        # expired key moves to the back, otherwise the hard-evict below
        # could drop a just-granted key as "oldest" and let its requester
        # escape the TTL gate mid-storm.
        self._seen.pop(key, None)
        self._seen[key] = now + self.ttl_s
        if len(self._seen) > self.cap:
            self._seen = {k: v for k, v in self._seen.items() if v > now}
            if len(self._seen) > self.cap:
                # A storm of >cap distinct keys inside one TTL: nothing has
                # expired, so the sweep alone would rebuild the whole dict
                # on EVERY allow (quadratic in exactly the storm this gate
                # bounds). Hard-evict the oldest half (insertion order ≈
                # grant order) so the dict stays capped and the next sweep
                # is ≥cap/2 inserts away — O(1) amortized.
                drop = len(self._seen) - self.cap // 2
                for k in list(itertools.islice(self._seen, drop)):
                    del self._seen[k]
        return True


class SlotTable:
    """Node-slot assignment: boot members get their rank in the sorted
    static member list (peers ∪ self), identical on every
    correctly-configured node. Unknown senders (e.g. reference nodes not
    in the static list) get dynamic slots from the remainder of the lane
    space — membership is static in the reference (README.md:78-86).

    Elastic membership (ROADMAP 3b) turns the table into runtime state:

    * ``add_member`` assigns the next free lane to a joiner and bumps the
      membership ``_epoch``;
    * ``remove_member`` retires a leaver's lane behind a **tombstone**
      stamped with the retirement epoch. The lane's final PN values stay
      join-absorbed forever (max-join never forgets them) and the
      addr→lane aliases are kept, so late echoes from the departed owner
      still attribute correctly and collapse into no-ops;
    * a tombstoned lane can ONLY be re-attached through :meth:`rejoin`,
      which demands the exact retirement epoch (the tombstone-epoch
      handshake) and bumps the epoch again. ``resolve`` allocates
      strictly fresh lanes (``_next_dynamic`` is monotone) and
      ``realias`` refuses tombstoned lanes — lane reuse without a
      tombstone epoch bump is structurally impossible, not merely
      discouraged.

    Lane lifecycle:  free → active → tombstoned(e) → active  (rejoin
    with epoch e only; every arrow bumps ``_epoch``).
    """

    def __init__(
        self,
        self_addr: str,
        peers: Iterable[str],
        max_slots: int,
        self_slot: Optional[int] = None,
    ):
        members = sorted(set(peers) | {self_addr})
        if len(members) > max_slots:
            raise ValueError(
                f"{len(members)} members exceed {max_slots} node lanes; "
                "raise LimiterConfig.nodes"
            )
        self.max_slots = max_slots
        self._mu = threading.Lock()
        if self_slot is None:
            self.slot_of: Dict[Addr, int] = {
                _resolve(a): i for i, a in enumerate(members)
            }
        else:
            # Rejoin boot (checkpoint restore under a possibly-new
            # address): self is PINNED to its original lane — a rank
            # recomputed over the new address could fork the node's PN
            # lane. Other members take the remaining lanes in sorted
            # order; v2 origin-slot trailers make their exact local
            # ranks cosmetic (attribution rides the wire).
            if not 0 <= self_slot < max_slots:
                raise ValueError(f"self_slot {self_slot} out of range")
            lanes = [i for i in range(max_slots) if i != self_slot]
            self.slot_of = {}
            for a in members:
                self.slot_of[_resolve(a)] = (
                    self_slot if a == self_addr else lanes.pop(0)
                )
        self.self_slot = self.slot_of[_resolve(self_addr)]
        self._next_dynamic = max(self.slot_of.values()) + 1
        # Elastic membership state (all under _mu): lane → member address
        # for ACTIVE members, the monotone membership epoch, and lane →
        # retirement-epoch tombstones.
        self._members: Dict[int, str] = {self.slot_of[_resolve(a)]: a for a in members}
        self._epoch = 0
        self._tombstones: Dict[int, int] = {}

    def resolve(self, addr: Addr) -> Optional[int]:
        slot = self.slot_of.get(addr)
        if slot is not None:
            return slot
        with self._mu:
            slot = self.slot_of.get(addr)
            if slot is not None:
                return slot
            if self._next_dynamic >= self.max_slots:
                return None
            slot = self._next_dynamic
            self._next_dynamic += 1
            self.slot_of[addr] = slot
            return slot

    def realias(self, old: Addr, new: Addr) -> None:
        """A member's address re-resolved to a new endpoint (DNS moved, or
        a hostname finally resolved): the NEW address must map to the SAME
        lane — a fresh dynamic slot would fork the peer's PN lane and
        permanently double its contribution after the old lane's state
        re-merges. The old alias is kept: late packets from the previous
        address still attribute correctly.

        A tombstoned lane is NOT realias-able: an arbitrary new endpoint
        adopting a retired lane would resurrect it without the epoch
        handshake, and its sub-tombstone counter restarts would be
        silently absorbed by the dead lane's final values (erased spend).
        Only :meth:`rejoin` — presenting the retirement epoch — may
        re-attach a tombstoned lane."""
        with self._mu:
            slot = self.slot_of.get(old)
            if slot is None or new in self.slot_of:
                return
            if slot in self._tombstones:
                return
            self.slot_of[new] = slot

    # -- elastic membership (ROADMAP 3b) ------------------------------------

    def add_member(self, addr_str: str, epoch: Optional[int] = None) -> Optional[int]:
        """Admit a joiner: assign the next FREE lane (never a tombstoned
        one — ``_next_dynamic`` is monotone) and bump the epoch. Idempotent
        for an already-active address. Returns the lane, or ``None`` when
        the lane space is exhausted or the address's lane is tombstoned
        (a retired lane needs the :meth:`rejoin` handshake).

        ``epoch`` is the ANNOUNCED assign epoch when the event arrived
        over the wire: the receiver max-joins it into its local epoch so
        every node's epoch counter converges to the admin's — the value a
        later tombstone will be stamped with. A local (admin-origin) add
        passes ``None`` and increments."""
        a = _resolve(addr_str)
        with self._mu:
            slot = self.slot_of.get(a)
            if slot is not None:
                if slot in self._tombstones:
                    return None
                if slot not in self._members:
                    # A sender we only knew dynamically is now a member.
                    self._members[slot] = addr_str
                    self._bump_epoch_locked(epoch)
                elif epoch is not None:
                    self._epoch = max(self._epoch, epoch)
                return slot
            if self._next_dynamic >= self.max_slots:
                return None
            slot = self._next_dynamic
            self._next_dynamic += 1
            self.slot_of[a] = slot
            self._members[slot] = addr_str
            self._bump_epoch_locked(epoch)
            return slot

    def _bump_epoch_locked(self, epoch: Optional[int]) -> None:
        # Local events increment; announced events max-join the admin's
        # value so independently-booted tables converge to the SAME
        # epoch sequence (the rejoin handshake compares tombstone epochs
        # across nodes with different event histories).
        if epoch is None:
            self._epoch += 1
        else:
            self._epoch = max(self._epoch, epoch)

    def remove_member(
        self, addr_str: str, epoch: Optional[int] = None
    ) -> Optional[Tuple[int, int]]:
        """Retire a leaver's lane behind a tombstone. The addr→lane alias
        is kept (stale echoes still attribute, harmlessly max-joined);
        the lane leaves the active member set and can never be handed out
        again without the epoch handshake. Returns ``(lane,
        tombstone_epoch)`` — the leaver carries the epoch to its eventual
        rejoin — or ``None`` for self/unknown addresses. Idempotent:
        re-removing returns the original tombstone epoch.

        ``epoch`` is the ANNOUNCED tombstone epoch for wire-received
        leaves: the tombstone is stamped with the admin's value (not the
        local counter) so the leaver's rejoin credential validates on
        EVERY node, whatever subset of prior announces each one saw."""
        a = _resolve(addr_str)
        with self._mu:
            slot = self.slot_of.get(a)
            if slot is None or slot == self.self_slot:
                return None
            ts = self._tombstones.get(slot)
            if ts is not None:
                return (slot, ts)
            owner = self._members.get(slot)
            if owner is None or _resolve(owner) != a:
                # The lane outlived this alias: it is active under a
                # DIFFERENT address (the leaver already rejoined under a
                # new one) or was never an admitted member. Only the
                # CURRENT owner's leave retires a lane — a stale or
                # replayed leave arriving after the rejoin must not
                # re-tombstone it (the re-announce repair path and UDP
                # reordering both produce exactly this sequence).
                return None
            self._bump_epoch_locked(epoch)
            stamp = self._epoch if epoch is None else epoch
            self._tombstones[slot] = stamp
            self._members.pop(slot, None)
            return (slot, stamp)

    def rejoin(self, addr_str: str, lane: int, epoch: int) -> bool:
        """The tombstone-epoch handshake: a node returning under a NEW
        address re-attaches to its ORIGINAL lane by presenting the exact
        epoch at which that lane was tombstoned. A match pops the
        tombstone, bumps the epoch, and aliases the new address onto the
        lane; anything else is rejected — this is the only arrow from
        tombstoned(e) back to active."""
        new = _resolve(addr_str)
        with self._mu:
            if (
                self.slot_of.get(new) == lane
                and lane not in self._tombstones
            ):
                # Already applied: the new address owns the lane. A
                # replayed handshake (re-announce repair) is a success
                # with NO epoch bump — idempotence, not a transition.
                return True
            ts = self._tombstones.get(lane)
            if ts is None or ts != epoch:
                return False
            existing = self.slot_of.get(new)
            if existing is not None and existing != lane:
                return False  # the new address already owns another lane
            del self._tombstones[lane]
            self._epoch += 1
            self.slot_of[new] = lane
            self._members[lane] = addr_str
            return True

    def restore_epoch(self, epoch) -> None:
        """Max-join a checkpoint-saved epoch back in at boot. The epoch
        is the one truly monotone piece of the membership view: a
        restarted node that regressed it to 0 could (as admin) re-issue
        assign/tombstone epochs that collide with history, breaking the
        exact-epoch rejoin handshake cluster-wide. Tombstones are NOT
        restored — lanes may have legitimately rejoined while this node
        was down, and a stale tombstone would evict the new owner."""
        if isinstance(epoch, int):
            with self._mu:
                self._epoch = max(self._epoch, epoch)

    @property
    def epoch(self) -> int:
        with self._mu:
            return self._epoch

    def is_tombstoned(self, lane: int) -> bool:
        with self._mu:
            return lane in self._tombstones

    def tombstone_epoch(self, lane: int) -> Optional[int]:
        with self._mu:
            return self._tombstones.get(lane)

    def view(self) -> dict:
        """Admin snapshot of the membership state (GET /admin/peers)."""
        with self._mu:
            return {
                "epoch": self._epoch,
                "self_slot": self.self_slot,
                "members": {str(s): a for s, a in sorted(self._members.items())},
                "tombstones": {str(s): e for s, e in sorted(self._tombstones.items())},
                "next_dynamic": self._next_dynamic,
                "max_slots": self.max_slots,
            }


class Replicator(asyncio.DatagramProtocol):
    """One UDP socket for send + receive, like the reference's single
    ``net.PacketConn`` (repo.go:31). Constructed via :meth:`create`.

    ``wire_mode`` gates the outgoing wire form (ops/wire.py module docs):
    ``"aggregate"`` (default) sends the dual-payload form — flag-day
    upgrade from pre-lane-trailer patrol_tpu builds; ``"compat"`` sends
    raw own-lane headers + base trailers every build can parse, for
    rolling upgrades; ``"delta"`` ships batched delta-interval datagrams
    (net/delta.py) to peers that advertised the v2 capability and the
    aggregate form to everyone else. Receiving deltas is unconditional —
    any build with the delta plane accepts them in every mode."""

    def __init__(
        self,
        node_addr: str,
        peer_addrs: Sequence[str],
        slots: SlotTable,
        log=None,
        wire_mode: str = "aggregate",
    ):
        self.node_addr = node_addr
        self.slots = slots
        self.log = log
        if wire_mode == "full":
            wire_mode = "aggregate"  # the CLI's opt-out alias
        if wire_mode not in ("aggregate", "compat", "delta"):
            raise ValueError(f"unknown wire_mode {wire_mode!r}")
        self.wire_mode = wire_mode
        self.transport: Optional[asyncio.DatagramTransport] = None
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.repo = None  # set by the supervisor (TPURepo)
        self.reply_gate = ReplyGate()
        self.rx_packets = 0
        self.rx_errors = 0
        self.tx_packets = 0
        self.tx_bytes = 0
        self.send_errors = 0  # OSErrors surfaced by the transport
        # Self-filtering peer list (repo.go:36-41); unresolvable peers are
        # health-tracked for re-resolution but EXCLUDED from the fan-out —
        # the reference's shadowed-error resolve bug attempted sends with
        # a nil address (SURVEY §2); we degrade gracefully instead.
        self.health = PeerHealth()
        self.peers: List[Addr] = []
        for p in dict.fromkeys(peer_addrs):
            if p == node_addr:
                continue
            a = _resolve(p)
            ok = _is_ip(a[0])
            self.health.add_peer(p, a, resolved=ok)
            if ok:
                self.peers.append(a)
            elif log:
                log.warning("peer %s unresolvable at startup; will retry", p)
        # Fault injection (the network-layer sibling of -clock-offset,
        # main.go:30): a predicate addr→bool; True drops traffic to/from
        # that address, simulating a partition. Settable at runtime.
        self.drop_addr: Optional[callable] = None
        # Scripted fault injection (net/faultnet.py): filters every
        # received datagram when set. Settable at runtime.
        self.faultnet = None
        from patrol_tpu_torch.net.antientropy import AntiEntropy
        from patrol_tpu_torch.net.audit import AuditPlane
        from patrol_tpu_torch.net.delta import DeltaPlane
        from patrol_tpu_torch.net.fleet import FleetPlane

        self.antientropy = AntiEntropy(self)
        # Wire-v2 delta-interval plane (net/delta.py): tx gated on
        # wire_mode == "delta" + per-peer capability; rx always on.
        self.delta = DeltaPlane(self)
        if self.wire_mode == "delta":
            self.delta.start()
        # patrol-fleet metrics-lattice gossip (net/fleet.py): paced
        # join-decompositions of the histogram/counter lattices on the
        # control channel. Gossip only runs when there is a fleet.
        self.fleet = FleetPlane(self)
        # patrol-audit consistency plane (net/audit.py): replication lag,
        # read-only divergence digests, AP-overshoot auditor. Like the
        # fleet gossip, the paced tick only runs when there are peers.
        self.audit = AuditPlane(self)
        # Elastic membership (net/membership.py): runtime join / leave /
        # rejoin events over the control channel, driving SlotTable lane
        # lifecycle + this backend's fan-out list.
        from patrol_tpu_torch.net.membership import MembershipPlane

        self.membership = MembershipPlane(self)
        if self.peers:
            self.fleet.start()
            self.audit.start()
        self._health_task: Optional[asyncio.Task] = None
        self._health_tick_s = 0.1
        self._probe_bytes = wire.encode(
            wire.WireState(name=PROBE_NAME, added=0.0, taken=0.0, elapsed_ns=0)
        )
        self._probe_ack_bytes = wire.encode(
            wire.WireState(name=PROBE_ACK_NAME, added=0.0, taken=0.0, elapsed_ns=0)
        )

    @classmethod
    async def create(
        cls,
        node_addr: str,
        peer_addrs: Sequence[str],
        slots: SlotTable,
        log=None,
        wire_mode: str = "aggregate",
    ) -> "Replicator":
        loop = asyncio.get_running_loop()
        self = cls(node_addr, peer_addrs, slots, log, wire_mode=wire_mode)
        self.loop = loop
        host, port = parse_addr(node_addr)
        await loop.create_datagram_endpoint(lambda: self, local_addr=(host, port))
        self._health_task = asyncio.ensure_future(self._health_loop())
        return self

    def connection_made(self, transport) -> None:
        self.transport = transport

    def error_received(self, exc: OSError) -> None:
        # Unconnected-UDP send errors (ICMP unreachable, EAI failures from
        # a junk address) surface here without peer attribution; counted,
        # never fatal — the broadcast loop must survive any peer state.
        self.send_errors += 1
        if self.log:
            self.log.debug("transport error: %s", exc)

    # -- peer health / control channel --------------------------------------

    async def _health_loop(self) -> None:
        """Periodic: release faultnet-held packets, advance the probe /
        backoff / re-resolution schedule. Errors are logged, never fatal."""
        while True:
            await asyncio.sleep(self._health_tick_s)
            try:
                if self.faultnet is not None:
                    for data, addr in self.faultnet.due():
                        self._ingest(data, addr)
                probes, resolves = self.health.tick()
                for addr in probes:
                    self._send(self._probe_bytes, addr)
                for p in resolves:
                    await self._reresolve_peer(p)
                if self.membership is not None:
                    # Membership loss repair: re-announce recent local
                    # events (bounded; duplicates are receiver no-ops).
                    self.membership.maybe_replay()
            except asyncio.CancelledError:
                raise
            except Exception:
                if self.log:
                    self.log.exception("health tick failed")

    async def _reresolve_peer(self, p) -> None:
        """Re-run DNS for a peer off the event loop; adopt a changed
        address atomically across peer list, slot table, and health."""
        assert self.loop is not None
        old = p.addr
        try:
            new = await self.loop.run_in_executor(None, _resolve, p.addr_str)
        except Exception:
            return
        if not _is_ip(new[0]) or new == old:
            return
        self.slots.realias(old, new)
        self.health.mark_resolved(p, new)
        self.peers = [a for a in self.peers if a != old] + [new]
        if self.log:
            self.log.info(
                "peer re-resolved", extra={"peer": p.addr_str, "addr": f"{new[0]}:{new[1]}"}
            )

    # -- elastic membership (net/membership.py drives these) ----------------

    def _adopt_peer(self, addr_str: str) -> Optional[Addr]:
        """Add a peer to the fan-out at runtime (membership join/rejoin).
        Idempotent. Starts the paced planes if this is the first peer —
        the constructor only starts them when booted with peers."""
        if addr_str == self.node_addr:
            return None
        a = _resolve(addr_str)
        ok = _is_ip(a[0])
        if a not in self.health.peers:
            self.health.add_peer(addr_str, a, resolved=ok)
        if ok and a not in self.peers:
            # Atomic list swap: broadcast paths snapshot self.peers.
            self.peers = self.peers + [a]
        if self.peers:
            self.fleet.start()
            self.audit.start()
        return a if ok else None

    def _drop_peer(self, addr_str: str) -> None:
        """Remove a departed peer from the fan-out (membership leave).
        Its lane stays tombstoned in the SlotTable — late datagrams from
        the address still attribute correctly and max-join to no-ops."""
        a = _resolve(addr_str)
        self.peers = [p for p in self.peers if p != a]
        self.health.remove_peer(a)
        if self.delta is not None:
            self.delta.on_peer_leave(a)

    def _handle_control(self, name: str, addr: Addr) -> None:
        """Reserved-name zero-state packets: probe pings/acks and the
        anti-entropy exchange. Never creates buckets, never incast-replies."""
        if name == PROBE_NAME:
            # Ack so the prober sees liveness even on an idle link; the
            # reply gate bounds hostile probe floods like incast storms.
            if self.reply_gate.allow(PROBE_ACK_NAME, addr):
                self._send(self._probe_ack_bytes, addr)
        elif name == PROBE_ACK_NAME:
            pass  # on_rx already refreshed liveness
        elif self.delta is not None and self.delta.handle_control(name, addr):
            pass  # v2 capability advert/ack (net/delta.py)
        elif self.antientropy is not None:
            self.antientropy.handle(name, addr)

    # -- receive path (repo.go:54-92) ---------------------------------------

    def datagram_received(self, data: bytes, addr: Addr) -> None:
        if self.faultnet is not None:
            for payload in self.faultnet.filter(data, addr):
                self._ingest(payload, addr)
        else:
            self._ingest(data, addr)

    def _ingest(self, data: bytes, addr: Addr) -> None:
        if self.drop_addr is not None and self.drop_addr(addr):
            return
        self.rx_packets += 1
        t0 = time.perf_counter_ns()
        try:
            state = wire.decode(data)
        except ValueError:
            self.rx_errors += 1
            if self.log:
                self.log.debug("bad packet", extra={"peer": f"{addr[0]}:{addr[1]}"})
            return
        dur = time.perf_counter_ns() - t0
        hist.STAGE_RX_DECODE.record(dur)
        tr = trace_mod.TRACE
        if tr.enabled:
            tr.record(trace_mod.EV_RX_DECODE, dur, 1)
        if state.trace_id:
            # A sampled remote take's state broadcast: this decode span
            # joins the sender's take span via the propagated id.
            trace_mod.SPANS.add(
                state.trace_id, self.slots.self_slot, "rx_decode",
                state.name, t0, dur,
            )
        healed = self.health.on_rx(addr)
        if healed is not None:
            if self.antientropy is not None:
                # Peer (re)joined or a partition healed: reconcile divergent
                # buckets by digest instead of waiting for organic takes.
                self.antientropy.trigger(healed)
            if self.delta is not None:
                # Pending delta intervals toward a healed peer are stale;
                # full-state repair (anti-entropy) takes over.
                self.delta.on_peer_heal(healed)
        if state.is_zero() and state.name.startswith(CTRL_PREFIX):
            if state.name == wire.DELTA_CHANNEL_NAME and self.delta is not None:
                # v2 delta-interval datagram: the payload rides AFTER the
                # reserved name, invisible to the v1 decode above.
                self.delta.on_packet(data, addr)
                return
            if state.name == wire.METRICS_CHANNEL_NAME and self.fleet is not None:
                # patrol-fleet metrics gossip: same envelope trick.
                self.fleet.on_packet(data, addr)
                return
            if state.name == wire.AUDIT_CHANNEL_NAME and self.audit is not None:
                # patrol-audit digests + admitted-window lanes.
                self.audit.on_packet(data, addr)
                return
            if state.name == wire.MEMBER_CHANNEL_NAME and self.membership is not None:
                # Elastic-membership events (join/leave/rejoin).
                self.membership.on_packet(data, addr)
                return
            self._handle_control(state.name, addr)
            return
        if self.repo is None:
            return
        if not state.is_zero():
            if state.lanes is not None:
                # Multi-lane incast reply: every non-zero PN lane of the
                # bucket in one packet. Expand to per-lane merges.
                for lane_slot, la, lt in state.lanes:
                    if lane_slot >= self.slots.max_slots:
                        self.rx_errors += 1
                        continue
                    self.repo.apply_delta(
                        wire.WireState(
                            name=state.name, added=state.added, taken=state.taken,
                            elapsed_ns=state.elapsed_ns, origin_slot=lane_slot,
                            cap_nt=state.cap_nt, lane_added_nt=la, lane_taken_nt=lt,
                        ),
                        lane_slot,
                    )
                hist.RX_APPLY.record(time.perf_counter_ns() - t0)
                return
            slot = (
                state.origin_slot
                if state.origin_slot is not None and state.origin_slot < self.slots.max_slots
                else self.slots.resolve(addr)
            )
            if slot is None:
                self.rx_errors += 1
                return
            # No trailer at all ⇒ a v1 (reference) peer's scalar-max state:
            # deficit-attribution semantics at ingest (see engine.ingest_delta).
            # A base (cap-less) trailer is a prior-version patrol_tpu peer
            # whose header carries raw own-lane values — plain lane merge.
            self.repo.apply_delta(state, slot, scalar=state.origin_slot is None)
            # rx→apply: wire bytes to engine-queue handoff, per datagram.
            hist.RX_APPLY.record(time.perf_counter_ns() - t0)
            if self.log:
                self.log.debug(
                    "received",
                    extra={"peer": f"{addr[0]}:{addr[1]}", "bucket": state.name, "slot": slot},
                )
        else:
            # Incast request: unicast our state back if we have any
            # (repo.go:86-90). Device read happens off the event loop.
            asyncio.ensure_future(self._reply_incast(state.name, addr, state.multi_ok))

    async def _reply_incast(self, name: str, addr: Addr, multi_ok: bool = False) -> None:
        assert self.loop is not None
        # Reply gate FIRST (before the device snapshot): one burst per
        # (bucket, requester) per TTL bounds cold-start storm traffic.
        if not self.reply_gate.allow(name, addr):
            return
        states = await self.loop.run_in_executor(None, self.repo.snapshot, name)
        payloads = states
        if multi_ok and self.wire_mode != "compat":
            # The requester can parse multi trailers: all lanes in one
            # packet (repo.go:86-90 answers with exactly one) instead of a
            # ×N reply storm against a hot bucket.
            payloads = wire.pack_multi(states)
        for i, st in enumerate(payloads):
            self._send(self._payload_bytes(st), addr)
            if i % 8 == 7:
                # Pace multi-packet bursts: yield the loop between groups
                # so a flagship-shape reply (~22 packets at 256 lanes)
                # never monopolizes the rx/tx event loop.
                await asyncio.sleep(0)
        if states and self.log:
            self.log.debug(
                "incast reply",
                extra={
                    "peer": f"{addr[0]}:{addr[1]}", "bucket": name,
                    "lanes": len(states), "packets": len(payloads),
                },
            )

    # -- send path (repo.go:123-169) ----------------------------------------

    def _send(self, data: bytes, addr: Addr) -> None:
        if self.drop_addr is not None and self.drop_addr(addr):
            return
        if self.transport is not None and not self.transport.is_closing():
            try:
                self.transport.sendto(data, addr)
            except OSError:
                # A peer's address going bad mid-run must degrade to a
                # counted error, never crash the broadcast loop.
                self.send_errors += 1
                return
            self.tx_packets += 1
            self.tx_bytes += len(data)

    def unicast(self, data: bytes, addr: Addr) -> None:
        """Thread-safe single-datagram send (anti-entropy worker)."""
        if self.loop is not None:
            self.loop.call_soon_threadsafe(self._send, data, addr)

    def _broadcast_now(self, payloads: List[bytes], addrs: Optional[List[Addr]] = None) -> None:
        targets = self.peers if addrs is None else addrs
        for data in payloads:
            for peer in targets:
                self._send(data, peer)
        if payloads and targets:
            profiling.COUNTERS.inc(
                "replication_tx_packets", len(payloads) * len(targets)
            )
            profiling.COUNTERS.inc(
                "replication_tx_bytes", sum(map(len, payloads)) * len(targets)
            )
        tr = trace_mod.TRACE
        if tr.enabled and payloads and targets:
            tr.record(
                trace_mod.EV_BROADCAST_TX, 0, len(payloads) * len(targets)
            )

    def _payload_bytes(self, st: wire.WireState) -> bytes:
        """Mode-gated encode: ``compat`` rewrites a dual-payload state to
        the pre-lane-trailer form (raw own-lane header + base trailer) that
        every patrol_tpu build can ingest without inflation."""
        if (
            self.wire_mode == "compat"
            and st.cap_nt is not None
            and st.lane_added_nt is not None
            and st.lane_taken_nt is not None
        ):
            st = wire.WireState(
                name=st.name,
                added=st.lane_added_nt / wire.NANO,
                taken=st.lane_taken_nt / wire.NANO,
                elapsed_ns=st.elapsed_ns,
                origin_slot=st.origin_slot,
            )
        return _encode_with_fallback(st)

    def broadcast_states(self, states: Sequence[wire.WireState]) -> None:
        """Thread-safe broadcast of full bucket states to every peer —
        callable from the engine thread (the reference broadcasts from the
        request goroutine, repo.go:129-158). In delta mode the emission is
        split: delta-able states accumulate in the per-peer delta buffers
        for v2-capable peers (shipped batched by the paced flusher) and
        only the remaining peers/states get classic per-state datagrams."""
        if not self.peers:
            return
        if self.delta is not None and self.delta.tx_enabled:
            classic_addrs, leftover = self.delta.offer(states)
            if self.loop is None:
                return
            if classic_addrs:
                payloads = [self._payload_bytes(st) for st in states]
                self.loop.call_soon_threadsafe(
                    self._broadcast_now, payloads, classic_addrs
                )
            if leftover:
                capable = [a for a in self.peers if a not in classic_addrs]
                if capable:
                    payloads = [self._payload_bytes(st) for st in leftover]
                    self.loop.call_soon_threadsafe(
                        self._broadcast_now, payloads, capable
                    )
            return
        payloads = [self._payload_bytes(st) for st in states]
        if self.loop is not None:
            self.loop.call_soon_threadsafe(self._broadcast_now, payloads)

    def send_incast_request(self, name: str) -> None:
        """Broadcast a zero-state packet: 'send me your state for this
        bucket' (repo.go:99-103), tagged with the multi-reply capability
        advert (a base trailer with the 0x04 bit — transparent to v1 and
        prior-version receivers). Thread-safe."""
        if not self.peers:
            return
        try:
            data = wire.encode(
                wire.WireState(
                    name=name, added=0.0, taken=0.0, elapsed_ns=0,
                    origin_slot=self.slots.self_slot, multi_ok=True,
                )
            )
        except wire.NameTooLargeError:
            # Trailer would not fit this name; plain v1 request.
            data = wire.encode(wire.WireState(name=name, added=0.0, taken=0.0, elapsed_ns=0))
        if self.loop is not None:
            self.loop.call_soon_threadsafe(self._broadcast_now, [data])

    def close(self) -> None:
        if self._health_task is not None:
            self._health_task.cancel()
            self._health_task = None
        if self.delta is not None:
            self.delta.close()
        if self.fleet is not None:
            self.fleet.close()
        if self.audit is not None:
            self.audit.close()
        if self.antientropy is not None:
            self.antientropy.close()
        if self.transport is not None:
            self.transport.close()

    def stats(self) -> dict:
        out = {
            "replication_rx_packets": self.rx_packets,
            "replication_rx_errors": self.rx_errors,
            "replication_tx_packets": self.tx_packets,
            "replication_tx_bytes": self.tx_bytes,
            "replication_send_errors": self.send_errors,
            "replication_peers": len(self.peers),
            "replication_incast_suppressed": self.reply_gate.suppressed,
            "faultnet_active": int(self.faultnet.active) if self.faultnet else 0,
        }
        out.update(self.health.stats())
        if self.membership is not None:
            out.update(self.membership.stats())
        if self.delta is not None:
            out.update(self.delta.stats())
        if self.fleet is not None:
            out.update(self.fleet.stats())
        if self.audit is not None:
            out.update(self.audit.stats())
        if self.antientropy is not None:
            out.update(self.antientropy.stats())
        if self.faultnet is not None:
            out.update(self.faultnet.stats())
        return out
