"""patrol-membership: elastic cluster membership over the control channel
(ROADMAP 3b — "the cluster" as runtime state, not a boot-time constant).

The reference pins its peer set at process start (command.go flags) and
the rebuild inherited that through :class:`~patrol_tpu_torch.net.replication.SlotTable`.
This plane turns the table into a live lattice:

* **join** — an admin (``POST /admin/peers?op=add``) admits a node: the
  joiner gets the next FREE lane, the epoch bumps, and the event is
  announced to every peer as a ``\\x00pt!mbr`` datagram;
* **leave** — a leaver's lane is retired behind a **tombstone** stamped
  with the retirement epoch. Its final PN values stay join-absorbed
  forever (the merge never forgets a max), so stale echoes from the
  departed address are harmless no-ops — the lane just stops growing;
* **rejoin** — a node returning under a NEW address re-attaches to its
  ORIGINAL lane only through the tombstone-epoch handshake
  (:meth:`SlotTable.rejoin`): it must present the exact epoch at which
  its lane was tombstoned. ``resolve``/``realias`` refuse tombstoned
  lanes outright, so lane reuse without an epoch bump is structurally
  impossible — the lane-lifecycle analog of the protocol model's
  ``lane-reuse-without-tombstone`` seeded mutation.

Why this is safe without consensus: membership events are idempotent
facts about a monotone lattice (lanes are allocated from a monotone
counter, tombstones only appear, the epoch only grows). Loss is repaired
by re-announce (admin retry or the joiner's own traffic landing a
dynamic lane that the next announce upgrades); duplication is a no-op;
reordering is absorbed because each event carries its own lane + epoch.
A diverged member set degrades exactly like a partition: data keeps
flowing (liveness and membership NEVER gate rx), and the audit plane
measures the divergence rather than assuming it away.

Loss repair is ACTIVE, not just possible: every locally-originated
event enters a bounded replay log and is re-announced a fixed number
of times (paced off the replicator's health tick). UDP loss under
incast is routine on the membership channel — one dropped leave or
rejoin datagram would otherwise leave a peer's view diverged until an
operator noticed. Replay is safe because every transition is
idempotent at the receiver: a re-applied join/leave max-joins the
epoch and changes nothing, a stale leave for a since-rejoined lane is
refused by the owner check (:meth:`SlotTable.remove_member`), and a
replayed rejoin for an already-attached address is a no-bump success.

Thread model: event-driven plus the replay hook. ``on_packet`` runs on
the rx context; admin calls arrive from the API executor;
:meth:`maybe_replay` runs on the replicator's health loop. SlotTable
holds the membership state under its own mutex; this plane never holds
a lock across a send (sends go through the replicator's thread-safe
``unicast``).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.utils import profiling

Addr = Tuple[str, int]

# Re-announce repair: each locally-originated event is re-sent this many
# times, one replay burst per interval. 8 × 0.5s rides out several
# consecutive loss windows without turning the channel into a chatterbox
# (a full replay burst is ≤ log-size × peers datagrams of ≤256 B).
REPLAYS = 8
REPLAY_INTERVAL_S = 0.5
_LOG_CAP = 16  # most recent events only; older ones had their chances


class MembershipPlane:
    """One per replicator (either backend). The replicator routes
    ``\\x00pt!mbr`` datagrams to :meth:`on_packet`; the admin API calls
    :meth:`local_join` / :meth:`local_leave`; a restarting node calls
    :meth:`announce_rejoin` with its checkpointed lane + the tombstone
    epoch the admin handed it at removal."""

    def __init__(self, rep):
        self.rep = rep
        self.events_tx = 0
        self.events_rx = 0
        self.rx_errors = 0
        self.rejected = 0  # handshake failures (wrong epoch / dead lane)
        self.replays = 0  # re-announced events (loss-repair bursts)
        # Replay log of locally-originated events: [event, sends_left].
        # Guarded by its own lock (API executor + health loop touch it).
        self._log_mu = profiling.ProfiledLock("membership.log")
        self._log: List[list] = []
        self._last_replay = time.monotonic()

    # -- local (admin-driven) events -----------------------------------------

    def local_join(self, addr_str: str) -> Optional[dict]:
        """Admit ``addr_str`` as a member. Returns the membership receipt
        (lane + epoch) or ``None`` when no lane is assignable (exhausted
        lane space, or the address's lane is tombstoned — a retired lane
        needs the rejoin handshake, not a plain add)."""
        slots = self.rep.slots
        before = slots.epoch
        lane = slots.add_member(addr_str)
        if lane is None:
            return None
        epoch = slots.epoch
        if epoch != before:
            profiling.COUNTERS.inc("peer_joins")
        self.rep._adopt_peer(addr_str)
        self._announce(wire.MemberEvent(wire.MEMBER_JOIN, lane, epoch, addr_str))
        return {"op": "add", "addr": addr_str, "lane": lane, "epoch": epoch}

    def local_leave(self, addr_str: str) -> Optional[dict]:
        """Retire ``addr_str``'s lane behind a tombstone. Returns the
        receipt carrying the tombstone epoch — the leaver needs it for
        its eventual rejoin handshake — or ``None`` for self/unknown
        addresses."""
        slots = self.rep.slots
        before = slots.epoch
        res = slots.remove_member(addr_str)
        if res is None:
            return None
        lane, ts_epoch = res
        if slots.epoch != before:
            profiling.COUNTERS.inc("peer_leaves")
            profiling.COUNTERS.inc("lane_tombstones")
        self.rep._drop_peer(addr_str)
        self._announce(
            wire.MemberEvent(wire.MEMBER_LEAVE, lane, ts_epoch, addr_str)
        )
        return {
            "op": "remove",
            "addr": addr_str,
            "lane": lane,
            "tombstone_epoch": ts_epoch,
        }

    def announce_rejoin(self, lane: int, epoch: int) -> None:
        """A restarted node (possibly under a new address) presents its
        original lane + tombstone epoch to the cluster. Receivers
        validate via the SlotTable handshake; our own table already maps
        self to ``lane`` (checkpoint restore / boot override). We adopt
        ``epoch + 1`` locally — the exact value every accepting receiver
        lands on — so the rejoiner's epoch converges with the cluster's
        instead of stalling at its checkpointed value."""
        self.rep.slots.restore_epoch(epoch + 1)
        self._announce(
            wire.MemberEvent(
                wire.MEMBER_REJOIN, lane, epoch, self.rep.node_addr
            )
        )

    # -- rx ------------------------------------------------------------------

    def on_packet(self, data: bytes, addr: Addr) -> bool:
        """Decode + apply one membership event. False ⇒ malformed."""
        pkt = wire.decode_member_packet(data)
        if pkt is None:
            self.rx_errors += 1
            return False
        self.events_rx += 1
        ev = pkt.event
        slots = self.rep.slots
        if ev.addr == self.rep.node_addr:
            # Events about ourselves: a join/rejoin announce echoing back
            # is a no-op; a leave for self never self-applies (only an
            # operator at another node retires us, and our own lane stays
            # ours until we actually shut down).
            return True
        before = slots.epoch
        if ev.op == wire.MEMBER_JOIN:
            # The announced epoch rides along so this table's counter
            # converges to the admin's (add_member max-joins it).
            lane = slots.add_member(ev.addr, epoch=ev.epoch)
            if lane is not None:
                if slots.epoch != before:
                    profiling.COUNTERS.inc("peer_joins")
                self.rep._adopt_peer(ev.addr)
        elif ev.op == wire.MEMBER_LEAVE:
            # Stamp the tombstone with the ADMIN's epoch, not the local
            # counter: the leaver's rejoin credential must validate on
            # every node regardless of which prior announces it saw.
            res = slots.remove_member(ev.addr, epoch=ev.epoch)
            if res is not None and slots.epoch != before:
                profiling.COUNTERS.inc("peer_leaves")
                profiling.COUNTERS.inc("lane_tombstones")
                self.rep._drop_peer(ev.addr)
        elif ev.op == wire.MEMBER_REJOIN:
            if slots.rejoin(ev.addr, ev.lane, ev.epoch):
                # Epoch unchanged ⇒ a replayed handshake we had already
                # applied: no transition, no counter.
                if slots.epoch != before:
                    profiling.COUNTERS.inc("peer_joins")
                self.rep._adopt_peer(ev.addr)
            else:
                self.rejected += 1
        return True

    # -- tx ------------------------------------------------------------------

    def _announce(self, event: wire.MemberEvent, record: bool = True) -> None:
        try:
            data = wire.encode_member_packet(
                self.rep.slots.self_slot, self.rep.slots.epoch, event
            )
        except ValueError:
            return  # address too long for the frame: local-only change
        peers: List[Addr] = list(getattr(self.rep, "peers", ()))
        for addr in peers:
            self.rep.unicast(data, addr)
        self.events_tx += len(peers)
        if record:
            with self._log_mu:
                self._log.append([event, REPLAYS])
                del self._log[:-_LOG_CAP]

    def maybe_replay(self) -> int:
        """Re-announce every logged event once (the health loop calls
        this each tick; pacing happens here). Returns events replayed.
        Receivers absorb duplicates as no-ops — see the module doc — so
        a burst repairs whatever subset of peers lost the original."""
        now = time.monotonic()
        if now - self._last_replay < REPLAY_INTERVAL_S:
            return 0
        self._last_replay = now
        with self._log_mu:
            pending = [entry for entry in self._log]
        for entry in pending:
            self._announce(entry[0], record=False)
            entry[1] -= 1
        with self._log_mu:
            self._log = [entry for entry in self._log if entry[1] > 0]
        self.replays += len(pending)
        return len(pending)

    # -- observability -------------------------------------------------------

    def view(self) -> dict:
        """The live SlotTable membership view (epoch, lanes, tombstones) —
        the ``GET /admin/peers`` body and the checkpoint's membership
        meta."""
        return self.rep.slots.view()

    def stats(self) -> dict:
        view = self.rep.slots.view()
        return {
            "membership_epoch": view["epoch"],
            "membership_members": len(view["members"]),
            "membership_tombstones": len(view["tombstones"]),
            "membership_events_tx": self.events_tx,
            "membership_events_rx": self.events_rx,
            "membership_rx_errors": self.rx_errors,
            "membership_rejected": self.rejected,
            "membership_replays": self.replays,
        }
