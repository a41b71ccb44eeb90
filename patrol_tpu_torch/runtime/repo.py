"""TPURepo — the device-backed implementation of the reference's keystone
``Repo`` seam (repo.go:13-18), plus the incast request logic of
``ReplicatedRepo.GetBucket`` (repo.go:96-106). The name is kept from the
JAX package so callers of either package read alike; here the device is a
CUDA card (or the CPU, for tests). The supervisor wires ``send_incast``
to ``Replicator.send_incast_request``; with ``send_incast=None`` (engine
tests) incast is a no-op.

The hot path is the *fused* :meth:`take` (get-or-create + take + upsert +
broadcast in one engine tick), because splitting it into the reference's
three calls would cost three device round-trips. The classic
``get_bucket`` / ``upsert_bucket`` pair is still provided for parity,
introspection and tests — ``get_bucket`` returns a scalar *view* of the
PN state (value = capacity base + Σadded − Σtaken).
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Callable, List, Optional, Tuple

from patrol_tpu_torch.ops.rate import Rate
from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.runtime.bucket import Bucket
from patrol_tpu_torch.runtime.engine import DeviceEngine, TakeTicket

IncastFn = Callable[[str], None]


class TPURepo:
    """Facade over the device engine: fused takes, incast-on-miss with
    singleflight-style dedup (≙ golang.org/x/sync/singleflight at
    repo.go:26,99-103), delta ingest, and Repo-seam compatibility."""

    def __init__(
        self,
        engine: DeviceEngine,
        send_incast: Optional[IncastFn] = None,
        incast_ttl_s: float = 1.0,
    ):
        self.engine = engine
        self.send_incast = send_incast
        self._incast_ttl_s = incast_ttl_s
        self._incast_mu = threading.Lock()
        self._incast_inflight: dict = {}

    # -- hot path -----------------------------------------------------------

    def submit_take(
        self, name: str, rate: Rate, count: int, now_ns: Optional[int] = None
    ) -> TakeTicket:
        ticket, created = self.engine.submit_take(name, rate, count, now_ns)
        if created:
            # First sight of this bucket: ask the cluster for its state
            # asynchronously (repo.go:96-106). The local request proceeds
            # against the fresh bucket; convergence is eventual.
            self._maybe_incast(name)
        return ticket

    def submit_takes_batch(self, names, rates, counts):
        """Batched :meth:`submit_take` (native HTTP pump): one engine
        directory pass, then the per-created incast solicitations.
        → [(ticket, created), ...] or None on a fully-pinned pool."""
        res = self.engine.submit_takes_batch(names, rates, counts)
        if res is None:
            return None
        for (ticket, created), name in zip(res, names):
            if created:
                self._maybe_incast(name)
        return res

    def take(
        self, name: str, rate: Rate, count: int, now_ns: Optional[int] = None
    ) -> Tuple[int, bool]:
        ticket = self.submit_take(name, rate, count, now_ns)
        ticket.wait()
        return ticket.remaining, ticket.ok

    async def take_async(
        self, name: str, rate: Rate, count: int, now_ns: Optional[int] = None
    ) -> Tuple[int, bool]:
        ticket = self.submit_take(name, rate, count, now_ns)
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def _done() -> None:
            loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result((ticket.remaining, ticket.ok))
            )

        ticket.add_done_callback(_done)
        return await fut

    def _maybe_incast(self, name: str) -> None:
        if self.send_incast is None:
            return
        now = time.monotonic()
        with self._incast_mu:
            deadline = self._incast_inflight.get(name, 0.0)
            if deadline > now:
                return  # already in flight — dedup
            self._incast_inflight[name] = now + self._incast_ttl_s
            if len(self._incast_inflight) > 4096:
                self._incast_inflight = {
                    k: v for k, v in self._incast_inflight.items() if v > now
                }
        self.send_incast(name)

    # -- replication ingest -------------------------------------------------

    def apply_delta(self, state: wire.WireState, slot: int, scalar: bool = False) -> None:
        self.engine.ingest_delta(state, slot, scalar=scalar)

    def snapshot(self, name: str) -> List[wire.WireState]:
        return self.engine.snapshot(name)

    # -- Repo-seam compatibility (repo.go:13-18) ----------------------------

    def get_bucket(self, name: str) -> Tuple[Bucket, bool]:
        """Scalar view of a bucket. Creates the row if absent (stamping
        ``created`` from the engine clock, repo.go:205). Mutating the
        returned view does not write back to device state."""
        row = self.engine.directory.lookup(name)
        existed = row is not None
        if row is None:
            # assign_row (not directory.assign): evicts idle rows when the
            # pool is spent, so keyspace > pool stays a supported state on
            # the introspection surface too.
            row, _ = self.engine.assign_row(name, self.engine.clock())
            self._maybe_incast(name)
        pn, elapsed = self.engine.row_view(row)
        base = int(self.engine.directory.cap_base_nt[row])
        return (
            Bucket(
                name=name,
                added_nt=base + int(pn[:, 0].sum()),
                taken_nt=int(pn[:, 1].sum()),
                elapsed_ns=int(elapsed),
                created_ns=int(self.engine.directory.created_ns[row]),
            ),
            existed,
        )

    def upsert_bucket(self, b: Bucket) -> Tuple[Bucket, bool]:
        """Merge a host bucket's scalar state into this node's lane (a join
        is always safe: lanes only grow). Returns the refreshed view."""
        existed = self.engine.directory.lookup(b.name) is not None
        self.engine.ingest_delta(
            wire.from_nanotokens(b.name, b.added_nt, b.taken_nt, b.elapsed_ns),
            slot=self.engine.node_slot,
        )
        self.engine.flush()
        view, _ = self.get_bucket(b.name)
        return view, existed

    def tokens(self, name: str) -> int:
        return self.engine.tokens(name)

    def tokens_if_known(self, name: str) -> Optional[int]:
        """Balance introspection with existence: ``None`` for a bucket this
        node has never seen (the HTTP /tokens route's 404), else the whole-
        token balance. Keeps API handlers on the repo facade rather than
        reaching into engine internals; the engine closes the
        eviction/rebind race with a post-read re-lookup."""
        return self.engine.tokens_if_known(name)
