"""Host-side token bucket with CRDT PN-counter semantics, and LocalRepo.

This is the *exact-semantics host model* of the reference's core
(bucket.go:17-263, repo.go:171-235). It exists for three reasons:

1. It is the differential-testing oracle for the batched device kernels in
   :mod:`patrol_tpu_torch.ops.take` / :mod:`patrol_tpu_torch.ops.merge` — every kernel
   behavior is cross-checked against this model.
2. Its arithmetic is the semantic model for the LIVE host fast path
   (``runtime/engine.py HostLanes`` — per-lane state, same take math):
   cold/low-QPS buckets are served in-process, µs-class, and promoted to
   the device path when hot (VERDICT r3 item 1; see tests/test_fastpath.py
   for the host/device equivalence laws).
3. It preserves the reference's ``Repo`` seam (repo.go:13-18) so the API and
   replication layers are backend-agnostic.

Unlike the reference's float64 scalars, counters here are integer
*nanotokens* (1 token = 1e9 nanotokens) so that host and device state merge
bit-identically. The arithmetic inside :meth:`Bucket.take` mirrors the
reference's float64 math (bucket.go:186-225) before quantizing the committed
grant to nanotokens.
"""

from __future__ import annotations

import dataclasses
import threading
import time as _time
from typing import Callable, Dict, Iterable, Tuple

from patrol_tpu_torch.ops.rate import Rate, format_duration

NANO = 1_000_000_000

ClockFn = Callable[[], int]  # returns epoch nanoseconds


def system_clock() -> int:
    """Default clock: wall time in epoch nanoseconds (UTC)."""
    return _time.time_ns()


def offset_clock(offset_ns: int, base: ClockFn = system_clock) -> ClockFn:
    """Clock skewed by a fixed offset — the reference's ``-clock-offset``
    fault-injection seam (cmd/patrol/main.go:30,35-37)."""
    return lambda: base() + offset_ns


@dataclasses.dataclass
class Bucket:
    """A token bucket whose counters form a state-based CRDT.

    ``added_nt`` / ``taken_nt`` are this *bucket's scalar view* in nanotokens
    (like the reference's ``added`` / ``taken`` floats, bucket.go:24-27);
    ``elapsed_ns`` is the G-counter of time consumed by successful takes;
    ``created_ns`` is the node-local creation timestamp that is deliberately
    never serialized (bucket.go:28-31, README.md:49-62) — clock-skew
    independence comes from replicating only the relative ``elapsed``.
    """

    name: str = ""
    added_nt: int = 0
    taken_nt: int = 0
    elapsed_ns: int = 0
    created_ns: int = 0

    def __post_init__(self) -> None:
        self._mu = threading.RLock()

    # -- introspection (bucket.go:156-182,228-236) --------------------------

    def tokens(self) -> int:
        """Whole tokens in the bucket: ``uint64(added - taken)`` truncation
        (bucket.go:156-161), clamped at zero (the Go float→uint64 cast of a
        negative value is undefined behavior we do not reproduce)."""
        with self._mu:
            nt = self.added_nt - self.taken_nt
        return max(nt, 0) // NANO

    def is_zero(self) -> bool:
        """True when all replicated state is zero (bucket.go:163-170).

        On the wire this doubles as the incast request marker (repo.go:78-90).
        """
        with self._mu:
            return self.added_nt == 0 and self.taken_nt == 0 and self.elapsed_ns == 0

    def __str__(self) -> str:
        with self._mu:
            return (
                f"Bucket{{name: {self.name!r}, "
                f"tokens: {(self.added_nt - self.taken_nt) / NANO:f}, "
                f"elapsed: {format_duration(self.elapsed_ns)}, "
                f"created: {self.created_ns}}}"
            )

    def log_fields(self) -> dict:
        """Structured-log rendering (bucket.go:173-182)."""
        with self._mu:
            return {
                "name": self.name,
                "added": self.added_nt / NANO,
                "taken": self.taken_nt / NANO,
                "elapsed": format_duration(self.elapsed_ns),
                "created": self.created_ns,
            }

    # -- the hot arithmetic (bucket.go:186-225) -----------------------------

    def take(self, now_ns: int, rate: Rate, n: int) -> Tuple[int, bool]:
        """Attempt to take ``n`` tokens at time ``now_ns`` with fill ``rate``.

        Returns ``(remaining_tokens, ok)``. Mirrors bucket.go:186-225
        step-for-step: lazy capacity init, monotonic-time guard, refill from
        elapsed time capped at capacity (the cap can be *negative*, forfeiting
        excess tokens — reference behavior), conditional commit.
        """
        with self._mu:
            # Burst capacity in nanotokens (bucket.go:192).
            capacity_nt = rate.freq * NANO

            if self.added_nt == 0:
                # Lazy init commits even when the take below fails
                # (bucket.go:194-196).
                self.added_nt = capacity_nt

            last = self.created_ns + self.elapsed_ns
            if now_ns < last:
                last = now_ns

            tokens_nt = self.added_nt - self.taken_nt
            elapsed = now_ns - last

            # Refill due to elapsed time, in nanotokens, quantized by floor.
            added_nt = int(rate.tokens(elapsed) * NANO)
            missing_nt = capacity_nt - tokens_nt
            if added_nt > missing_nt:
                added_nt = missing_nt

            take_nt = n * NANO
            have_nt = tokens_nt + added_nt
            if take_nt > have_nt:
                return max(have_nt, 0) // NANO, False

            self.elapsed_ns += elapsed
            self.added_nt += added_nt
            self.taken_nt += take_nt
            return max(self.added_nt - self.taken_nt, 0) // NANO, True

    # -- the CRDT join (bucket.go:240-263) ----------------------------------

    def merge(self, *others: "Bucket") -> None:
        """Join: field-wise max of added, taken, elapsed.

        Commutative, associative, idempotent — the CvRDT laws the property
        tests pin down (bucket_test.go:68-114). Locks are taken in id() order
        to avoid the ABBA deadlock the reference's self-then-other ordering
        permits under concurrent cross-merges (bucket.go:240-263).
        """
        for other in others:
            if other is self:
                continue
            first, second = (
                (self, other) if id(self) < id(other) else (other, self)
            )
            with first._mu, second._mu:
                if self.added_nt < other.added_nt:
                    self.added_nt = other.added_nt
                if self.taken_nt < other.taken_nt:
                    self.taken_nt = other.taken_nt
                if self.elapsed_ns < other.elapsed_ns:
                    self.elapsed_ns = other.elapsed_ns


class Repo:
    """The keystone storage seam (repo.go:13-18).

    Implementations must be safe for concurrent use. The API layer is written
    against this interface; replication decorates it; the TPU runtime
    implements it with device-resident state.
    """

    def get_bucket(self, name: str) -> Tuple[Bucket, bool]:
        raise NotImplementedError

    def upsert_bucket(self, b: Bucket) -> Tuple[Bucket, bool]:
        raise NotImplementedError


class LocalRepo(Repo):
    """In-memory bucket store (repo.go:171-235).

    Get-or-create stamps ``created`` from the injected clock (repo.go:205);
    upsert keeps the identity fast path (repo.go:220) and otherwise merges
    (repo.go:233).
    """

    def __init__(self, clock: ClockFn, buckets: Iterable[Bucket] = ()) -> None:
        self._clock = clock
        self._mu = threading.Lock()
        self._buckets: Dict[str, Bucket] = {b.name: b for b in buckets}

    def get_bucket(self, name: str) -> Tuple[Bucket, bool]:
        # Python dict reads are atomic under the GIL; the lock only guards
        # the create path (the reference uses an RWMutex + double-checked
        # locking, repo.go:189-211).
        b = self._buckets.get(name)
        if b is not None:
            return b, True
        with self._mu:
            b = self._buckets.get(name)
            if b is None:
                b = Bucket(name=name, created_ns=self._clock())
                self._buckets[name] = b
                return b, False
        return b, True

    def upsert_bucket(self, b: Bucket) -> Tuple[Bucket, bool]:
        prev = self._buckets.get(b.name)
        if prev is b:  # Identity fast path (repo.go:220).
            return prev, True
        with self._mu:
            prev = self._buckets.get(b.name)
            if prev is None:
                b.created_ns = self._clock()
                self._buckets[b.name] = b
                return b, False
        prev.merge(b)
        return prev, True

    def __len__(self) -> int:
        return len(self._buckets)
