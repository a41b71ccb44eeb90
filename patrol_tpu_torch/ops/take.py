"""The batched take — ``Bucket.Take`` re-expressed as one kernel call over
a microbatch of requests (counterpart of ``patrol_tpu/ops/take.py``).

Hot buckets are coalesced algebraically: the host batcher folds
same-(bucket, rate, count) requests into one row carrying ``nreq`` and
the kernel grants ``min(nreq, available)`` greedily — exactly the
reference's sequential takes at one timestamp, where only the first take
refills. :func:`take_n_batch` runs the hand-written take-n kernel
(:mod:`patrol_tpu_torch.ops.take_kernel`) and updates state IN PLACE;
:func:`split_grant` splits a row's grant FIFO across its tickets.

Fixed-point notes: state is int64 nanotokens; the refill grant is
computed in float64 (``float64(delta) / float64(interval)``, then ·1e9,
floored), bit-identical to the JAX reference on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from patrol_tpu_torch.models.limiter import NANO, LimiterState
from patrol_tpu_torch.ops.take_kernel import (
    TAKE_PACK_ROWS,
    TAKE_RESULT_ROWS,
    take_n,
)

__all__ = [
    "TAKE_PACK_ROWS",
    "TAKE_RESULT_ROWS",
    "TakeRequest",
    "TakeResult",
    "take_batch",
    "take_n_batch",
    "split_grant",
    "remaining_for_request",
]


class TakeRequest(NamedTuple):
    """A microbatch of K take requests, each field a tensor of length K.

    Invariants maintained by the host batcher: ``rows`` are unique among
    rows with ``nreq > 0`` (duplicates are coalesced into ``nreq``);
    padding rows have ``nreq == 0`` and commit nothing; ``cap_base_nt`` is
    the lazily-initialized capacity base; ``created_ns`` the host-owned
    creation stamp."""

    rows: torch.Tensor  # [K] bucket-slot indices
    now_ns: torch.Tensor  # int64[K] request clock
    freq: torch.Tensor  # int64[K] rate frequency (capacity in tokens)
    per_ns: torch.Tensor  # int64[K] rate period
    count_nt: torch.Tensor  # int64[K] tokens per request, in nanotokens
    nreq: torch.Tensor  # int64[K] identical requests coalesced into this row
    cap_base_nt: torch.Tensor  # int64[K] capacity base (0 ⇒ fresh bucket)
    created_ns: torch.Tensor  # int64[K] bucket creation time


class TakeResult(NamedTuple):
    """Per-row outcome; the host fans per-request responses out of it
    (:func:`remaining_for_request`)."""

    have_nt: torch.Tensor  # tokens after refill, before the batch's takes
    admitted: torch.Tensor  # how many of nreq were admitted
    own_added_nt: torch.Tensor  # this node's PN lane after commit …
    own_taken_nt: torch.Tensor  # … the exact lane values for the v2 trailer
    elapsed_ns: torch.Tensor  # bucket elapsed after commit
    sum_added_nt: torch.Tensor  # Σ lanes added post-commit …
    sum_taken_nt: torch.Tensor  # … the aggregate scalars of the header


def take_n_batch(
    state: LimiterState, packed: torch.Tensor, node_slot: int
) -> Tuple[LimiterState, torch.Tensor]:
    """The take-n serving kernel: ONE packed ``int64[TAKE_PACK_ROWS, K]``
    request matrix (rows, now_ns, freq, per_ns, count_nt, nreq,
    cap_base_nt, created_ns) in, ONE ``int64[TAKE_RESULT_ROWS, K]`` result
    matrix (have, admitted, own_added, own_taken, elapsed, sum_added,
    sum_taken) out. ``state`` is updated in place and returned. A padding
    column (``nreq == 0``) gets an all-zero result column; the engine
    reads only its live columns."""
    out = take_n(state.pn, state.elapsed, packed, node_slot)
    return state, out


def take_batch(
    state: LimiterState, req: TakeRequest, node_slot: int
) -> Tuple[LimiterState, TakeResult]:
    """The unpacked form of :func:`take_n_batch`: stacks the request
    fields into the packed layout, runs the kernel, unstacks the result."""
    packed = torch.stack(
        [
            req.rows.to(torch.int64),
            req.now_ns,
            req.freq,
            req.per_ns,
            req.count_nt,
            req.nreq,
            req.cap_base_nt,
            req.created_ns,
        ]
    ).contiguous()
    state, out = take_n_batch(state, packed, node_slot)
    return state, TakeResult(*out.unbind(0))


def split_grant(
    have_nt: int, admitted: int, count_nt: int, nreq: int
) -> list[tuple[int, bool]]:
    """Deterministic FIFO split of one coalesced row's grant across its
    ``nreq`` waiting tickets, in arrival order: the first ``admitted``
    tickets succeed (each seeing the balance after its own commit), the
    rest get clean denies (each seeing the balance after ALL admitted
    commits)."""
    return [
        remaining_for_request(have_nt, admitted, count_nt, i)
        for i in range(nreq)
    ]


def remaining_for_request(
    have_nt: int, admitted: int, count_nt: int, index: int
) -> tuple[int, bool]:
    """Host-side fan-out of one coalesced row to per-request responses.

    ``index`` is the request's 0-based arrival position in the coalesced
    queue. Matches the reference's sequential semantics: admitted requests
    see the balance after their own commit; rejected ones see the balance
    left after all admitted requests (bucket.go:215-224). The uint64 cast of
    the reference is clamped at zero (PN merges can drive the balance
    negative; Go's negative-float→uint64 cast is UB we do not reproduce).
    """
    ok = index < admitted
    consumed = (index + 1 if ok else admitted) * count_nt
    remaining_nt = have_nt - consumed
    return max(remaining_nt, 0) // NANO, ok
