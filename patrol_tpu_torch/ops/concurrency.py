"""In-flight concurrency limits as paired PN-counter lanes (counterpart
of ``patrol_tpu/ops/concurrency.py``).

``acquire`` takes a unit while ``inflight < limit``, ``release`` returns
one. The own ``TAKEN`` lane counts this node's acquires, the own
``ADDED`` lane its releases, both monotone, and
``inflight = sum(TAKEN) - sum(ADDED)``, so the rows join and replicate as
the bucket's do. A release is clamped to what the own lane holds
(``own_taken - own_added``): a node never returns a remote node's units,
which keeps ``ADDED[slot] <= TAKEN[slot]`` per lane (the phantom-release
guard). Releases apply before acquires.

:func:`conc_acquire_batch` runs the hand-written kernel
(:mod:`patrol_tpu_torch.ops.cert_kernel`, ``csrc/cert.cu``'s
``conc_admit``, one launch that reads, then commits) on a CUDA state, or
raises; on a CPU state it runs :func:`conc_acquire_batch_plain`.
State is updated IN PLACE (the reference donated it).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from patrol_tpu_torch.models.limiter import ADDED, TAKEN, LimiterState
from patrol_tpu_torch.ops import cert_kernel

# Packed layout: int64[CONC_PACK_ROWS, K] in (rows, limit_nt, count_nt,
# nreq, releases; rows wrapped), int64[CONC_RESULT_ROWS, K] out
# (ConcResult's fields).
CONC_PACK_ROWS = 5
CONC_RESULT_ROWS = 6


class ConcRequest(NamedTuple):
    """A microbatch of K release-then-acquire ticks. Padding columns have
    ``nreq == releases == 0`` and commit nothing."""

    rows: torch.Tensor  # [K] bucket-slot indices (read as int32)
    limit_nt: torch.Tensor  # int64[K] max in-flight units
    count_nt: torch.Tensor  # int64[K] units per acquire (NANO-scaled)
    nreq: torch.Tensor  # int64[K] acquires coalesced into this column
    releases: torch.Tensor  # int64[K] releases (of count_nt units each)


class ConcResult(NamedTuple):
    """Per-column outcome; own lanes post-commit feed the wire trailer."""

    admitted: torch.Tensor  # int64[K] acquires granted
    released_nt: torch.Tensor  # int64[K] units actually released (post-clamp)
    inflight_nt: torch.Tensor  # int64[K] cluster-visible in-flight post-commit
    own_acquired_nt: torch.Tensor  # int64[K] own TAKEN lane post-commit
    own_released_nt: torch.Tensor  # int64[K] own ADDED lane post-commit
    clamped_nt: torch.Tensor  # int64[K] release units refused by the clamp


def packed_plain(
    pn: torch.Tensor, rows: torch.Tensor, limit: torch.Tensor, count: torch.Tensor,
    nreq: torch.Tensor, releases: torch.Tensor, node_slot: int,
) -> torch.Tensor:
    """The plain version over the packed layout's columns (rows wrapped):
    the reference's body (``concurrency.py:73-125``). → the result matrix; commits into
    ``pn`` in place."""
    g, in_range = cert_kernel.gather_index(rows, pn.shape[0])
    pn_rows = pn[g]  # [K, N, 2] gather
    own_added = pn_rows[:, node_slot, ADDED]
    own_taken = pn_rows[:, node_slot, TAKEN]
    sum_added = pn_rows[:, :, ADDED].sum(dim=-1)
    sum_taken = pn_rows[:, :, TAKEN].sum(dim=-1)

    want_rel = torch.clamp(releases, min=0) * torch.clamp(count, min=0)
    held_own = torch.clamp(own_taken - own_added, min=0)
    d_rel = torch.minimum(want_rel, held_own)

    inflight = sum_taken - (sum_added + d_rel)
    headroom = limit - inflight
    safe_count = torch.where(count <= 0, torch.ones_like(count), count)
    k = torch.div(headroom, safe_count, rounding_mode="floor")
    k = torch.minimum(torch.clamp(k, min=0), nreq)
    k = torch.where(count > 0, k, torch.zeros_like(k))
    d_acq = k * count

    # One scatter-add of the (ADDED, TAKEN) pair; rows outside [0, B) dropped.
    pn[:, node_slot].index_put_(
        (rows[in_range],), torch.stack([d_rel, d_acq], dim=1)[in_range], accumulate=True
    )
    return torch.stack(
        [k, d_rel, inflight + d_acq, own_taken + d_acq, own_added + d_rel, want_rel - d_rel]
    )


def pack(req: ConcRequest, b: int) -> torch.Tensor:
    """The request as the packed matrix (rows cast and wrapped)."""
    return cert_kernel.pack(req, b, 1)


def conc_acquire_packed(state: LimiterState, packed: torch.Tensor, node_slot: int) -> torch.Tensor:
    """One packed microbatch: → the int64[6, K] result matrix on the
    state's device; ``state`` is updated in place."""
    if state.pn.device.type == "cpu":
        return packed_plain(state.pn, *packed, node_slot)
    return cert_kernel.run("conc", state.pn, packed, node_slot)


def conc_acquire_batch_plain(
    state: LimiterState, req: ConcRequest, node_slot: int
) -> Tuple[LimiterState, ConcResult]:
    """The plain version on any device: → (state, result)."""
    out = packed_plain(state.pn, *pack(req, state.pn.shape[0]), node_slot)
    return state, ConcResult(*out.unbind(0))


def conc_acquire_batch(
    state: LimiterState, req: ConcRequest, node_slot: int
) -> Tuple[LimiterState, ConcResult]:
    """Apply a microbatch of release-then-acquire ticks (state updated in
    place) → (state, result)."""
    out = conc_acquire_packed(state, pack(req, state.pn.shape[0]), node_slot)
    return state, ConcResult(*out.unbind(0))
