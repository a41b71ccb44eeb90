"""CvRDT merge ops over dense torch state (counterpart of
``patrol_tpu/ops/merge.py``).

Every scatter-shaped join — :func:`merge_batch` (K raw deltas, duplicate
keys allowed), :func:`merge_batch_folded` (the tick fold's sorted unique
pairs with sentinel padding), :func:`merge_rows_dense` (whole-row lane
windows) and :func:`merge_scalar_batch`'s final max — goes through the
hand-written join kernel (:mod:`patrol_tpu_torch.ops.join_kernel`).
:func:`merge_dense`, :func:`zero_rows` and :func:`read_rows` are plain
torch ops, as they were plain XLA in the reference.

State is updated IN PLACE (the reference donated its buffers); each
function returns the same :class:`LimiterState`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from patrol_tpu_torch.models.limiter import ADDED, TAKEN, LimiterState
from patrol_tpu_torch.ops.join_kernel import pair_join, row_join

# Sentinel row for fold/commit padding (engine tick fold and the commit
# ring): far above any bucket row, so the join kernel drops it.
FOLD_PAD_ROW = 1 << 30

_I64_MIN = -(2**63)


class MergeBatch(NamedTuple):
    """K replication deltas (int64 tensors). Values are non-negative
    (clamped at ingest); padding uses (row 0, slot 0, zeros), a no-op max."""

    rows: torch.Tensor
    slots: torch.Tensor
    added_nt: torch.Tensor
    taken_nt: torch.Tensor
    elapsed_ns: torch.Tensor


class FoldedMergeBatch(NamedTuple):
    """A tick-level folded merge batch (engine._fold_core): sorted unique
    (row, slot) pairs, the per-row elapsed fold in ``erows``/``elapsed_ns``,
    and out-of-range sentinel padding that the join drops."""

    rows: torch.Tensor
    slots: torch.Tensor
    added_nt: torch.Tensor
    taken_nt: torch.Tensor
    erows: torch.Tensor
    elapsed_ns: torch.Tensor


class RowDenseBatch(NamedTuple):
    """R bucket rows committing their FULL lane plane (zeros = no-op):
    the dense half of the fold-to-dense hybrid."""

    rows: torch.Tensor  # [R]
    updates: torch.Tensor  # int64[R, N, 2]
    elapsed_ns: torch.Tensor  # int64[R]


def _c(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64).contiguous()


def merge_batch(state: LimiterState, batch: MergeBatch) -> LimiterState:
    """Scatter-max K deltas into state (≙ bucket.go:240-263 per delta)."""
    rows = _c(batch.rows)
    pair_join(
        state.pn, state.elapsed, rows, _c(batch.slots), _c(batch.added_nt),
        _c(batch.taken_nt), rows, _c(batch.elapsed_ns),
    )
    return state


def merge_batch_folded(state: LimiterState, batch: FoldedMergeBatch) -> LimiterState:
    """Scatter-max of a host-folded batch (sentinel rows dropped)."""
    pair_join(
        state.pn, state.elapsed, _c(batch.rows), _c(batch.slots),
        _c(batch.added_nt), _c(batch.taken_nt), _c(batch.erows),
        _c(batch.elapsed_ns),
    )
    return state


def merge_rows_dense(state: LimiterState, batch: RowDenseBatch) -> LimiterState:
    """Scatter-max R full-row lane windows into state."""
    row_join(
        state.pn, state.elapsed, _c(batch.rows), _c(batch.updates),
        _c(batch.elapsed_ns),
    )
    return state


def merge_scalar_batch(state: LimiterState, batch: MergeBatch) -> LimiterState:
    """Deficit-attribution merge for deltas from scalar-semantics peers
    (reference nodes): attribute to the sender's lane only the part of its
    counter not explained by the other lanes,

        attributed = max(delta − Σ_{l ≠ slot} lane_l, 0)
        lane_slot  = max(lane_slot, attributed)

    Every row of the batch reads the pre-batch state (gather first), then
    one join commits the attributed pairs."""
    rows = _c(batch.rows)
    slots = _c(batch.slots)
    pn_rows = state.pn[rows]  # [K, N, 2] gather
    ar = torch.arange(rows.numel(), device=rows.device)
    lane_a = pn_rows[ar, slots, ADDED]
    lane_t = pn_rows[ar, slots, TAKEN]
    other_a = pn_rows[:, :, ADDED].sum(dim=-1) - lane_a
    other_t = pn_rows[:, :, TAKEN].sum(dim=-1) - lane_t
    attr_a = torch.clamp(_c(batch.added_nt) - other_a, min=0).contiguous()
    attr_t = torch.clamp(_c(batch.taken_nt) - other_t, min=0).contiguous()
    pair_join(
        state.pn, state.elapsed, rows, slots, attr_a, attr_t, rows,
        _c(batch.elapsed_ns),
    )
    return state


def _u64_max_(a: torch.Tensor, b: torch.Tensor) -> None:
    """``a = max(a, b)`` under UNSIGNED 64-bit order, in place — the
    reference's bitcast-to-uint64 max. Flipping the sign bit maps unsigned
    order onto signed order."""
    a.bitwise_xor_(_I64_MIN)
    torch.maximum(a, b ^ _I64_MIN, out=a)
    a.bitwise_xor_(_I64_MIN)


def merge_dense(state: LimiterState, other: LimiterState) -> LimiterState:
    """Full-state join: elementwise max of both CRDT planes (unsigned
    order, identical to signed on the non-negative domain of the planes)."""
    _u64_max_(state.pn, other.pn)
    _u64_max_(state.elapsed, other.elapsed)
    return state


def zero_rows(state: LimiterState, rows: torch.Tensor) -> LimiterState:
    """Clear bucket rows (slot recycling / eviction). Duplicates are fine."""
    rows = _c(rows)
    state.pn[rows] = 0
    state.elapsed[rows] = 0
    return state


class RowState(NamedTuple):
    pn: torch.Tensor  # int64[K, N, 2]
    elapsed: torch.Tensor  # int64[K]


def read_rows(state: LimiterState, rows: torch.Tensor) -> RowState:
    """Gather full per-bucket state for the given rows (a copy)."""
    rows = _c(rows)
    return RowState(pn=state.pn[rows], elapsed=state.elapsed[rows])
