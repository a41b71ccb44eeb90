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

Indices follow the reference's scatter and gather: a row in ``[-B, 0)``
or a slot in ``[-N, 0)`` wraps (``+B``, ``+N``), numpy style; any other
row or slot outside ``[0, B)`` / ``[0, N)`` is dropped by the joins and
:func:`zero_rows`, and clamped into range by :func:`read_rows`. The
kernel itself drops every out-of-range index (``FOLD_PAD_ROW`` padding
relies on it), so the wrap happens here, in the wrappers.
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


def wrap_index(t: torch.Tensor, n: int) -> torch.Tensor:
    """int64 copy of an index tensor with ``[-n, 0)`` wrapped to ``+n``
    (the reference's negative-index rule); everything else as it was."""
    t = t.to(torch.int64)
    return torch.where(t < 0, t + n, t).contiguous()


def merge_batch(state: LimiterState, batch: MergeBatch) -> LimiterState:
    """Scatter-max K deltas into state (≙ bucket.go:240-263 per delta)."""
    b, n, _ = state.pn.shape
    rows = wrap_index(batch.rows, b)
    pair_join(
        state.pn, state.elapsed, rows, wrap_index(batch.slots, n), _c(batch.added_nt),
        _c(batch.taken_nt), rows, _c(batch.elapsed_ns),
    )
    return state


def merge_batch_folded(state: LimiterState, batch: FoldedMergeBatch) -> LimiterState:
    """Scatter-max of a host-folded batch (sentinel rows dropped)."""
    b, n, _ = state.pn.shape
    pair_join(
        state.pn, state.elapsed, wrap_index(batch.rows, b),
        wrap_index(batch.slots, n), _c(batch.added_nt), _c(batch.taken_nt),
        wrap_index(batch.erows, b), _c(batch.elapsed_ns),
    )
    return state


def merge_rows_dense(state: LimiterState, batch: RowDenseBatch) -> LimiterState:
    """Scatter-max R full-row lane windows into state."""
    row_join(
        state.pn, state.elapsed, wrap_index(batch.rows, state.pn.shape[0]),
        _c(batch.updates),
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
    one join commits the attributed pairs. The gather clamps its indices,
    as the reference's does; an entry it clamped is dropped by the join."""
    b, n, _ = state.pn.shape
    rows = wrap_index(batch.rows, b)
    slots = wrap_index(batch.slots, n)
    pn_rows = state.pn[rows.clamp(0, b - 1)]  # [K, N, 2] gather
    ar = torch.arange(rows.numel(), device=rows.device)
    gs = slots.clamp(0, n - 1)
    lane_a = pn_rows[ar, gs, ADDED]
    lane_t = pn_rows[ar, gs, TAKEN]
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
    """Clear bucket rows (slot recycling / eviction). Duplicates are fine;
    rows out of range after the wrap are dropped."""
    b = state.pn.shape[0]
    rows = wrap_index(rows, b)
    rows = rows[(rows >= 0) & (rows < b)]
    state.pn[rows] = 0
    state.elapsed[rows] = 0
    return state


class RowState(NamedTuple):
    pn: torch.Tensor  # int64[K, N, 2]
    elapsed: torch.Tensor  # int64[K]


def read_rows(state: LimiterState, rows: torch.Tensor) -> RowState:
    """Gather full per-bucket state for the given rows (a copy); rows out
    of range after the wrap are clamped to ``[0, B)``."""
    b = state.pn.shape[0]
    rows = wrap_index(rows, b).clamp(0, b - 1)
    return RowState(pn=state.pn[rows], elapsed=state.elapsed[rows])
