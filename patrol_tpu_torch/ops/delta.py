"""Delta-interval fold — the device half of the wire-v2 python-decode path
(counterpart of ``patrol_tpu/ops/delta.py``).

One decoded delta datagram carries hundreds of bucket join-decompositions:
absolute PN-lane values, monotone by construction. :func:`delta_fold`
joins a whole interval into state in ONE launch of the scatter-max join
kernel (:func:`patrol_tpu_torch.ops.join_kernel.pair_join`): the same
lattice join as ops/merge.py, with ``FOLD_PAD_ROW`` padding dropped.
State is updated IN PLACE.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from patrol_tpu_torch.models.limiter import LimiterState
from patrol_tpu_torch.ops.join_kernel import pair_join
from patrol_tpu_torch.ops.merge import FOLD_PAD_ROW  # noqa: F401  (re-export: the
# sentinel contract is shared with the tick fold and the commit ring)
from patrol_tpu_torch.ops.merge import wrap_index


class DeltaBatch(NamedTuple):
    """K decoded delta-interval entries. Padding entries carry
    ``FOLD_PAD_ROW`` (out of range ⇒ dropped); live entries are
    non-negative absolute lane values (the decode guard rejects bit-63 wire
    values, ingest clamps the rest)."""

    rows: torch.Tensor  # [K]; FOLD_PAD_ROW marks padding
    slots: torch.Tensor  # [K] origin node lane
    added_nt: torch.Tensor  # int64[K] absolute own-lane PN values
    taken_nt: torch.Tensor  # int64[K]
    elapsed_ns: torch.Tensor  # int64[K]


def delta_fold(state: LimiterState, batch: DeltaBatch) -> LimiterState:
    """Join one delta interval into state: scatter-max of K (row, slot)
    lane pairs plus the per-row elapsed max, in place. Duplicate keys are
    fine (max is commutative, associative and idempotent); sentinel rows
    are dropped, and negative rows and slots wrap as in
    :mod:`patrol_tpu_torch.ops.merge`."""
    b, n, _ = state.pn.shape
    rows = wrap_index(batch.rows, b)
    pair_join(
        state.pn, state.elapsed, rows,
        wrap_index(batch.slots, n),
        batch.added_nt.to(torch.int64).contiguous(),
        batch.taken_nt.to(torch.int64).contiguous(),
        rows,
        batch.elapsed_ns.to(torch.int64).contiguous(),
    )
    return state
