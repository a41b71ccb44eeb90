"""Coalesced device commit (counterpart of ``patrol_tpu/ops/commit.py``).

A commit is an ``int64[6, J, K]`` block ring — J blocks of K folded pairs
each (rows, slots, added, taken, erows, elapsed), the flattened view
sorted and unique with out-of-range sentinel padding — committed as ONE
join-kernel launch instead of J. Exact because the join is commutative
and idempotent. :func:`commit_shape` and :func:`pack_commit_blocks` are
the host packers (numpy), as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from patrol_tpu_torch.models.limiter import LimiterState
from patrol_tpu_torch.ops.join_kernel import pair_join
from patrol_tpu_torch.ops.merge import FOLD_PAD_ROW


class CommitBlocks(NamedTuple):
    """J fixed-shape blocks of host-folded merge pairs, committed in one
    launch (see :func:`pack_commit_blocks` for the invariants)."""

    rows: torch.Tensor  # [J, K]
    slots: torch.Tensor  # [J, K]
    added_nt: torch.Tensor  # int64[J, K]
    taken_nt: torch.Tensor  # int64[J, K]
    erows: torch.Tensor  # [J, K]
    elapsed_ns: torch.Tensor  # int64[J, K]


def commit_blocks(state: LimiterState, blocks: CommitBlocks) -> LimiterState:
    """Fold a whole block ring into state with ONE join launch, in place."""

    def flat(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.int64).reshape(-1).contiguous()

    pair_join(
        state.pn, state.elapsed, flat(blocks.rows), flat(blocks.slots),
        flat(blocks.added_nt), flat(blocks.taken_nt), flat(blocks.erows),
        flat(blocks.elapsed_ns),
    )
    return state


def commit_packed(state: LimiterState, packed: torch.Tensor) -> LimiterState:
    """:func:`commit_blocks` over the packed ``int64[6, J, K]`` (or
    ``[6, K]``) staging matrix the engine ships."""
    return commit_blocks(state, CommitBlocks(*packed.unbind(0)))


def commit_shape(n_pairs: int, block_rows: int) -> Tuple[int, int, int]:
    """The staging-buffer shape for a fold of ``n_pairs`` pairs: (6, J,
    block_rows) with J the smallest power of two whose ring holds the
    fold — the shape key the engine's StagingPool recycles on."""
    j = 1
    while j * block_rows < n_pairs:
        j <<= 1
    return (6, j, block_rows)


def pack_commit_blocks(
    ur: np.ndarray,
    us: np.ndarray,
    ua: np.ndarray,
    ut: np.ndarray,
    er: np.ndarray,
    e: np.ndarray,
    block_rows: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Pack one cross-block fold (sorted unique pairs + per-row elapsed,
    engine._fold_core's output) into the int64[6, J, K] commit matrix.
    ``out``, when given, is a staging buffer of exactly
    :func:`commit_shape`'s shape (leased from the engine pool and
    refilled in place). Sentinel tail mirrors engine._pack_folded: rows
    above every live row keep the flattened keys sorted, distinct
    slots/rows keep them unique, and the join drops them."""
    n, ne = len(ur), len(er)
    if out is None:
        out = np.empty(commit_shape(n, block_rows), dtype=np.int64)
    elif out.shape[0] != 6 or out.shape[1] * out.shape[2] < n:
        raise ValueError(
            f"staging buffer shape {tuple(out.shape)} cannot hold {n} pairs"
        )
    k = out.shape[1] * out.shape[2]
    flat = out.reshape(6, k)
    flat[0, :n] = ur
    flat[1, :n] = us
    flat[2, :n] = ua
    flat[3, :n] = ut
    flat[0, n:] = FOLD_PAD_ROW
    flat[1, n:] = np.arange(k - n)
    flat[2, n:] = 0
    flat[3, n:] = 0
    flat[4, :ne] = er
    flat[5, :ne] = e
    flat[4, ne:] = FOLD_PAD_ROW + np.arange(k - ne)
    flat[5, ne:] = 0
    return out
