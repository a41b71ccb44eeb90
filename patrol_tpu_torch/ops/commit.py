"""Coalesced device commit (counterpart of ``patrol_tpu/ops/commit.py``).

A commit is an ``int64[6, J, K]`` block ring — J blocks of K folded pairs
each (rows, slots, added, taken, erows, elapsed), the flattened view
sorted and unique with out-of-range sentinel padding — committed as ONE
join-kernel launch instead of J. Exact because the join is commutative
and idempotent. :func:`commit_shape` and :func:`pack_commit_blocks` are
the host packers (numpy), as in the reference. The engine commits only
the live prefix of a ring (:func:`commit_packed` with the fold's counts).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from patrol_tpu_torch.models.limiter import LimiterState
from patrol_tpu_torch.ops.join_kernel import pair_join
from patrol_tpu_torch.ops.merge import FOLD_PAD_ROW


def commit_packed(
    state: LimiterState,
    packed: torch.Tensor,
    n: Optional[int] = None,
    ne: Optional[int] = None,
) -> LimiterState:
    """Fold a packed ``int64[6, J, K]`` (or ``[6, K]``) block ring, the
    staging matrix the engine ships, into state with ONE join launch, in
    place. ``n`` and ``ne``, when given, are the live counts of its pair
    and elapsed rows (``len(ur)`` and ``len(er)`` of the fold): the join
    then gets the live prefixes only and never loads the sentinel tail
    (see :func:`live_pairs`)."""
    pair_join(state.pn, state.elapsed, *live_pairs(packed, n, ne, state.pn.shape[0]))
    return state


def live_pairs(
    packed: torch.Tensor, n: Optional[int], ne: Optional[int], buckets: int
) -> Tuple[torch.Tensor, ...]:
    """The pair half of a packed ``[6, J, K]`` or ``[6, K]`` matrix as
    views of its live prefixes: rows, slots, added and taken cut at ``n``,
    erows and elapsed at ``ne`` (None: the whole row). On a CPU tensor,
    every entry past a count must be a sentinel (a row outside ``[0,
    buckets)``), else ValueError; on a card that check would be a device
    sync and is not made."""
    flat = packed.reshape(6, -1)
    k = flat.shape[1]
    n = k if n is None else n
    ne = k if ne is None else ne
    if not (0 <= n <= k and 0 <= ne <= k):
        raise ValueError(f"live counts ({n}, {ne}) outside a ring of {k}")
    if flat.device.type == "cpu":
        for row, count, what in ((flat[0], n, "pair"), (flat[4], ne, "elapsed")):
            tail = row[count:]
            if ((tail >= 0) & (tail < buckets)).any():
                raise ValueError(f"a live {what} entry lies past the live count {count}")
    return (
        flat[0, :n], flat[1, :n], flat[2, :n], flat[3, :n], flat[4, :ne], flat[5, :ne]
    )


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
