"""The scatter-max CRDT join: wrappers over ``csrc/join.cu`` and their
plain PyTorch versions.

Replaces ``patrol_tpu/ops/pallas_merge.py::_kernel``. One kernel
(``patrol_join``) takes a dense half and a pair half, either one empty;
three wrappers serve the whole join family of
:mod:`patrol_tpu_torch.ops.merge`, :mod:`patrol_tpu_torch.ops.commit` and
the engine's merge tick:

* :func:`pair_join` — K (row, slot, added, taken) pairs plus Ke
  (erow, elapsed) entries, each max-joined into state;
* :func:`row_join` — R rows whose whole ``N × 2`` lane plane is
  max-joined at once (the dense half of the tick fold);
* :func:`tick_join` — both halves of one merge tick in one launch.

All update ``pn``/``elapsed`` IN PLACE and return them. Entries whose
row lies outside ``[0, B)`` or slot outside ``[0, N)`` are dropped, never
clamped (``FOLD_PAD_ROW`` sentinel padding relies on that). The kernel's
grid is sized from the operands' lengths, so callers pass the live prefix
of a padded batch, and nothing live launches nothing.

On a CUDA state the wrapper launches the kernel, or raises; the plain
version runs only for a state that lies on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from patrol_tpu_torch.ops import _build


def pair_join_plain(
    pn: torch.Tensor,
    elapsed: torch.Tensor,
    rows: torch.Tensor,
    slots: torch.Tensor,
    added: torch.Tensor,
    taken: torch.Tensor,
    erows: torch.Tensor,
    evals: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``scatter_reduce_(amax)`` over the flattened
    ``pn`` with out-of-range entries masked out first (torch index ops
    raise on them, the kernel drops them)."""
    b, n, _ = pn.shape
    ok = (rows >= 0) & (rows < b) & (slots >= 0) & (slots < n)
    flat = rows[ok] * n + slots[ok]
    src = torch.stack([added[ok], taken[ok]], dim=1)
    pn.view(b * n, 2).scatter_reduce_(
        0, flat.unsqueeze(1).expand(-1, 2), src, reduce="amax", include_self=True
    )
    eok = (erows >= 0) & (erows < b)
    elapsed.scatter_reduce_(0, erows[eok], evals[eok], reduce="amax", include_self=True)
    return pn, elapsed


def row_join_plain(
    pn: torch.Tensor,
    elapsed: torch.Tensor,
    rows: torch.Tensor,
    updates: torch.Tensor,
    evals: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dense join: one ``scatter_reduce_(amax)``
    of whole ``[N, 2]`` row windows, out-of-range rows masked out."""
    b, n, _ = pn.shape
    ok = (rows >= 0) & (rows < b)
    r = rows[ok]
    pn.scatter_reduce_(
        0, r.view(-1, 1, 1).expand(-1, n, 2), updates[ok],
        reduce="amax", include_self=True,
    )
    elapsed.scatter_reduce_(0, r, evals[ok], reduce="amax", include_self=True)
    return pn, elapsed


def tick_join_plain(
    pn: torch.Tensor,
    elapsed: torch.Tensor,
    dense: Optional[Sequence[torch.Tensor]],
    pairs: Optional[Sequence[torch.Tensor]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of one tick: :func:`row_join_plain` of the dense
    half, then :func:`pair_join_plain` of the pair half. Exact in either
    order: the max-join is commutative and idempotent."""
    if dense is not None:
        row_join_plain(pn, elapsed, *dense)
    if pairs is not None:
        pair_join_plain(pn, elapsed, *pairs)
    return pn, elapsed


def _check_state(pn: torch.Tensor, elapsed: torch.Tensor) -> torch.device:
    dev = pn.device
    _build.check_int64("pn", pn, dev)
    _build.check_int64("elapsed", elapsed, dev)
    if pn.dim() != 3 or pn.shape[2] != 2 or elapsed.shape != (pn.shape[0],):
        raise ValueError(
            f"state must be pn[B,N,2] and elapsed[B], got {tuple(pn.shape)} "
            f"and {tuple(elapsed.shape)}"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_pairs(pairs: Sequence[torch.Tensor], dev: torch.device) -> None:
    """A pair half: (rows, slots, added, taken, erows, evals)."""
    if len(pairs) != 6:
        raise ValueError(f"a pair half has 6 operands, got {len(pairs)}")
    for name, t in zip(("rows", "slots", "added", "taken", "erows", "evals"), pairs):
        _build.check_int64(name, t, dev)
    rows, slots, added, taken, erows, evals = pairs
    k = rows.numel()
    if not (slots.numel() == added.numel() == taken.numel() == k):
        raise ValueError("rows, slots, added and taken must have one length")
    if erows.numel() != evals.numel():
        raise ValueError("erows and evals must have one length")


def _check_dense(dense: Sequence[torch.Tensor], dev: torch.device, n: int) -> None:
    """A dense half: (rows, updates[R, N, 2], evals[R])."""
    if len(dense) != 3:
        raise ValueError(f"a dense half has 3 operands, got {len(dense)}")
    for name, t in zip(("rows", "updates", "evals"), dense):
        _build.check_int64(name, t, dev)
    rows, updates, evals = dense
    r = rows.numel()
    if tuple(updates.shape) != (r, n, 2) or evals.numel() != r:
        raise ValueError(
            f"updates must be [{r}, {n}, 2] and evals [{r}], got "
            f"{tuple(updates.shape)} and {tuple(evals.shape)}"
        )


def _launch(pn, elapsed, dense, pairs, name: str) -> None:
    """One launch of the join kernel over both halves (either may be
    None); nothing live launches nothing and counts nothing."""
    b, n, _ = pn.shape
    r = dense[0].numel() if dense is not None else 0
    k = pairs[0].numel() if pairs is not None else 0
    ke = pairs[4].numel() if pairs is not None else 0
    if r + k + ke == 0:
        return
    if r and dense[1].data_ptr() % 16:
        raise ValueError("dense updates must be 16-byte aligned")
    d = [t.data_ptr() for t in dense] if r else [None] * 3
    p = [t.data_ptr() for t in pairs] if k + ke else [None] * 6
    with _build.on_device(pn.device):
        rc = _build.lib().patrol_join(
            pn.data_ptr(), elapsed.data_ptr(), b, n, d[0], d[1], d[2], r,
            p[0], p[1], p[2], p[3], k, p[4], p[5], ke, _build.stream_handle(pn),
        )
    _build.check_rc(rc, name)
    _build.count_launch(name)


def pair_join(
    pn: torch.Tensor,
    elapsed: torch.Tensor,
    rows: torch.Tensor,
    slots: torch.Tensor,
    added: torch.Tensor,
    taken: torch.Tensor,
    erows: torch.Tensor,
    evals: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter-max K pairs and Ke elapsed entries into state, in place.
    All arguments are contiguous int64 on the state's device; ``rows``,
    ``slots``, ``added``, ``taken`` have one shape (flattened), as do
    ``erows``/``evals``."""
    dev = _check_state(pn, elapsed)
    _check_pairs((rows, slots, added, taken, erows, evals), dev)
    pairs = tuple(t.reshape(-1) for t in (rows, slots, added, taken, erows, evals))
    if dev.type == "cpu":
        return pair_join_plain(pn, elapsed, *pairs)
    _launch(pn, elapsed, None, pairs, "pair_join")
    return pn, elapsed


def row_join(
    pn: torch.Tensor,
    elapsed: torch.Tensor,
    rows: torch.Tensor,
    updates: torch.Tensor,
    evals: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter-max R full-row lane windows ``updates[R, N, 2]`` (and
    ``evals[R]`` into ``elapsed``) into state, in place."""
    dev = _check_state(pn, elapsed)
    _check_dense((rows, updates, evals), dev, pn.shape[1])
    dense = (rows.reshape(-1), updates, evals.reshape(-1))
    if dev.type == "cpu":
        return row_join_plain(pn, elapsed, *dense)
    _launch(pn, elapsed, dense, None, "row_join")
    return pn, elapsed


def tick_join(
    pn: torch.Tensor,
    elapsed: torch.Tensor,
    dense: Optional[Sequence[torch.Tensor]],
    pairs: Optional[Sequence[torch.Tensor]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One merge tick in ONE launch: the dense half ``(rows, updates[R,
    N, 2], evals)`` and the pair half ``(rows, slots, added, taken,
    erows, evals)``, either of them None or empty. Exact because the
    max-join is commutative and idempotent; the tick fold gives the two
    halves disjoint rows."""
    dev = _check_state(pn, elapsed)
    if dense is not None:
        _check_dense(dense, dev, pn.shape[1])
        dense = (dense[0].reshape(-1), dense[1], dense[2].reshape(-1))
    if pairs is not None:
        _check_pairs(pairs, dev)
        pairs = tuple(t.reshape(-1) for t in pairs)
    if dev.type == "cpu":
        return tick_join_plain(pn, elapsed, dense, pairs)
    _launch(pn, elapsed, dense, pairs, "tick_join")
    return pn, elapsed
