"""The scatter-max CRDT join: wrappers over ``csrc/join.cu`` and their
plain PyTorch versions.

Replaces ``patrol_tpu/ops/pallas_merge.py::_kernel``. Two entry points
serve the whole join family of :mod:`patrol_tpu_torch.ops.merge` and
:mod:`patrol_tpu_torch.ops.commit`:

* :func:`pair_join` — K (row, slot, added, taken) pairs plus Ke
  (erow, elapsed) entries, each max-joined into state;
* :func:`row_join` — R rows whose whole ``N × 2`` lane plane is
  max-joined at once (the dense half of the tick fold).

Both update ``pn``/``elapsed`` IN PLACE and return them. Entries whose
row lies outside ``[0, B)`` or slot outside ``[0, N)`` are dropped, never
clamped (``FOLD_PAD_ROW`` sentinel padding relies on that). On a CUDA
state the wrapper launches the kernel, or raises; the plain version runs
only for a state that lies on the CPU.
"""

from __future__ import annotations

from typing import Tuple

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
    for name, t in (("rows", rows), ("slots", slots), ("added", added),
                    ("taken", taken), ("erows", erows), ("evals", evals)):
        _build.check_int64(name, t, dev)
    k = rows.numel()
    if not (slots.numel() == added.numel() == taken.numel() == k):
        raise ValueError("rows, slots, added and taken must have one length")
    if erows.numel() != evals.numel():
        raise ValueError("erows and evals must have one length")
    if dev.type == "cpu":
        return pair_join_plain(
            pn, elapsed, rows.reshape(-1), slots.reshape(-1), added.reshape(-1),
            taken.reshape(-1), erows.reshape(-1), evals.reshape(-1),
        )
    ke = erows.numel()
    if k + ke == 0:
        return pn, elapsed
    b, n, _ = pn.shape
    rc = _build.lib().patrol_pair_join(
        pn.data_ptr(), elapsed.data_ptr(), b, n,
        rows.data_ptr(), slots.data_ptr(), added.data_ptr(), taken.data_ptr(), k,
        erows.data_ptr(), evals.data_ptr(), ke, _build.stream_handle(pn),
    )
    _build.check_rc(rc, "pair_join")
    _build.count_launch("pair_join")
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
    for name, t in (("rows", rows), ("updates", updates), ("evals", evals)):
        _build.check_int64(name, t, dev)
    r = rows.numel()
    b, n, _ = pn.shape
    if tuple(updates.shape) != (r, n, 2) or evals.numel() != r:
        raise ValueError(
            f"updates must be [{r}, {n}, 2] and evals [{r}], got "
            f"{tuple(updates.shape)} and {tuple(evals.shape)}"
        )
    if dev.type == "cpu":
        return row_join_plain(pn, elapsed, rows.reshape(-1), updates, evals.reshape(-1))
    if r == 0:
        return pn, elapsed
    rc = _build.lib().patrol_row_join(
        pn.data_ptr(), elapsed.data_ptr(), b, n,
        rows.data_ptr(), updates.data_ptr(), evals.data_ptr(), r,
        _build.stream_handle(pn),
    )
    _build.check_rc(rc, "row_join")
    _build.count_launch("row_join")
    return pn, elapsed
