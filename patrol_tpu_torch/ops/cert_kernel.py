"""The certified families' kernels: the wrapper over ``csrc/cert.cu``.

One family call is two launches on the current stream. The family's
admit kernel (``gcra_admit``, ``conc_admit`` or ``quota_admit``) gathers
every column's rows from the pre-batch state, writes the result matrix
and one commit entry per own-lane update (a flat ``pn`` offset, or -1,
and a value); then ``own_lane_commit`` applies the entries with atomics
(a signed max for GCRA, a wrapping add for the other two). Reads finish
before any write, so duplicate, aliased, shared-ancestor and clamped
rows all read the pre-batch state, as the reference's gather-then-scatter
does.

The packed request carries rows already cast to int32 and wrapped
(``[-B, 0)`` → ``+B``, :func:`wrap_rows`); the kernels clamp a row into
``[0, B)`` to gather and drop a commit outside it. The plain versions of
the three admits are in :mod:`~patrol_tpu_torch.ops.gcra`,
:mod:`~patrol_tpu_torch.ops.concurrency` and
:mod:`~patrol_tpu_torch.ops.hierquota`; the commit's is
:func:`own_lane_commit_plain`. On a CUDA state these launch the kernels
or raise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from patrol_tpu_torch.ops import _build

# family → (packed rows, result rows, commit entries per column, commit op);
# the row counts are the family modules' *_PACK_ROWS and *_RESULT_ROWS.
FAMILIES = {
    "gcra": (5, 4, 1, "max"),
    "conc": (5, 6, 2, "add"),
    "quota": (8, 5, 3, "add"),
}
_FAMILY_IDS = {"gcra": 0, "conc": 1, "quota": 2}  # patrol_cert_admit's switch
_OPS = {"max": 0, "add": 1}


def wrap_rows(rows: torch.Tensor, b: int) -> torch.Tensor:
    """int64 copy of a row vector cast to int32 (as the reference's
    ``np.asarray(rows, np.int32)``) with ``[-B, 0)`` wrapped to ``+B``."""
    r = rows.to(torch.int32).to(torch.int64)
    return torch.where(r < 0, r + b, r)


def wrap_rows_np(rows, b: int) -> np.ndarray:
    """numpy form of :func:`wrap_rows` (the engine packs on the host)."""
    r = np.asarray(rows, np.int32).astype(np.int64)
    return np.where(r < 0, r + b, r)


def pack(req, b: int, levels: int) -> torch.Tensor:
    """A family's request NamedTuple as its packed int64 matrix: the first
    ``levels`` fields are rows (cast and wrapped), the rest int64."""
    rows = [wrap_rows(r, b) for r in req[:levels]]
    return torch.stack([*rows, *(f.to(torch.int64) for f in req[levels:])]).contiguous()


def gather_index(rows: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wrapped rows → (gather index clamped into ``[0, B)``, commit mask)."""
    return rows.clamp(0, b - 1), (rows >= 0) & (rows < b)


def own_lane_commit_plain(pn: torch.Tensor, commit: torch.Tensor, op: str) -> None:
    """The commit kernel's plain version: ``commit`` is int64[2, M] (flat
    ``pn`` offsets, -1 for none; values); a scatter-max or a scatter-add
    (wrapping) into ``pn`` in place."""
    live = commit[0] >= 0
    off, val = commit[0][live], commit[1][live]
    flat = pn.view(-1)
    if op == "max":
        flat.scatter_reduce_(0, off, val, reduce="amax")
    else:
        flat.index_put_((off,), val, accumulate=True)


def _check(pn: torch.Tensor, packed: torch.Tensor, family: str, node_slot: int):
    dev = pn.device
    if dev.type != "cuda":
        raise ValueError(f"the cert kernels run on CUDA tensors, got {dev}")
    _build.check_int64("pn", pn, dev)
    _build.check_int64("packed", packed, dev)
    b, n, two = pn.shape
    if two != 2:
        raise ValueError("pn must be [B, N, 2]")
    rows_in = FAMILIES[family][0]
    if packed.dim() != 2 or packed.shape[0] != rows_in:
        raise ValueError(f"packed must be [{rows_in}, K], got {tuple(packed.shape)}")
    if not 0 <= node_slot < n:
        raise ValueError(f"node_slot {node_slot} outside [0, {n})")
    if pn.data_ptr() % 16:
        raise ValueError("pn must be 16-byte aligned (its lanes are read as 16-byte vectors)")
    return b, n


def admit(
    family: str, pn: torch.Tensor, packed: torch.Tensor, node_slot: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one family's admit kernel: → (result int64[RESULT_ROWS, K],
    commit int64[2, per_col * K]). Reads ``pn`` only."""
    b, n = _check(pn, packed, family, node_slot)
    _, rows_out, per_col, _ = FAMILIES[family]
    k = packed.shape[1]
    out = torch.empty((rows_out, k), dtype=torch.int64, device=pn.device)
    commit = torch.empty((2, per_col * k), dtype=torch.int64, device=pn.device)
    if k == 0:
        return out, commit
    rc = _build.lib().patrol_cert_admit(
        _FAMILY_IDS[family], pn.data_ptr(), b, n, node_slot, packed.data_ptr(),
        out.data_ptr(), commit.data_ptr(), k, _build.stream_handle(pn),
    )
    _build.check_rc(rc, f"{family}_admit")
    _build.count_launch(f"{family}_admit")
    return out, commit


def own_lane_commit(pn: torch.Tensor, commit: torch.Tensor, op: str) -> None:
    """Launch the commit kernel over ``commit`` (int64[2, M]) into ``pn``."""
    dev = pn.device
    if dev.type != "cuda":
        raise ValueError(f"the cert kernels run on CUDA tensors, got {dev}")
    _build.check_int64("pn", pn, dev)
    _build.check_int64("commit", commit, dev)
    if commit.dim() != 2 or commit.shape[0] != 2:
        raise ValueError(f"commit must be [2, M], got {tuple(commit.shape)}")
    m = commit.shape[1]
    if m == 0:
        return
    rc = _build.lib().patrol_own_lane_commit(
        pn.data_ptr(), pn.numel(), commit.data_ptr(), m, _OPS[op], _build.stream_handle(pn),
    )
    _build.check_rc(rc, "own_lane_commit")
    _build.count_launch("own_lane_commit")


def run(family: str, pn: torch.Tensor, packed: torch.Tensor, node_slot: int) -> torch.Tensor:
    """One family call on a CUDA state: admit, then commit; → the result
    matrix. ``pn`` is updated in place."""
    out, commit = admit(family, pn, packed, node_slot)
    own_lane_commit(pn, commit, FAMILIES[family][3])
    return out
