"""The per-row read-modify-write scatter: a wrapper over ``csrc/row_rmw.cu``
and its plain PyTorch version.

Replaces ``scripts/probe_dma_scatter.py::mk_kern``, the DMA-pipeline
probe of a whole-row RMW join. The state is ``int32[B, 8, 128]``: each
row 512 int64 values with (lo, hi) int32 halves interleaved, which is the
limiter's ``pn int64[B, 256, 2]`` seen through :func:`probe_view`. For
update ``j`` (``rows``, ``w0``, ``lo``, ``hi``: int32[K]):

* ``bcast``: every int32 of row ``rows[j]`` becomes ``max(value, lo[j])``;
* ``pairmax``: every int64 pair ``p`` of the row becomes
  ``max(pair, upd)``, signed, where ``upd`` is
  ``(int64(hi[j]) << 32) | uint32(lo[j])`` at ``p == w0[j] >> 1`` and 0
  elsewhere — so a negative pair of a touched row rises to 0.

The state is updated IN PLACE (the probe aliased it). Rows outside
``[0, B)`` are dropped; update rows must be unique. On a CUDA state the
wrapper launches the kernel, or raises; the plain version runs only for a
state that lies on the CPU.
"""

from __future__ import annotations

import torch

from patrol_tpu_torch.ops import _build

S, L = 8, 128
ROW_INTS = S * L
INNERS = {"bcast": 0, "pairmax": 1}


def probe_view(pn: torch.Tensor) -> torch.Tensor:
    """The probe's ``int32[B, 8, 128]`` view of a ``pn int64[B, 256, 2]``
    (no copy: writes through it land in ``pn``). On a little-endian device
    an int64 value's low half is the even int32, so pair ``p`` of a row is
    ``pn[row, p // 2, p % 2]``."""
    if pn.dtype != torch.int64 or pn.dim() != 3 or tuple(pn.shape[1:]) != (ROW_INTS // 4, 2):
        raise ValueError(
            f"probe_view needs pn int64[B, {ROW_INTS // 4}, 2], got {pn.dtype} {tuple(pn.shape)}"
        )
    if not pn.is_contiguous():
        raise ValueError("probe_view needs a contiguous pn")
    return pn.view(torch.int32).view(pn.shape[0], S, L)


def pair_value(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The int64 value of each (lo, hi) int32 update pair:
    ``(int64(hi) << 32) | uint32(lo)``."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)


def row_rmw_plain(
    state: torch.Tensor,
    rows: torch.Tensor,
    w0: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    inner: str,
) -> torch.Tensor:
    """The plain version: ``index_select`` the touched rows, take the max,
    ``index_copy_`` them back. Raises on duplicate rows (the kernel's
    contract excludes them)."""
    b = state.shape[0]
    flat = state.view(b, ROW_INTS)
    ok = (rows >= 0) & (rows < b)
    r = rows[ok].to(torch.int64)
    if torch.unique(r).numel() != r.numel():
        raise ValueError("row_rmw: update rows must be unique")
    cur = flat.index_select(0, r)
    if inner == "bcast":
        new = torch.maximum(cur, lo[ok].unsqueeze(1))
    elif inner == "pairmax":
        pair, val = w0[ok].to(torch.int64) >> 1, pair_value(lo[ok], hi[ok])
        upd = torch.zeros((r.numel(), ROW_INTS // 2), dtype=torch.int64, device=state.device)
        hit = (pair >= 0) & (pair < ROW_INTS // 2)
        upd[torch.nonzero(hit).squeeze(1), pair[hit]] = val[hit]
        new = torch.maximum(cur.view(torch.int64), upd).view(torch.int32)
    else:
        raise ValueError(f"unknown inner {inner!r}; expected one of {sorted(INNERS)}")
    flat.index_copy_(0, r, new)
    return state


def row_rmw(
    state: torch.Tensor,
    rows: torch.Tensor,
    w0: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    inner: str,
) -> torch.Tensor:
    """Apply K row updates to ``state int32[B, 8, 128]`` in place; →
    ``state``. ``rows``, ``w0``, ``lo``, ``hi`` are contiguous int32[K] on
    the state's device; ``inner`` is ``"bcast"`` or ``"pairmax"``."""
    dev = state.device
    _build.check_operand("state", state, torch.int32, dev)
    if state.dim() != 3 or tuple(state.shape[1:]) != (S, L):
        raise ValueError(f"state must be int32[B, {S}, {L}], got {tuple(state.shape)}")
    for name, t in (("rows", rows), ("w0", w0), ("lo", lo), ("hi", hi)):
        _build.check_operand(name, t, torch.int32, dev)
    k = rows.numel()
    if not (w0.numel() == lo.numel() == hi.numel() == k):
        raise ValueError("rows, w0, lo and hi must have one length")
    if inner not in INNERS:
        raise ValueError(f"unknown inner {inner!r}; expected one of {sorted(INNERS)}")
    if dev.type == "cpu":
        return row_rmw_plain(
            state, rows.reshape(-1), w0.reshape(-1), lo.reshape(-1), hi.reshape(-1), inner
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if k == 0:
        return state
    with _build.on_device(state.device):
        rc = _build.lib().patrol_row_rmw(
            state.data_ptr(), state.shape[0], rows.data_ptr(), w0.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), k, INNERS[inner], _build.stream_handle(state),
        )
    _build.check_rc(rc, "row_rmw")
    _build.count_launch("row_rmw")
    return state
