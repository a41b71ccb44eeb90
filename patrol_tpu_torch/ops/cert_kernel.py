"""The certified families' kernels: the wrapper over ``csrc/cert.cu``.

A family call is one cooperative launch on the current stream
(``gcra_admit``, ``conc_admit``, ``quota_admit``): a persistent grid
gathers every column's rows from the pre-batch state and writes the
result matrix, the grid meets at one barrier (on the stream's word,
:func:`barrier_word`), and then each block applies its columns' own-lane
commits, only for columns that have something to commit: a signed max
for GCRA, wrapping adds for the other two. The grid is no larger than the
card holds resident (:func:`resident_blocks`) and no larger than K needs
(:func:`grid`). Reads finish before any write, so duplicate, aliased,
shared-ancestor and clamped rows all read the pre-batch state, as the
reference's gather-then-scatter does.

The packed request carries rows already cast to int32 and wrapped
(``[-B, 0)`` → ``+B``, :func:`wrap_rows`); the kernels clamp a row into
``[0, B)`` to gather and drop a commit outside it. The plain versions of
the three families are in :mod:`~patrol_tpu_torch.ops.gcra`,
:mod:`~patrol_tpu_torch.ops.concurrency` and
:mod:`~patrol_tpu_torch.ops.hierquota`. On a CUDA state these launch
the kernels or raise.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from patrol_tpu_torch.ops import _build

# family → (packed rows, result rows, own lanes a column commits); the row
# counts are the family modules' *_PACK_ROWS and *_RESULT_ROWS.
FAMILIES = {
    "gcra": (5, 4, 1),
    "conc": (5, 6, 2),
    "quota": (8, 5, 3),
}
_FUSED_IDS = {"gcra": 0, "conc": 1, "quota": 2}  # patrol_cert_fused's family argument
TILE = 32  # columns a block takes at a time (cert.cu kTile)

# (family, device index) → blocks the card holds resident at once.
_RESIDENT: Dict[Tuple[str, int], int] = {}
# (device index, stream) → the kernels' grid barrier word: int32,
# zeroed once; every launch's barrier leaves its low 31 bits at zero.
# Launches on one stream never overlap, so they can share it.
_BARRIERS: Dict[Tuple[int, int], torch.Tensor] = {}
_BARRIERS_MU = threading.Lock()


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


def grid(k: int, resident: int) -> Tuple[int, int]:
    """A call's grid for K columns on a card that holds ``resident``
    blocks: → (blocks, the most tiles a block walks). K's tiles of
    :data:`TILE` columns go round-robin: block b takes tiles b,
    b + blocks, ... (the kernels' loop)."""
    tiles = -(-k // TILE)
    blocks = min(tiles, resident)
    return blocks, -(-tiles // blocks)


def resident_blocks(family: str, device: torch.device) -> int:
    """Blocks of a family's kernel the card holds at once (the
    occupancy call's blocks an SM times the SMs), asked once a process."""
    key = (family, device.index or 0)
    if key not in _RESIDENT:
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = _build.lib().patrol_cert_occupancy(
                _FUSED_IDS[family], ctypes.byref(per_sm), ctypes.byref(sms))
        _build.check_rc(rc, f"{family}_admit occupancy")
        if per_sm.value < 1:
            raise RuntimeError(f"{family}_admit: no block fits an SM")
        _RESIDENT[key] = per_sm.value * sms.value
    return _RESIDENT[key]


def barrier_word(device: torch.device, stream: int) -> torch.Tensor:
    """The grid barrier word of ``stream``, the current stream on
    ``device`` (made and zeroed on it at its first use)."""
    key = (device.index or 0, stream)
    with _BARRIERS_MU:
        if key not in _BARRIERS:
            _BARRIERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
        return _BARRIERS[key]


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


def fused(family: str, pn: torch.Tensor, packed: torch.Tensor, node_slot: int) -> torch.Tensor:
    """One family call as one cooperative launch: → the result matrix;
    ``pn`` is updated in place."""
    b, n = _check(pn, packed, family, node_slot)
    _, rows_out, per_col = FAMILIES[family]
    k = packed.shape[1]
    out = torch.empty((rows_out, k), dtype=torch.int64, device=pn.device)
    if k == 0:
        return out
    blocks, tiles = grid(k, resident_blocks(family, pn.device))
    # A block keeps one tile's entries in shared memory; the rest of what
    # its tiles can commit goes to its own stretch of the spill buffer.
    spill_len = per_col * TILE * (tiles - 1)
    spill = torch.empty(2 * blocks * spill_len, dtype=torch.int64, device=pn.device)
    stream = _build.stream_handle(pn)
    with _build.on_device(pn.device):
        rc = _build.lib().patrol_cert_fused(
            _FUSED_IDS[family], pn.data_ptr(), barrier_word(pn.device, stream).data_ptr(), b, n,
            node_slot, packed.data_ptr(), out.data_ptr(), spill.data_ptr(), spill_len, k, blocks,
            stream,
        )
    _build.check_rc(rc, f"{family}_admit")
    _build.count_launch(f"{family}_admit")
    return out


# The family modules' entry (ops/gcra.py, ops/concurrency.py, ops/hierquota.py).
run = fused
