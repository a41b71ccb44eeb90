"""Take-n: the wrapper over ``csrc/take.cu`` and its plain PyTorch version.

One call is one engine take tick: the packed ``int64[8, K]`` request
matrix in, the ``int64[7, K]`` result matrix out, the admitting rows'
own lane and ``elapsed`` committed IN PLACE. It computes
``patrol_tpu/ops/take.py::take_n_batch`` (whose body is ``take_batch``).
On a CUDA state the wrapper launches the kernel, or raises; the plain
version runs only for a state that lies on the CPU.
"""

from __future__ import annotations

import torch

from patrol_tpu_torch.models.limiter import ADDED, NANO, TAKEN
from patrol_tpu_torch.ops import _build

TAKE_PACK_ROWS = 8
TAKE_RESULT_ROWS = 7

# Refill grants are clipped here before the float64→int64 cast.
_GRANT_CLIP = float(2**62)


def take_n_plain(
    pn: torch.Tensor, elapsed: torch.Tensor, packed: torch.Tensor, node_slot: int
) -> torch.Tensor:
    """The plain version: a torch transcription of ``take_batch``
    (reference ``take.py:176-253``) over the packed layout. Index
    semantics follow the reference: rows cast to int32, negative rows
    wrap by B, the gather clamps, the commit drops out-of-range rows.
    A column with ``nreq <= 0`` (the engine's padding) gets an all-zero
    result column, as the kernel gives it; the reference computes one
    from the aliased row, which the engine never reads."""
    i64 = torch.int64
    b = pn.shape[0]
    rows = packed[0].to(torch.int32).to(i64)
    rows = torch.where(rows < 0, rows + b, rows)
    in_range = (rows >= 0) & (rows < b)
    g = rows.clamp(0, b - 1)
    now, freq, per, count, nreq, cap_base, created = packed[1:8]

    pn_rows = pn[g]  # [K, N, 2] gather
    sum_added = pn_rows[:, :, ADDED].sum(dim=-1)
    sum_taken = pn_rows[:, :, TAKEN].sum(dim=-1)
    el = elapsed[g]

    cap_now = freq * NANO
    tokens = cap_base + sum_added - sum_taken
    last = torch.minimum(created + el, now)
    delta = now - last

    one = torch.ones_like(freq)
    safe_freq = torch.where(freq == 0, one, freq)
    interval = torch.div(per, safe_freq, rounding_mode="floor")
    rate_zero = (freq == 0) | (per == 0) | (interval == 0)
    safe_interval = torch.where(interval == 0, one, interval)
    grant_tokens = delta.to(torch.float64) / safe_interval.to(torch.float64)
    grant_f = torch.where(
        rate_zero, torch.zeros_like(grant_tokens), grant_tokens * float(NANO)
    )
    grant = torch.floor(grant_f.clamp(0.0, _GRANT_CLIP)).to(i64)
    grant = torch.minimum(grant, cap_now - tokens)
    have = tokens + grant

    safe_count = torch.where(count <= 0, one, count)
    k = torch.div(have, safe_count, rounding_mode="floor")
    k = torch.minimum(torch.clamp(k, min=0), nreq)
    k = torch.where(count > 0, k, torch.zeros_like(k))
    success = k >= 1

    zero = torch.zeros_like(k)
    forfeit = torch.clamp(-grant, min=0)
    d_added = torch.where(success, torch.clamp(grant, min=0), zero)
    d_taken = torch.where(success, k * count + forfeit, zero)
    d_elapsed = torch.where(success, delta, zero)

    out = torch.stack(
        [
            have,
            k,
            pn_rows[:, node_slot, ADDED] + d_added,
            pn_rows[:, node_slot, TAKEN] + d_taken,
            el + d_elapsed,
            sum_added + d_added,
            sum_taken + d_taken,
        ]
    )
    out = torch.where(nreq > 0, out, torch.zeros_like(out))
    # Commit: scatter-add of the deltas (padding rows add zeros), out of
    # range rows dropped — the reference's scatter semantics.
    cr = rows[in_range]
    pn[:, node_slot].index_put_(
        (cr,), torch.stack([d_added, d_taken], dim=1)[in_range], accumulate=True
    )
    elapsed.index_put_((cr,), d_elapsed[in_range], accumulate=True)
    return out


def take_n(
    pn: torch.Tensor, elapsed: torch.Tensor, packed: torch.Tensor, node_slot: int
) -> torch.Tensor:
    """Apply one packed take tick to state in place; returns the
    ``int64[7, K]`` result matrix on the state's device. Columns with
    ``nreq > 0`` must name distinct rows (the engine's grouping
    guarantees it); columns with ``nreq <= 0`` read no state and return
    zeros."""
    dev = pn.device
    _build.check_int64("pn", pn, dev)
    _build.check_int64("elapsed", elapsed, dev)
    _build.check_int64("packed", packed, dev)
    b, n, two = pn.shape
    if two != 2 or elapsed.shape != (b,):
        raise ValueError("state must be pn[B,N,2] and elapsed[B]")
    if packed.dim() != 2 or packed.shape[0] != TAKE_PACK_ROWS:
        raise ValueError(f"packed must be [{TAKE_PACK_ROWS}, K], got {tuple(packed.shape)}")
    if not 0 <= node_slot < n:
        raise ValueError(f"node_slot {node_slot} outside [0, {n})")
    if dev.type == "cpu":
        return take_n_plain(pn, elapsed, packed, node_slot)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k = packed.shape[1]
    out = torch.empty((TAKE_RESULT_ROWS, k), dtype=torch.int64, device=dev)
    if k == 0:
        return out
    rc = _build.lib().patrol_take_n(
        pn.data_ptr(), elapsed.data_ptr(), b, n, node_slot,
        packed.data_ptr(), out.data_ptr(), k, _build.stream_handle(pn),
    )
    _build.check_rc(rc, "take_n")
    _build.count_launch("take_n")
    return out
