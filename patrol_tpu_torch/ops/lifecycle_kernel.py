"""Lifecycle probe: the wrapper over ``csrc/lifecycle.cu``.

Replaces ``patrol_tpu/ops/lifecycle.py::lifecycle_probe`` (XLA in the
reference). One launch evaluates the IsZero verdict of K sweep
candidates and gathers each one's own lane and ``elapsed``; it reads
state and writes only its output buffer. The plain version is
:func:`patrol_tpu_torch.ops.lifecycle.lifecycle_probe_plain`, which
:func:`~patrol_tpu_torch.ops.lifecycle.lifecycle_probe` takes for a state
that lies on the CPU; on a CUDA state it launches this kernel, or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from patrol_tpu_torch.ops import _build


def output_bytes(k: int) -> int:
    """Size of the one uint8 buffer a launch writes: ``own_added``,
    ``own_taken`` and ``elapsed`` (int64[3, K]), then ``full`` (one byte
    per candidate). The sweep reads it back with one copy."""
    return 25 * k


def split_outputs(buf, k: int):
    """→ ``(full[K], own_added[K], own_taken[K], elapsed[K])``: views into a
    buffer of :func:`output_bytes` (a uint8 tensor or numpy array)."""
    if isinstance(buf, torch.Tensor):
        ints = buf[: 24 * k].view(torch.int64)
        full = buf[24 * k: 25 * k].view(torch.bool)
    else:
        ints = buf[: 24 * k].view("int64")
        full = buf[24 * k: 25 * k].view(bool)
    return full, ints[:k], ints[k: 2 * k], ints[2 * k: 3 * k]


def probe(
    pn: torch.Tensor,
    elapsed: torch.Tensor,
    rows: torch.Tensor,
    now_ns: torch.Tensor,
    per_ns: torch.Tensor,
    cap_base_nt: torch.Tensor,
    created_ns: torch.Tensor,
    node_slot: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the probe on CUDA tensors: five contiguous int64[K] columns
    (``rows`` is read as the reference's int32 rows are) → the output
    buffer (``out`` when given: uint8 of at least :func:`output_bytes`)."""
    dev = pn.device
    if dev.type != "cuda":
        raise ValueError(f"the lifecycle kernel runs on CUDA tensors, got {dev}")
    _build.check_int64("pn", pn, dev)
    _build.check_int64("elapsed", elapsed, dev)
    b, n, two = pn.shape
    if two != 2 or elapsed.shape != (b,):
        raise ValueError("state must be pn[B,N,2] and elapsed[B]")
    if not 0 <= node_slot < n:
        raise ValueError(f"node_slot {node_slot} outside [0, {n})")
    if pn.data_ptr() % 16:
        raise ValueError("pn must be 16-byte aligned (its lanes are read as 16-byte vectors)")
    cols = (rows, now_ns, per_ns, cap_base_nt, created_ns)
    k = rows.shape[0]
    for name, c in zip(("rows", "now_ns", "per_ns", "cap_base_nt", "created_ns"), cols):
        _build.check_int64(name, c, dev)
        if c.shape != (k,):
            raise ValueError(f"{name} must be [{k}], got {tuple(c.shape)}")
    need = output_bytes(k)
    if out is None:
        out = torch.empty(need, dtype=torch.uint8, device=dev)
    else:
        _build.check_operand("out", out, torch.uint8, dev)
        if out.numel() < need:
            raise ValueError(f"out holds {out.numel()} bytes, the launch writes {need}")
    if k == 0:
        return out
    rc = _build.lib().patrol_lifecycle_probe(
        pn.data_ptr(), elapsed.data_ptr(), b, n, node_slot,
        *(c.data_ptr() for c in cols), out.data_ptr(), k, _build.stream_handle(pn),
    )
    _build.check_rc(rc, "lifecycle_probe")
    _build.count_launch("lifecycle_probe")
    return out
