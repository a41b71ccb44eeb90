"""GCRA / sliding-window rate limiting as a max-lattice register
(counterpart of ``patrol_tpu/ops/gcra.py``).

The Generic Cell Rate Algorithm keeps one scalar per flow, the
Theoretical Arrival Time (TAT). A request at ``now`` conforms iff
``TAT <= now + tol``; an admission advances the TAT to
``max(TAT, now) + T``. Each node keeps its own TAT watermark in its own
``TAKEN`` lane (``ADDED`` stays zero); the effective TAT is the max over
lanes, so the rows join and replicate as the bucket's do. TAT and ``now``
are clock nanoseconds.

:func:`gcra_take_batch` runs the hand-written kernels
(:mod:`patrol_tpu_torch.ops.cert_kernel`, ``csrc/cert.cu``) on a CUDA
state, or raises; on a CPU state it runs :func:`gcra_take_batch_plain`.
State is updated IN PLACE (the reference donated it).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from patrol_tpu_torch.models.limiter import TAKEN, LimiterState
from patrol_tpu_torch.ops import cert_kernel

# Packed layout: one int64[GCRA_PACK_ROWS, K] request matrix in (rows,
# now_ns, emission_ns, tol_ns, nreq; rows wrapped, cert_kernel.wrap_rows),
# one int64[GCRA_RESULT_ROWS, K] result matrix out (GcraResult's fields).
GCRA_PACK_ROWS = 5
GCRA_RESULT_ROWS = 4


class GcraRequest(NamedTuple):
    """A microbatch of K GCRA conformance tests, each field a tensor of
    length K. Padding columns have ``nreq == 0`` and commit nothing."""

    rows: torch.Tensor  # [K] bucket-slot indices (read as int32)
    now_ns: torch.Tensor  # int64[K] request clock
    emission_ns: torch.Tensor  # int64[K] T: nanoseconds per admitted request
    tol_ns: torch.Tensor  # int64[K] tau: burst tolerance window
    nreq: torch.Tensor  # int64[K] identical requests coalesced into this column


class GcraResult(NamedTuple):
    """Per-column outcome. ``allow_at_ns`` is the earliest clock at which
    the next request conforms (TAT - tol)."""

    admitted: torch.Tensor  # int64[K] how many of nreq conformed
    tat_ns: torch.Tensor  # int64[K] global TAT (max over lanes) post-commit
    own_tat_ns: torch.Tensor  # int64[K] this node's lane post-commit (trailer)
    allow_at_ns: torch.Tensor  # int64[K] earliest conforming arrival


def packed_plain(
    pn: torch.Tensor, rows: torch.Tensor, now: torch.Tensor, t: torch.Tensor,
    tol: torch.Tensor, nreq: torch.Tensor, node_slot: int,
) -> torch.Tensor:
    """The plain version over the packed layout's columns (rows wrapped):
    the reference's body (``gcra.py:69-119``). → the result matrix; commits into
    ``pn`` in place."""
    g, in_range = cert_kernel.gather_index(rows, pn.shape[0])
    pn_rows = pn[g]  # [K, N, 2] gather
    own_tat = pn_rows[:, node_slot, TAKEN]
    tat = pn_rows[:, :, TAKEN].amax(dim=-1)

    base = torch.maximum(tat, now)
    deadline = now + tol
    conforms = tat <= deadline
    zero = torch.zeros_like(tat)
    safe_t = torch.where(t <= 0, torch.ones_like(t), t)
    extras = torch.div(torch.clamp(deadline - base, min=0), safe_t, rounding_mode="floor")
    k = torch.where(conforms, 1 + extras, zero)
    k = torch.where(t > 0, k, zero)
    k = torch.minimum(torch.clamp(k, min=0), nreq)

    new_own = torch.where(k >= 1, base + k * t, own_tat)
    # Scatter-max of the own lane; rows outside [0, B) are dropped.
    lane = pn[:, node_slot, TAKEN]
    lane.scatter_reduce_(0, rows[in_range], new_own[in_range], reduce="amax")

    tat_out = torch.maximum(tat, new_own)
    return torch.stack([k, tat_out, torch.maximum(own_tat, new_own), tat_out - tol])


def pack(req: GcraRequest, b: int) -> torch.Tensor:
    """The request as the packed matrix (rows cast and wrapped)."""
    return cert_kernel.pack(req, b, 1)


def gcra_take_packed(state: LimiterState, packed: torch.Tensor, node_slot: int) -> torch.Tensor:
    """One packed microbatch: → the int64[4, K] result matrix on the
    state's device; ``state`` is updated in place. The kernels on a CUDA
    state, the plain version on a CPU one."""
    if state.pn.device.type == "cpu":
        return packed_plain(state.pn, *packed, node_slot)
    return cert_kernel.run("gcra", state.pn, packed, node_slot)


def gcra_take_batch_plain(
    state: LimiterState, req: GcraRequest, node_slot: int
) -> Tuple[LimiterState, GcraResult]:
    """The plain version on any device: → (state, result)."""
    out = packed_plain(state.pn, *pack(req, state.pn.shape[0]), node_slot)
    return state, GcraResult(*out.unbind(0))


def gcra_take_batch(
    state: LimiterState, req: GcraRequest, node_slot: int
) -> Tuple[LimiterState, GcraResult]:
    """Admit a microbatch of GCRA requests (state updated in place) →
    (state, result)."""
    out = gcra_take_packed(state, pack(req, state.pn.shape[0]), node_slot)
    return state, GcraResult(*out.unbind(0))
