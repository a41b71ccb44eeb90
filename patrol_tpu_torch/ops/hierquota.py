"""Hierarchical quotas (global -> tenant -> user) as a lattice path debit
(counterpart of ``patrol_tpu/ops/hierquota.py``).

A request is admitted only if every level of its path has budget. Each
level is one ordinary state row whose own ``TAKEN`` lane counts this
node's debits (``ADDED`` stays zero; budgets ride in the request), and a
level's spend is the sum of its row's TAKEN lanes. One call admits
``k = clip(min_level(headroom) // count, 0, nreq)`` against the pre-batch
spends and debits ``k * count`` into the own TAKEN lane of all three
levels, all or nothing. Paths sharing a tenant or global row (or one row
serving as two levels) each read the pre-batch spend, and every debit
lands.

:func:`quota_take_batch` runs the hand-written kernel
(:mod:`patrol_tpu_torch.ops.cert_kernel`, ``csrc/cert.cu``'s
``quota_admit``, one launch that reads, then commits) on a CUDA state, or
raises; on a CPU state it runs :func:`quota_take_batch_plain`.
State is updated IN PLACE (the reference donated it).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from patrol_tpu_torch.models.limiter import TAKEN, LimiterState
from patrol_tpu_torch.ops import cert_kernel

# Path depth is fixed: global -> tenant -> user.
QUOTA_LEVELS = 3

# Packed layout: int64[QUOTA_PACK_ROWS, K] in (rows_global, rows_tenant,
# rows_user, the three limits, count_nt, nreq; rows wrapped),
# int64[QUOTA_RESULT_ROWS, K] out (QuotaResult's fields).
QUOTA_PACK_ROWS = 8
QUOTA_RESULT_ROWS = 5


class QuotaRequest(NamedTuple):
    """A microbatch of K path takes; the three row vectors address the
    path's levels (rows of the same planes). Padding columns have
    ``nreq == 0`` and commit nothing."""

    rows_global: torch.Tensor  # [K] global-pool row (read as int32)
    rows_tenant: torch.Tensor  # [K] tenant row
    rows_user: torch.Tensor  # [K] user (leaf) row
    limit_global_nt: torch.Tensor  # int64[K] global budget
    limit_tenant_nt: torch.Tensor  # int64[K] tenant budget
    limit_user_nt: torch.Tensor  # int64[K] user budget
    count_nt: torch.Tensor  # int64[K] units per request
    nreq: torch.Tensor  # int64[K] identical requests coalesced


class QuotaResult(NamedTuple):
    """Per-column outcome; per-level headrooms are post-commit."""

    admitted: torch.Tensor  # int64[K] requests granted
    headroom_global_nt: torch.Tensor  # int64[K]
    headroom_tenant_nt: torch.Tensor  # int64[K]
    headroom_user_nt: torch.Tensor  # int64[K]
    own_taken_user_nt: torch.Tensor  # int64[K] leaf own lane (wire trailer)


def packed_plain(
    pn: torch.Tensor, rows_g: torch.Tensor, rows_t: torch.Tensor, rows_u: torch.Tensor,
    limit_g: torch.Tensor, limit_t: torch.Tensor, limit_u: torch.Tensor,
    count: torch.Tensor, nreq: torch.Tensor, node_slot: int,
) -> torch.Tensor:
    """The plain version over the packed layout's columns (rows wrapped):
    the reference's body (``hierquota.py:79-129``). → the result matrix; commits into
    ``pn`` in place."""
    kb = rows_u.shape[0]
    rows = torch.cat([rows_g, rows_t, rows_u])
    g, in_range = cert_kernel.gather_index(rows, pn.shape[0])
    pn_rows = pn[g]  # [3K, N, 2] gather, one for the path
    spend = pn_rows[:, :, TAKEN].sum(dim=-1)

    head_g = limit_g - spend[:kb]
    head_t = limit_t - spend[kb:2 * kb]
    head_u = limit_u - spend[2 * kb:]
    head_min = torch.minimum(torch.minimum(head_g, head_t), head_u)

    safe_count = torch.where(count <= 0, torch.ones_like(count), count)
    k = torch.div(head_min, safe_count, rounding_mode="floor")
    k = torch.minimum(torch.clamp(k, min=0), nreq)
    k = torch.where(count > 0, k, torch.zeros_like(k))
    d = k * count

    # One [3K] scatter-add into the own TAKEN lane; shared rows accumulate,
    # rows outside [0, B) are dropped.
    debit = torch.cat([d, d, d])
    lane = pn[:, node_slot, TAKEN]
    lane.index_put_((rows[in_range],), debit[in_range], accumulate=True)
    return torch.stack(
        [k, head_g - d, head_t - d, head_u - d, pn_rows[2 * kb:, node_slot, TAKEN] + d]
    )


def pack(req: QuotaRequest, b: int) -> torch.Tensor:
    """The request as the packed matrix (rows cast and wrapped)."""
    return cert_kernel.pack(req, b, 3)


def quota_take_packed(state: LimiterState, packed: torch.Tensor, node_slot: int) -> torch.Tensor:
    """One packed microbatch: → the int64[5, K] result matrix on the
    state's device; ``state`` is updated in place."""
    if state.pn.device.type == "cpu":
        return packed_plain(state.pn, *packed, node_slot)
    return cert_kernel.run("quota", state.pn, packed, node_slot)


def quota_take_batch_plain(
    state: LimiterState, req: QuotaRequest, node_slot: int
) -> Tuple[LimiterState, QuotaResult]:
    """The plain version on any device: → (state, result)."""
    out = packed_plain(state.pn, *pack(req, state.pn.shape[0]), node_slot)
    return state, QuotaResult(*out.unbind(0))


def quota_take_batch(
    state: LimiterState, req: QuotaRequest, node_slot: int
) -> Tuple[LimiterState, QuotaResult]:
    """Admit a microbatch of hierarchical-quota takes (state updated in
    place) → (state, result)."""
    out = quota_take_packed(state, pack(req, state.pn.shape[0]), node_slot)
    return state, QuotaResult(*out.unbind(0))
