"""Bucket lifecycle: the IsZero predicate that makes idle-bucket GC safe
(counterpart of ``patrol_tpu/ops/lifecycle.py``).

A limiter bucket is reconstructible from its rate exactly when its
balance at ``now`` -- tokens plus the refill grant the next take would
commit -- reaches its capacity: dropping it and re-creating it later is
observation-equivalent, because its whole history is subsumed by "full
at capacity". The refill arithmetic is the take path's, step for step
(float64 grant, floor, capacity clamp), so a "full" verdict never
reclaims a bucket whose next take would have seen less than capacity.

The engine keeps a reclaimed bucket's OWN lane and refill clock in a
directory tombstone (runtime/directory.py) and re-seeds the row from it
on re-creation; the probe returns those values beside the verdict, so a
sweep reads each candidate once.

:func:`lifecycle_probe` launches the hand-written kernel
(``csrc/lifecycle.cu``, :mod:`patrol_tpu_torch.ops.lifecycle_kernel`) on
a CUDA state, or raises; on a CPU state it runs
:func:`lifecycle_probe_plain`. The numpy twins
:func:`host_lifecycle_full` and :func:`host_reconstructed_nt` answer for
host-resident lanes (no device hop) and for tests.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from patrol_tpu_torch.models.limiter import ADDED, NANO, TAKEN, LimiterState
from patrol_tpu_torch.ops import lifecycle_kernel
from patrol_tpu_torch.ops.take_kernel import _GRANT_CLIP


class LifecycleProbe(NamedTuple):
    """K reclaim candidates, each field a tensor of length K. Padding
    rows carry ``cap_base_nt == 0`` (capacity unknown, never reclaimable),
    so any row index is safe padding: the probe only reads."""

    rows: torch.Tensor  # [K] bucket rows (read as int32, as the reference's)
    now_ns: torch.Tensor  # int64[K] sweep clock
    per_ns: torch.Tensor  # int64[K] rate period (0: unknown, no refill)
    cap_base_nt: torch.Tensor  # int64[K] capacity base (0: not reclaimable)
    created_ns: torch.Tensor  # int64[K] bucket creation time


class LifecycleView(NamedTuple):
    """Per-candidate verdict and the tombstone payload."""

    full: torch.Tensor  # bool[K] reconstructed balance reaches capacity
    own_added_nt: torch.Tensor  # int64[K] this node's PN lane ...
    own_taken_nt: torch.Tensor  # int64[K] ... the tombstone residue
    elapsed_ns: torch.Tensor  # int64[K] the bucket's refill clock


def lifecycle_probe_plain(
    state: LimiterState, probe: LifecycleProbe, node_slot: int
) -> LifecycleView:
    """The plain version: the reference's expressions in their order.
    Rows are cast to int32, a row in ``[-B, 0)`` wraps, and the gather
    clamps to ``[0, B)``, as a JAX gather does."""
    i64 = torch.int64
    b = state.pn.shape[0]
    rows = probe.rows.to(torch.int32).to(i64)
    rows = torch.where(rows < 0, rows + b, rows).clamp(0, b - 1)
    now = probe.now_ns.to(i64)
    per = probe.per_ns.to(i64)
    cap = probe.cap_base_nt.to(i64)
    created = probe.created_ns.to(i64)

    pn_rows = state.pn[rows]  # [K, N, 2] gather
    sum_added = pn_rows[:, :, ADDED].sum(dim=-1)
    sum_taken = pn_rows[:, :, TAKEN].sum(dim=-1)
    tokens = cap + sum_added - sum_taken

    elapsed = state.elapsed[rows]
    last = torch.minimum(created + elapsed, now)
    delta = now - last

    one = torch.ones_like(cap)
    freq = torch.div(cap, NANO, rounding_mode="floor")
    safe_freq = torch.where(freq == 0, one, freq)
    interval = torch.div(per, safe_freq, rounding_mode="floor")
    rate_zero = (freq == 0) | (per == 0) | (interval == 0)
    safe_interval = torch.where(interval == 0, one, interval)
    grant_tokens = delta.to(torch.float64) / safe_interval.to(torch.float64)
    grant_f = torch.where(
        rate_zero, torch.zeros_like(grant_tokens), grant_tokens * float(NANO)
    )
    grant = torch.floor(grant_f.clamp(0.0, _GRANT_CLIP)).to(i64)

    missing = cap - tokens
    return LifecycleView(
        full=(cap > 0) & (grant >= missing),
        own_added_nt=pn_rows[:, node_slot, ADDED],
        own_taken_nt=pn_rows[:, node_slot, TAKEN],
        elapsed_ns=elapsed,
    )


def lifecycle_probe(
    state: LimiterState,
    probe: LifecycleProbe,
    node_slot: int,
    out: Optional[torch.Tensor] = None,
) -> LifecycleView:
    """A pure read: the IsZero verdict over a probe batch. On a CUDA state
    one kernel launch, whose outputs are views into one buffer (``out``
    when given, of ``lifecycle_kernel.output_bytes(K)``, so a caller can
    read them back with one copy); on a CPU state the plain version."""
    dev = state.pn.device
    if dev.type == "cpu":
        return lifecycle_probe_plain(state, probe, node_slot)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    cols = [c.to(torch.int64).contiguous() for c in probe]
    buf = lifecycle_kernel.probe(state.pn, state.elapsed, *cols, node_slot, out=out)
    return LifecycleView(*lifecycle_kernel.split_outputs(buf, cols[0].shape[0]))


def _rate_grant(cap_base_nt, created_ns, elapsed_ns, now_ns, per_ns):
    """The take path's refill grant (float64, floor, clip), in numpy."""
    last = np.minimum(created_ns + elapsed_ns, now_ns)
    delta = now_ns - last
    freq = cap_base_nt // NANO
    safe_freq = np.where(freq == 0, 1, freq)
    interval = per_ns // safe_freq
    rate_zero = (freq == 0) | (per_ns == 0) | (interval == 0)
    safe_interval = np.where(interval == 0, 1, interval)
    grant_f = np.where(
        rate_zero,
        0.0,
        delta.astype(np.float64) / safe_interval.astype(np.float64) * float(NANO),
    )
    return np.floor(np.clip(grant_f, 0.0, _GRANT_CLIP)).astype(np.int64)


def _as_i64(*xs):
    return [np.asarray(x, np.int64) for x in xs]


def host_lifecycle_full(
    sum_added_nt, sum_taken_nt, elapsed_ns, cap_base_nt, created_ns, now_ns, per_ns
) -> np.ndarray:
    """Numpy twin of the verdict, for host-resident lanes (the sweep
    evaluates them under ``_host_mu`` with no device hop) and for tests."""
    sum_added_nt, sum_taken_nt, elapsed_ns, cap_base_nt, created_ns, per_ns = _as_i64(
        sum_added_nt, sum_taken_nt, elapsed_ns, cap_base_nt, created_ns, per_ns
    )
    tokens_nt = cap_base_nt + sum_added_nt - sum_taken_nt
    grant_nt = _rate_grant(cap_base_nt, created_ns, elapsed_ns, now_ns, per_ns)
    return (cap_base_nt > 0) & (grant_nt >= cap_base_nt - tokens_nt)


def host_reconstructed_nt(
    sum_added_nt, sum_taken_nt, elapsed_ns, cap_base_nt, created_ns, now_ns, per_ns
) -> np.ndarray:
    """The balance at ``now`` exactly as the next take computes ``have``
    (refill capped at capacity, over-capacity forfeited). A reclaimed
    bucket reconstructs to capacity by the IsZero contract, so two runs
    that differ only in when they reclaim agree on this value."""
    sum_added_nt, sum_taken_nt, elapsed_ns, cap_base_nt, created_ns, per_ns = _as_i64(
        sum_added_nt, sum_taken_nt, elapsed_ns, cap_base_nt, created_ns, per_ns
    )
    tokens_nt = cap_base_nt + sum_added_nt - sum_taken_nt
    grant_nt = _rate_grant(cap_base_nt, created_ns, elapsed_ns, now_ns, per_ns)
    return tokens_nt + np.minimum(grant_nt, cap_base_nt - tokens_nt)
