"""The linearizability stage's sequential specs pinned to the port's
kernels, on any device.

``analysis/linearizability.py`` checks the replicated model against
sequential specs; these pins check that each spec IS the kernel the
engine dispatches. Every pin runs K independent histories at once (one
bucket row each, drawn from ``rng``), one kernel call a step, on a fully
synchronized state (every lane in one tensor, the node lane that acts
drawn per call), and compares each column's outcome with the spec's
replay of the same history, bit for bit:

* :func:`pin_take` — :class:`~.linearizability.SequentialSpec` against
  ``take_n_batch`` (``take.cu``) on a frozen clock: ``nreq`` coalesced
  takes admit exactly the spec's sequential grants, and the balance the
  kernel read is the spec's;
* :func:`pin_lifecycle` — the spec's GC gate (reclaim only at full)
  against ``lifecycle_probe`` (``lifecycle.cu``) over take/refill
  histories spread across lanes;
* :func:`pin_gcra`, :func:`pin_conc`, :func:`pin_quota` — the cert
  algebras' specs (:class:`~.linearizability.SequentialGcra`,
  :class:`~.linearizability.SequentialConc`,
  :class:`~.linearizability.SequentialQuota`) against
  ``gcra_take_batch``, ``conc_acquire_batch`` and ``quota_take_batch``
  (``cert.cu``).

On a CPU device the wrappers run their plain versions; on ``cuda`` they
launch the kernels (``tests/test_torch_lin.py`` runs the first,
``chip_smoke.py`` phase 3k the second). Each pin returns
``{"calls": n, "columns": n, "mismatches": [...]}``, the first few
mismatches described.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from patrol_tpu_torch.analysis.linearizability import (
    SequentialConc,
    SequentialGcra,
    SequentialQuota,
    SequentialSpec,
)
from patrol_tpu_torch.models.limiter import ADDED, NANO, TAKEN, LimiterState

_KEEP = 5  # mismatches described in a result
_PER_NS = 3600 * NANO  # an hour-long period: a frozen clock refills nothing


def _state(b: int, n: int, device) -> LimiterState:
    return LimiterState(
        pn=torch.zeros((b, n, 2), dtype=torch.int64, device=device),
        elapsed=torch.zeros(b, dtype=torch.int64, device=device),
    )


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device)


class _Tally:
    def __init__(self):
        self.calls = 0
        self.columns = 0
        self.mismatches: List[str] = []
        self.bad = 0

    def call(self, k: int) -> None:
        self.calls += 1
        self.columns += k

    def expect(self, got, want, what: Callable[[], str]) -> None:
        if got != want:
            self.bad += 1
            if len(self.mismatches) < _KEEP:
                self.mismatches.append(f"{what()}: kernel {got}, spec {want}")

    def result(self) -> Dict[str, object]:
        return {"calls": self.calls, "columns": self.columns,
                "mismatch_count": self.bad, "mismatches": self.mismatches}


def pin_take(device, rng: np.random.Generator, k: int = 64, lanes: int = 4,
             steps: int = 24) -> Dict[str, object]:
    """``take_n_batch`` against :class:`SequentialSpec`: row ``r`` is a
    bucket of capacity ``limit[r]`` (1..6); each step every column
    carries ``nreq`` (0..3) coalesced takes of ``count`` (1..2) tokens at
    the frozen clock 0, taken by one node lane a call. The kernel must
    admit exactly the spec's grants of those ``nreq`` sequential takes
    and read the spec's balance before them."""
    from patrol_tpu_torch.ops.take import take_n_batch

    tally = _Tally()
    limits = rng.integers(1, 7, k)
    specs = [SequentialSpec(int(x)) for x in limits]
    state = _state(k, lanes, device)
    rows = np.arange(k)
    zeros = np.zeros(k, np.int64)
    for step in range(steps):
        nreq = rng.integers(0, 4, k)
        count = rng.integers(1, 3, k)
        slot = int(rng.integers(lanes))
        packed = _t(np.stack([rows, zeros, limits, np.full(k, _PER_NS), count * NANO,
                              nreq, limits * NANO, zeros]), device)
        state, out = take_n_batch(state, packed, slot)
        out = out.cpu().numpy()
        tally.call(k)
        for c in range(k):
            have = specs[c].tokens
            grants = sum(specs[c].take(int(count[c])) for _ in range(int(nreq[c])))
            if nreq[c] == 0:
                continue  # a padding column reads nothing
            tally.expect(int(out[1, c]), grants,
                         lambda: f"take step {step} col {c} nreq {nreq[c]} count {count[c]}")
            tally.expect(int(out[0, c]), have * NANO, lambda: f"take balance step {step} col {c}")
    return tally.result()


def pin_lifecycle(device, rng: np.random.Generator, k: int = 64, lanes: int = 4,
                  steps: int = 24) -> Dict[str, object]:
    """``lifecycle_probe`` against the spec's GC gate: each step every
    column's bucket takes or refills one token through a random lane,
    the lanes are written into the state as the spec's grants left them,
    and the probe's ``full`` verdict (frozen clock) must be
    ``SequentialSpec.gc()``."""
    from patrol_tpu_torch.ops.lifecycle import LifecycleProbe, lifecycle_probe

    tally = _Tally()
    limits = rng.integers(1, 4, k)
    specs = [SequentialSpec(int(x)) for x in limits]
    pn = np.zeros((k, lanes, 2), np.int64)
    state = _state(k, lanes, device)
    zeros = np.zeros(k, np.int64)
    probe = LifecycleProbe(
        rows=_t(np.arange(k), device), now_ns=_t(zeros, device),
        per_ns=_t(np.full(k, _PER_NS), device), cap_base_nt=_t(limits * NANO, device),
        created_ns=_t(zeros, device),
    )
    for step in range(steps):
        take = rng.random(k) < 0.5
        lane = rng.integers(0, lanes, k)
        for c in range(k):
            s = specs[c]
            if take[c]:
                pn[c, lane[c], TAKEN] += NANO * s.take()
            else:
                before = s.tokens
                s.refill()
                pn[c, lane[c], ADDED] += NANO * (s.tokens - before)
        state.pn.copy_(_t(pn, device))
        view = lifecycle_probe(state, probe, int(rng.integers(lanes)))
        full = view.full.cpu().numpy()
        tally.call(k)
        for c in range(k):
            tally.expect(bool(full[c]), specs[c].gc(), lambda: f"gc gate step {step} col {c}")
    return tally.result()


def pin_gcra(device, rng: np.random.Generator, k: int = 64, lanes: int = 4,
             steps: int = 24) -> Dict[str, object]:
    """``gcra_take_batch`` against :class:`SequentialGcra`: emission
    interval 1, tolerance ``limit - 1`` (burst 1..4), each column's clock
    advancing 0 or 1 a step; admitted and the global TAT must be the
    spec's."""
    from patrol_tpu_torch.ops.gcra import GcraRequest, gcra_take_batch

    tally = _Tally()
    limits = rng.integers(1, 5, k)
    specs = [SequentialGcra(int(x)) for x in limits]
    state = _state(k, lanes, device)
    now = np.zeros(k, np.int64)
    for step in range(steps):
        now += rng.integers(0, 2, k)
        req = GcraRequest(
            rows=_t(np.arange(k), device), now_ns=_t(now, device),
            emission_ns=_t(np.ones(k), device), tol_ns=_t(limits - 1, device),
            nreq=_t(np.ones(k), device),
        )
        state, res = gcra_take_batch(state, req, int(rng.integers(lanes)))
        admitted, tat = res.admitted.cpu().numpy(), res.tat_ns.cpu().numpy()
        tally.call(k)
        for c in range(k):
            ok = specs[c].take(int(now[c]))
            tally.expect(int(admitted[c]), int(ok), lambda: f"gcra step {step} col {c}")
            tally.expect(int(tat[c]), specs[c].tat, lambda: f"gcra tat step {step} col {c}")
    return tally.result()


def pin_conc(device, rng: np.random.Generator, k: int = 64, lanes: int = 4,
             steps: int = 24) -> Dict[str, object]:
    """``conc_acquire_batch`` against :class:`SequentialConc` with the
    lanes as its clients: each step one lane acts, and every column
    acquires or releases one lease; an acquire is admitted, and a release
    takes effect, exactly when the spec says."""
    from patrol_tpu_torch.ops.concurrency import ConcRequest, conc_acquire_batch

    tally = _Tally()
    limits = rng.integers(1, 5, k)
    specs = [SequentialConc(int(x), lanes) for x in limits]
    state = _state(k, lanes, device)
    for step in range(steps):
        client = int(rng.integers(lanes))
        acquire = rng.random(k) < 0.6
        req = ConcRequest(
            rows=_t(np.arange(k), device), limit_nt=_t(limits, device),
            count_nt=_t(np.ones(k), device), nreq=_t(acquire, device),
            releases=_t(~acquire, device),
        )
        state, res = conc_acquire_batch(state, req, client)
        admitted, released = res.admitted.cpu().numpy(), res.released_nt.cpu().numpy()
        tally.call(k)
        for c in range(k):
            if acquire[c]:
                tally.expect(int(admitted[c]), int(specs[c].acquire(client)),
                             lambda: f"conc acquire step {step} col {c} client {client}")
            else:
                tally.expect(int(released[c]), int(specs[c].release(client)),
                             lambda: f"conc release step {step} col {c} client {client}")
    return tally.result()


def pin_quota(device, rng: np.random.Generator, k: int = 64, lanes: int = 4,
              steps: int = 24) -> Dict[str, object]:
    """``quota_take_batch`` against :class:`SequentialQuota`: each column
    is one path (its own global, tenant and user rows, budgets 1..5
    each), taking one unit a step through a random lane; admitted must
    be the spec's."""
    from patrol_tpu_torch.ops.hierquota import QuotaRequest, quota_take_batch

    tally = _Tally()
    budgets = rng.integers(1, 6, (k, 3))
    specs = [SequentialQuota(tuple(int(v) for v in row)) for row in budgets]
    state = _state(3 * k, lanes, device)
    ones = np.ones(k)
    req = QuotaRequest(
        rows_global=_t(np.arange(k), device), rows_tenant=_t(np.arange(k, 2 * k), device),
        rows_user=_t(np.arange(2 * k, 3 * k), device),
        limit_global_nt=_t(budgets[:, 0], device), limit_tenant_nt=_t(budgets[:, 1], device),
        limit_user_nt=_t(budgets[:, 2], device), count_nt=_t(ones, device),
        nreq=_t(ones, device),
    )
    for step in range(steps):
        state, res = quota_take_batch(state, req, int(rng.integers(lanes)))
        admitted = res.admitted.cpu().numpy()
        tally.call(k)
        for c in range(k):
            tally.expect(int(admitted[c]), int(specs[c].take()), lambda: f"quota step {step} col {c}")
    return tally.result()


PINS = {
    "take": pin_take,
    "lifecycle": pin_lifecycle,
    "gcra": pin_gcra,
    "conc": pin_conc,
    "quota": pin_quota,
}
