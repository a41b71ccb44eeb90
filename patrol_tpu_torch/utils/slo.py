"""SLO sentinel: burn-rate / stage-budget watchdogs over the patrol-scope
latency histograms, auto-firing the flight recorder's anomaly snapshots.

patrol-scope records *what happened*; this module decides *when it is
bad enough to freeze evidence*. Two breach classes, both computed from
cumulative histogram deltas between checks (so a check is O(histograms ×
buckets) integer work — no sampling, no timers):

* **take-latency burn rate** — the fraction of takes in the window since
  the last check that exceeded the take budget. A window burning past
  ``max_burn`` fires ``anomaly("slo.take_burn")``, which snapshots every
  thread's flight-recorder ring (damped to 1/reason/s by the recorder).
* **stage-budget overrun** — any commit-pipeline or device stage whose
  window p99 exceeds its budget fires ``anomaly("slo.stage_budget")``.
* **AP-overshoot** (patrol-audit, net/audit.py) — when the measured
  admitted-token overshoot factor of the last evaluated audit window
  exceeds ``PATROL_SLO_OVERSHOOT × partition-sides-estimate``, the
  sentinel fires ``anomaly("slo.overshoot")``: admission multiplied
  beyond what the observed partition explains is evidence worth
  freezing. Enabled by setting ``PATROL_SLO_OVERSHOOT`` > 0 (1.0 = the
  paper's AP bound exactly: overshoot must not exceed the sides
  estimate).

Budgets default OFF (0 = disabled) so an unconfigured process never
snapshots itself; set them via environment (``PATROL_SLO_TAKE_P99_NS``,
``PATROL_SLO_STAGE_P99_NS``, ``PATROL_SLO_OVERSHOOT``) or
programmatically (tests, operators). The check is driven by the fleet
gossip flusher (net/fleet.py) — the same paced observability tick that
ships the histograms — by the audit plane's own tick
(:meth:`SloSentinel.check_audit`), and by ``bench.py --trend``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from patrol_tpu_torch.utils import config
from patrol_tpu_torch.utils import histogram as hist
from patrol_tpu_torch.utils import profiling


# Observations in buckets strictly ABOVE this index are guaranteed over
# the budget (bucket b holds [2^(b-1), 2^b)); the budget's own bucket may
# contain under-budget values, so it is not counted — conservative, never
# a false breach from bucketing.
def _over_bucket(budget_ns: int) -> int:
    return hist.bucket_of(max(budget_ns, 0))


class SloSentinel:
    """Windowed breach detector. ``check()`` compares each watched
    histogram's cumulative bucket counts against the last check's
    snapshot; the difference is the window. Thread-safe; one instance
    per process (``SENTINEL``)."""

    def __init__(
        self,
        take_budget_ns: Optional[int] = None,
        stage_budget_ns: Optional[int] = None,
        max_burn: float = 0.10,
        min_samples: int = 16,
        overshoot_budget: Optional[float] = None,
    ):
        self.take_budget_ns = (
            config.env_int("PATROL_SLO_TAKE_P99_NS")
            if take_budget_ns is None
            else take_budget_ns
        )
        self.stage_budget_ns = (
            config.env_int("PATROL_SLO_STAGE_P99_NS")
            if stage_budget_ns is None
            else stage_budget_ns
        )
        self.overshoot_budget = (
            config.env_float("PATROL_SLO_OVERSHOOT")
            if overshoot_budget is None
            else overshoot_budget
        )
        self.max_burn = max_burn
        self.min_samples = min_samples
        self._mu = threading.Lock()
        self._last: Dict[str, List[int]] = {}
        self.breaches = 0
        # Bucket-lifecycle budget provider (engine._budget_snapshot):
        # registered when a memory budget is configured, polled on every
        # check — a hard-watermark breach freezes evidence exactly like a
        # latency burn.
        self._budget_src: Optional[Callable[[], dict]] = None
        # patrol-audit overshoot provider (AuditPlane._slo_snapshot):
        # last evaluated window's measured factor + sides estimate.
        self._audit_src: Optional[Callable[[], dict]] = None
        # The last (window, factor) breach fired, so one bad window does
        # not re-fire on every subsequent check.
        self._audit_fired: Optional[tuple] = None

    def watch_budget(self, provider: Callable[[], dict]) -> None:
        """Register the engine's memory-budget snapshot provider (dict
        with ``over`` plus the accounting gauges). Latest engine wins —
        one process serves one engine."""
        with self._mu:
            self._budget_src = provider

    def unwatch_budget(self, provider: Callable[[], dict]) -> None:
        """Engine shutdown: drop the provider IF it is still ours (a
        replacement engine's registration must survive). Equality, not
        identity: bound methods are fresh objects per attribute access —
        ``==`` compares (instance, function)."""
        with self._mu:
            if self._budget_src == provider:
                self._budget_src = None

    def watch_audit(self, provider: Callable[[], dict]) -> None:
        """Register the audit plane's overshoot provider (dict with
        ``overshoot``, ``sides``, ``window``). Latest plane wins."""
        with self._mu:
            self._audit_src = provider

    def unwatch_audit(self, provider: Callable[[], dict]) -> None:
        """Audit plane shutdown: drop the provider IF still ours (same
        equality contract as :meth:`unwatch_budget`)."""
        with self._mu:
            if self._audit_src == provider:
                self._audit_src = None

    def configure(
        self,
        take_budget_ns: Optional[int] = None,
        stage_budget_ns: Optional[int] = None,
        max_burn: Optional[float] = None,
        min_samples: Optional[int] = None,
        overshoot_budget: Optional[float] = None,
    ) -> None:
        with self._mu:
            if take_budget_ns is not None:
                self.take_budget_ns = take_budget_ns
            if stage_budget_ns is not None:
                self.stage_budget_ns = stage_budget_ns
            if max_burn is not None:
                self.max_burn = max_burn
            if min_samples is not None:
                self.min_samples = min_samples
            if overshoot_budget is not None:
                self.overshoot_budget = overshoot_budget

    def _window(self, name: str, counts: List[int]) -> List[int]:
        """Per-bucket deltas since the last check (counts are cumulative
        monotone, so the delta is exact). First sight seeds the baseline
        and reports an empty window — budgets judge fresh traffic only."""
        last = self._last.get(name)
        self._last[name] = list(counts)
        if last is None:
            return [0] * len(counts)
        return [max(0, c - l) for c, l in zip(counts, last)]

    def _burn(self, window: List[int], budget_ns: int) -> tuple:
        total = sum(window)
        over = sum(window[_over_bucket(budget_ns) + 1 :])
        return total, (over / total if total else 0.0)

    def check(
        self, registry: Optional[hist.HistogramRegistry] = None
    ) -> List[dict]:
        """One sentinel pass; returns the breaches found (and fires an
        anomaly snapshot per breach class)."""
        from patrol_tpu_torch.utils import trace as trace_mod

        reg = registry if registry is not None else hist.HISTOGRAMS
        breaches: List[dict] = []
        with self._mu:
            if self.take_budget_ns > 0:
                h = reg.get("take_service_ns")
                total, burn = self._burn(
                    self._window("take_service_ns", h._merged_counts()),
                    self.take_budget_ns,
                )
                if total >= self.min_samples and burn > self.max_burn:
                    breaches.append(
                        {
                            "kind": "take_burn",
                            "stage": "take_service_ns",
                            "window": total,
                            "burn": round(burn, 4),
                            "budget_ns": self.take_budget_ns,
                        }
                    )
            if self.stage_budget_ns > 0:
                for name in hist.INGEST_STAGES + hist.DEVICE_STAGES:
                    h = reg.get(name)
                    window = self._window(name, h._merged_counts())
                    total, burn = self._burn(window, self.stage_budget_ns)
                    if total >= self.min_samples and burn > 0.01:
                        # p99 over budget ⇔ >1% of the window's samples
                        # landed in buckets strictly above it.
                        breaches.append(
                            {
                                "kind": "stage_budget",
                                "stage": name,
                                "window": total,
                                "burn": round(burn, 4),
                                "budget_ns": self.stage_budget_ns,
                            }
                        )
            breaches.extend(self._audit_breach_locked())
            budget_src = self._budget_src
            if budget_src is not None:
                try:
                    snap = budget_src()
                except Exception:  # pragma: no cover - provider must not kill checks
                    snap = None
                if snap and snap.get("over"):
                    breaches.append(
                        {
                            "kind": "budget",
                            "stage": "state_bytes",
                            "window": 1,
                            "burn": 1.0,
                            "budget_ns": 0,
                            **{
                                k: snap.get(k, 0)
                                for k in (
                                    "state_bytes_in_use",
                                    "state_bytes_budget",
                                    "buckets_bound",
                                    "max_buckets",
                                )
                            },
                        }
                    )
            if breaches:
                self.breaches += len(breaches)
        for kind in sorted({b["kind"] for b in breaches}):
            profiling.COUNTERS.inc("slo_breaches")
            trace_mod.anomaly(f"slo.{kind}")
        return breaches

    def _audit_breach_locked(self) -> List[dict]:
        """The AP-overshoot budget (patrol-audit): breach when the last
        evaluated window's measured factor exceeds ``overshoot_budget ×
        sides-estimate``. Caller holds ``_mu``. Fires once per (window,
        factor) — a standing bad window must not re-snapshot every tick."""
        if self.overshoot_budget <= 0 or self._audit_src is None:
            return []
        try:
            snap = self._audit_src()
        except Exception:  # pragma: no cover - provider must not kill checks
            return []
        factor = float(snap.get("overshoot", 0.0))
        sides = max(int(snap.get("sides", 1)), 1)
        window = snap.get("window", -1)
        bound = self.overshoot_budget * sides
        key = (window, round(factor, 6))
        if factor <= bound or window < 0 or self._audit_fired == key:
            return []
        self._audit_fired = key
        profiling.COUNTERS.inc("audit_overshoot_breaches")
        return [
            {
                "kind": "overshoot",
                "stage": "audit_overshoot_factor",
                "window": window,
                "burn": round(factor, 4),
                "budget_ns": 0,
                "overshoot": round(factor, 4),
                "sides": sides,
                "bound": round(bound, 4),
            }
        ]

    def check_audit(self) -> List[dict]:
        """The audit plane's own tick: evaluate ONLY the overshoot budget
        (the latency/stage windows stay on the fleet-gossip cadence, so
        an extra audit tick never shrinks their burn windows)."""
        from patrol_tpu_torch.utils import trace as trace_mod

        with self._mu:
            breaches = self._audit_breach_locked()
            if breaches:
                self.breaches += len(breaches)
        for _ in breaches:
            profiling.COUNTERS.inc("slo_breaches")
            trace_mod.anomaly("slo.overshoot")
        return breaches


SENTINEL = SloSentinel()
