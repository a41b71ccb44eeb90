"""Observability primitives behind the ``/debug`` routes — the equivalent of
the reference's full ``net/http/pprof`` suite (api.go:29-39) plus mutex-
profile-style engine stats (cmd/patrol/main.go:24), re-imagined for a
Python-host + CUDA-device process:

* :class:`SamplingProfiler` — a wall-clock sampling CPU profiler over all
  threads (``sys._current_frames`` at a fixed interval), the analogue of
  ``pprof.Profile``'s sampled CPU profile.
* :func:`thread_dump` — all-thread stack dump (≙ ``/debug/pprof/goroutine``).
* :func:`heap_summary` — allocation summary via ``tracemalloc`` when
  enabled, else GC stats (≙ ``/debug/pprof/heap`` / ``allocs``).
* :func:`cuda_trace` — a ``torch.profiler`` capture of the whole process
  (host ops, and the card's kernels and copies when a card is present)
  as a Chrome-trace JSON (≙ the reference's ``jax_trace``).
"""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import threading
import time
import traceback
from collections import Counter
from typing import Dict, Optional


def _qualname(code) -> str:
    """``co_qualname`` is 3.11+; on 3.10 fall back to the bare name. An
    AttributeError here used to kill whichever engine thread recorded the
    first contended wait — feeder death presented as takes hanging."""
    return getattr(code, "co_qualname", None) or code.co_name


class SamplingProfiler:
    """Sample every thread's stack at ``interval_s`` for ``duration_s``;
    report as pprof protobuf (:meth:`run_pprof`, ≙ ``pprof.Profile``'s
    sampled CPU profile — opens in ``go tool pprof`` / speedscope) or as
    human-readable text (:meth:`run`)."""

    def __init__(self, duration_s: float = 5.0, interval_s: float = 0.005):
        self.duration_s = min(duration_s, 120.0)
        self.interval_s = interval_s

    def _collect(self) -> Counter:
        """Counter over stack tuples, each a tuple of
        ``(qualname, filename, line)`` frames leaf-first."""
        stacks: Counter = Counter()
        deadline = time.monotonic() + self.duration_s
        me = threading.get_ident()
        while time.monotonic() < deadline:
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                stack = []
                f: Optional[object] = frame
                while f is not None:
                    code = f.f_code  # type: ignore[attr-defined]
                    stack.append(
                        (_qualname(code), code.co_filename, f.f_lineno)  # type: ignore[attr-defined]
                    )
                    f = f.f_back  # type: ignore[attr-defined]
                stacks[tuple(stack)] += 1
            time.sleep(self.interval_s)
        return stacks

    def run_pprof(self) -> bytes:
        """Gzipped pprof protobuf (profile.proto), the reference's
        ``/debug/pprof/profile`` artifact class (api.go:29-39)."""
        from patrol_tpu_torch.utils.pprof import build_profile

        stacks = self._collect()
        return build_profile(
            stacks,
            period_ns=int(self.interval_s * 1e9),
            duration_ns=int(self.duration_s * 1e9),
        )

    def run(self) -> str:
        stacks = self._collect()
        samples = sum(stacks.values())
        leaf: Counter = Counter()
        flat: Counter = Counter()
        for stack, n in stacks.items():
            name, filename, line = stack[0]
            leaf[f"{name} ({filename}:{line})"] += n
            flat[";".join(f[0] for f in reversed(stack))] += n

        lines = [
            f"sampling cpu profile: {self.duration_s:.1f}s at "
            f"{1 / self.interval_s:.0f}Hz, {samples} samples",
            "",
            "-- hottest frames --",
        ]
        for name, n in leaf.most_common(30):
            lines.append(f"{n:8d}  {name}")
        lines += ["", "-- hottest stacks --"]
        for stack, n in flat.most_common(10):
            lines.append(f"{n:8d}  {stack}")
        return "\n".join(lines) + "\n"


class ContentionRegistry:
    """Process-wide lock/block contention accounting — the real
    ``/debug/pprof/mutex`` and ``/block`` (VERDICT r2 item 5; reference:
    ``runtime.SetMutexProfileFraction(50)`` at main.go:24, routes at
    api.go:29-39). Two event classes, matching Go's split:

    * **mutex** — time a thread spent WAITING to acquire a lock another
      thread held (recorded by :class:`ProfiledLock`);
    * **block** — time a thread spent parked in a condition wait
      (:class:`ProfiledCondition`), Go's block-profile class.

    ``fraction`` subsamples events Go-style (stack walks are the
    expensive part); the default records every event — a contended
    acquire already paid a wait that dwarfs the ~µs stack walk, and at
    rate-limiter tick rates (kHz, not MHz) full recording is noise-level
    overhead. Raise it for pathologically contended deployments."""

    def __init__(self, fraction: int = 1):
        self.fraction = max(1, fraction)
        self._mu = threading.Lock()
        # stack tuple -> [contentions, delay_ns]
        self._mutex: Dict[tuple, list] = {}
        self._block: Dict[tuple, list] = {}
        self._mutex_events = 0
        self._block_events = 0

    @staticmethod
    def _caller_stack(skip: int) -> tuple:
        stack = []
        f = sys._getframe(skip)
        while f is not None and len(stack) < 24:
            code = f.f_code
            stack.append((_qualname(code), code.co_filename, f.f_lineno))
            f = f.f_back
        return tuple(stack)

    def _record(self, table: Dict[tuple, list], nth: int, name: str, wait_ns: int) -> None:
        if nth % self.fraction:
            return
        # The lock name leads the stack so pprof's top view groups by
        # which lock contended, then by waiter call site.
        stack = ((name, "<lock>", 0),) + self._caller_stack(3)
        with self._mu:
            entry = table.get(stack)
            if entry is None:
                table[stack] = [1, wait_ns]
            else:
                entry[0] += 1
                entry[1] += wait_ns

    def record_mutex(self, name: str, wait_ns: int) -> None:
        self._mutex_events += 1  # benign race: stat, not invariant
        self._record(self._mutex, self._mutex_events, name, wait_ns)

    def record_block(self, name: str, wait_ns: int) -> None:
        self._block_events += 1
        self._record(self._block, self._block_events, name, wait_ns)

    def _pprof(self, table: Dict[tuple, list], kind: str) -> bytes:
        from patrol_tpu_torch.utils.pprof import build_profile_values

        with self._mu:
            samples = {
                stack: (c * self.fraction, d * self.fraction)
                for stack, (c, d) in table.items()
            }
        return build_profile_values(
            samples,
            period_ns=self.fraction,
            duration_ns=0,
            sample_type=(("contentions", "count"), ("delay", "nanoseconds")),
            period_type=(kind, "count"),
        )

    def mutex_pprof(self) -> bytes:
        return self._pprof(self._mutex, "contentions")

    def block_pprof(self) -> bytes:
        return self._pprof(self._block, "contentions")

    def _text(self, table: Dict[tuple, list], title: str) -> str:
        with self._mu:
            rows = sorted(table.items(), key=lambda kv: -kv[1][1])
        lines = [f"{title}: {len(rows)} contended sites (1/{self.fraction} sampled)"]
        for stack, (c, d) in rows[:30]:
            where = " <- ".join(f"{f[0]}" for f in stack[:4])
            lines.append(
                f"{c * self.fraction:8d} waits  {d * self.fraction / 1e6:10.2f} ms  {where}"
            )
        return "\n".join(lines) + "\n"

    def mutex_text(self) -> str:
        return self._text(self._mutex, "mutex contention")

    def block_text(self) -> str:
        return self._text(self._block, "block (condition-wait)")


REGISTRY = ContentionRegistry()


class CounterRegistry:
    """Process-wide transfer/dispatch counters for the device-commit
    pipeline, surfaced verbatim in ``/debug/vars`` (pt-stats) next to the
    engine stats and snapshotted by bench.py's ingest stages:

    * ``staging_reuse_hits`` / ``staging_leases_fresh`` — how often a
      packed commit matrix refilled a recycled pinned staging buffer
      instead of allocating (engine.StagingPool);
    * ``commit_blocks_coalesced`` / ``commit_dispatches`` — drained delta
      blocks folded into single donated commit dispatches (ops/commit.py)
      and how many such dispatches ran;
    * ``dispatch_ahead_depth`` — high-water count of device ticks in
      flight ahead of the completer (the pipeline's achieved depth);
    * ``rx_staging_reuse_hits`` — native rx batches served from the
      replicator's reused slot/flag staging planes;
    * ``peer_probes_tx`` / ``peer_reresolves`` — replication peer-health
      probe pings sent and DNS re-resolution attempts (net/replication.py
      ``PeerHealth``);
    * ``ae_resync_buckets`` / ``ae_packets_tx`` — buckets re-synced and
      packets sent by heal-time anti-entropy (net/antientropy.py);
    * ``shutdown_flush_states`` — final dirty bucket states broadcast by
      the graceful-shutdown flush (command.py);
    * ``trace_anomaly_snapshots`` / ``trace_take_samples`` — patrol-scope
      flight-recorder anomaly snapshots taken and takes tagged with a
      cross-node trace id (utils/trace.py);
    * ``replication_tx_packets`` / ``replication_tx_bytes`` — datagrams
      and bytes the replication send paths put on the wire (both
      backends' broadcast fan-outs);
    * ``wire_deltas_batched`` / ``wire_interval_retransmits`` /
      ``wire_fullstate_fallbacks`` — wire-v2 delta plane (net/delta.py):
      bucket join-decompositions packed into delta-interval datagrams,
      expired intervals re-shipped, and peers dropped back to full-state
      repair (anti-entropy) after ack loss or heal;
    * ``fleet_packets_tx`` / ``fleet_packets_rx`` — patrol-fleet metrics
      gossip datagrams shipped and joined (net/fleet.py);
    * ``slo_breaches`` — SLO sentinel breach classes fired (take-latency
      burn rate / stage-budget overrun / memory-budget watermark,
      utils/slo.py — each also freezes a flight-recorder anomaly
      snapshot);
    * ``gc_sweeps`` / ``gc_buckets_reclaimed`` — bucket-lifecycle sweeps
      run and full idle buckets reclaimed from the device plane + host
      directory (runtime/engine.py gc_sweep, the IsZero predicate of
      ops/lifecycle.py);
    * ``gc_pressure_shed`` — NEW bucket names shed with the explicit
      429/overloaded signal at the memory budget's hard watermark;
    * ``directory_compactions`` — free-list compactions after a reclaim
      (lane-reuse locality: lowest rows hand out first);
    * ``state_bytes_in_use`` — high-water bytes of live limiter state
      (device rows + directory metadata + host lanes + GC tombstones);
      the live gauge rides ``engine_state_bytes`` in ``/debug/vars``.

    Monotonic counts + high-water gauges only; all call sites are
    per-tick/per-batch (kHz), so one mutex is noise-level overhead.

    Every ``inc``/``set_max`` call site in the tree must name a counter
    declared here — enforced by the PTL005 lint (analysis/lint.py), so a
    new counter cannot silently miss the zero-filled ``/debug/vars``
    field set below."""

    _KNOWN = (
        "staging_reuse_hits",
        "staging_leases_fresh",
        "commit_blocks_coalesced",
        "commit_dispatches",
        "dispatch_ahead_depth",
        "rx_staging_reuse_hits",
        "peer_probes_tx",
        "peer_reresolves",
        "ae_resync_buckets",
        "ae_packets_tx",
        "shutdown_flush_states",
        "trace_anomaly_snapshots",
        "trace_take_samples",
        "replication_tx_packets",
        "replication_tx_bytes",
        "wire_deltas_batched",
        "wire_interval_retransmits",
        "wire_fullstate_fallbacks",
        "fleet_packets_tx",
        "fleet_packets_rx",
        "slo_breaches",
        "gc_sweeps",
        "gc_buckets_reclaimed",
        "gc_pressure_shed",
        "directory_compactions",
        "state_bytes_in_use",
        # patrol-audit (net/audit.py): lag samples recorded, read-only
        # divergence compares completed, admitted-token windows evaluated,
        # the high-water measured overshoot (milli-factor, set_max so the
        # gauge is monotone and fleet-gossip-safe), audit frames shipped /
        # joined, and SLO overshoot breaches fired.
        # Device-resident ingest (ops/ingest.py, r15): raw-plane
        # decode+fold dispatches issued, raw dv2 bytes shipped to the
        # device (the wire→state path's "bytes, not matrices" proof),
        # rx-ring/pool plane reuse hits, and adaptive commit-block
        # resizes (PATROL_COMMIT_BLOCKS=auto governor actuations).
        "ingest_raw_device_dispatches",
        "ingest_raw_bytes_on_device",
        "rx_ring_lease_reuse",
        "commit_blocks_auto_resized",
        "audit_lag_samples",
        "audit_divergence_checks",
        "audit_windows_evaluated",
        "audit_overshoot_millis",
        "audit_packets_tx",
        "audit_packets_rx",
        "audit_overshoot_breaches",
        # patrol-membership (net/membership.py + runtime/mesh_engine.py):
        # members admitted (join + successful rejoin handshakes), members
        # retired, lanes tombstoned behind a retirement epoch, and live
        # device-mesh reshardings (MeshEngine.resize quiesce-swap-resume
        # cycles). Churn observability: /debug/vars + Prometheus carry
        # them zero-filled, and bench --churn-smoke gates on them.
        "peer_joins",
        "peer_leaves",
        "lane_tombstones",
        "mesh_resizes",
        # patrol-dispatch (runtime/engine.py scrape mirror): stats/debug
        # reads served from the epoch-validated host mirror vs. reads
        # that had to gather device rows, and mirror refreshes run (the
        # regression test pins gathers at zero per steady-state scrape).
        "scrape_mirror_hits",
        "scrape_device_gathers",
        "scrape_mirror_refreshes",
        # Hot-key take coalescing (runtime/engine.py): packed rows
        # dispatched as take-n (nreq > 1), tickets absorbed into an
        # already-open queue fold at submit time (the rx-side collapse),
        # and coalesced rows whose grant covered only a FIFO prefix of
        # their tickets (partial grant → clean denies for the rest).
        # bench --smoke's hot-key leg gates all three nonzero.
        "take_rows_coalesced",
        "take_tickets_folded",
        "take_partial_grants",
        # Merge ticks whose host fold ran in C++ (pt_fold_hybrid,
        # runtime/engine.py) instead of the numpy fold, and raw-ingest
        # batches shipped straight from page-locked rx ring planes.
        "fold_native_ticks",
        "ingest_raw_pinned_ships",
        # Raw-plane structure walks (ops/ingest.py host_walk) a batch:
        # in C++ (pt_walk_batch), or in numpy where the native library
        # does not load.
        "rx_walk_native",
        "rx_walk_plain",
        # Device-trace captures (cuda_trace, /debug/cuda/trace and
        # /debug/pprof/trace): captures written, and requests refused
        # because another capture was running (the routes' 409).
        "trace_captures",
        "trace_captures_busy",
        # Raw ingest against host lanes (runtime/engine.py): raw batches
        # whose entries the host-lane join took, entries it absorbed, and
        # take tickets sent down the device path.
        "ingest_raw_hosted_dispatches",
        "ingest_raw_hosted_absorbed",
        "take_device_tickets",
        # Multi-block commit rings by their J blocks (a power of two,
        # ops/commit.py::commit_shape); runtime/engine.py picks the name
        # from its COMMIT_RING_COUNTERS, which lists these.
        "commit_ring_j1",
        "commit_ring_j2",
        "commit_ring_j4",
        "commit_ring_j8",
        "commit_ring_j16",
        "commit_ring_j32",
        "commit_ring_j64",
        "commit_ring_j128",
        "commit_ring_j256",
        "commit_ring_j512",
        "commit_ring_j1024",
        "commit_ring_j2048",
        "commit_ring_j4096",
        "commit_ring_j8192",
        "commit_ring_j16384",
        "commit_ring_j32768",
        "commit_ring_j65536",
    )

    def __init__(self):
        self._mu = threading.Lock()
        self._vals: Dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._mu:
            self._vals[name] = self._vals.get(name, 0) + n

    def set_max(self, name: str, value: int) -> None:
        """High-water gauge: keep the largest value ever observed."""
        with self._mu:
            if value > self._vals.get(name, 0):
                self._vals[name] = value

    def get(self, name: str) -> int:
        with self._mu:
            return self._vals.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        """Every known counter (zero-filled) plus any ad-hoc ones — the
        stable field set /debug/vars readers can rely on."""
        with self._mu:
            out = {k: self._vals.get(k, 0) for k in self._KNOWN}
            for k, v in self._vals.items():
                out.setdefault(k, v)
            return out


COUNTERS = CounterRegistry()


class ProfiledLock:
    """``threading.Lock`` wrapper recording contended-acquire wait time
    into :data:`REGISTRY`. The uncontended fast path is one extra
    non-blocking try — no timing, no stack walk."""

    __slots__ = ("_lock", "_name")

    def __init__(self, name: str):
        self._lock = threading.Lock()
        self._name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(False):
            return True
        if not blocking:
            return False
        t0 = time.perf_counter_ns()
        ok = self._lock.acquire(True, timeout)
        REGISTRY.record_mutex(self._name, time.perf_counter_ns() - t0)
        return ok

    def release(self) -> None:
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self._lock.release()


class ProfiledCondition:
    """``threading.Condition`` over a :class:`ProfiledLock`, recording
    ``wait``/``wait_for`` park time as block events (Go's block-profile
    class) and lock contention as mutex events."""

    def __init__(self, name: str):
        self._name = name
        self._plock = ProfiledLock(name)
        self._cond = threading.Condition(self._plock)  # type: ignore[arg-type]

    def wait(self, timeout: Optional[float] = None) -> bool:
        t0 = time.perf_counter_ns()
        ok = self._cond.wait(timeout)
        REGISTRY.record_block(self._name, time.perf_counter_ns() - t0)
        return ok

    def wait_for(self, predicate, timeout: Optional[float] = None):
        t0 = time.perf_counter_ns()
        ok = self._cond.wait_for(predicate, timeout)
        REGISTRY.record_block(self._name, time.perf_counter_ns() - t0)
        return ok

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def acquire(self, *a, **kw):
        return self._plock.acquire(*a, **kw)

    def release(self) -> None:
        self._plock.release()

    def __enter__(self):
        return self._cond.__enter__()

    def __exit__(self, *exc):
        return self._cond.__exit__(*exc)


def thread_dump() -> str:
    """Stack dump of all live threads (≙ /debug/pprof/goroutine?debug=2)."""
    names: Dict[int, str] = {t.ident: t.name for t in threading.enumerate() if t.ident}
    out = [f"threads: {threading.active_count()}", ""]
    for tid, frame in sys._current_frames().items():
        out.append(f"thread {tid} [{names.get(tid, '?')}]:")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out) + "\n"


def heap_summary(limit: int = 30) -> str:
    """Allocation summary (≙ /debug/pprof/heap). Detailed when tracemalloc
    is active (start the server with PYTHONTRACEMALLOC=1 or POST
    /debug/pprof/heap/start), GC table otherwise."""
    import tracemalloc

    lines = []
    if tracemalloc.is_tracing():
        snap = tracemalloc.take_snapshot()
        stats = snap.statistics("lineno")
        total = sum(s.size for s in stats)
        lines.append(f"tracemalloc: {total / 1e6:.2f} MB in {len(stats)} sites")
        for s in stats[:limit]:
            lines.append(f"{s.size / 1e3:10.1f} kB  {s.count:8d} blocks  {s.traceback}")
    else:
        lines.append("tracemalloc not active; gc stats:")
        for i, gen in enumerate(gc.get_stats()):
            lines.append(f"gen{i}: {gen}")
        lines.append(f"objects: {len(gc.get_objects())}")
    return "\n".join(lines) + "\n"


class ProfilerBusyError(RuntimeError):
    """A trace capture is already running (the routes answer 409)."""


# One capture at a time: the profiler is process-global state, and a
# second overlapping capture would start it twice. Serialized here rather
# than in the HTTP layer so both fronts (and direct callers) get the same
# busy contract, as the reference's jax_trace does.
_cuda_trace_mu = threading.Lock()
_cuda_trace_prepared = False  # the profiler's one-time set-up is done


def _trace_profile():
    """The capture's ``torch.profiler.profile`` (not started) and whether
    a card is traced: CPU activity of every thread (the engine's feeder
    and completer, the fronts' pumps), not only the capturing one, plus
    the CUDA activity (kernels, copies, through CUPTI) whenever a card is
    present, whichever device the engine uses. A torch build that cannot
    trace a present card raises rather than drop the device's events."""
    import torch
    from torch._C._profiler import _ExperimentalConfig

    acts = [torch.profiler.ProfilerActivity.CPU]
    card = torch.cuda.is_available()
    if card:
        cuda = torch.profiler.ProfilerActivity.CUDA
        if cuda not in torch.profiler.supported_activities():
            raise RuntimeError(
                "a card is present but this torch build cannot trace it "
                "(no CUDA profiler activity)"
            )
        acts.append(cuda)
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(activities=acts, experimental_config=every_thread), card


def prepare_cuda_trace() -> float:
    """The profiler's one-time set-up (Kineto, and CUPTI on a card), as
    an empty capture, once a process. → its seconds (0.0 when already
    done).

    A process that serves on a card calls this before it serves
    (:class:`Command` does, on its loop's thread as it starts). Left to
    the first :func:`cuda_trace`, the set-up runs while the node serves:
    on an H100 it then took several times as long, the node served more
    slowly meanwhile, and some such processes died of a segmentation
    fault as they exited (``PERF.md`` §6; ``ROADMAP.md`` C6). Kineto's "External init
    callback must run in same thread as registerClient", printed when
    the set-up runs on another thread than the one that imported torch,
    is harmless: prepared before serving on such a thread, no process
    crashed."""
    global _cuda_trace_prepared
    with _cuda_trace_mu:
        if _cuda_trace_prepared:
            return 0.0
        t = time.perf_counter()
        prof, card = _trace_profile()
        with prof:
            if card:
                import torch

                torch.cuda.synchronize()
        _cuda_trace_prepared = True
        return time.perf_counter() - t


def cuda_trace(duration_s: float = 2.0, out_dir: Optional[str] = None) -> str:
    """Capture ``min(duration_s, 30)`` seconds of the whole process with
    ``torch.profiler`` and write it as a Chrome-trace JSON (Perfetto,
    ``chrome://tracing``) into ``out_dir``, by default a new
    ``patrol-cuda-trace-*`` temp directory. → the JSON's path.

    What it records is :func:`_trace_profile`'s: every thread's torch
    ops, and the card's kernels and copies when a card is present. The
    card is synchronized before the capture stops, so every kernel
    launched inside the window has run by then.

    Raises :class:`ProfilerBusyError` when a capture is already running.

    A capture may lose the device records of some launches early in its
    window. On an H100 serving device-path takes (``chip_smoke.py``
    phase 3k(d), in a fresh process as a deployed node runs; and
    ``chip_smoke.py --fresh-trace-legs``), most first captures held a
    kernel record for every launch call in the window, and some lacked
    the records of the calls in their first 1-230 ms; one first capture
    of 0.5 s in a smoke run held no take-n record at all. In the
    smoke run's own process, after its earlier profiled windows (which
    wait out a 0.25 s lead-in for that reason), a capture lost the
    device records of its first few launches. In a process that has not
    run :func:`prepare_cuda_trace`, the first capture does that set-up
    before its window opens."""
    global _cuda_trace_prepared
    if not _cuda_trace_mu.acquire(blocking=False):
        COUNTERS.inc("trace_captures_busy")
        raise ProfilerBusyError("a trace capture is already running")
    try:
        prof, card = _trace_profile()
        out = out_dir or tempfile.mkdtemp(prefix="patrol-cuda-trace-")
        path = os.path.join(out, "trace.json")
        with prof:
            time.sleep(min(duration_s, 30.0))
            if card:
                import torch

                torch.cuda.synchronize()
        _cuda_trace_prepared = True
        prof.export_chrome_trace(path)
        COUNTERS.inc("trace_captures")
        return path
    finally:
        _cuda_trace_mu.release()
