"""The ``PATROL_*`` environment-knob registry (PTL007).

Every environment knob the codebase reads is declared HERE, once, with
its default and a one-line operator doc. The patrol-lint PTL007 pass
enforces the contract statically: any ``os.environ`` / ``os.getenv``
read of a ``PATROL_*`` name anywhere in the tree must use a string
literal that appears in :data:`KNOBS` (so the README knob table — which
``tests/test_config.py`` checks is generated from this registry — can
never silently drift from the code), and reads through a *computed*
name are allowed only in this module, the one declared seam.

Import-light on purpose: no jax, no heavy deps — the lint stage loads
this file standalone (``importlib``) the same way it loads the native
effects table, and pure-python consumers (net/, utils/) must not pull
an accelerator runtime just to read a flush interval.

Call-site idiom: modules may keep reading literally —
``os.environ.get("PATROL_GC_WINDOW_MS", 500)`` — as long as the name is
registered, or use the typed accessors below (``env_int`` /
``env_float`` / ``env_str`` / ``env_flag``) which fall back to the
registry default and swallow malformed values the way the old scattered
``_env_int``/``_env_float`` helpers did.
"""

# NOTE: no `from __future__ import annotations` here — the lint stage
# execs this file standalone (spec_from_file_location without a
# sys.modules entry), where dataclass field resolution under deferred
# annotations breaks on py3.10.

import dataclasses
import os
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Knob:
    """One declared environment knob: the default in its environment
    string form (empty string = unset), and a one-line operator doc."""

    name: str
    default: str
    doc: str


_DECLARED: Tuple[Knob, ...] = (
    # --- runtime/engine.py: device-commit pipeline ---------------------
    Knob("PATROL_MAX_MERGE_ROWS", "8192",
         "Per-dispatch row budget for the padded merge kernels."),
    Knob("PATROL_COMMIT_BLOCKS", "auto",
         "Commit pipeline block count, or 'auto' for the adaptive governor."),
    Knob("PATROL_COMMIT_BLOCKS_MAX", "8",
         "Upper bound the 'auto' commit-block governor may resize to."),
    Knob("PATROL_COMMIT_BUDGET_MS", "50",
         "Per-tick commit latency budget steering the block governor."),
    Knob("PATROL_DISPATCH_AHEAD", "8",
         "Max in-flight device dispatches before the engine awaits."),
    Knob("PATROL_DEVICE_TIMING", "1",
         "Record per-kernel device timings into patrol-scope (0 = off)."),
    Knob("PATROL_DEVICE_ANNOTATIONS", "0",
         "Emit jax named_scope annotations for profiler traces (1 = on)."),
    Knob("PATROL_MERGE_KERNEL", "scatter",
         "Merge kernel select: scatter | auto | pallas (compile-probed)."),
    Knob("PATROL_TICK_FOLD", "1",
         "Fold deltas before the merge tick (default: 0 on cpu, 1 on "
         "accelerators)."),
    Knob("PATROL_TAKE_FOLD", "1",
         "Hot-key take coalescing (0 = per-ticket replay; differential/"
         "debug)."),
    Knob("PATROL_ROW_DENSE_MIN", "0",
         "Min distinct rows before the row-dense merge path engages."),
    Knob("PATROL_FOLD_NATIVE_MAX_DISTINCT", "4096",
         "Native-fold cutover: max distinct buckets per fold batch."),
    # --- runtime/engine.py + hoststore.py: host fastpath ---------------
    Knob("PATROL_HOST_FASTPATH", "1",
         "Serve cold and low-QPS buckets from in-process host lanes, with "
         "no device launch (0 = every take rides the device)."),
    Knob("PATROL_HOST_PROMOTE_TAKES", "4096",
         "Host takes (or absorbed rx deltas) per window past which a "
         "bucket is promoted to the device path."),
    Knob("PATROL_HOST_PROMOTE_WINDOW_MS", "100",
         "Window for the host-promotion take counter."),
    Knob("PATROL_HOST_DEMOTE_TAKES", "1024",
         "Device takes per demote window below which a promoted bucket "
         "moves back to host lanes (default: PROMOTE_TAKES/4)."),
    Knob("PATROL_HOST_DEMOTE_WINDOW_MS", "200",
         "Window for the host-demotion take counter."),
    Knob("PATROL_NATIVE_PROMOTE_TAKES", "0",
         "In-front (C++) takes per window past which the native host store "
         "promotes a bucket (0 = off)."),
    # --- runtime/engine.py: stats/debug scrape mirror ------------------
    Knob("PATROL_SCRAPE_MIRROR", "1",
         "Serve stats/debug reads (snapshot/tokens//debug/vars) from an "
         "epoch-validated host mirror instead of a device gather per "
         "scrape (0 = gather every time)."),
    Knob("PATROL_SCRAPE_MIRROR_ROWS", "4096",
         "Max device rows the scrape mirror caches per refresh; rows "
         "beyond the window fall back to a targeted gather."),
    # --- runtime/engine.py: bucket lifecycle / GC ----------------------
    Knob("PATROL_GC_WINDOW_MS", "500",
         "Idle-bucket GC sweep cadence."),
    Knob("PATROL_GC_IDLE_MS", "1000",
         "Idle age after which a zero-balance bucket is reclaimable."),
    Knob("PATROL_GC_SWEEP_MAX", "8192",
         "Max buckets examined per GC sweep."),
    Knob("PATROL_MAX_BUCKETS", "0",
         "Hard bucket-count budget (0 = unbounded)."),
    Knob("PATROL_STATE_BYTES_BUDGET", "0",
         "Hard device-state byte budget (0 = unbounded)."),
    Knob("PATROL_GC_SOFT_FRAC", "0.85",
         "Budget fraction at which GC turns eager before shedding."),
    Knob("PATROL_AUDIT_WINDOW_MS", "5000",
         "patrol-audit consistency-window length on the engine side."),
    # --- ops/pallas_merge.py -------------------------------------------
    Knob("PATROL_PALLAS_MIN_BATCH", "1024",
         "Min batch before the pallas merge is preferred under 'auto'."),
    Knob("PATROL_PALLAS_BLOCK_FRAC", "0.25",
         "VMEM fraction the pallas merge may claim per block."),
    # --- net/: replication planes --------------------------------------
    Knob("PATROL_RAW_INGEST", "1",
         "Device-resident decode+fold of raw delta datagrams (0 = host)."),
    Knob("PATROL_DELTA_FLUSH_MS", "20",
         "Delta-plane flush pacing."),
    Knob("PATROL_DELTA_RETX_TICKS", "8",
         "Flush ticks before an unacked delta interval retransmits."),
    Knob("PATROL_PYFRONT_BATCH", "1",
         "Batch python HTTP-front takes per engine tick (0 = per-call)."),
    Knob("PATROL_AUDIT_MS", "1000",
         "patrol-audit plane pacing (0 = manual flush; tests/bench)."),
    Knob("PATROL_FLEET_GOSSIP_MS", "1000",
         "Metrics-lattice gossip pacing (0 = manual flush)."),
    # --- native/ --------------------------------------------------------
    Knob("PATROL_NATIVE_LIB", "",
         "Override path for the native host library (asan-py stage)."),
    Knob("PATROL_FOLD_THREADS", "",
         "Native fold worker threads (unset = library picks)."),
    # --- utils/: observability ------------------------------------------
    Knob("PATROL_TRACE", "1",
         "Flight-recorder master switch (0 = rings off)."),
    Knob("PATROL_TRACE_RING", "4096",
         "Flight-recorder ring capacity, events per thread."),
    Knob("PATROL_TRACE_SAMPLE", "0",
         "Cross-node span sampling: 1 in N takes traced (0 = off)."),
    Knob("PATROL_SLO_TAKE_P99_NS", "0",
         "Take-latency burn-rate budget for the SLO sentinel (0 = off)."),
    Knob("PATROL_SLO_STAGE_P99_NS", "0",
         "Commit-stage p99 budget for the SLO sentinel (0 = off)."),
    Knob("PATROL_SLO_OVERSHOOT", "0",
         "AP-overshoot budget factor for patrol-audit (0 = off)."),
)

KNOBS: Dict[str, Knob] = {k.name: k for k in _DECLARED}
assert len(KNOBS) == len(_DECLARED), "duplicate knob declaration"


def _raw(name: str, default: Optional[str]) -> str:
    knob = KNOBS[name]  # KeyError = unregistered knob; declare it above
    fallback = knob.default if default is None else default
    # The one sanctioned computed-name environment read (PTL007 seam).
    return os.environ.get(name, fallback)


def env_str(name: str, default: Optional[str] = None) -> str:
    """Registered knob as a string (registry default when unset)."""
    return _raw(name, default)


def env_int(name: str, default: Optional[int] = None) -> int:
    """Registered knob as an int; malformed values fall back to the
    default (the old scattered ``_env_int`` helpers' contract)."""
    fb = None if default is None else str(default)
    try:
        return int(_raw(name, fb))
    except ValueError:
        return int(KNOBS[name].default if default is None else default)


def env_float(name: str, default: Optional[float] = None) -> float:
    """Registered knob as a float; malformed values fall back."""
    fb = None if default is None else str(default)
    try:
        return float(_raw(name, fb))
    except ValueError:
        return float(KNOBS[name].default if default is None else default)


def env_flag(name: str, default: Optional[bool] = None) -> bool:
    """Registered knob as the repo's boolean idiom: set-and-not-"0"."""
    fb = None if default is None else ("1" if default else "0")
    return _raw(name, fb) != "0"


def render_knob_table() -> str:
    """The README/PROBES markdown table, generated from the registry so
    docs and code cannot drift (checked by ``tests/test_config.py``)."""
    lines = [
        "| knob | default | what it does |",
        "|------|---------|--------------|",
    ]
    for k in _DECLARED:
        default = f"`{k.default}`" if k.default else "*(unset)*"
        lines.append(f"| `{k.name}` | {default} | {k.doc} |")
    return "\n".join(lines)
