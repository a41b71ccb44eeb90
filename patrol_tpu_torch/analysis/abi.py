"""patrol-abi: native-ABI conformance prover + cross-boundary concurrency
lint over the port's own C++ library (stage 5; counterpart of the JAX
package's ``analysis/abi.py``).

The port builds ``libpatrolhost.so`` from its own copies of the C++
sources (``patrol_tpu_torch/native/*.cpp``). Its hot native path
re-implements the join in C++: ``pt_rx_classify`` folds duplicate deltas
by max inside the rx batch, ``pt_fold_hybrid`` folds whole ticks into
per-row lane blocks, and ``hls_take_locked`` serves /take decisions on
the epoll thread. A refactor that swaps a ``>`` for a ``>=`` in one of
those folds forks replica state, so every fold and interleaving is
checked on the library actually built, through the C ABI via ctypes (the
exact seam production uses).

1. **Conformance** (PTA001) — run ``pt_fold_hybrid`` and
   ``pt_rx_classify`` exhaustively over a tiny lattice domain (3 rows ×
   2 slots × {0, 3} values, the reference's prove domain) plus the wire
   codec's hostile float grid, and assert bit-exactness against the
   Python-side references — including applying the native fold's output
   through the registered merge kernels (``ops/obligations.py``'s
   ``KERNEL_ROOTS``, resolved at call time) on an explicit device, and
   comparing against the raw batch through ``merge_batch``: the two
   paths into device state must be indistinguishable. On the CPU those
   kernels are the plain versions; on ``cuda`` they launch ``join.cu``.

2. **Merge laws on the native side** (PTA002 commutativity / batch-order
   freedom, PTA003 idempotence under duplication + monotonicity),
   evaluated on the C++ outputs: permuting a batch, duplicating it, or
   extending it must never reorder, re-derive, or shrink a folded lane.

3. **Interleaving exploration** (PTA004) — a deterministic schedule
   explorer for the host-lane store: bounded per-caller scripts of
   ``pt_hls_lock``/``host_locked``/``unhost_locked``/``drain_locked``/
   ``take_probe``/``events``/``stats`` are interleaved every legal way
   across 2–3 simulated callers; every schedule executes against a
   fresh native store AND a step-for-step Python model, and every
   per-op result plus the post-schedule token-conservation invariant
   must agree. Lock-protocol legality is judged from the declared
   effects table (``native/__init__.py::NATIVE_EFFECTS``). The rx ring's
   lease/commit protocol is explored the same way.

PTA005 closes the loop on the boundary contract itself: every
``lib.pt_*`` symbol bound in ``native/__init__.py`` and every ``pt_*``
function the C++ sources define must have a ``NATIVE_EFFECTS`` entry,
and no entry may be stale.

Findings reuse :class:`patrol_tpu_torch.analysis.lint.Finding` and the
same inline suppression directives (``# patrol-lint: disable=PTA001``).
Driver: ``patrol_tpu_torch/scripts/abi_repo.py``; tests:
``tests/test_torch_abi.py``; on the card, ``chip_smoke.py`` phase 3k.

Obligation codes:

====== ==========================================================
PTA001 native/kernel conformance: bit-exact against the merge kernels
PTA002 batch-order freedom (commutativity) on the native side
PTA003 idempotence under duplication + monotonicity, native side
PTA004 host-lane store and rx-ring schedule exploration
PTA005 effects-table completeness for every bound and defined pt_* symbol
====== ==========================================================
"""

from __future__ import annotations

import ctypes
import dataclasses
import errno
import functools
import itertools
import math
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from patrol_tpu_torch.analysis.lint import Finding, apply_suppressions

__all__ = [
    "AbiObligation",
    "HlsOp",
    "HlsScenario",
    "NativeUnavailable",
    "abi_all",
    "abi_repo",
    "builtin_scenarios",
    "explore_scenario",
    "ALL_CODES",
]

ALL_CODES = ("PTA001", "PTA002", "PTA003", "PTA004", "PTA005")

NANO = 1_000_000_000
INT64_MAX = (1 << 63) - 1

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_HOST_CPP = "patrol_tpu_torch/native/patrol_host.cpp"
_HTTP_CPP = "patrol_tpu_torch/native/patrol_http.cpp"
_NATIVE_INIT = "patrol_tpu_torch/native/__init__.py"


class NativeUnavailable(RuntimeError):
    """The native toolchain/library is absent — the stage must SKIP
    loudly (``abi_repo.py`` exits 77), never silently pass."""


@dataclasses.dataclass(frozen=True)
class AbiObligation:
    """One registered native-ABI obligation (the registry itself lives
    next to the kernels, in ``patrol_tpu_torch/ops/obligations.py`` —
    ``ABI_OBLIGATIONS``). ``check`` names the pass in :data:`_CHECKS`;
    ``twins`` names the kernel roots the native symbol must stay
    bit-exact against (resolved at call time through ``KERNEL_ROOTS``,
    so a monkeypatched kernel is what gets compared)."""

    name: str
    symbol: Optional[str]
    codes: Tuple[str, ...]
    check: str
    twins: Tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# Finding sites: anchor native findings at the symbol's definition line in
# the .cpp source (best-effort), PTA005 at the registration line.

_DEF_PREFIXES = ("int", "void", "uint", "extern")


def _cpp_site(symbol: str) -> Tuple[str, int]:
    for rel in (_HOST_CPP, _HTTP_CPP):
        try:
            with open(os.path.join(_REPO_ROOT, rel), encoding="utf-8") as fh:
                for lineno, line in enumerate(fh, start=1):
                    s = line.lstrip()
                    if f"{symbol}(" in s and s.startswith(_DEF_PREFIXES):
                        return rel, lineno
        except OSError:  # pragma: no cover
            continue
    return _HOST_CPP, 1


def _fnv1a64(raw: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in raw:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _load_lib():
    from patrol_tpu_torch import native

    lib = native.load()
    if lib is None:
        raise NativeUnavailable(
            "the port's libpatrolhost is unavailable (no toolchain?) — "
            "patrol-abi cannot run; the stage must SKIP, not pass"
        )
    return lib


def _sat_mul_nano(v: int) -> int:
    if v > INT64_MAX // NANO:
        return INT64_MAX
    if v < -(INT64_MAX // NANO):
        return -INT64_MAX
    return v * NANO


# ===========================================================================
# Pass 1a/2 — pt_fold_hybrid conformance + merge laws.


def _reference_fold(
    rows, slots, added, taken, elapsed, nodes, row_dense_min, max_distinct,
    cap_dense,
):
    """The Python-side reference of pt_fold_hybrid: per-row elementwise
    max into lane planes, ascending-row emission, dense split by touched
    lanes with first-``cap_dense`` selection. Returns the nine output
    arrays (sp_rows, sp_slots, sp_a, sp_t, sp_er, sp_e, d_rows, d_upd,
    d_el) or None where the native fold must bail (rc=-1): a malformed
    slot or a distinct-row set past ``max_distinct``. Module-level and
    resolved by name at check time, so the seeded-mutation self-test can
    perturb it and watch PTA001 reject the divergence."""
    acc: Dict[int, Tuple[np.ndarray, int, Set[int]]] = {}
    for i in range(len(rows)):
        s = int(slots[i])
        if s < 0 or s >= nodes:
            return None
        r = int(rows[i])
        if r not in acc:
            if len(acc) >= max_distinct:
                return None
            acc[r] = [np.zeros((nodes, 2), np.int64), 0, set()]
        lanes, el, touched = acc[r]
        touched.add(s)
        if int(added[i]) > lanes[s, 0]:
            lanes[s, 0] = int(added[i])
        if int(taken[i]) > lanes[s, 1]:
            lanes[s, 1] = int(taken[i])
        if int(elapsed[i]) > el:
            acc[r][1] = int(elapsed[i])
    sp_rows, sp_slots, sp_a, sp_t, sp_er, sp_e = [], [], [], [], [], []
    d_rows, d_upd, d_el = [], [], []
    for r in sorted(acc):
        lanes, el, touched = acc[r]
        if len(touched) >= row_dense_min and len(d_rows) < cap_dense:
            d_rows.append(r)
            d_upd.append(lanes)
            d_el.append(el)
            continue
        for s in sorted(touched):
            sp_rows.append(r)
            sp_slots.append(s)
            sp_a.append(int(lanes[s, 0]))
            sp_t.append(int(lanes[s, 1]))
        sp_er.append(r)
        sp_e.append(el)
    return (
        np.array(sp_rows, np.int64),
        np.array(sp_slots, np.int64),
        np.array(sp_a, np.int64),
        np.array(sp_t, np.int64),
        np.array(sp_er, np.int64),
        np.array(sp_e, np.int64),
        np.array(d_rows, np.int64),
        np.array(d_upd, np.int64).reshape(len(d_rows), nodes, 2),
        np.array(d_el, np.int64),
    )


def _native_fold(
    lib, rows, slots, added, taken, elapsed, nodes, row_dense_min,
    max_distinct, cap_dense,
):
    """Drive pt_fold_hybrid through ctypes → the nine output arrays, or
    None on rc=-1 (the bail the numpy path absorbs)."""
    n = len(rows)
    as_i64 = lambda a: np.ascontiguousarray(a, np.int64)  # noqa: E731
    d_rows = np.zeros(cap_dense, np.int64)
    d_upd = np.zeros(cap_dense * nodes * 2, np.int64)
    d_el = np.zeros(cap_dense, np.int64)
    sp_rows = np.zeros(max(n, 1), np.int64)
    sp_slots = np.zeros(max(n, 1), np.int64)
    sp_a = np.zeros(max(n, 1), np.int64)
    sp_t = np.zeros(max(n, 1), np.int64)
    sp_er = np.zeros(max(n, 1), np.int64)
    sp_e = np.zeros(max(n, 1), np.int64)
    counts = np.zeros(3, np.int64)
    rc = lib.pt_fold_hybrid(
        as_i64(rows), as_i64(slots), as_i64(added), as_i64(taken),
        as_i64(elapsed), n, nodes, row_dense_min, max_distinct,
        d_rows, d_upd, d_el, cap_dense,
        sp_rows, sp_slots, sp_a, sp_t, sp_er, sp_e, counts,
    )
    if rc != 0:
        return None
    npairs, nrows, nd = int(counts[0]), int(counts[1]), int(counts[2])
    return (
        sp_rows[:npairs].copy(), sp_slots[:npairs].copy(),
        sp_a[:npairs].copy(), sp_t[:npairs].copy(),
        sp_er[:nrows].copy(), sp_e[:nrows].copy(),
        d_rows[:nd].copy(), d_upd[: nd * nodes * 2].reshape(nd, nodes, 2).copy(),
        d_el[:nd].copy(),
    )


def _fold_outputs_equal(a, b) -> bool:
    if (a is None) != (b is None):
        return False
    if a is None:
        return True
    return all(np.array_equal(x, y) for x, y in zip(a, b))


_FOLD_KW = dict(nodes=2, row_dense_min=2, max_distinct=8, cap_dense=8)


def _fold_domain_deltas() -> np.ndarray:
    """The tiny lattice domain (the reference's prove domain
    ``JoinDomain(B=3, N=2).deltas((0, 3))``): every (row, slot, added,
    taken, elapsed) combination over 3 rows × 2 slots × {0, 3} values,
    in that product order."""
    vals = (0, 3)
    return np.array(
        list(itertools.product(range(3), range(2), vals, vals, vals)), np.int64
    )


def _zero_state(B: int, nodes: int, device):
    import torch

    from patrol_tpu_torch.models.limiter import LimiterState

    return LimiterState(
        pn=torch.zeros((B, nodes, 2), dtype=torch.int64, device=device),
        elapsed=torch.zeros(B, dtype=torch.int64, device=device),
    )


def _i64(a, device):
    import torch

    return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device)


def _planes(state):
    return state.pn.cpu().numpy(), state.elapsed.cpu().numpy()


def _apply_fold_via_kernels(out, B: int, nodes: int, kernels, device="cuda"):
    """Native fold output → state on ``device`` through the registered
    folded kernel roots (zero initial state) → numpy (pn, elapsed)."""
    from patrol_tpu_torch.ops.merge import FoldedMergeBatch, RowDenseBatch

    sp_rows, sp_slots, sp_a, sp_t, sp_er, sp_e, d_rows, d_upd, d_el = out
    state = _zero_state(B, nodes, device)
    if len(sp_rows):
        state = kernels["ops.merge.merge_batch_folded"](
            state,
            FoldedMergeBatch(
                rows=_i64(sp_rows, device),
                slots=_i64(sp_slots, device),
                added_nt=_i64(sp_a, device),
                taken_nt=_i64(sp_t, device),
                erows=_i64(sp_er, device),
                elapsed_ns=_i64(sp_e, device),
            ),
        )
    if len(d_rows):
        state = kernels["ops.merge.merge_rows_dense"](
            state,
            RowDenseBatch(
                rows=_i64(d_rows, device),
                updates=_i64(d_upd, device),
                elapsed_ns=_i64(d_el, device),
            ),
        )
    return _planes(state)


def _apply_raw_via_merge_batch(
    deltas: np.ndarray, B: int, nodes: int, kernels, device="cuda"
):
    """The raw batch → state on ``device`` through ``merge_batch`` (zero
    initial state) → numpy (pn, elapsed)."""
    from patrol_tpu_torch.ops.merge import MergeBatch

    state = kernels["ops.merge.merge_batch"](
        _zero_state(B, nodes, device),
        MergeBatch(
            rows=_i64(deltas[:, 0], device),
            slots=_i64(deltas[:, 1], device),
            added_nt=_i64(deltas[:, 2], device),
            taken_nt=_i64(deltas[:, 3], device),
            elapsed_ns=_i64(deltas[:, 4], device),
        ),
    )
    return _planes(state)


def _resolve_twins(ob: AbiObligation) -> Dict[str, Callable]:
    """twin name → the function as it stands in its module now (looked
    up at each call, so a monkeypatched kernel is what gets compared)."""
    import importlib

    from patrol_tpu_torch.ops.obligations import KERNEL_ROOTS

    out: Dict[str, Callable] = {}
    for t in ob.twins:
        if t in KERNEL_ROOTS:
            module, func = KERNEL_ROOTS[t]
            out[t] = getattr(importlib.import_module(module), func)
    return out


def _fold_of(lib, deltas: np.ndarray, **kw):
    return _native_fold(
        lib, deltas[:, 0], deltas[:, 1], deltas[:, 2], deltas[:, 3],
        deltas[:, 4], **kw,
    )


def check_fold_conformance(ob: AbiObligation, lib, device="cuda") -> List[Finding]:
    """PTA001-PTA003 for pt_fold_hybrid: exhaustive singles + pairs over
    the lattice domain against the Python reference fold (and, at the
    state level, against the registered merge kernels on ``device``), plus
    order/duplication/monotonicity laws and structured shapes (dense
    split, dense-cap spill, distinct-row bail, malformed-slot bail, a
    forced 2-shard fold)."""
    site = _cpp_site("pt_fold_hybrid")
    findings: List[Finding] = []
    kernels = _resolve_twins(ob)
    deltas = _fold_domain_deltas()
    B, nodes = 3, 2
    kw = dict(_FOLD_KW)
    kw["nodes"] = nodes

    def emit(code: str, msg: str) -> None:
        findings.append(Finding(code, *site, f"[{ob.name}] {msg}"))

    def conforms(batch: np.ndarray, what: str) -> Optional[tuple]:
        got = _fold_of(lib, batch, **kw)
        want = _reference_fold(
            batch[:, 0], batch[:, 1], batch[:, 2], batch[:, 3], batch[:, 4],
            **kw,
        )
        if not _fold_outputs_equal(got, want):
            emit(
                "PTA001",
                f"native fold diverges from the reference fold on {what}: "
                f"batch={batch.tolist()}",
            )
            return None
        return got

    # -- exhaustive singles + ordered pairs (the prove domain) --------------
    bad = 0
    for i in range(len(deltas)):
        if conforms(deltas[i : i + 1], "a single delta") is None:
            bad += 1
        if bad >= 3:
            break
    for a, b in itertools.product(range(len(deltas)), repeat=2):
        if bad >= 3:
            break
        if conforms(np.stack([deltas[a], deltas[b]]), "a delta pair") is None:
            bad += 1

    # -- state-level agreement through the registered kernel roots ----------
    rng = np.random.default_rng(7)
    structured = [
        deltas[rng.integers(0, len(deltas), size=n)] for n in (1, 4, 9, 24)
    ]
    # A hot row touching both slots: exercises the dense emission.
    structured.append(
        np.array(
            [[1, 0, 3, 0, 3], [1, 1, 0, 3, 0], [1, 0, 1, 1, 1], [0, 1, 3, 3, 3]],
            np.int64,
        )
    )
    if kernels:
        for batch in structured:
            got = conforms(batch, "a structured batch")
            if got is None:
                continue
            via_fold = _apply_fold_via_kernels(got, B, nodes, kernels, device)
            via_raw = _apply_raw_via_merge_batch(batch, B, nodes, kernels, device)
            if not (
                np.array_equal(via_fold[0], via_raw[0])
                and np.array_equal(via_fold[1], via_raw[1])
            ):
                emit(
                    "PTA001",
                    "state diverges: native fold applied through "
                    "merge_batch_folded/merge_rows_dense != the raw batch "
                    f"through merge_batch (batch={batch.tolist()})",
                )
                break

    # -- merge laws evaluated on the native outputs -------------------------
    law_batch = deltas[rng.integers(0, len(deltas), size=5)]
    base = _fold_of(lib, law_batch, **kw)
    for perm in itertools.permutations(range(5)):
        if not _fold_outputs_equal(base, _fold_of(lib, law_batch[list(perm)], **kw)):
            emit(
                "PTA002",
                "native fold is batch-order dependent: permutation "
                f"{list(perm)} of {law_batch.tolist()} changed the output "
                "(replicas folding different arrival orders would diverge)",
            )
            break
    dup = np.concatenate([law_batch, law_batch])
    if not _fold_outputs_equal(base, _fold_of(lib, dup, **kw)):
        emit(
            "PTA003",
            "native fold is not idempotent under batch duplication: "
            f"{law_batch.tolist()} twice != once",
        )
    # Monotonicity: extending the batch must never shrink a folded lane.
    ext = np.concatenate([law_batch, deltas[rng.integers(0, len(deltas), size=3)]])
    fe = _fold_of(lib, ext, **kw)
    if base is not None and fe is not None:

        def lane_map(out):
            m = {}
            for r, s, a, t in zip(out[0], out[1], out[2], out[3]):
                m[(int(r), int(s))] = (int(a), int(t))
            for i, r in enumerate(out[6]):
                for s in range(nodes):
                    m[(int(r), s)] = (int(out[7][i, s, 0]), int(out[7][i, s, 1]))
            return m

        small, big = lane_map(base), lane_map(fe)
        for key, (a, t) in small.items():
            ba, bt = big.get(key, (-1, -1))
            if ba < a or bt < t:
                emit(
                    "PTA003",
                    f"native fold is not monotone: extending the batch "
                    f"shrank lane {key} from {(a, t)} to {(ba, bt)}",
                )
                break

    # -- shape edges: spill, bail parity, forced shard merge ----------------
    spill_kw = dict(kw)
    spill_kw["cap_dense"] = 1
    spill = np.array(
        [[0, 0, 3, 1, 1], [0, 1, 1, 3, 2], [2, 0, 3, 3, 3], [2, 1, 1, 1, 1]],
        np.int64,
    )
    got = _fold_of(lib, spill, **spill_kw)
    want = _reference_fold(
        spill[:, 0], spill[:, 1], spill[:, 2], spill[:, 3], spill[:, 4],
        **spill_kw,
    )
    if not _fold_outputs_equal(got, want):
        emit("PTA001", "dense-cap spill order diverges from the reference")
    bail_kw = dict(kw)
    bail_kw["max_distinct"] = 2
    three_rows = np.array(
        [[0, 0, 1, 0, 0], [1, 0, 1, 0, 0], [2, 0, 1, 0, 0]], np.int64
    )
    if _fold_of(lib, three_rows, **bail_kw) is not None:
        emit(
            "PTA001",
            "native fold did not bail at max_distinct (the numpy fallback "
            "contract): 3 distinct rows accepted with max_distinct=2",
        )
    bad_slot = np.array([[0, 5, 1, 0, 0]], np.int64)
    if _fold_of(lib, bad_slot, **kw) is not None:
        emit("PTA001", "native fold accepted a malformed slot (must bail)")
    # Forced 2-shard fold: the shard-merge path must stay bit-exact.
    old = os.environ.get("PATROL_FOLD_THREADS")
    os.environ["PATROL_FOLD_THREADS"] = "2"
    try:
        big = deltas[rng.integers(0, len(deltas), size=64)]
        conforms(big, "a forced 2-shard fold")
    finally:
        if old is None:
            os.environ.pop("PATROL_FOLD_THREADS", None)
        else:  # pragma: no cover
            os.environ["PATROL_FOLD_THREADS"] = old
    return findings


# ===========================================================================
# Pass 1b/2 — pt_rx_classify conformance + merge laws.


class _DirHarness:
    """A native directory with abi-owned side arrays, driven raw through
    the C ABI — rows 0..k-1 bound to ``names``."""

    def __init__(self, lib, names: Sequence[bytes], capacity: int = 8):
        self.lib = lib
        self.capacity = capacity
        self.names = list(names)
        self.name_bytes = np.zeros((capacity, 256), np.uint8)
        self.name_lens = np.zeros(capacity, np.int32)
        self.cap_base = np.zeros(capacity, np.int64)
        self.created = np.zeros(capacity, np.int64)
        self.pins = np.zeros(capacity, np.int32)
        self.last_used = np.zeros(capacity, np.int64)
        self.rows = {}
        self.h = lib.pt_dir_create(capacity, self.name_bytes, self.name_lens)
        if self.h < 0:  # pragma: no cover
            raise NativeUnavailable("pt_dir_create failed")
        for row, raw in enumerate(self.names):
            self.name_bytes[row, : len(raw)] = np.frombuffer(raw, np.uint8)
            self.name_lens[row] = len(raw)
            self.rows[raw] = row
            lib.pt_dir_insert(self.h, _fnv1a64(raw), row)

    def close(self) -> None:
        self.lib.pt_dir_destroy(self.h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


@dataclasses.dataclass
class _ClassifyBatch:
    """One pt_rx_classify input batch, name-addressed."""

    names: List[bytes]
    lens: List[int]  # explicit so a malformed len (-1) is expressible
    slots: List[int]
    added: List[float]
    taken: List[float]
    elapsed: List[int]  # u64 as seen on the wire
    caps: List[int]
    lane_a: List[int]
    lane_t: List[int]
    no_trailer: List[int]

    @property
    def n(self) -> int:
        return len(self.names)

    def subset(self, order: Sequence[int]) -> "_ClassifyBatch":
        g = lambda xs: [xs[i] for i in order]  # noqa: E731
        return _ClassifyBatch(
            g(self.names), g(self.lens), g(self.slots), g(self.added),
            g(self.taken), g(self.elapsed), g(self.caps), g(self.lane_a),
            g(self.lane_t), g(self.no_trailer),
        )

    def concat(self, other: "_ClassifyBatch") -> "_ClassifyBatch":
        fields = [f.name for f in dataclasses.fields(self)]
        return _ClassifyBatch(
            *[getattr(self, f) + getattr(other, f) for f in fields]
        )


def _native_classify(lib, d: _DirHarness, b: _ClassifyBatch, max_slots: int,
                     now: int):
    n = b.n
    name_buf = np.zeros((n, 256), np.uint8)
    for i, raw in enumerate(b.names):
        name_buf[i, : len(raw)] = np.frombuffer(raw, np.uint8)
    hashes = np.array([_fnv1a64(raw) for raw in b.names], np.uint64)
    rows = np.full(n, -9, np.int64)
    out_a = np.zeros(n, np.int64)
    out_t = np.zeros(n, np.int64)
    out_e = np.zeros(n, np.int64)
    out_s = np.zeros(n, np.uint8)
    lib.pt_rx_classify(
        d.h, n, hashes, name_buf,
        np.ascontiguousarray(b.lens, np.int32),
        np.ascontiguousarray(b.added, np.float64),
        np.ascontiguousarray(b.taken, np.float64),
        np.ascontiguousarray(b.elapsed, np.uint64),
        np.ascontiguousarray(b.slots, np.int64), max_slots,
        np.ascontiguousarray(b.caps, np.int64),
        np.ascontiguousarray(b.lane_a, np.int64),
        np.ascontiguousarray(b.lane_t, np.int64),
        np.ascontiguousarray(b.no_trailer, np.uint8),
        d.cap_base, d.pins, d.last_used, now,
        rows, out_a, out_t, out_e, out_s,
    )
    return rows, out_a, out_t, out_e, out_s


def _reference_classify(
    bound: Dict[bytes, int], cap_base: np.ndarray, pins: np.ndarray,
    last_used: np.ndarray, b: _ClassifyBatch, max_slots: int, now: int,
):
    """Python-side reference of pt_rx_classify over the same mutable side
    arrays (mutated in place, like the native call): resolve + batch-wide
    cap adoption, sanitize through the registered wire codec, wire-
    semantics classification, and the per-batch (row, slot, code) CRDT
    dedup. Module-level so self-tests can perturb it."""
    from patrol_tpu_torch.ops import wire

    n = b.n
    rows = np.zeros(n, np.int64)
    out_a = np.zeros(n, np.int64)
    out_t = np.zeros(n, np.int64)
    out_e = np.zeros(n, np.int64)
    out_s = np.zeros(n, np.uint8)
    # Pass 1: resolve (pin + LRU stamp) and adopt wire capacities in batch
    # order, so classification below sees the batch-wide base.
    for i in range(n):
        if b.lens[i] < 0 or b.slots[i] < 0 or b.slots[i] >= max_slots:
            rows[i] = -2
            continue
        r = bound.get(b.names[i], -1)
        if r >= 0 and b.lens[i] != len(b.names[i]):
            r = -1  # wrong declared length: byte row cannot verify
        rows[i] = r
        if r >= 0:
            pins[r] += 1
            last_used[r] = now
            if b.caps[i] > 0 and cap_base[r] == 0:
                cap_base[r] = b.caps[i]
    # Pass 2: sanitize + classify + dedup into the first occurrence.
    a_nt = wire.sanitize_nt_array(np.asarray(b.added, np.float64))
    t_nt = wire.sanitize_nt_array(np.asarray(b.taken, np.float64))
    e_i64 = np.asarray(b.elapsed, np.uint64).view(np.int64)
    first: Dict[Tuple[int, int, int], int] = {}
    for i in range(n):
        r = int(rows[i])
        if r < 0:
            continue
        a, t = int(a_nt[i]), int(t_nt[i])
        out_e[i] = max(int(e_i64[i]), 0)
        if b.caps[i] >= 0:
            if b.lane_a[i] >= 0 and b.lane_t[i] >= 0:
                out_a[i], out_t[i] = b.lane_a[i], b.lane_t[i]
            else:
                out_a[i] = max(a - b.caps[i], 0)
                out_t[i] = t
                out_s[i] = 1
        elif b.no_trailer[i]:
            base = int(cap_base[r])
            if base == 0:
                out_a[i], out_t[i], out_s[i] = a, t, 2
            else:
                out_a[i] = max(a - base, 0)
                out_t[i] = t
                out_s[i] = 1
        else:
            out_a[i], out_t[i] = a, t
        key = (r, int(b.slots[i]), int(out_s[i]))
        j = first.get(key)
        if j is None:
            first[key] = i
        else:
            out_a[j] = max(out_a[j], out_a[i])
            out_t[j] = max(out_t[j], out_t[i])
            out_e[j] = max(out_e[j], out_e[i])
            rows[i] = -4
            pins[r] -= 1
    return rows, out_a, out_t, out_e, out_s


# The hostile float grid (a slice of the wire codec model's) + the lattice
# values: NaN, infinities, negatives, rounding, and the overflow edge.
_F_VALS = (0.0, 1.5, -1.0, float("nan"), float("inf"), 2.0**62)
_T_VALS = (0.0, 0.5, float("nan"), 2.0**62)
_E_VALS = (0, 7, (1 << 64) - 3)  # third is a negative i64 → clamps to 0
_FORMS = (
    # (caps, lane_a, lane_t, no_trailer)
    (-1, -1, -1, 1),               # v1 packet
    (-1, -1, -1, 0),               # cap-less base trailer
    (0, -1, -1, 0),                # cap trailer, zero cap
    (2 * NANO, -1, -1, 0),         # cap trailer
    (2 * NANO, 0, 0, 0),           # lane trailer variants
    (2 * NANO, 3 * NANO, 0, 0),
    (2 * NANO, 0, NANO, 0),
    (2 * NANO, 3 * NANO, NANO, 0),
)


def _classify_compare(lib, d: _DirHarness, b: _ClassifyBatch, now: int,
                      max_slots: int = 2,
                      presets: Optional[Dict[int, int]] = None):
    """Run native + reference on identical side-array states → mismatch
    description or None. Resets cap_base/pins/last_used around the run."""
    presets = presets or {}
    for arrs in (d.cap_base, d.pins, d.last_used):
        arrs[:] = 0
    for row, cap in presets.items():
        d.cap_base[row] = cap
    got = _native_classify(lib, d, b, max_slots, now)
    ncap, npin, nlru = d.cap_base.copy(), d.pins.copy(), d.last_used.copy()
    for arrs in (d.cap_base, d.pins, d.last_used):
        arrs[:] = 0
    for row, cap in presets.items():
        d.cap_base[row] = cap
    want = _reference_classify(
        d.rows, d.cap_base, d.pins, d.last_used, b, max_slots, now
    )
    if not np.array_equal(got[0], want[0]):
        return f"rows {got[0].tolist()} != {want[0].tolist()}"
    live = got[0] >= 0
    folded = got[0] == -4
    sel = live | folded
    for k, label in ((1, "added"), (2, "taken"), (3, "elapsed"), (4, "scalar")):
        if not np.array_equal(got[k][sel], want[k][sel]):
            return (
                f"{label} {got[k][sel].tolist()} != {want[k][sel].tolist()}"
            )
    if not np.array_equal(ncap, d.cap_base):
        return f"cap adoption {ncap.tolist()} != {d.cap_base.tolist()}"
    if not np.array_equal(npin, d.pins):
        return f"pins {npin.tolist()} != {d.pins.tolist()}"
    if not np.array_equal(nlru, d.last_used):
        return f"last_used {nlru.tolist()} != {d.last_used.tolist()}"
    return None


def _classify_agg(res, b: _ClassifyBatch) -> Dict[tuple, tuple]:
    """Surviving classify entries → {(row, slot, code): per-key maxes} —
    the order-free summary the PTA002/PTA003 law checks compare."""
    rows, out_a, out_t, out_e, out_s = res
    agg: Dict[tuple, tuple] = {}
    for i in range(len(rows)):
        if rows[i] < 0:
            continue
        key = (int(rows[i]), int(b.slots[i]), int(out_s[i]))
        prev = agg.get(key, (0, 0, 0))
        agg[key] = (
            max(prev[0], int(out_a[i])),
            max(prev[1], int(out_t[i])),
            max(prev[2], int(out_e[i])),
        )
    return agg


def check_classify_conformance(ob: AbiObligation, lib) -> List[Finding]:
    """PTA001-PTA003 for pt_rx_classify: a pointwise sweep over names ×
    slots × trailer forms × the hostile float grid against the Python
    reference (sanitize rides the registered wire codec), then batch-level
    law checks — permutation, duplication, extension — on the surviving
    (row, slot, code) aggregates, plus pin accounting."""
    site = _cpp_site("pt_rx_classify")
    findings: List[Finding] = []

    def emit(code: str, msg: str) -> None:
        findings.append(Finding(code, *site, f"[{ob.name}] {msg}"))

    with _DirHarness(lib, [b"a", b"b"]) as d:
        presets = {1: 5 * NANO}  # row 1 has a known capacity; row 0 adopts
        # -- pointwise sweep ------------------------------------------------
        bad = 0
        for name in (b"a", b"b", b"zz"):
            for slot in (-1, 0, 1, 2):
                for caps, la, lt, no_tr in _FORMS:
                    for add in _F_VALS:
                        for tak in _T_VALS:
                            for el in _E_VALS:
                                b1 = _ClassifyBatch(
                                    [name], [len(name)], [slot], [add], [tak],
                                    [el], [caps], [la], [lt], [no_tr],
                                )
                                err = _classify_compare(
                                    lib, d, b1, now=1234, presets=presets
                                )
                                if err is not None:
                                    emit(
                                        "PTA001",
                                        "native classify diverges from the "
                                        f"reference on name={name!r} slot="
                                        f"{slot} form={(caps, la, lt, no_tr)}"
                                        f" added={add!r} taken={tak!r} "
                                        f"elapsed={el}: {err}",
                                    )
                                    bad += 1
                            if bad >= 3:
                                return findings
        # Malformed length: must classify as invalid (-2), untouched side
        # arrays.
        b_bad = _ClassifyBatch(
            [b"a"], [-1], [0], [1.0], [0.0], [0], [-1], [-1], [-1], [1]
        )
        err = _classify_compare(lib, d, b_bad, now=1, presets=presets)
        if err is not None:
            emit("PTA001", f"malformed-length delta diverges: {err}")

        # -- batch-level conformance + laws --------------------------------
        mixed = _ClassifyBatch(
            names=[b"a", b"a", b"b", b"a", b"zz", b"b", b"a", b"a"],
            lens=[1, 1, 1, 1, 2, 1, 1, 1],
            slots=[0, 0, 1, 0, 0, 1, 1, 0],
            added=[3.0, 9.0, 2.5, 1.0, 4.0, 7.0, 2.0, float("nan")],
            taken=[1.0, 0.5, 2.0, 8.0, 1.0, 0.0, 3.0, 2.0],
            elapsed=[5, 2, 9, 1, 3, 4, 8, 6],
            caps=[2 * NANO, -1, -1, 2 * NANO, -1, 2 * NANO, -1, -1],
            lane_a=[NANO, -1, -1, -1, -1, 3 * NANO, -1, -1],
            lane_t=[0, -1, -1, -1, -1, NANO, -1, -1],
            no_trailer=[0, 1, 1, 0, 1, 0, 0, 1],
        )
        err = _classify_compare(lib, d, mixed, now=99, presets=presets)
        if err is not None:
            emit(
                "PTA001",
                f"native classify diverges from the reference on the mixed "
                f"batch (dedup/adoption path): {err}",
            )
        # Pin accounting: pins[r] == surviving entries on r.
        for arrs in (d.cap_base, d.pins, d.last_used):
            arrs[:] = 0
        d.cap_base[1] = 5 * NANO
        res = _native_classify(lib, d, mixed, 2, 99)
        for row in range(d.capacity):
            expect = int((res[0] == row).sum())
            if int(d.pins[row]) != expect:
                emit(
                    "PTA001",
                    f"pin accounting broken: row {row} pinned "
                    f"{int(d.pins[row])}× for {expect} surviving entries "
                    "(folded duplicates must release their pin)",
                )
                break
        base_agg = _classify_agg(res, mixed)

        def run_agg(b: _ClassifyBatch) -> Dict[tuple, tuple]:
            for arrs in (d.cap_base, d.pins, d.last_used):
                arrs[:] = 0
            d.cap_base[1] = 5 * NANO
            return _classify_agg(_native_classify(lib, d, b, 2, 99), b)

        # PTA002: batch order must not change the surviving aggregates
        # (within one batch at most one distinct positive cap per row — the
        # adoption rule is first-positive-wins, which IS order-free then).
        for order in ([7, 6, 5, 4, 3, 2, 1, 0], [3, 1, 4, 0, 6, 2, 7, 5]):
            if run_agg(mixed.subset(order)) != base_agg:
                emit(
                    "PTA002",
                    f"native classify is batch-order dependent: permutation "
                    f"{order} changed the surviving (row, slot, code) "
                    "aggregates",
                )
                break
        # PTA003: duplication is a no-op; extension never shrinks a key.
        if run_agg(mixed.concat(mixed)) != base_agg:
            emit(
                "PTA003",
                "native classify is not idempotent: duplicating the batch "
                "changed the surviving aggregates",
            )
        extra = _ClassifyBatch(
            [b"a", b"b"], [1, 1], [1, 0], [8.0, 2.0], [9.0, 1.0], [11, 12],
            [-1, -1], [-1, -1], [-1, -1], [0, 0],
        )
        big_agg = run_agg(mixed.concat(extra))
        for key, vals in base_agg.items():
            if any(b < a for a, b in zip(vals, big_agg.get(key, (-1, -1, -1)))):
                emit(
                    "PTA003",
                    f"native classify is not monotone: extending the batch "
                    f"shrank aggregate {key}",
                )
                break
    return findings


# ===========================================================================
# Pass 3 — PTA004: deterministic schedule exploration of the host-lane
# store across simulated callers.


@dataclasses.dataclass(frozen=True)
class HlsOp:
    """One scripted host-lane store operation. ``kind`` maps to a native
    symbol (``_OP_SYMBOL``) whose declared effects drive lock-protocol
    legality."""

    kind: str  # lock|unlock|host|unhost|drain|probe|events|stats
    row: int = 0
    name: bytes = b""
    freq: int = 0
    per_ns: int = 0
    count: int = 1


_OP_SYMBOL = {
    "lock": "pt_hls_lock",
    "unlock": "pt_hls_unlock",
    "host": "pt_hls_host_locked",
    "unhost": "pt_hls_unhost_locked",
    "drain": "pt_hls_drain_locked",
    "probe": "pt_hls_take_probe",
    "events": "pt_hls_events",
    "stats": "pt_hls_stats",
}


@dataclasses.dataclass
class HlsScenario:
    """A bounded multi-caller script set. Rows ``hosted`` are made
    resident in a setup prologue (lock/host/unlock) before exploration;
    ``post`` is an optional native-state invariant run after each
    schedule (e.g. token conservation), receiving (harness, results)."""

    name: str
    names: Tuple[bytes, ...]
    cap_base: Tuple[int, ...]
    scripts: Tuple[Tuple[HlsOp, ...], ...]
    promote_takes: int = 0
    window_ns: int = 10**15
    hosted: Tuple[int, ...] = (0,)
    post: Optional[Callable] = None


class _HlsModel:
    """Step-for-step Python model of HostStore + hls_take_locked — the
    replication-aware oracle every schedule is checked against."""

    def __init__(self, scenario: HlsScenario, nodes: int, node_slot: int):
        self.nodes = nodes
        self.node_slot = node_slot
        self.promote_takes = scenario.promote_takes
        self.window_ns = scenario.window_ns
        self.cap_base = list(scenario.cap_base) + [0] * 8
        self.created = [0] * (len(scenario.cap_base) + 8)
        self.last_used = [0] * (len(scenario.cap_base) + 8)
        self.rows = {raw: i for i, raw in enumerate(scenario.names)}
        self.blocks: Dict[int, dict] = {}
        self.dirty: List[int] = []
        self.promote: List[int] = []
        self.events = 0
        self.native_takes = 0

    def host(self, row: int) -> None:
        self.blocks[row] = {
            "added": [0] * self.nodes, "taken": [0] * self.nodes,
            "elapsed": 0, "win_start": 0, "win_takes": 0,
            "resident": 1, "dirty": 0,
        }

    def unhost(self, row: int) -> None:
        if row in self.blocks:
            self.blocks[row]["resident"] = 0

    def probe(self, op: HlsOp, now: int) -> Tuple[int, Optional[int]]:
        row = self.rows.get(op.name, -1)
        if row < 0:
            return -1, None
        self.last_used[row] = now  # pt_dir_resolve_rt stamps on hit
        blk = self.blocks.get(row)
        if blk is None or not blk["resident"]:
            return -1, None
        if now - blk["win_start"] > self.window_ns:
            blk["win_start"] = now
            blk["win_takes"] = 0
        blk["win_takes"] += 1
        if (
            self.promote_takes > 0
            and blk["win_takes"] == self.promote_takes + 1
        ):
            self.promote.append(row)
            self.events += 1
        cap = self.cap_base[row]
        cap_now = _sat_mul_nano(op.freq)
        tokens = cap + sum(blk["added"]) - sum(blk["taken"])
        last = self.created[row] + blk["elapsed"]
        if now < last:
            last = now
        delta = now - last
        interval = op.per_ns // op.freq if op.freq else 0
        grant = 0
        if op.freq != 0 and op.per_ns != 0 and interval != 0:
            gf = (float(delta) / float(interval)) * 1e9
            if gf < 0.0:
                gf = 0.0
            hi = 4611686018427387904.0
            if gf > hi:
                gf = hi
            grant = int(math.floor(gf))
        if grant > cap_now - tokens:
            grant = cap_now - tokens
        have = tokens + grant
        count_nt = _sat_mul_nano(op.count)
        k = 1 if (count_nt > 0 and have >= count_nt) else 0
        if k:
            forfeit = -grant if grant < 0 else 0
            blk["added"][self.node_slot] += grant if grant > 0 else 0
            blk["taken"][self.node_slot] += count_nt + forfeit
            blk["elapsed"] += delta
        rem = have - (count_nt if k else 0)
        if rem < 0:
            rem = 0
        self.native_takes += 1
        if not blk["dirty"]:
            blk["dirty"] = 1
            self.dirty.append(row)
        return k, rem // NANO

    def drain(self, cap_d: int, cap_p: int):
        nd = min(cap_d, len(self.dirty))
        popped = self.dirty[:nd]
        snaps = []
        for row in popped:
            blk = self.blocks[row]
            blk["dirty"] = 0
            snaps.append(blk["added"] + blk["taken"] + [blk["elapsed"]])
        self.dirty = self.dirty[nd:]
        np_ = min(cap_p, len(self.promote))
        promoted = self.promote[:np_]
        self.promote = self.promote[np_:]
        return popped, snaps, promoted

    def stats(self) -> Tuple[int, int, int, int]:
        res = sum(1 for b in self.blocks.values() if b["resident"])
        return (
            self.native_takes, res, len(self.blocks),
            len(self.dirty) + len(self.promote),
        )


class _HlsHarness:
    """One fresh native directory + host-lane store per schedule."""

    NODES = 2
    NODE_SLOT = 0

    def __init__(self, lib, scenario: HlsScenario):
        self.lib = lib
        self.dir = _DirHarness(lib, scenario.names)
        for i, cap in enumerate(scenario.cap_base):
            self.dir.cap_base[i] = cap
        self.h = lib.pt_hls_create(
            self.NODES, self.NODE_SLOT, scenario.promote_takes,
            scenario.window_ns, 0, self.dir.cap_base, self.dir.created,
            self.dir.last_used,
        )
        if self.h < 0:  # pragma: no cover
            self.dir.close()
            raise NativeUnavailable("pt_hls_create failed")
        self._dirty = np.zeros(8, np.int32)
        self._snap = np.zeros((8, 2 * self.NODES + 1), np.int64)
        self._promote = np.zeros(8, np.int32)
        self._np = ctypes.c_int(0)
        self.block_ptrs: Dict[int, int] = {}

    def lock(self) -> None:
        self.lib.pt_hls_lock(self.h)

    def unlock(self) -> None:
        self.lib.pt_hls_unlock(self.h)

    def host(self, row: int) -> None:
        ptr = self.lib.pt_hls_host_locked(self.h, row)
        self.block_ptrs[row] = ptr

    def unhost(self, row: int) -> None:
        self.lib.pt_hls_unhost_locked(self.h, row)

    def probe(self, op: HlsOp, now: int) -> Tuple[int, Optional[int]]:
        buf = np.zeros(256, np.uint8)
        buf[: len(op.name)] = np.frombuffer(op.name, np.uint8)
        rem = ctypes.c_int64(0)
        rc = self.lib.pt_hls_take_probe(
            self.h, self.dir.h, buf, len(op.name), op.freq, op.per_ns,
            op.count, now, ctypes.byref(rem),
        )
        return (rc, rem.value if rc >= 0 else None)

    def drain(self):
        nd = self.lib.pt_hls_drain_locked(
            self.h, self._dirty, self._snap, len(self._dirty),
            self._promote, len(self._promote), ctypes.byref(self._np),
        )
        nd = max(nd, 0)
        return (
            self._dirty[:nd].tolist(),
            [row.tolist() for row in self._snap[:nd]],
            self._promote[: self._np.value].tolist(),
        )

    def events(self) -> int:
        return int(self.lib.pt_hls_events(self.h))

    def stats(self) -> Tuple[int, int, int, int]:
        out = np.zeros(4, np.uint64)
        self.lib.pt_hls_stats(self.h, out)
        return tuple(int(v) for v in out)

    def block_view(self, row: int) -> np.ndarray:
        words = 2 * self.NODES + 6
        buf = (ctypes.c_int64 * words).from_address(self.block_ptrs[row])
        return np.ctypeslib.as_array(buf)

    def destroy(self) -> None:
        self.lib.pt_hls_destroy(self.h)
        self.dir.close()


def _enumerate_schedules(scenario: HlsScenario, effects, max_schedules: int):
    """All interleavings of the per-caller scripts that respect blocking
    (a takes_host_mu op is only schedulable while the mutex is free), plus
    the lock-protocol violations discovered along the way. → (schedules,
    violations) where a schedule is a tuple of (caller, op)."""
    scripts = scenario.scripts
    schedules: List[Tuple[Tuple[int, HlsOp], ...]] = []
    violations: Set[str] = set()

    def eff(op: HlsOp):
        return effects.get(_OP_SYMBOL[op.kind])

    def rec(pos: Tuple[int, ...], holder: Optional[int], prefix):
        if len(schedules) >= max_schedules:
            return
        if all(pos[c] >= len(scripts[c]) for c in range(len(scripts))):
            if holder is not None:
                # A leaked lock is the finding itself; executing the
                # schedule would then self-deadlock on the post-schedule
                # stats read (pt_hls_stats takes the same mutex).
                violations.add(
                    f"caller {holder} ends the schedule still holding "
                    "_host_mu (leaked lock)"
                )
            else:
                schedules.append(tuple(prefix))
            return
        progressed = False
        for c in range(len(scripts)):
            if pos[c] >= len(scripts[c]):
                continue
            op = scripts[c][pos[c]]
            e = eff(op)
            if e is None:  # pragma: no cover - unknown kind
                violations.add(f"op {op.kind} has no effects entry")
                continue
            if getattr(e, "requires_host_mu"):
                if holder != c:
                    violations.add(
                        f"caller {c} runs {op.kind} ({_OP_SYMBOL[op.kind]}, "
                        "declared requires_host_mu) without holding "
                        "_host_mu — lock-protocol violation"
                    )
                    continue
                new_holder = None if op.kind == "unlock" else holder
            elif getattr(e, "takes_host_mu"):
                if holder == c:
                    violations.add(
                        f"caller {c} runs {op.kind} ({_OP_SYMBOL[op.kind]}, "
                        "declared takes_host_mu) while already holding "
                        "_host_mu — self-deadlock"
                    )
                    continue
                if holder is not None:
                    continue  # blocked on the other caller: defer, not illegal
                new_holder = c if op.kind == "lock" else holder
            else:
                new_holder = holder
            progressed = True
            pos2 = tuple(
                p + 1 if i == c else p for i, p in enumerate(pos)
            )
            prefix.append((c, op))
            rec(pos2, new_holder, prefix)
            prefix.pop()
        if not progressed and not violations:
            violations.add(
                "deadlock: unfinished scripts but no schedulable caller"
            )

    rec(tuple(0 for _ in scripts), None, [])
    return schedules, violations


def _run_schedule(lib, scenario: HlsScenario, schedule) -> Optional[str]:
    """Execute one schedule against a fresh native store and the Python
    model in lockstep → mismatch description or None."""
    har = _HlsHarness(lib, scenario)
    model = _HlsModel(scenario, _HlsHarness.NODES, _HlsHarness.NODE_SLOT)
    try:
        # Setup prologue: make the declared rows resident on both sides.
        har.lock()
        for row in scenario.hosted:
            har.host(row)
            model.host(row)
        har.unlock()
        now = 0
        results = []
        for caller, op in schedule:
            now += 1000
            if op.kind == "probe":
                got = har.probe(op, now)
                want = model.probe(op, now)
                results.append(("probe", caller, got))
                if got != want:
                    return f"probe by caller {caller}: {got} != {want}"
            elif op.kind == "drain":
                got = har.drain()
                want = model.drain(8, 8)
                if (got[0], got[2]) != (want[0], want[2]) or got[1] != want[1]:
                    return f"drain by caller {caller}: {got} != {want}"
            elif op.kind == "events":
                g, w = har.events(), model.events
                if g != w:
                    return f"events: {g} != {w}"
            elif op.kind == "stats":
                g, w = har.stats(), model.stats()
                if g != w:
                    return f"stats: {g} != {w}"
            elif op.kind == "lock":
                har.lock()
            elif op.kind == "unlock":
                har.unlock()
            elif op.kind == "host":
                har.host(op.row)
                model.host(op.row)
            elif op.kind == "unhost":
                har.unhost(op.row)
                model.unhost(op.row)
        g, w = har.stats(), model.stats()
        if g != w:
            return f"post-schedule stats: {g} != {w}"
        if scenario.post is not None:
            return scenario.post(har, results)
        return None
    finally:
        har.destroy()


def explore_scenario(
    scenario: HlsScenario, lib=None, max_schedules: int = 4096
) -> List[Finding]:
    """Explore every legal interleaving of one scenario; PTA004 findings
    for protocol violations, model divergence, or invariant breaks."""
    lib = lib if lib is not None else _load_lib()
    from patrol_tpu_torch.native import NATIVE_EFFECTS

    site = _cpp_site("pt_hls_lock")
    findings: List[Finding] = []
    schedules, violations = _enumerate_schedules(
        scenario, NATIVE_EFFECTS, max_schedules
    )
    for v in sorted(violations):
        findings.append(
            Finding("PTA004", *site, f"[{scenario.name}] {v}")
        )
    seen_msgs: Set[str] = set()
    for schedule in schedules:
        err = _run_schedule(lib, scenario, schedule)
        if err is not None:
            trace = " ".join(f"{c}:{op.kind}" for c, op in schedule)
            msg = (
                f"[{scenario.name}] schedule [{trace}] diverges from the "
                f"model: {err}"
            )
            if msg not in seen_msgs:
                seen_msgs.add(msg)
                findings.append(Finding("PTA004", *site, msg))
            if len(seen_msgs) >= 3:
                break
    return findings


def _conservation_post(expect_admits: int):
    """Token conservation over the whole schedule, checked on the NATIVE
    block bytes: admitted takes == the capacity's worth, the taken lane
    booked exactly admits×NANO (+forfeits), refill grants stay sub-token."""

    def post(har: _HlsHarness, results) -> Optional[str]:
        admits = sum(1 for kind, _, got in results if kind == "probe" and got[0] == 1)
        probes = sum(1 for kind, _, _ in results if kind == "probe")
        if admits != min(expect_admits, probes):
            return (
                f"token conservation broken: {admits} admits for {probes} "
                f"probes against a {expect_admits}-token bucket"
            )
        blk = har.block_view(0)
        n = har.NODES
        taken_sum = int(blk[n : 2 * n].sum())
        added_sum = int(blk[:n].sum())
        if taken_sum != admits * NANO:
            return (
                f"taken lanes book {taken_sum} nt for {admits} admits "
                "(forfeit/refill accounting broken)"
            )
        if added_sum >= NANO:
            return f"refill grants accumulated a full token ({added_sum} nt)"
        return None

    return post


def builtin_scenarios() -> Tuple[HlsScenario, ...]:
    """The shipped scenario set: bounded enough to enumerate exhaustively
    (≤ ~1.3k schedules each), wide enough to interleave takes against the
    pump drain, the residency lifecycle, and take-pressure promotion."""
    probe = HlsOp("probe", name=b"k0", freq=3, per_ns=NANO, count=1)
    return (
        # Front takes racing the pump's drain cycle: 210 interleavings.
        HlsScenario(
            name="takes-vs-pump",
            names=(b"k0",),
            cap_base=(3 * NANO,),
            scripts=(
                (probe, probe),
                (probe, probe),
                (HlsOp("lock"), HlsOp("drain"), HlsOp("unlock")),
            ),
            post=_conservation_post(3),
        ),
        # Take-pressure promotion: the events counter, the promote queue,
        # and the stats must agree with the model at every read point.
        HlsScenario(
            name="promotion-pressure",
            names=(b"k0",),
            cap_base=(2 * NANO,),
            promote_takes=2,
            scripts=(
                (probe, probe, probe, probe),
                (
                    HlsOp("events"), HlsOp("lock"), HlsOp("drain"),
                    HlsOp("unlock"), HlsOp("events"), HlsOp("stats"),
                ),
            ),
        ),
        # Residency lifecycle: unhost/re-host racing takes; a probe of a
        # non-resident row must refuse (-1) on both sides, and re-hosting
        # zeroes the block identically.
        HlsScenario(
            name="residency-lifecycle",
            names=(b"k0",),
            cap_base=(2 * NANO,),
            scripts=(
                (HlsOp("lock"), HlsOp("unhost", row=0), HlsOp("unlock")),
                (probe, probe),
                (HlsOp("lock"), HlsOp("host", row=0), HlsOp("unlock"), probe),
            ),
        ),
    )


def check_hls_interleavings(ob: AbiObligation, lib) -> List[Finding]:
    findings: List[Finding] = []
    for scenario in builtin_scenarios():
        findings.extend(explore_scenario(scenario, lib))
    return findings


# ===========================================================================
# PTA004 — rx-ring lease/commit vs the pump (device-resident ingest).
#
# The zero-copy rx ring's ownership protocol spans two threads: the rx
# loop LEASES a plane before recvmmsg fills it, hands the shipped plane
# to the engine, and the completion pipeline COMMITS it back once the
# H2D transfer is ready. This explorer enumerates EVERY interleaving of
# a bounded rx script (leases, one past capacity — the -EAGAIN edge)
# against a completer script (commits, in hand-off FIFO order, only
# schedulable while the queue is non-empty), running each schedule
# against a fresh native ring AND a step-for-step Python model of the
# lowest-free-first lease policy. Divergence (wrong plane index, a lease
# succeeding on an in-flight plane, stats drift) and ownership-protocol
# violations (double commit, stray-index commit must refuse -EINVAL)
# are PTA004 findings.


class _RingModel:
    """Python twin of PtRxRing: lowest-free-first lease, commit frees."""

    def __init__(self, n_planes: int):
        self.free = list(range(n_planes))
        self.leased: set = set()
        self.used: set = set()
        self.leases = 0
        self.commits = 0
        self.reuse = 0
        self.exhausted = 0

    def lease(self) -> int:
        for i in sorted(self.free):
            self.free.remove(i)
            self.leased.add(i)
            self.leases += 1
            if i in self.used:
                self.reuse += 1
            self.used.add(i)
            return i
        self.exhausted += 1
        return -errno.EAGAIN

    def commit(self, i: int) -> int:
        if i not in self.leased:
            return -errno.EINVAL
        self.leased.discard(i)
        self.free.append(i)
        self.commits += 1
        return 0

    def stats(self):
        return (self.leases, self.commits, self.reuse, self.exhausted)


def _ring_schedules(n_leases: int, n_commits: int):
    """All interleavings of ``n_leases`` rx ops vs ``n_commits`` pump
    commits, a commit only schedulable while the hand-off queue holds a
    successfully leased plane (the blocking rule — exactly how the real
    completer parks until the feeder hands it work)."""
    out: List[Tuple[str, ...]] = []

    def rec(lx, cx, queue, prefix):
        if lx == n_leases and cx == n_commits:
            out.append(tuple(prefix))
            return
        if lx < n_leases:
            prefix.append("lease")
            rec(lx + 1, cx, queue + 1, prefix)  # queue grows iff success;
            prefix.pop()  # the runner tracks real success — this bound
            # only prunes schedules that could never run.
        if cx < n_commits and queue > 0:
            prefix.append("commit")
            rec(lx, cx + 1, queue - 1, prefix)
            prefix.pop()

    rec(0, 0, 0, [])
    return out


def check_rxring_interleavings(ob: AbiObligation, lib=None) -> List[Finding]:
    lib = lib if lib is not None else _load_lib()
    site = _cpp_site("pt_rx_ring_lease")
    findings: List[Finding] = []
    n_planes, n_leases, n_commits = 2, 3, 2

    def run_schedule(schedule) -> Optional[str]:
        h = lib.pt_rx_ring_create(n_planes, 4, 256)
        if h < 0:
            return f"pt_rx_ring_create failed ({h})"
        try:
            model = _RingModel(n_planes)
            queue: List[int] = []
            for step, op in enumerate(schedule):
                if op == "lease":
                    got = lib.pt_rx_ring_lease(h)
                    want = model.lease()
                    if got != want:
                        return f"step {step}: lease → {got}, model {want}"
                    if got >= 0:
                        queue.append(got)
                else:
                    if not queue:
                        continue  # pruned interleaving became empty: skip
                    plane = queue.pop(0)
                    got = lib.pt_rx_ring_commit(h, plane)
                    want = model.commit(plane)
                    if got != want:
                        return (
                            f"step {step}: commit({plane}) → {got}, "
                            f"model {want}"
                        )
            # Ownership refusals: a double commit and a stray index must
            # both refuse -EINVAL (the use-after-recycle guard).
            if queue:
                plane = queue.pop(0)
                if lib.pt_rx_ring_commit(h, plane) != model.commit(plane):
                    return "drain commit diverged"
                if lib.pt_rx_ring_commit(h, plane) != -errno.EINVAL:
                    return f"double commit of plane {plane} not refused"
            if lib.pt_rx_ring_commit(h, n_planes + 3) != -errno.EINVAL:
                return "stray-index commit not refused"
            out = np.zeros(4, np.uint64)
            if lib.pt_rx_ring_stats(h, out) != 0:
                return "pt_rx_ring_stats failed"
            got_stats = tuple(int(v) for v in out)
            # The refused commits above must not count.
            want_stats = model.stats()
            if got_stats != want_stats:
                return f"stats {got_stats} != model {want_stats}"
            # Drain the rest so destroy frees immediately (leak check).
            for plane in queue:
                lib.pt_rx_ring_commit(h, plane)
            return None
        finally:
            lib.pt_rx_ring_destroy(h)

    seen: Set[str] = set()
    for schedule in _ring_schedules(n_leases, n_commits):
        err = run_schedule(schedule)
        if err is not None:
            msg = (
                f"[rxring lease/commit vs pump] schedule "
                f"[{' '.join(schedule)}] diverges from the model: {err}"
            )
            if msg not in seen:
                seen.add(msg)
                findings.append(Finding("PTA004", *site, msg))
            if len(seen) >= 3:
                break
    return findings


# ===========================================================================
# Pass 4 — PTA005: effects-table completeness.

_ARGTYPES_RE = re.compile(r"lib\.(pt_\w+)\.argtypes")
# A C ABI function definition at the start of a line of the C++ sources
# (return type, name, parameter list), the shape every export has.
_CPP_DEF_RE = re.compile(
    r"^(?:extern \"C\" )?(?:[A-Za-z_][\w:]*\s+\**)+(pt_\w+)\(", re.MULTILINE
)


def cpp_exports() -> Dict[str, Tuple[str, int]]:
    """Every ``pt_*`` function the port's C++ sources define → (file,
    line) of its first definition: the library's C ABI."""
    out: Dict[str, Tuple[str, int]] = {}
    for rel in (_HOST_CPP, _HTTP_CPP):
        with open(os.path.join(_REPO_ROOT, rel), encoding="utf-8") as fh:
            src = fh.read()
        for m in _CPP_DEF_RE.finditer(src):
            out.setdefault(m.group(1), (rel, src[: m.start()].count("\n") + 1))
    return out


def check_effects_table(ob: AbiObligation, lib=None) -> List[Finding]:
    """Diff the ctypes registrations in native/__init__.py against
    NATIVE_EFFECTS, both ways: an unregistered effect is stale; a
    registered symbol without an effect is a boundary the lint passes
    cannot see through (the exact blindness this table exists to fix).
    Every ``pt_*`` function the C++ sources define must have an entry
    too, so a new export cannot land unregistered."""
    from patrol_tpu_torch.native import NATIVE_EFFECTS

    findings: List[Finding] = []
    path = os.path.join(_REPO_ROOT, _NATIVE_INIT)
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    registered: Dict[str, int] = {}
    for m in _ARGTYPES_RE.finditer(src):
        registered.setdefault(m.group(1), src[: m.start()].count("\n") + 1)
    for sym, line in sorted(registered.items()):
        if sym not in NATIVE_EFFECTS:
            findings.append(
                Finding(
                    "PTA005",
                    _NATIVE_INIT,
                    line,
                    f"ctypes symbol {sym} is registered but has no "
                    "NATIVE_EFFECTS entry: PTL002/PTL003 cannot see through "
                    "this boundary call — declare blocks/takes_host_mu/"
                    "requires_host_mu/callback_safe",
                )
            )
    for sym in sorted(NATIVE_EFFECTS):
        if sym not in registered:
            m = re.search(rf'"{sym}":', src)
            line = src[: m.start()].count("\n") + 1 if m else 1
            findings.append(
                Finding(
                    "PTA005",
                    _NATIVE_INIT,
                    line,
                    f"stale NATIVE_EFFECTS entry {sym}: no such ctypes "
                    "symbol is registered",
                )
            )
    for sym, (rel, line) in sorted(cpp_exports().items()):
        if sym not in NATIVE_EFFECTS:
            findings.append(
                Finding(
                    "PTA005",
                    rel,
                    line,
                    f"exported C ABI function {sym} has no NATIVE_EFFECTS "
                    "entry: declare its effects (and bind it) in "
                    "native/__init__.py",
                )
            )
    return findings


# ===========================================================================
# Drivers.

_CHECKS: Dict[str, Callable] = {
    "fold_conformance": check_fold_conformance,
    "rxring_interleavings": check_rxring_interleavings,
    "classify_conformance": check_classify_conformance,
    "hls_interleavings": check_hls_interleavings,
    "effects_table": check_effects_table,
}


def abi_all(
    only: Optional[Sequence[str]] = None, device="cuda"
) -> List[Finding]:
    """Run every registered ABI obligation → findings (unsuppressed). The
    fold's kernel twins run on ``device`` (``"cpu"``: the plain versions;
    ``"cuda"``: ``join.cu``). Raises :class:`NativeUnavailable` when
    libpatrolhost cannot load."""
    lib = _load_lib()
    from patrol_tpu_torch.ops.obligations import ABI_OBLIGATIONS

    checks = dict(
        _CHECKS,
        fold_conformance=functools.partial(check_fold_conformance, device=device),
    )
    out: List[Finding] = []
    for ob in ABI_OBLIGATIONS:
        if only and not any(k in ob.name for k in only):
            continue
        out.extend(checks[ob.check](ob, lib))
    return sorted(out, key=lambda f: (f.path, f.line, f.check))


def abi_repo(repo_root: str, device="cuda") -> List[Finding]:
    """abi_all with the shared inline-suppression filter applied (stale
    PTA suppressions come back as PTL006)."""
    return apply_suppressions(
        abi_all(device=device), repo_root, stale_family="PTA"
    )
