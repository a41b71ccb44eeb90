"""patrol-dispatch over the port (stage 10; counterpart of the JAX
package's ``analysis/dispatch.py``).

The reference proved its XLA dispatch boundary: no retrace, no broken
donation, no host transfer on the serve path. The port has no jit cache
and donates nothing (both absences are on record in
``ops/obligations.py::DISPATCH_ABSENT``), so what is left to prove is the
third: that the serving paths launch their kernels without a hidden wait
on the device. A host that waits on the card while it holds
``_state_mu`` is the fault class that keeps the device idle (``zero_rows``
used to read a device mask back, ROADMAP C8).

Static half:

* **PTD003 host wait on the serve graph** — the lint's PTL002 walk
  (:class:`~patrol_tpu_torch.analysis.lint._FuncIndex`), generalized from
  the launch wrappers to the serve graph's roots (:data:`SERVE_ROOTS`:
  the feeder, the completer, rx ingest, the take entry points, the family
  calls, the mesh's apply, the scrape and introspection paths). In every
  reached function of ``runtime/``, ``parallel/``, ``net/`` and ``ops/``
  (outside a kernel's plain version and a wrapper's CPU branch) it flags
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int()``,
  ``float()`` and ``bool()`` on a device value, a boolean-mask index of
  one, ``nonzero`` of one, a ``copy_`` between host and device without
  ``non_blocking=True``, and any ``synchronize()``. A device value is a
  name bound, in that function, from the state (``.state`` and what is
  read off it), a ``torch`` call on the device, a ``.to(...)`` or
  ``.cuda()``, a staging ship, an ``ops`` function's result, or anything
  computed from one; a parameter annotated ``torch.Tensor`` or
  ``LimiterState`` is one. A CPU-only branch (``if <x>.type == "cpu":``,
  ``if not self._cuda:``, the ``else`` of ``if self._cuda:``) is left
  out of both the taint and the scan. The
  engine's own readbacks are the registry's ``DECLARED_WAITS``: a wait
  outside the list is a finding, and so is a declared wait that is no
  longer there.
* **PTD005 completeness** — every ``_build.LAUNCHES`` key and every
  ``count_launch`` caller has a ``DISPATCH_SPECS`` record; every spec
  names a witness path that exists or carries a written reason, and a
  ``pow2`` bucket law matches a ``_pad_size`` site of the engine files;
  PTD001 and PTD002 carry their written absences.

Dynamic half (:func:`run_witness`):

* **PTD004 the witness** — each path of ``WITNESS_LAUNCHES`` (the
  reference's 16 plus ``row_rmw``, ``converge``, and over several pieces
  ``mesh_pieces``, the mesh's dispatch with its exchange, and a family
  call, ``read_rows`` and ``zero_rows`` on rows of every shard) runs on a small
  :class:`DeviceEngine` (or a :class:`MeshEngine`) once warm, then once
  more at the same shapes. The second run must make exactly the launches
  its registry entry declares, reach the declared wrappers as often, keep
  the state planes' dtype, shape and device, and build nothing (no
  ``_build.build()`` after the warm-up). On the card the second run is
  under ``torch.cuda.set_sync_debug_mode("error")`` (mode 0 restored in a
  ``finally``), so any stream sync on its path — in the caller's thread or
  the engine's — raises. The detector cannot see an event's wait, so the
  witness also counts every ``torch.cuda.Event.synchronize`` of the second
  run by the function that made it (:class:`_Waits`): each must be a
  declared wait, and each path must reach exactly the declared waits its
  ``WITNESS_WAITS`` entry names. On the CPU (no events) only the shape,
  dtype and reached-wrapper half runs, and the report says so.

Suppressions ride the lint's machinery (``# patrol-lint:
disable=PTD003``), swept for staleness as the ``PTD`` family. Driver:
``python -m patrol_tpu_torch.scripts.dispatch_repo [--device cpu|cuda]``.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
import sys
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set, Tuple

from patrol_tpu_torch.analysis.lint import (
    PACKAGE,
    SYNC_BOUNDARIES,
    HOST_SCALAR_METHODS,
    Finding,
    Module,
    _FuncIndex,
    _is_count_launch,
    _is_cpu_branch,
    _is_mask,
    _launch_nodes,
    repo_sources,
)

ALL_CODES = ("PTD003", "PTD004", "PTD005")
_REG = f"{PACKAGE}/ops/obligations.py"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_ENGINE = f"{PACKAGE}/runtime/engine.py"

# The serve graph's roots: the threads and synchronous entry points that
# production traffic rides (the reference's list, plus the take entry
# points and the lifecycle paths that zero rows).
SERVE_ROOTS: Tuple[Tuple[str, str], ...] = (
    (_ENGINE, "DeviceEngine._run_loop"),
    (_ENGINE, "DeviceEngine._complete_loop"),
    (_ENGINE, "DeviceEngine.submit_take"),
    (_ENGINE, "DeviceEngine.submit_takes_batch"),
    (_ENGINE, "DeviceEngine.ingest_raw_planes"),
    (_ENGINE, "DeviceEngine.ingest_interval"),
    (_ENGINE, "DeviceEngine.ingest_deltas_batch"),
    (_ENGINE, "DeviceEngine.gcra_take"),
    (_ENGINE, "DeviceEngine.conc_acquire"),
    (_ENGINE, "DeviceEngine.quota_take"),
    (_ENGINE, "DeviceEngine.release_bucket"),
    (_ENGINE, "DeviceEngine.gc_sweep"),
    (_ENGINE, "DeviceEngine.tokens_if_known"),
    (_ENGINE, "DeviceEngine.snapshot"),
    (_ENGINE, "DeviceEngine.snapshot_many"),
    (_ENGINE, "DeviceEngine.row_view"),
    (f"{PACKAGE}/runtime/mesh_engine.py", "MeshEngine._apply"),
)

# Files whose reached functions PTD003 scans.
_SCANNED = tuple(f"{PACKAGE}/{d}/" for d in ("runtime", "parallel", "net", "ops"))

# Methods that read a device value back to the host.
_READBACKS = {"item", "tolist", "cpu", "numpy"}
# Tensor attributes that answer from metadata, on the host.
_METADATA = {"shape", "dtype", "device", "ndim", "is_cuda", "layout"}
# Engine helpers that return device operands (staging ships).
_DEVICE_PRODUCERS = {"_ship", "_upload", "_ship_flat"}
# torch calls that stay on the host without a device argument.
_HOST_TORCH = {"from_numpy", "as_tensor", "tensor", "zeros", "ones", "empty", "full", "arange"}


def _qualnames(tree: ast.AST) -> Dict[int, str]:
    """id(node) → the qualified name of its innermost enclosing def
    (``Class.method.inner``), for every node inside a def."""
    out: Dict[int, str] = {}

    def visit(node: ast.AST, prefix: str, in_def: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                out[id(child)] = q
                visit(child, q + ".", q)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", in_def)
            else:
                if in_def:
                    out[id(child)] = in_def
                visit(child, prefix, in_def)

    visit(tree, "", "")
    return out


def _is_cuda_flag(test: ast.AST) -> bool:
    return isinstance(test, ast.Attribute) and test.attr == "_cuda"


def _cpu_only(fn: ast.AST) -> Set[int]:
    """ids of the nodes of ``fn`` that run only for a state on the CPU:
    the body of ``if <x>.type == "cpu":`` or ``if not self._cuda:``, the
    ``else`` of ``if self._cuda:``."""
    out: Set[int] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        t = node.test
        region = []
        if _is_cpu_branch(node) or (isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not)
                                    and _is_cuda_flag(t.operand)):
            region = node.body
        elif _is_cuda_flag(t):
            region = node.orelse
        for stmt in region:
            out.update(id(n) for n in ast.walk(stmt))
    return out


class _DeviceNames:
    """Device-value taint over one function: a fixpoint over its simple
    assignments (nested defs included, closures read outer names), those
    of CPU-only branches left out."""

    def __init__(self, fn: ast.AST, ops_names: Set[str], ops_mods: Set[str],
                 cpu_only: Set[int]):
        self.ops_names = ops_names  # names imported from ops modules
        self.ops_mods = ops_mods  # aliases of ops modules
        self.names: Set[str] = set()
        args = fn.args.args + fn.args.kwonlyargs if hasattr(fn, "args") else []
        for a in args:
            if a.annotation is not None and re.search(
                    r"\b(Tensor|LimiterState)\b", ast.unparse(a.annotation)):
                self.names.add(a.arg)
        assigns = []
        for node in ast.walk(fn):
            if id(node) in cpu_only:
                continue
            if isinstance(node, ast.Assign):
                assigns.append((node.targets, node.value))
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                assigns.append(([node.target], node.value))
        changed = True
        while changed:
            changed = False
            for targets, value in assigns:
                if not self.device(value):
                    continue
                for t in targets:
                    elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                    for n in elts:
                        n = n.value if isinstance(n, ast.Starred) else n
                        if isinstance(n, ast.Name) and n.id not in self.names:
                            self.names.add(n.id)
                            changed = True

    def device(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Attribute):
            if e.attr in _METADATA:
                return False
            return e.attr == "state" or self.device(e.value)
        if isinstance(e, ast.Call):
            f = e.func
            args = list(e.args) + [k.value for k in e.keywords]
            if isinstance(f, ast.Attribute):
                if f.attr in _READBACKS or f.attr in HOST_SCALAR_METHODS:
                    return False
                if f.attr in _DEVICE_PRODUCERS or f.attr == "cuda":
                    return True
                if f.attr == "to":
                    return self.device(f.value) or any(
                        "device" in ast.unparse(a) or "cuda" in ast.unparse(a) for a in args)
                if isinstance(f.value, ast.Name) and f.value.id == "torch":
                    if any(k.arg == "device" for k in e.keywords):
                        return True
                    return f.attr not in _HOST_TORCH and any(self.device(a) for a in args)
                if isinstance(f.value, ast.Name) and f.value.id in self.ops_mods:
                    return any(self.device(a) for a in args)
                return self.device(f.value)
            if isinstance(f, ast.Name) and f.id in self.ops_names:
                return any(self.device(a) for a in args)
            return False
        if isinstance(e, (ast.BinOp, ast.UnaryOp, ast.Subscript, ast.Compare, ast.BoolOp,
                          ast.IfExp, ast.Tuple, ast.List, ast.Starred)):
            return any(self.device(c) for c in ast.iter_child_nodes(e)
                       if isinstance(c, ast.expr))
        return False


def _wait_hit(node: ast.AST, dn: _DeviceNames) -> Optional[str]:
    """→ the spelling of a host wait at ``node``, or None."""
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr == "synchronize":
                recv = ast.unparse(f.value)
                return f"{recv}.synchronize()" if recv.startswith("torch") else ".synchronize()"
            if f.attr in _READBACKS and dn.device(f.value):
                return f".{f.attr}() on a device value"
            if f.attr == "nonzero" and (dn.device(f.value) or any(dn.device(a) for a in node.args)):
                return "nonzero of a device value"
            if f.attr == "copy_" and node.args:
                nb = any(k.arg == "non_blocking" and not (
                    isinstance(k.value, ast.Constant) and not k.value.value) for k in node.keywords)
                if not nb and dn.device(f.value) != dn.device(node.args[0]):
                    return "a blocking copy_ between host and device"
        elif (isinstance(f, ast.Name) and f.id in ("int", "float", "bool") and node.args
              and dn.device(node.args[0])):
            return f"{f.id}() of a device value"
    elif isinstance(node, ast.Subscript):
        idx = node.slice
        parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
        if any(_is_mask(p) for p in parts) and (dn.device(node.value) or any(dn.device(p) for p in parts)):
            return "a boolean-mask index of a device value"
    return None


@dataclasses.dataclass(frozen=True)
class WaitSite:
    path: str
    line: int
    qualname: str
    what: str


def _ops_imports(tree: ast.AST) -> Tuple[Set[str], Set[str]]:
    names: Set[str] = set()
    mods: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith(
                f"{PACKAGE}.ops"):
            for a in node.names:
                (mods if node.module == f"{PACKAGE}.ops" else names).add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(f"{PACKAGE}.ops."):
                    mods.add(a.asname or a.name.split(".")[-1])
    return names, mods


def wait_sites(mods: Sequence[Module], roots=SERVE_ROOTS) -> Tuple[List[WaitSite], Dict]:
    """Every host wait in the functions reached from ``roots`` → (sites,
    reach-from map)."""
    index = _FuncIndex(list(mods))
    mod_by_path = {m.relpath: m for m in mods}
    seen: Set[Tuple[str, str]] = set()
    reach_from: Dict[Tuple[str, str], Tuple[str, str]] = {}
    frontier = [r for r in roots if r in index.funcs]

    def boundary(key) -> bool:
        return key[1] in SYNC_BOUNDARIES.get(key[0], {})

    while frontier:
        key = frontier.pop()
        if key in seen or boundary(key):
            continue
        seen.add(key)
        for node in _launch_nodes(index.funcs[key]):
            if isinstance(node, ast.Call):
                tgt = index.resolve(key[0], node, caller=key)
                if tgt and tgt in index.funcs and tgt not in seen:
                    reach_from.setdefault(tgt, key)
                    frontier.append(tgt)
    sites: Dict[Tuple[str, int, str], WaitSite] = {}
    quals: Dict[str, Dict[int, str]] = {}
    imports: Dict[str, Tuple[Set[str], Set[str]]] = {}
    for rel, name in sorted(seen):
        if not rel.startswith(_SCANNED):
            continue
        m = mod_by_path[rel]
        if rel not in quals:
            quals[rel] = _qualnames(m.tree)
            imports[rel] = _ops_imports(m.tree)
        fn = index.funcs[(rel, name)]
        cpu_only = _cpu_only(fn)
        dn = _DeviceNames(fn, *imports[rel], cpu_only)
        for node in ast.walk(fn):
            if id(node) in cpu_only:
                continue
            what = _wait_hit(node, dn)
            if what is None:
                continue
            key = (rel, node.lineno, what)
            if key not in sites:
                sites[key] = WaitSite(rel, node.lineno, quals[rel].get(id(node), name), what)
    return sorted(sites.values(), key=lambda s: (s.path, s.line, s.what)), reach_from


def check_waits(
    mods: Sequence[Module],
    declared: Optional[Sequence[Tuple[str, str, str, str]]] = None,
    roots=SERVE_ROOTS,
) -> List[Finding]:
    """PTD003: every host wait on the serve graph is declared, and every
    declared wait is still there."""
    if declared is None:
        from patrol_tpu_torch.ops.obligations import DECLARED_WAITS

        declared = DECLARED_WAITS
    sites, _ = wait_sites(mods, roots)
    mod_by_path = {m.relpath: m for m in mods}
    # Each declared entry pardons one site.
    left: Dict[Tuple[str, str, str], int] = {}
    for p, q, w, _why in declared:
        left[(p, q, w)] = left.get((p, q, w), 0) + 1
    out: List[Finding] = []
    for s in sites:
        k = (s.path, s.qualname, s.what)
        if left.get(k, 0) > 0:
            left[k] -= 1
            continue
        if mod_by_path[s.path].suppressed("PTD003", s.line):
            continue
        out.append(Finding(
            "PTD003", s.path, s.line,
            f"host wait {s.what} inside {s.qualname}(), on the serve path, is not a "
            f"declared wait ({_REG}::DECLARED_WAITS) — a device sync per call that holds "
            "the caller (and any lock it holds) until the card drains"))
    for (p, q, w), n in sorted(left.items()):
        if n > 0:
            out.append(Finding(
                "PTD003", _REG, 1,
                f"declared wait {w} in {p}::{q} is no longer on the serve graph — drop it "
                "from DECLARED_WAITS (a stale declaration would pardon the next wait there)"))
    return out


# ---------------------------------------------------------------------------
# PTD005 — completeness.


def _pad_laws(mods: Sequence[Module]) -> Set[Tuple[str, str]]:
    laws: Set[Tuple[str, str]] = set()
    for m in mods:
        if not m.relpath.startswith(f"{PACKAGE}/runtime/"):
            continue
        for node in ast.walk(m.tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "_pad_size" and node.args):
                lo, hi = "8", "MAX_MERGE_ROWS"
                pos = [ast.unparse(a) for a in node.args[1:3]]
                lo = pos[0] if pos else lo
                hi = pos[1] if len(pos) > 1 else hi
                for kw in node.keywords:
                    if kw.arg == "lo":
                        lo = ast.unparse(kw.value)
                    elif kw.arg == "hi":
                        hi = ast.unparse(kw.value)
                laws.add((lo, hi))
    return laws


def check_completeness(
    mods: Sequence[Module],
    specs=None,
    witness_launches=None,
    absent=None,
    launch_keys: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """PTD005 over the registry and the sources."""
    from patrol_tpu_torch.ops import obligations as ob

    specs = ob.DISPATCH_SPECS if specs is None else specs
    witness_launches = ob.WITNESS_LAUNCHES if witness_launches is None else witness_launches
    absent = ob.DISPATCH_ABSENT if absent is None else absent
    if launch_keys is None:
        from patrol_tpu_torch.ops._build import LAUNCHES

        launch_keys = tuple(LAUNCHES)
    out: List[Finding] = []

    def bad(msg: str, path: str = _REG, line: int = 1) -> None:
        out.append(Finding("PTD005", path, line, msg))

    names = {s.name for s in specs}
    for key in launch_keys:
        if key not in names:
            bad(f"kernel launch key {key!r} has no DISPATCH_SPECS record — declare its "
                "serving function, launcher, bucket law and witness path")
    launchers = {(s.launcher_module or s.module, s.launcher) for s in specs if s.launcher}
    for m in mods:
        if not m.relpath.startswith(f"{PACKAGE}/"):
            continue
        dotted = m.relpath[:-3].replace("/", ".")
        for node in ast.walk(m.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if any(isinstance(c, ast.Call) and _is_count_launch(c) for c in ast.walk(node)):
                if (dotted, node.name) not in launchers:
                    bad(f"{dotted}.{node.name}() counts kernel launches but no DISPATCH_SPECS "
                        "record names it as its launcher", m.relpath, node.lineno)
    laws = _pad_laws(mods)
    for s in specs:
        if s.witness and s.witness_absent:
            bad(f"DISPATCH_SPECS[{s.name}] declares both a witness path and a justified "
                "absence — stale justification")
        elif not s.witness and not s.witness_absent:
            bad(f"DISPATCH_SPECS[{s.name}] has neither a witness path nor a written "
                "justified absence")
        if s.witness and s.witness not in witness_launches:
            bad(f"DISPATCH_SPECS[{s.name}] names witness path {s.witness!r}, which "
                "WITNESS_LAUNCHES does not declare")
        elif s.witness and s.name in launch_keys and witness_launches[s.witness].get(s.name, 0) < 1:
            bad(f"DISPATCH_SPECS[{s.name}]'s witness path {s.witness!r} declares no launch of it")
        if s.buckets == "pow2" and (s.bucket_lo, s.bucket_hi) not in laws:
            bad(f"DISPATCH_SPECS[{s.name}] declares the bucket law _pad_size(lo={s.bucket_lo}, "
                f"hi={s.bucket_hi}), which no _pad_size site of the engine files has — the "
                "padding was dropped or the clamp drifted from the registry")
    for path, launches in witness_launches.items():
        for key in launches:
            if key not in launch_keys:
                bad(f"WITNESS_LAUNCHES[{path!r}] names {key!r}, which is no launch key")
        if path not in WITNESS_PATHS:
            bad(f"WITNESS_LAUNCHES[{path!r}] has no drive in analysis/dispatch.py")
    declared = {q for _p, q, _w, _why in ob.DECLARED_WAITS}
    for path in WITNESS_PATHS:
        if path not in ob.WITNESS_WAITS:
            bad(f"witness path {path!r} has no WITNESS_WAITS entry")
        for q in ob.WITNESS_WAITS.get(path, ()):
            if q not in declared:
                bad(f"WITNESS_WAITS[{path!r}] names {q!r}, which DECLARED_WAITS does not list")
    for code in ("PTD001", "PTD002"):
        if not absent.get(code, "").strip():
            bad(f"{code} has no CUDA counterpart and no written absence in DISPATCH_ABSENT")
    return out


# ---------------------------------------------------------------------------
# The static aggregate.


def check_sources(
    sources: Dict[str, str],
    used_out: Optional[Set[Tuple[str, int, str]]] = None,
    **registry,
) -> List[Finding]:
    """The static half (PTD003, PTD005) over a source map; ``registry``
    overrides ``declared``, ``specs``, ``witness_launches``, ``absent``,
    ``launch_keys`` for fixtures. ``used_out`` collects the inline
    suppressions honored, for the stale sweep."""
    mods = [Module(rel, src) for rel, src in sorted(sources.items())]
    findings = check_waits(mods, registry.get("declared")) + check_completeness(
        mods,
        registry.get("specs"),
        registry.get("witness_launches"),
        registry.get("absent"),
        registry.get("launch_keys"),
    )
    if used_out is not None:
        for m in mods:
            used_out.update((m.relpath, ln, tok) for ln, tok in m.used)
    findings.sort(key=lambda f: (f.path, f.line, f.check))
    return findings


def check_repo(repo_root: str, used_out=None) -> List[Finding]:
    return check_sources(repo_sources(repo_root), used_out=used_out)


# ---------------------------------------------------------------------------
# The witness (PTD004).

WITNESS_PATHS: Tuple[str, ...] = (
    "take", "take_n", "merge_packed", "merge_folded", "commit_blocks", "merge_rows_dense",
    "merge_scalar", "zero_rows", "lifecycle_probe", "gcra", "conc", "quota", "delta_fold",
    "raw_ingest", "read_rows", "mesh_step", "row_rmw", "converge", "mesh_pieces",
    "mesh_pieces_quota", "mesh_pieces_read_rows", "mesh_pieces_zero_rows",
)


@dataclasses.dataclass
class WitnessReport:
    findings: List[Finding]
    device: str
    half: str  # what ran: the CPU half or the card's whole witness
    paths: Tuple[str, ...]
    launches: Dict[str, Dict[str, int]]  # path → second run's launches (card)
    reached: Dict[str, Dict[str, int]]  # path → second run's wrapper calls
    seconds: Dict[str, float]  # path → second run's seconds
    builds_after_warmup: int
    waits: Dict[str, Dict[str, int]]  # path → second run's event waits by site (card)


class _Reach:
    """Counts calls of the registry's serving functions in every thread
    (a profile hook on their code objects)."""

    def __init__(self, specs):
        import importlib

        self.codes: Dict[object, str] = {}
        for s in specs:
            fn = getattr(importlib.import_module(s.module), s.attr)
            self.codes[fn.__code__] = s.name
        self.counts: Dict[str, int] = {}

    def _hook(self, frame, event, arg):
        if event == "call":
            name = self.codes.get(frame.f_code)
            if name is not None:
                self.counts[name] = self.counts.get(name, 0) + 1

    def __enter__(self):
        self.counts = {}
        threading.setprofile_all_threads(self._hook)
        return self

    def __exit__(self, *exc):
        threading.setprofile_all_threads(None)


class _Waits:
    """Counts ``torch.cuda.Event.synchronize`` calls in every thread by the
    function that made them (``file::qualname``, ``<locals>`` dropped, as
    ``DECLARED_WAITS`` spells it). A no-op when not ``enabled``: on the CPU
    the engine records no events."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.counts: Dict[str, int] = {}
        self._mu = threading.Lock()
        self._real = None

    def __enter__(self):
        if self.enabled:
            import torch

            real = self._real = torch.cuda.Event.synchronize
            counts, mu = self.counts, self._mu

            def synchronize(ev):
                code = sys._getframe(1).f_code
                site = (os.path.relpath(code.co_filename, _ROOT).replace(os.sep, "/") + "::"
                        + code.co_qualname.replace("<locals>.", ""))
                with mu:
                    counts[site] = counts.get(site, 0) + 1
                return real(ev)

            torch.cuda.Event.synchronize = synchronize
        return self

    def __exit__(self, *exc):
        if self._real is not None:
            import torch

            torch.cuda.Event.synchronize = self._real
            self._real = None


def wait_findings(path: str, counts: Mapping[str, int], declared=None, want=None,
                  timed: bool = True) -> List[Finding]:
    """PTD004 over one path's counted event waits (``file::qualname`` →
    count): a wait at a site ``declared`` (default ``DECLARED_WAITS``) does
    not list, and a set of declared waits reached that differs from the
    path's ``want`` (default its ``WITNESS_WAITS`` entry; the commit
    timing's wait dropped when not ``timed``)."""
    from patrol_tpu_torch.ops import obligations as ob

    declared = ob.DECLARED_WAITS if declared is None else declared
    sites = {f"{p}::{q}" for p, q, _w, _why in declared}
    want_q = set(ob.WITNESS_WAITS.get(path, ()) if want is None else want)
    if not timed:
        want_q.discard(ob._TIMED)
    anchor = f"{PACKAGE}/analysis/dispatch.py"
    out: List[Finding] = []
    for site, n in sorted(counts.items()):
        if n and site not in sites:
            out.append(Finding("PTD004", anchor, 1, (
                f"witness path '{path}' waited on a CUDA event {n} time(s) at {site}, which "
                "DECLARED_WAITS does not list")))
    got_q = {site.split("::", 1)[1] for site, n in counts.items() if n and site in sites}
    if got_q != want_q:
        out.append(Finding("PTD004", anchor, 1, (
            f"witness path '{path}' waited at the declared waits {sorted(got_q)}, its "
            f"WITNESS_WAITS entry declares {sorted(want_q)}")))
    return out


def _witness_drives(eng, mesh1, mesh2, mesh3, cfg, device) -> Dict[str, Callable[[], None]]:
    """path name → zero-argument drive: deterministic inputs and fixed
    shapes, every device operand made before the drive so that a drive
    only ships through the engine's staging or launches."""
    import numpy as np
    import torch

    from patrol_tpu_torch.models.limiter import NANO, init_state
    from patrol_tpu_torch.ops import commit as commit_mod
    from patrol_tpu_torch.ops import ingest as ingest_ops
    from patrol_tpu_torch.ops import wire
    from patrol_tpu_torch.ops.merge import (
        FOLD_PAD_ROW, FoldedMergeBatch, RowDenseBatch, merge_batch_folded, merge_rows_dense)
    from patrol_tpu_torch.ops.rate import Rate
    from patrol_tpu_torch.ops.row_rmw_kernel import row_rmw
    from patrol_tpu_torch.ops.take import TAKE_PACK_ROWS, take_n_batch
    from patrol_tpu_torch.runtime import engine as engine_mod

    rate = Rate(freq=100, per_ns=3600 * NANO)
    names = [f"wit{i}" for i in range(8)]

    def d(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)

    def ok(ticket) -> None:
        if not ticket.wait(timeout=60):
            raise TimeoutError(f"take of {ticket.name!r} not answered in 60 s")

    def lanes(e):
        e.ingest_deltas_batch(
            names, [1] * 8, [-1] * 8, [-1] * 8, [NANO] * 8, caps_nt=[-1] * 8,
            lane_added_nt=[100 + i for i in range(8)],
            lane_taken_nt=[10 + i for i in range(8)])
        if not e.flush(timeout=60):
            raise TimeoutError("flush timed out")

    # Bind the names device-resident (rows a replica's delta made are
    # not host lanes), so the takes below ride the feeder's device path.
    for e in (eng, mesh2, mesh3):
        lanes(e)

    def take():
        for i, nm in enumerate(names):
            ok(eng.submit_take(nm, rate, 1, now_ns=NANO + i)[0])

    def merge_scalar():
        eng.ingest_deltas_batch(names, [1] * 8, [50 + i for i in range(8)],
                                [5 + i for i in range(8)], [NANO] * 8, caps_nt=[1000] * 8)
        if not eng.flush(timeout=60):
            raise TimeoutError("flush timed out")

    def delta_fold():
        eng.ingest_interval(names, [1] * 8, [1000] * 8, [200 + i for i in range(8)],
                            [20 + i for i in range(8)], [NANO] * 8)
        if not eng.flush(timeout=60):
            raise TimeoutError("flush timed out")

    row = ingest_ops.RAW_PLANE_BYTES
    ents = [wire.DeltaEntry(nm, 1, 1000, 300 + i, 30 + i, NANO) for i, nm in enumerate(names)]
    data, n = wire.encode_delta_packet(1, 7, [], ents, max_size=row)
    planes = np.zeros((2, row), np.uint8)
    planes[0, : len(data)] = np.frombuffer(data, np.uint8)
    plane_lengths = np.array([len(data), 0], np.int32)

    def raw_ingest():
        eng.ingest_raw_planes(planes.copy(), plane_lengths.copy())
        if not eng.flush(timeout=60):
            raise TimeoutError("flush timed out")

    def zero_rows():
        ok(eng.submit_take("victim", rate, 1, now_ns=NANO)[0])
        if not eng.release_bucket("victim", timeout=60):
            raise RuntimeError("release_bucket('victim') failed")

    probe_rows = np.arange(8, dtype=np.int64)

    def lifecycle_probe():
        eng._probe_device_rows(probe_rows, NANO, np.zeros(8, np.int64),
                               np.zeros(8, np.int64), np.zeros(8, np.int64))

    def gcra():
        eng.gcra_take(np.arange(4, dtype=np.int32), np.full(4, NANO, np.int64),
                      np.full(4, 1000, np.int64), np.full(4, 4000, np.int64),
                      np.full(4, 1, np.int64))

    def conc():
        eng.conc_acquire(np.arange(4, dtype=np.int32), np.full(4, 10, np.int64),
                         np.full(4, 1, np.int64), np.full(4, 1, np.int64), np.zeros(4, np.int64))

    def quota():
        eng.quota_take(np.zeros(4, np.int32), np.full(4, 1, np.int32),
                       np.arange(2, 6, dtype=np.int32), np.full(4, 1 << 20, np.int64),
                       np.full(4, 1 << 16, np.int64), np.full(4, 1 << 10, np.int64),
                       np.full(4, 1, np.int64), np.full(4, 1, np.int64))

    def read_rows():
        eng.read_rows(np.arange(4, dtype=np.int64))

    # The direct paths: the ops the feeder's fold, the commit ring and the
    # probe's entry point dispatch, at the engine's base shapes, on a
    # scratch state of the engine's geometry.
    scratch = init_state(cfg, device=device)
    pad = FOLD_PAD_ROW
    folded = FoldedMergeBatch(
        d(np.r_[np.arange(4), np.full(4, pad)]), d(np.r_[np.zeros(4), np.arange(4)]).long(),
        d(np.arange(8) + 5), d(np.arange(8) + 1), d(np.r_[np.arange(4), pad + np.arange(4)]),
        d(np.full(8, NANO)))
    dense = RowDenseBatch(d(np.arange(8, dtype=np.int64) + 16),
                          d(np.arange(8 * cfg.nodes * 2, dtype=np.int64).reshape(8, cfg.nodes, 2)),
                          d(np.full(8, NANO)))
    mr = engine_mod.MAX_MERGE_ROWS
    ring = commit_mod.pack_commit_blocks(
        np.arange(24, dtype=np.int64), np.zeros(24, np.int64), np.arange(24, dtype=np.int64),
        np.ones(24, np.int64), np.arange(24, dtype=np.int64), np.full(24, NANO),
        mr, out=np.empty((6, 2, mr), np.int64))
    ring_d = d(ring)
    packed = np.zeros((TAKE_PACK_ROWS, 8), np.int64)
    packed[0] = np.arange(8) + 32
    packed[1], packed[2], packed[3], packed[4] = NANO, 100, 3600 * NANO, NANO
    packed[5], packed[6] = 3, 100 * NANO
    packed_d = d(packed)
    rmw_state = torch.zeros((cfg.buckets, 8, 128), dtype=torch.int32, device=device)
    rmw_ops = [d(x.astype(np.int32)) for x in (np.arange(8), np.arange(8) * 2,
                                               np.arange(8) - 3, np.arange(8) % 2)]

    def take_n():
        take_n_batch(scratch, packed_d, 0)

    def merge_folded():
        merge_batch_folded(scratch, folded)

    def merge_rows_dense_():
        merge_rows_dense(scratch, dense)

    def commit_blocks():
        commit_mod.commit_packed(scratch, ring_d, 24, 24)

    def row_rmw_():
        row_rmw(rmw_state, *rmw_ops, "pairmax")

    def mesh_step():
        lanes(mesh1)

    def converge():
        for i, nm in enumerate(names[:1]):
            t = mesh2.submit_take(nm, rate, 1, now_ns=NANO + i)[0]
            ok(t)

    def mesh_pieces():
        ok(mesh3.submit_take(names[0], rate, 1, now_ns=NANO)[0])

    # A row in each shard of mesh3, past the names' rows: each call
    # gathers from four home pieces and writes back to all eight.
    rps = mesh3.plan.rows_per_shard
    spread = np.arange(mesh3.plan.shards, dtype=np.int64) * rps + rps - 3

    def mesh_pieces_quota():
        mesh3.quota_take(np.full(4, spread[0], np.int32), spread[1:3].repeat(2).astype(np.int32),
                         (spread[[3, 3, 2, 1]] - [0, 1, 1, 1]).astype(np.int32),
                         np.full(4, 1 << 20, np.int64),
                         np.full(4, 1 << 16, np.int64), np.full(4, 1 << 10, np.int64),
                         np.full(4, 1, np.int64), np.full(4, 1, np.int64))

    def mesh_pieces_read_rows():
        mesh3.read_rows(spread)

    def mesh_pieces_zero_rows():
        # The hook release, eviction and GC's reclaim call, under the lock
        # they hold.
        with mesh3._state_mu:
            mesh3._zero_rows(spread)

    return {
        "take": take, "take_n": take_n, "merge_packed": lambda: lanes(eng),
        "merge_folded": merge_folded, "commit_blocks": commit_blocks,
        "merge_rows_dense": merge_rows_dense_, "merge_scalar": merge_scalar,
        "zero_rows": zero_rows, "lifecycle_probe": lifecycle_probe, "gcra": gcra,
        "conc": conc, "quota": quota, "delta_fold": delta_fold, "raw_ingest": raw_ingest,
        "read_rows": read_rows, "mesh_step": mesh_step, "row_rmw": row_rmw_,
        "converge": converge, "mesh_pieces": mesh_pieces,
        "mesh_pieces_quota": mesh_pieces_quota, "mesh_pieces_read_rows": mesh_pieces_read_rows,
        "mesh_pieces_zero_rows": mesh_pieces_zero_rows,
    }


def _planes_meta(eng) -> list:
    """Dtype, shape and device of an engine's planes: its state, or each
    piece's over a mesh of several pieces."""
    placed = getattr(eng, "_placed", None)
    states = placed.states if placed is not None else [eng.state]
    return [(st.pn.dtype, tuple(st.pn.shape), st.pn.device, st.elapsed.dtype,
             tuple(st.elapsed.shape)) for st in states]


def run_witness(device="cuda", only: Optional[Sequence[str]] = None,
                mutate: Optional[str] = None) -> WitnessReport:
    """PTD004: warm every witness path once, then re-drive each at the
    same shapes under the launch counts, the reach counts and (on the
    card) torch's sync detector. ``mutate="extra_launch"`` seeds a drive
    that launches its kernel once more than its registry entry declares
    (the dynamic mutation the stage must reject)."""
    import torch

    from patrol_tpu_torch.models.limiter import NANO, LimiterConfig, resolve_device
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.ops.obligations import DISPATCH_SPECS, WITNESS_LAUNCHES
    from patrol_tpu_torch.runtime.engine import DEVICE_TIMING, DeviceEngine
    from patrol_tpu_torch.runtime.mesh_engine import MeshEngine

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    paths = tuple(p for p in WITNESS_PATHS if only is None or p in only)
    cfg = LimiterConfig(buckets=256, nodes=2)
    findings: List[Finding] = []
    anchor = f"{PACKAGE}/analysis/dispatch.py"

    def bad(msg: str) -> None:
        findings.append(Finding("PTD004", anchor, 1, msg))

    # The feeder's fold keyed on the card's default, so the CPU half takes
    # the card's route (tick_join) and both halves count the same calls.
    saved_fold = os.environ.get("PATROL_TICK_FOLD")
    os.environ["PATROL_TICK_FOLD"] = "1"
    engines = []
    errors: List[str] = []
    prev_hook = threading.excepthook

    def hook(args):
        errors.append(f"{args.thread.name if args.thread else '?'}: "
                      f"{args.exc_type.__name__}: {str(args.exc_value)[:200]}")
        prev_hook(args)

    threading.excepthook = hook
    launches: Dict[str, Dict[str, int]] = {}
    reached: Dict[str, Dict[str, int]] = {}
    waited: Dict[str, Dict[str, int]] = {}
    seconds: Dict[str, float] = {}
    builds = 0
    try:
        eng = DeviceEngine(cfg, node_slot=0, clock=lambda: NANO, device=dev)
        engines.append(eng)
        mesh1 = MeshEngine(cfg, replicas=1, node_slot=0, clock=lambda: NANO, devices=[dev])
        engines.append(mesh1)
        mesh2 = MeshEngine(cfg, replicas=2, node_slot=0, clock=lambda: NANO, devices=[dev] * 8)
        engines.append(mesh2)
        # The multi-piece dispatch: the same 2 x 4 mesh, a piece a block.
        mesh3 = MeshEngine(cfg, replicas=2, node_slot=0, clock=lambda: NANO, devices=[dev] * 8,
                           piece_per_block=True)
        engines.append(mesh3)
        for e in engines:
            e.configure_lifecycle(window_ms=0)
            e.warmup()
        drives = _witness_drives(eng, mesh1, mesh2, mesh3, cfg, dev)
        if mutate == "extra_launch":
            inner = drives["take_n"]

            def twice():
                inner()
                inner()

            drives["take_n"] = twice
        for path in paths:
            drives[path]()  # the warm leg
        if cuda:
            torch.cuda.synchronize(dev)
        reach = _Reach(DISPATCH_SPECS)
        real_build = _build.build
        count = [0]

        def counted_build():
            count[0] += 1
            return real_build()

        _build.build = counted_build
        try:
            for path in paths:
                before = dict(_build.LAUNCHES)
                states = [_planes_meta(e) for e in engines]
                n_err = len(errors)
                t0 = time.perf_counter()
                raised = None
                waits = _Waits(cuda)
                with reach, waits:
                    if cuda:
                        torch.cuda.set_sync_debug_mode("error")
                    try:
                        drives[path]()
                        # Every completion lands inside the counts.
                        for e in engines:
                            if not e.flush(timeout=60):
                                raise TimeoutError("an engine did not go idle in 60 s")
                    except Exception as exc:  # the sync detector raises here
                        raised = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
                    finally:
                        if cuda:
                            torch.cuda.set_sync_debug_mode(0)
                if cuda:
                    torch.cuda.synchronize(dev)
                seconds[path] = time.perf_counter() - t0
                moved = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
                launches[path] = moved
                reached[path] = {k: v for k, v in reach.counts.items() if v}
                waited[path] = dict(waits.counts)
                if cuda:
                    findings.extend(wait_findings(path, waited[path], timed=DEVICE_TIMING))
                want = {k: v for k, v in WITNESS_LAUNCHES[path].items() if v}
                if raised is not None:
                    bad(f"witness path '{path}' raised in its warm run — {raised}")
                for err in errors[n_err:]:
                    bad(f"witness path '{path}': an engine thread raised — {err}")
                got_reach = {k: v for k, v in reached[path].items() if k in _build.LAUNCHES}
                if got_reach != want:
                    bad(f"witness path '{path}' reached the kernel wrappers {got_reach}, its "
                        f"registry entry declares {want}")
                if cuda and moved != want:
                    bad(f"witness path '{path}' launched {moved} in its warm run, its "
                        f"registry entry declares {want}")
                for s in DISPATCH_SPECS:
                    if s.witness == path and s.name not in _build.LAUNCHES and not reached[path].get(s.name):
                        bad(f"witness path '{path}' never reached {s.module}.{s.attr}, whose "
                            "spec names it")
                after = [_planes_meta(e) for e in engines]
                if after != states:
                    bad(f"witness path '{path}' changed a state plane's dtype, shape or device: "
                        f"{states} -> {after}")
        finally:
            _build.build = real_build
        builds = count[0]
        if builds:
            bad(f"the kernel library was built {builds} time(s) after the warm-up")
    finally:
        threading.excepthook = prev_hook
        if saved_fold is None:
            os.environ.pop("PATROL_TICK_FOLD", None)
        else:
            os.environ["PATROL_TICK_FOLD"] = saved_fold
        for e in reversed(engines):
            e.stop()
    half = ("the card: launches, event waits, reached wrappers, shapes and dtypes, under "
            "set_sync_debug_mode('error')" if cuda else
            "the CPU half: shapes, dtypes and reached wrappers (no launches, no sync detector)")
    return WitnessReport(findings, str(dev), half, paths, launches, reached, seconds, builds,
                         waited)


# ---------------------------------------------------------------------------
# Seeded mutations: each fixture is the repo's sources with exactly one
# dispatch-discipline defect, which the stack must reject with its code.

_C8_OLD_ZERO_ROWS = '''def zero_rows(state: LimiterState, rows: torch.Tensor) -> LimiterState:
    """Clear bucket rows (slot recycling / eviction). Duplicates are fine;
    rows out of range after the wrap are dropped."""
    b = state.pn.shape[0]
    rows = wrap_index(rows, b)
    rows = rows[(rows >= 0) & (rows < b)]
    state.pn[rows] = 0
    state.elapsed[rows] = 0
    return state
'''


def _with_old_zero_rows(sources: Dict[str, str]) -> Dict[str, str]:
    """The sources with ``ops/merge.py`` as it was before C8's repair:
    ``zero_rows`` read a boolean mask of a device tensor, and the module
    imported no numpy."""
    rel = f"{PACKAGE}/ops/merge.py"
    src = sources[rel].replace("import numpy as np\n", "", 1)
    tree = ast.parse(src)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "zero_rows")
    lines = src.splitlines(keepends=True)
    new = "".join(lines[: fn.lineno - 1]) + _C8_OLD_ZERO_ROWS + "".join(lines[fn.end_lineno:])
    return {**sources, rel: new}


def _undeclared_wait(sources: Dict[str, str]) -> Dict[str, str]:
    """A ``torch.cuda.synchronize()`` in the engine's read_rows, after the
    gather, that no registry entry declares."""
    rel = _ENGINE
    src = sources[rel]
    anchor = "            got = merge_mod.read_rows(state, idx)\n"
    if anchor not in src:
        raise ValueError("engine.read_rows lost its gather line")
    return {**sources, rel: src.replace(anchor, anchor + "            torch.cuda.synchronize()\n")}


def _unspecced_launch(sources: Dict[str, str]) -> Dict[str, str]:
    """A new wrapper that counts launches under a key no spec names."""
    rel = f"{PACKAGE}/ops/shadow_kernel.py"
    return {**sources, rel: (
        "from patrol_tpu_torch.ops._build import count_launch\n\n\n"
        "def shadow(pn):\n    count_launch('shadow')\n    return pn\n")}


# name → (code, what the defect is, the fixture's source transform)
DISPATCH_MUTATIONS: Dict[str, Tuple[str, str, Optional[Callable]]] = {
    "zero-rows-mask-read": ("PTD003", "zero_rows as it was before C8's repair: a "
                            "boolean-mask read of a device tensor under _state_mu",
                            _with_old_zero_rows),
    "undeclared-wait": ("PTD003", "a torch.cuda.synchronize() on the read path that "
                        "DECLARED_WAITS does not list", _undeclared_wait),
    "unspecced-launch": ("PTD005", "a wrapper counting launches that no DISPATCH_SPECS "
                         "record names", _unspecced_launch),
    "extra-launch": ("PTD004", "the take_n witness path launching its kernel twice", None),
}


def mutation_findings(name: str, repo_root: str, device="cuda") -> List[Finding]:
    """The stack over the seeded fixture for ``name``; ``extra-launch``
    runs the witness's take_n path instead."""
    code, _what, transform = DISPATCH_MUTATIONS[name]
    if transform is None:
        return run_witness(device, only=("take_n",), mutate="extra_launch").findings
    sources = transform(repo_sources(repo_root))
    launch_keys = None
    if name == "unspecced-launch":
        from patrol_tpu_torch.ops._build import LAUNCHES

        launch_keys = (*LAUNCHES, "shadow")
    return check_sources(sources, launch_keys=launch_keys)


def dispatch_repo(repo_root: str, device="cuda") -> Tuple[List[Finding], WitnessReport]:
    """The static half over the repo, the stale PTD sweep, then the
    witness on ``device``."""
    from patrol_tpu_torch.analysis.lint import apply_suppressions

    used: Set[Tuple[str, int, str]] = set()
    static = check_repo(repo_root, used_out=used)
    static = apply_suppressions(static, repo_root, stale_family="PTD", inline_used=used)
    report = run_witness(device)
    findings = sorted(static + report.findings, key=lambda f: (f.path, f.line, f.check))
    return findings, report
