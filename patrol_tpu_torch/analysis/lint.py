"""patrol-check AST lint over the port's own Python sources (counterpart
of the JAX package's ``analysis/lint.py``), plus the findings and
inline-suppression machinery every one of the port's check stages
shares.

Seven checks, each encoding a discipline the runtime depends on but no
generic tool can express. The tables they read are keyed to the files of
``patrol_tpu_torch/``:

* **PTL001 wall-clock** — the limiter is driven by an *injected* clock
  (``runtime/bucket.py::system_clock`` is the one seam; the engine maps
  it onto CLOCK_REALTIME once, in ``DeviceEngine.__init__``, for the
  native host-lane store). A stray ``time.time()`` or argless
  ``datetime.now()`` anywhere else silently forks the clock domain.
  Observability-only wall clocks (uptime metrics, log timestamps) carry
  an inline ``# patrol-lint: clock-seam`` declaration.

* **PTL002 sync-on-launch** — the CUDA counterpart of the reference's
  sync-in-jit check. Its roots are the functions that launch a
  hand-written kernel: every function that calls
  ``_build.count_launch`` (found by that call, so a new wrapper is a root
  the day it lands), plus the declared :data:`LAUNCH_ROOTS`. The call
  graph from them (the reference's :class:`_FuncIndex` walk) must hold
  no host-device sync: ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``torch.cuda.synchronize`` or ``.synchronize()`` on an
  event or stream, ``nonzero``, ``unique``, ``masked_select``, a read or
  write through a boolean mask (``t[t > 0]``), ``int``/``float``/``bool``
  of a method call's result, an ``if``/``while`` test that ends in
  ``.any()``/``.all()``, numpy's array constructors, and a native symbol
  declared ``blocks`` in ``NATIVE_EFFECTS``. A sync there stalls the
  launching thread on the card once a call. The walk does not enter a
  wrapper's CPU branch (the body of ``if <device>.type == "cpu":``) or a
  function declared in :data:`SYNC_BOUNDARIES` (the plain versions,
  which run on CPU tensors only and may sync). Where a root calls
  ``lib().patrol_<name>(...)``, the ``extern "C"`` entry of that name in
  ``patrol_tpu_torch/csrc/*.cu`` must not call a blocking CUDA runtime
  function (:data:`CUDA_SYNC_CALLS`); that finding lands on the ``.cu``
  line. ``torch.cuda.set_sync_debug_mode`` sees only torch's own syncs,
  never one inside the ``ctypes`` library, which is why that half is a
  text scan.

* **PTL003 lock-order** — the engine's documented order is ``_host_mu``
  (outer) before ``_state_mu`` (inner); the epoll thread blocks on
  ``_host_mu`` (it IS the native store mutex), so the reverse nesting
  deadlocks the native front against the feeder. Re-acquiring a held
  lock is flagged too (``threading.Lock`` is not reentrant).

* **PTL004 dtype-discipline** — ``ops/wire.py`` (numpy) and
  ``ops/merge.py`` (torch) state math stays in the declared
  u32/u64/i64 nanotoken dtypes. Float literals, true division, float
  dtypes, and dtype-less constructors are flagged outside the declared
  codec-boundary functions. numpy's constructors take the dtype
  positionally or by keyword (:data:`DTYPE_CTORS`); torch's
  (:data:`TORCH_DTYPE_CTORS`: ``torch.arange``, ``zeros``, ``ones``,
  ``empty``, ``full``, ``tensor``) only by ``dtype=``.

* **PTL005 counter-registry** — every ``COUNTERS.inc(...)`` /
  ``COUNTERS.set_max(...)`` call site must name a counter declared in
  ``utils/profiling.py::CounterRegistry._KNOWN``, which the registry
  zero-fills into every ``/debug/vars`` snapshot. A name picked from a
  module-level literal table (``COUNTERS.inc(_NAMES[i])`` where
  ``_NAMES`` is a tuple, list or dict display of string literals) is
  verified entry by entry; any other non-literal name is flagged.

* **PTL006 stale-suppression** — a directive that suppresses nothing is
  itself a finding (see below).

* **PTL007 env-knob registry** — every ``os.environ`` / ``os.getenv``
  access of a ``PATROL_*`` name must use a string literal declared in
  ``utils/config.py::KNOBS``; computed names are allowed only inside
  ``utils/config.py`` itself.

Suppressions are inline comments, as in the reference:

    x = time.time()  # patrol-lint: clock-seam (uptime metric)
    y = a / b        # patrol-lint: wire-f64 (wire tokens are float64)
    z = risky()      # patrol-lint: disable=PTL001,PTL004

``clock-seam`` suppresses PTL001 only; ``wire-f64`` suppresses PTL004
only; ``disable=`` names codes explicitly. Every suppression is a
*declaration*: greppable, reviewed like code. A directive that
suppresses nothing is PTL006: the hazard it declared was fixed, and the
comment would silently pardon whatever lands on that line next. The
lint stage sweeps its own family (PTL codes plus the markers) after all
checks run; the other stages inherit the same sweep for their code
families through :func:`apply_suppressions`. A ``disable=PTL006`` on
the same line self-suppresses (the one deliberate escape hatch).

Run it with ``python -m patrol_tpu_torch.scripts.lint_repo``. It never
imports torch (the native effects table it loads by path needs numpy).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Dict, List, Optional, Sequence, Set, Tuple

# The package the lint and the stale-suppression sweep walk, relative to
# the repo root.
PACKAGE = "patrol_tpu_torch"
CSRC = f"{PACKAGE}/csrc"

# ---------------------------------------------------------------------------
# Declared invariant configuration (the checks' allowlists live HERE, in
# code review's line of sight, not scattered through the tree).

# PTL001: functions allowed to read the wall clock without an inline
# declaration — the clock seams themselves.
CLOCK_SEAMS: Dict[str, Set[str]] = {
    # The injected-clock default (≙ main.go:35-37 offset clocks).
    "patrol_tpu_torch/runtime/bucket.py": {"system_clock"},
    # One-time injected-clock → CLOCK_REALTIME offset for the C++ store.
    "patrol_tpu_torch/runtime/engine.py": {"DeviceEngine.__init__"},
}

# PTL002: functions the launch walk never enters, with the reason. Each
# is a plain version that a wrapper runs only for a state on the CPU:
# it may sync (``row_rmw_plain`` counts ``torch.unique`` and indexes
# through ``torch.nonzero``), and no launch path reaches it on the card.
SYNC_BOUNDARIES: Dict[str, Dict[str, str]] = {
    "patrol_tpu_torch/ops/take_kernel.py": {
        "take_n_plain": "take_n's CPU branch only",
    },
    "patrol_tpu_torch/ops/join_kernel.py": {
        "pair_join_plain": "pair_join's CPU branch only",
        "row_join_plain": "row_join's CPU branch only",
        "tick_join_plain": "tick_join's CPU branch only",
    },
    "patrol_tpu_torch/ops/ingest_kernel.py": {
        "decode_fold_plain": "decode_fold's CPU branch only",
    },
    "patrol_tpu_torch/ops/row_rmw_kernel.py": {
        "row_rmw_plain": "row_rmw's CPU branch only (torch.unique, torch.nonzero)",
    },
    "patrol_tpu_torch/ops/converge_kernel.py": {
        "gather_plain": "gather's CPU branch only",
        "converge_plain": "converge's CPU branch only",
    },
}

# PTL002: launch roots that reach their kernels through the wrappers
# rather than by calling count_launch themselves. The mesh's device half
# slices, allocates and launches five kernels between host steps; over
# several pieces it also records events and copies between cards.
LAUNCH_ROOTS: Dict[str, Set[str]] = {
    "patrol_tpu_torch/parallel/topology.py": {"run_pieces"},
}

# PTL004: scope and declared float-boundary functions (the wire format is
# float64 tokens; the conversion in/out of nanotokens lives only here).
DTYPE_FILES: Set[str] = {
    "patrol_tpu_torch/ops/wire.py",
    "patrol_tpu_torch/ops/merge.py",
}
DTYPE_BOUNDARIES: Dict[str, Set[str]] = {
    "patrol_tpu_torch/ops/wire.py": {
        "_sanitize_nt",
        "sanitize_nt_array",
        "from_nanotokens",
    },
}

# PTL003: lock rank — outer locks first. Acquiring a lock while holding
# one of strictly lower rank (later in this list) is a violation.
LOCK_ORDER: List[str] = ["_host_mu", "_state_mu"]

FLOAT_DTYPES = {"float64", "float32", "float16", "bfloat16", "double", "half"}
# numpy constructor → positional index of its dtype parameter (None:
# keyword only).
DTYPE_CTORS: Dict[str, Optional[int]] = {
    "array": 1,
    "asarray": 1,
    "ascontiguousarray": 1,
    "zeros": 1,
    "ones": 1,
    "empty": 1,
    "full": 2,
    "arange": None,
}
# torch constructors: sizes are positional, so the dtype is keyword only.
TORCH_DTYPE_CTORS: Set[str] = {"arange", "zeros", "ones", "empty", "full", "tensor"}

# PTL002 primitives: method calls that copy a device value to the host or
# wait on the card, on any receiver.
SYNC_ATTRS = {
    "item", "cpu", "tolist", "numpy", "synchronize",
    "nonzero", "unique", "masked_select",
}
SYNC_NP_FUNCS = {"asarray", "array", "ascontiguousarray"}
# int()/float()/bool() of a method call's result reads a device scalar,
# except for these methods, which answer from the tensor's metadata.
HOST_SCALAR_METHODS = {
    "numel", "dim", "size", "data_ptr", "element_size", "nelement",
    "stride", "storage_offset", "get_device",
}
# PTL002, the .cu half: blocking CUDA runtime calls an extern "C" entry
# must not make (the async forms, cudaMemcpyAsync and friends, are fine).
CUDA_SYNC_CALLS = (
    "cudaMemcpy", "cudaDeviceSynchronize", "cudaStreamSynchronize",
    "cudaEventSynchronize", "cudaMalloc", "cudaFree",
)

_DIRECTIVE_RE = re.compile(r"#\s*patrol-lint:\s*([A-Za-z0-9=,_\- ]+)")

# Marker tokens the lint stage owns (each aliases one PTL code).
LINT_MARKERS = ("clock-seam", "wire-f64")


def _parse_directive(comment: str) -> Set[str]:
    """Directive tokens out of one comment string (empty set: none)."""
    m = _DIRECTIVE_RE.search(comment)
    if not m:
        return set()
    toks: Set[str] = set()
    for raw in re.split(r"[,\s]+", m.group(1).strip()):
        if not raw:
            continue
        if raw.startswith("disable="):
            toks.update(t for t in raw[8:].split(",") if t)
        else:
            toks.add(raw)
    return toks


def directive_map(source: str) -> Dict[int, Set[str]]:
    """line → directive tokens, from real COMMENT tokens only. A
    ``# patrol-lint:`` spelled inside a string literal is prose about the
    machinery, not an instance of it — the tokenizer is the cheapest
    oracle that tells the two apart. Falls back to a raw line scan if
    tokenization fails (the caller already ast-parsed, so it shouldn't)."""
    out: Dict[int, Set[str]] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            parsed = _parse_directive(tok.string)
            if parsed:
                out.setdefault(tok.start[0], set()).update(parsed)
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        for lineno, line in enumerate(source.splitlines(), start=1):
            parsed = _parse_directive(line)
            if parsed:
                out.setdefault(lineno, set()).update(parsed)
    return out


# ---------------------------------------------------------------------------
# Cross-boundary effects: the declared per-symbol contract of the port's
# C ABI (patrol_tpu_torch/native/__init__.py::NATIVE_EFFECTS). PTL002
# treats a launch-reachable call to a symbol declared `blocks` like
# .item(); PTL003 treats a call to a symbol declared `takes_host_mu` as
# an acquisition of _host_mu. Loaded by file path when the package module
# is not imported yet, so a caller that only wants the table never
# builds the library.

_native_effects_cache: Optional[Dict[str, object]] = None


def native_effects() -> Dict[str, object]:
    """symbol → NativeEffect, from patrol_tpu_torch/native/__init__.py.
    Empty on any load failure (the boundary checks degrade, the rest
    still run)."""
    global _native_effects_cache
    if _native_effects_cache is not None:
        return _native_effects_cache
    try:
        import sys

        mod = sys.modules.get("patrol_tpu_torch.native")
        if mod is None:
            import importlib.util

            path = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "native",
                "__init__.py",
            )
            spec = importlib.util.spec_from_file_location(
                "_patrol_torch_native_effects", path
            )
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        _native_effects_cache = dict(mod.NATIVE_EFFECTS)
    except Exception:  # pragma: no cover - numpy-less environments
        _native_effects_cache = {}
    return _native_effects_cache


@dataclasses.dataclass(frozen=True)
class Finding:
    check: str
    path: str  # repo-relative, "/"-separated
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.check} {self.message}"


class Module:
    """One parsed source file plus its suppression table."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.tree = ast.parse(source, filename=self.relpath)
        # line → directive tokens ("clock-seam", "wire-f64", "PTL001", ...)
        self.directives: Dict[int, Set[str]] = directive_map(source)
        # (line, token) pairs that actually suppressed a finding — the
        # PTL006 stale sweep flags any directive token never seen here.
        self.used: Set[Tuple[int, str]] = set()

    def suppressed(self, check: str, line: int, marker: Optional[str] = None) -> bool:
        toks = self.directives.get(line, ())
        hit = False
        if check in toks:
            self.used.add((line, check))
            hit = True
        if marker is not None and marker in toks:
            self.used.add((line, marker))
            hit = True
        return hit


def _time_aliases(tree: ast.AST) -> Tuple[Set[str], Set[str], Set[str]]:
    """→ (aliases of module ``time``, names bound to time.time/time_ns,
    names bound to the ``datetime`` class or module)."""
    mods: Set[str] = set()
    funcs: Set[str] = set()
    dt: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    mods.add(a.asname or a.name)
                elif a.name == "datetime":
                    dt.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "time":
                for a in node.names:
                    if a.name in ("time", "time_ns"):
                        funcs.add(a.asname or a.name)
            elif node.module == "datetime":
                for a in node.names:
                    if a.name == "datetime":
                        dt.add(a.asname or a.name)
    return mods, funcs, dt


def _module_aliases(tree: ast.AST, name: str) -> Set[str]:
    """Names bound to the top-level module ``name`` by ``import``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == name:
                    out.add(a.asname or a.name)
    return out


class _ScopedVisitor(ast.NodeVisitor):
    """Tracks the qualified name of the enclosing function/class."""

    def __init__(self) -> None:
        self.stack: List[str] = []

    def qualname(self) -> str:
        return ".".join(self.stack) if self.stack else "<module>"

    def visit_FunctionDef(self, node):  # noqa: N802
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):  # noqa: N802
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()


# ---------------------------------------------------------------------------
# PTL001 — wall-clock outside the declared clock seams


def check_wall_clock(mod: Module) -> List[Finding]:
    time_mods, time_funcs, dt_names = _time_aliases(mod.tree)
    seams = CLOCK_SEAMS.get(mod.relpath, set())
    out: List[Finding] = []

    class V(_ScopedVisitor):
        def visit_Call(self, node):  # noqa: N802
            hit = None
            f = node.func
            if isinstance(f, ast.Attribute):
                if (
                    f.attr in ("time", "time_ns")
                    and isinstance(f.value, ast.Name)
                    and f.value.id in time_mods
                ):
                    hit = f"{f.value.id}.{f.attr}()"
                elif f.attr == "now" and not node.args and not node.keywords:
                    v = f.value
                    if (isinstance(v, ast.Name) and v.id in dt_names) or (
                        isinstance(v, ast.Attribute)
                        and v.attr == "datetime"
                        and isinstance(v.value, ast.Name)
                        and v.value.id in dt_names
                    ):
                        hit = "datetime.now()"
            elif isinstance(f, ast.Name) and f.id in time_funcs:
                hit = f"{f.id}()"
            if hit is not None:
                qn = self.qualname()
                if qn not in seams and not mod.suppressed(
                    "PTL001", node.lineno, "clock-seam"
                ):
                    out.append(
                        Finding(
                            "PTL001",
                            mod.relpath,
                            node.lineno,
                            f"wall-clock call {hit} outside the declared "
                            f"clock seams (in {qn}); route it through the "
                            "injected clock or declare the seam with "
                            "`# patrol-lint: clock-seam`",
                        )
                    )
            self.generic_visit(node)

    V().visit(mod.tree)
    return out


# ---------------------------------------------------------------------------
# PTL002 — host-device syncs reachable from a kernel launch


def _module_to_relpath(dotted: str) -> str:
    return dotted.replace(".", "/") + ".py"


class _FuncIndex:
    """(relpath, qualified function name) → FunctionDef, plus per-module
    import resolution for cross-module call-graph edges.

    Module-level functions are keyed by bare name; methods by
    ``"Class.method"`` (one class level). ``attr_funcs`` records functions
    stored on instance attributes in ``__init__`` (``self._fn = fn``) so
    ``self._fn(...)`` call sites resolve — the attribute-chain resolution
    PTL002 needs for kernels dispatched through instance state."""

    def __init__(self, mods: Sequence[Module]):
        self.funcs: Dict[Tuple[str, str], ast.AST] = {}
        # relpath → {local name: (target relpath, target func name)}
        self.imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        # relpath → {alias: module relpath} for `import pkg.mod as alias`
        self.mod_aliases: Dict[str, Dict[str, str]] = {}
        # (relpath, class name) → {attr: resolved (relpath, func key)}
        self.attr_funcs: Dict[Tuple[str, str], Dict[str, Tuple[str, str]]] = {}
        self.relpaths = {m.relpath for m in mods}
        for m in mods:
            imap: Dict[str, Tuple[str, str]] = {}
            amap: Dict[str, str] = {}
            for node in ast.walk(m.tree):
                if isinstance(node, ast.ImportFrom) and node.module:
                    rel = _module_to_relpath(node.module)
                    for a in node.names:
                        if rel in self.relpaths:
                            imap[a.asname or a.name] = (rel, a.name)
                        else:
                            sub = _module_to_relpath(f"{node.module}.{a.name}")
                            if sub in self.relpaths:
                                amap[a.asname or a.name] = sub
                elif isinstance(node, ast.Import):
                    for a in node.names:
                        rel = _module_to_relpath(a.name)
                        if rel in self.relpaths:
                            amap[a.asname or a.name] = rel
            self.imports[m.relpath] = imap
            self.mod_aliases[m.relpath] = amap
        for m in mods:
            self._collect_funcs(m.relpath, m.tree, None)
        for m in mods:
            self._collect_attr_funcs(m)

    def _collect_funcs(self, rel: str, node: ast.AST, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = f"{cls}.{child.name}" if cls else child.name
                self.funcs[(rel, key)] = child
                # Nested defs register under their bare names, as before.
                self._collect_funcs(rel, child, None)
            elif isinstance(child, ast.ClassDef):
                self._collect_funcs(rel, child, child.name)
            else:
                self._collect_funcs(rel, child, cls)

    def _collect_attr_funcs(self, m: Module) -> None:
        rel = m.relpath
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            init = self.funcs.get((rel, f"{node.name}.__init__"))
            if init is None:
                continue
            amap: Dict[str, Tuple[str, str]] = {}
            for stmt in ast.walk(init):
                if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                value = stmt.value
                if value is None:
                    continue
                tgt = self._resolve_value(rel, node.name, value)
                if tgt is None:
                    continue
                for t in targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        amap[t.attr] = tgt
            if amap:
                self.attr_funcs[(rel, node.name)] = amap

    def _resolve_value(
        self, rel: str, cls: str, v: ast.AST
    ) -> Optional[Tuple[str, str]]:
        """A value expression naming a known function (module-level, imported,
        module-attribute, or a sibling method) → its funcs key."""
        if isinstance(v, ast.Name):
            if (rel, v.id) in self.funcs:
                return (rel, v.id)
            imp = self.imports.get(rel, {}).get(v.id)
            if imp and imp in self.funcs:
                return imp
        elif isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name):
            if v.value.id == "self":
                mkey = (rel, f"{cls}.{v.attr}")
                if mkey in self.funcs:
                    return mkey
            tgt = self.mod_aliases.get(rel, {}).get(v.value.id)
            if tgt and (tgt, v.attr) in self.funcs:
                return (tgt, v.attr)
        return None

    def resolve(
        self,
        relpath: str,
        call: ast.Call,
        caller: Optional[Tuple[str, str]] = None,
    ) -> Optional[Tuple[str, str]]:
        f = call.func
        if isinstance(f, ast.Name):
            if (relpath, f.id) in self.funcs:
                return (relpath, f.id)
            return self.imports.get(relpath, {}).get(f.id)
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.value.id == "self" and caller is not None and "." in caller[1]:
                cname = caller[1].split(".", 1)[0]
                mkey = (caller[0], f"{cname}.{f.attr}")
                if mkey in self.funcs:
                    return mkey
                tgt = self.attr_funcs.get((caller[0], cname), {}).get(f.attr)
                if tgt is not None:
                    return tgt
            target = self.mod_aliases.get(relpath, {}).get(f.value.id)
            if target and (target, f.attr) in self.funcs:
                return (target, f.attr)
        return None


def _is_count_launch(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "count_launch") or (
        isinstance(f, ast.Name) and f.id == "count_launch"
    )


def _is_cpu_branch(node: ast.AST) -> bool:
    """``if <expr>.type == "cpu":`` — a wrapper's plain-version branch."""
    if not isinstance(node, ast.If):
        return False
    t = node.test
    return (
        isinstance(t, ast.Compare)
        and len(t.ops) == 1
        and isinstance(t.ops[0], ast.Eq)
        and isinstance(t.left, ast.Attribute)
        and t.left.attr == "type"
        and isinstance(t.comparators[0], ast.Constant)
        and t.comparators[0].value == "cpu"
    )


def _launch_nodes(fn: ast.AST):
    """Every node of ``fn`` that runs on its launch path: the whole body,
    nested defs included (as the reference's ``ast.walk``), except the
    body of a CPU branch (its ``else`` still runs)."""
    stack = [fn]
    while stack:
        node = stack.pop()
        yield node
        if _is_cpu_branch(node):
            stack.append(node.test)
            stack.extend(node.orelse)
            continue
        stack.extend(ast.iter_child_nodes(node))


def _launch_roots(mods: Sequence[Module], index: _FuncIndex) -> Set[Tuple[str, str]]:
    """Functions that launch a kernel: each one that calls
    ``count_launch`` on its launch path, plus :data:`LAUNCH_ROOTS`."""
    roots: Set[Tuple[str, str]] = set()
    for key, node in index.funcs.items():
        if any(
            isinstance(n, ast.Call) and _is_count_launch(n)
            for n in _launch_nodes(node)
        ):
            roots.add(key)
    for rel, names in LAUNCH_ROOTS.items():
        for name in names:
            if (rel, name) in index.funcs:
                roots.add((rel, name))
    return roots


def _is_mask(expr: ast.AST) -> bool:
    """A boolean-mask index: a comparison, or ~, & and | over them."""
    if isinstance(expr, ast.Compare):
        return True
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, (ast.Invert, ast.Not)):
        return _is_mask(expr.operand)
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, (ast.BitAnd, ast.BitOr)):
        return _is_mask(expr.left) or _is_mask(expr.right)
    return False


def _any_all_tail(test: ast.AST) -> Optional[str]:
    """The ``.any()``/``.all()`` an if/while test ends in, if any."""
    if isinstance(test, ast.UnaryOp):
        return _any_all_tail(test.operand)
    if isinstance(test, ast.BoolOp):
        for v in test.values:
            hit = _any_all_tail(v)
            if hit:
                return hit
        return None
    if (
        isinstance(test, ast.Call)
        and isinstance(test.func, ast.Attribute)
        and test.func.attr in ("any", "all")
    ):
        return f".{test.func.attr}()"
    return None


def _sync_hit(node: ast.AST, np_names: Set[str], effects: Dict[str, object]):
    """→ (kind, spelling) when ``node`` is a host-device sync primitive."""
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in SYNC_ATTRS:
                return "host-device sync", f".{f.attr}()"
            if f.attr in effects and getattr(effects[f.attr], "blocks"):
                # The ctypes boundary is not opaque: the native effects
                # table declares this symbol blocking (poll/condvar/
                # contended mutex), the same per-launch stall as a sync.
                return "blocking native ABI call", f".{f.attr}()"
            if (
                isinstance(f.value, ast.Name)
                and f.value.id in np_names
                and f.attr in SYNC_NP_FUNCS
            ):
                return "host-device sync", f"{f.value.id}.{f.attr}()"
        elif (
            isinstance(f, ast.Name)
            and f.id in ("int", "float", "bool")
            and len(node.args) == 1
            and isinstance(node.args[0], ast.Call)
            and isinstance(node.args[0].func, ast.Attribute)
            and node.args[0].func.attr not in HOST_SCALAR_METHODS
        ):
            return "host-device sync", f"{f.id}(.{node.args[0].func.attr}())"
    elif isinstance(node, (ast.If, ast.While)):
        tail = _any_all_tail(node.test)
        if tail:
            return "host-device sync", f"a branch on {tail}"
    elif isinstance(node, ast.Subscript):
        idx = node.slice
        parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
        if any(_is_mask(p) for p in parts):
            return "host-device sync", "a boolean-mask index"
    return None


def _launched_entry(call: ast.Call) -> Optional[str]:
    """``lib().patrol_<name>(...)`` → ``patrol_<name>``."""
    f = call.func
    if (
        isinstance(f, ast.Attribute)
        and f.attr.startswith("patrol_")
        and isinstance(f.value, ast.Call)
    ):
        return f.attr
    return None


_CU_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_CU_SYNC_RE = re.compile(r"\b(" + "|".join(CUDA_SYNC_CALLS) + r")\s*\(")


def cuda_entries(
    cuda_sources: Dict[str, str],
) -> Dict[str, Tuple[str, str, int, int]]:
    """``extern "C"`` entry name → (relpath, its file's text with comments
    blanked and newlines kept, the offsets of the definition's start and
    closing brace) over ``{relpath: .cu source}``."""
    out: Dict[str, Tuple[str, str, int, int]] = {}
    for rel, src in sorted(cuda_sources.items()):
        # Blank comments but keep every newline, so offsets map to lines.
        text = _CU_COMMENT_RE.sub(
            lambda m: re.sub(r"[^\n]", " ", m.group(0)), src
        )
        for m in re.finditer(r'extern\s+"C"[^{;(]*?\b(\w+)\s*\(', text):
            name = m.group(1)
            open_at = text.find("{", m.end())
            semi = text.find(";", m.end())
            if open_at < 0 or (0 <= semi < open_at):
                continue  # a declaration, not a definition
            depth, i = 0, open_at
            while i < len(text):
                if text[i] == "{":
                    depth += 1
                elif text[i] == "}":
                    depth -= 1
                    if depth == 0:
                        break
                i += 1
            out[name] = (rel, text, m.start(), i + 1)
    return out


def check_launch_sync(
    mods: Sequence[Module], cuda_sources: Optional[Dict[str, str]] = None
) -> List[Finding]:
    """PTL002 over the call graph from every kernel launch root, then the
    ``extern "C"`` entries those roots launch through (when
    ``cuda_sources`` is given: {relpath: .cu source})."""
    index = _FuncIndex(mods)
    roots = _launch_roots(mods, index)
    mod_by_path = {m.relpath: m for m in mods}
    np_aliases = {m.relpath: _module_aliases(m.tree, "numpy") for m in mods}

    def boundary(key: Tuple[str, str]) -> bool:
        return key[1] in SYNC_BOUNDARIES.get(key[0], {})

    # BFS the call graph from the launch roots.
    seen: Set[Tuple[str, str]] = set()
    frontier = [r for r in roots if r in index.funcs and not boundary(r)]
    reach_from: Dict[Tuple[str, str], Tuple[str, str]] = {}
    entries: Dict[str, Tuple[Tuple[str, str], int]] = {}
    while frontier:
        key = frontier.pop()
        if key in seen:
            continue
        seen.add(key)
        for node in _launch_nodes(index.funcs[key]):
            if not isinstance(node, ast.Call):
                continue
            entry = _launched_entry(node)
            if entry is not None:
                entries.setdefault(entry, (key, node.lineno))
            target = index.resolve(key[0], node, caller=key)
            if (
                target
                and target in index.funcs
                and target not in seen
                and not boundary(target)
            ):
                reach_from.setdefault(target, key)
                frontier.append(target)

    def root_note(key: Tuple[str, str]) -> str:
        if key in roots:
            return ""
        return (
            " (reachable from a launch root via "
            f"{reach_from.get(key, ('?', '?'))[1]})"
        )

    effects = native_effects()
    out: List[Finding] = []
    for relpath, name in sorted(seen):
        m = mod_by_path[relpath]
        for node in _launch_nodes(index.funcs[(relpath, name)]):
            hit = _sync_hit(node, np_aliases[relpath], effects)
            if hit is None:
                continue
            kind, what = hit
            if m.suppressed("PTL002", node.lineno):
                continue
            out.append(
                Finding(
                    "PTL002",
                    relpath,
                    node.lineno,
                    f"{kind} {what} inside {name}(), which is on a CUDA "
                    f"kernel's launch path{root_note((relpath, name))}",
                )
            )
    if cuda_sources is None:
        return out
    table = cuda_entries(cuda_sources)
    for entry, ((relpath, name), line) in sorted(entries.items()):
        found = table.get(entry)
        if found is None:
            if not mod_by_path[relpath].suppressed("PTL002", line):
                out.append(
                    Finding(
                        "PTL002",
                        relpath,
                        line,
                        f"{name}() launches {entry}, which no extern \"C\" "
                        f"entry of {CSRC}/*.cu defines: its sync scan "
                        "cannot see it",
                    )
                )
            continue
        cu_rel, text, start, end = found
        for sm in _CU_SYNC_RE.finditer(text, start, end):
            out.append(
                Finding(
                    "PTL002",
                    cu_rel,
                    text.count("\n", 0, sm.start()) + 1,
                    f"blocking CUDA call {sm.group(1)}() inside extern \"C\" "
                    f"{entry}(), which {name}() launches through ctypes"
                    f"{root_note((relpath, name))}",
                )
            )
    return out


# ---------------------------------------------------------------------------
# PTL003 — lock-acquisition ordering (_host_mu before _state_mu)


def _lock_name(expr: ast.AST) -> Optional[str]:
    if isinstance(expr, ast.Attribute) and expr.attr in LOCK_ORDER:
        return expr.attr
    if isinstance(expr, ast.Name) and expr.id in LOCK_ORDER:
        return expr.id
    return None


def check_lock_order(mod: Module) -> List[Finding]:
    out: List[Finding] = []
    rank = {name: i for i, name in enumerate(LOCK_ORDER)}
    effects = native_effects()

    def walk(node: ast.AST, held: Tuple[str, ...]) -> None:
        acquired: List[str] = []
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                name = _lock_name(item.context_expr)
                if name is not None:
                    _record(name, node.lineno, held + tuple(acquired))
                    acquired.append(name)
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "acquire":
                name = _lock_name(f.value)
                if name is not None:
                    _record(name, node.lineno, held)
            elif (
                isinstance(f, ast.Attribute)
                and f.attr in effects
                and getattr(effects[f.attr], "takes_host_mu")
            ):
                # Declared in the native effects table: this ctypes call
                # acquires the host-lane store mutex — which IS the
                # engine's _host_mu — inside the .so. Analyze the call
                # site as an acquisition of _host_mu.
                _record("_host_mu", node.lineno, held, via=f.attr)
        new_held = held + tuple(acquired)
        for child in ast.iter_child_nodes(node):
            # Nested defs start a fresh dynamic scope: a closure body does
            # not run under the enclosing `with` at definition time.
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk_fresh(child)
            else:
                walk(child, new_held)

    def walk_fresh(fn: ast.AST) -> None:
        for child in ast.iter_child_nodes(fn):
            walk(child, ())

    def _record(
        name: str, line: int, held: Tuple[str, ...], via: Optional[str] = None
    ) -> None:
        if mod.suppressed("PTL003", line):
            return
        how = f" (via native {via}, declared takes_host_mu)" if via else ""
        if name in held:
            out.append(
                Finding(
                    "PTL003",
                    mod.relpath,
                    line,
                    f"re-acquiring non-reentrant lock {name}{how} while "
                    "already holding it (self-deadlock)",
                )
            )
            return
        for h in held:
            if rank[h] > rank[name]:
                out.append(
                    Finding(
                        "PTL003",
                        mod.relpath,
                        line,
                        f"acquiring {name}{how} while holding {h}: declared "
                        f"order is {' -> '.join(LOCK_ORDER)} (outer first); "
                        "the reverse nesting deadlocks the native front "
                        "against the feeder",
                    )
                )

    walk_fresh(mod.tree)
    return out


# ---------------------------------------------------------------------------
# PTL004 — nanotoken dtype discipline in the wire/merge state math


def check_dtype_discipline(mod: Module) -> List[Finding]:
    if mod.relpath not in DTYPE_FILES:
        return []
    boundaries = DTYPE_BOUNDARIES.get(mod.relpath, set())
    torch_names = _module_aliases(mod.tree, "torch")
    out: List[Finding] = []

    class V(_ScopedVisitor):
        def in_boundary(self) -> bool:
            return any(name in boundaries for name in self.stack)

        def flag(self, node: ast.AST, msg: str) -> None:
            if self.in_boundary() or mod.suppressed(
                "PTL004", node.lineno, "wire-f64"
            ):
                return
            out.append(Finding("PTL004", mod.relpath, node.lineno, msg))

        def visit_Constant(self, node):  # noqa: N802
            if isinstance(node.value, float):
                self.flag(
                    node,
                    f"float literal {node.value!r} in nanotoken state math; "
                    "stay in u32/u64/i64 (or move to a declared boundary)",
                )

        def visit_BinOp(self, node):  # noqa: N802
            if isinstance(node.op, ast.Div):
                self.flag(
                    node,
                    "true division promotes to float64; use // on nanotoken "
                    "integers (or move to a declared boundary)",
                )
            self.generic_visit(node)

        def visit_Attribute(self, node):  # noqa: N802
            if node.attr in FLOAT_DTYPES:
                self.flag(
                    node,
                    f"float dtype .{node.attr} referenced in nanotoken state "
                    "math; declared dtypes are u32/u64/i64",
                )
            self.generic_visit(node)

        def visit_Call(self, node):  # noqa: N802
            f = node.func
            if isinstance(f, ast.Attribute):
                is_torch = isinstance(f.value, ast.Name) and f.value.id in torch_names
                has_kw = any(k.arg == "dtype" for k in node.keywords)
                if is_torch and f.attr in TORCH_DTYPE_CTORS:
                    has_pos = False
                elif not is_torch and f.attr in DTYPE_CTORS:
                    pos = DTYPE_CTORS[f.attr]
                    has_pos = pos is not None and len(node.args) > pos
                else:
                    has_kw = has_pos = True
                if not has_kw and not has_pos:
                    self.flag(
                        node,
                        f"{f.attr}() without an explicit dtype: the default "
                        "is environment-dependent (x64 mode) and can "
                        "float-promote; pass the nanotoken dtype explicitly",
                    )
            self.generic_visit(node)

    V().visit(mod.tree)
    return out


# ---------------------------------------------------------------------------
# PTL005 — COUNTERS call sites must use names declared in _KNOWN

_counter_names_cache: Optional[Set[str]] = None


def known_counter_names() -> Set[str]:
    """``CounterRegistry._KNOWN`` from the port's utils/profiling.py,
    loaded by file path (like :func:`native_effects`) so the lint stage
    never imports torch. Empty on load failure — the check then degrades
    to silence rather than flagging every call site."""
    global _counter_names_cache
    if _counter_names_cache is not None:
        return _counter_names_cache
    try:
        import importlib.util

        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "utils",
            "profiling.py",
        )
        spec = importlib.util.spec_from_file_location(
            "_patrol_torch_counter_names", path
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _counter_names_cache = set(mod.CounterRegistry._KNOWN)
    except Exception:  # pragma: no cover - stdlib-only module; belt&braces
        _counter_names_cache = set()
    return _counter_names_cache


def _literal_tables(tree: ast.AST) -> Dict[str, List[ast.Constant]]:
    """Module-level ``NAME = (...)``/``[...]``/``{...}`` displays whose
    every value is a string literal → those literals."""
    out: Dict[str, List[ast.Constant]] = {}
    for node in getattr(tree, "body", ()):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        t, v = node.targets[0], node.value
        if not isinstance(t, ast.Name):
            continue
        if isinstance(v, (ast.Tuple, ast.List)):
            vals = v.elts
        elif isinstance(v, ast.Dict):
            vals = v.values
        else:
            continue
        if vals and all(
            isinstance(x, ast.Constant) and isinstance(x.value, str) for x in vals
        ):
            out[t.id] = list(vals)
    return out


def check_counter_registry(mod: Module) -> List[Finding]:
    known = known_counter_names()
    if not known:
        return []
    tables = _literal_tables(mod.tree)
    out: List[Finding] = []

    class V(_ScopedVisitor):
        def visit_Call(self, node):  # noqa: N802
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in ("inc", "set_max")
                and (
                    (isinstance(f.value, ast.Name) and f.value.id == "COUNTERS")
                    or (
                        isinstance(f.value, ast.Attribute)
                        and f.value.attr == "COUNTERS"
                    )
                )
            ) and not mod.suppressed("PTL005", node.lineno):
                arg = node.args[0] if node.args else None
                if (
                    isinstance(arg, ast.Subscript)
                    and isinstance(arg.value, ast.Name)
                    and arg.value.id in tables
                ):
                    # A name picked from a literal table: every entry must
                    # be declared.
                    names = [c.value for c in tables[arg.value.id]]
                elif isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    names = [arg.value]
                else:
                    out.append(
                        Finding(
                            "PTL005",
                            mod.relpath,
                            node.lineno,
                            f"COUNTERS.{f.attr}() with a non-literal counter "
                            "name: it cannot be verified against "
                            "CounterRegistry._KNOWN — pass the declared name "
                            "as a string literal",
                        )
                    )
                    names = []
                for name in names:
                    if name not in known:
                        out.append(
                            Finding(
                                "PTL005",
                                mod.relpath,
                                node.lineno,
                                f"COUNTERS.{f.attr}({name!r}) uses a counter "
                                "name not declared in CounterRegistry._KNOWN; "
                                "it would be missing from the zero-filled "
                                "/debug/vars field set — declare it in "
                                "utils/profiling.py",
                            )
                        )
            self.generic_visit(node)

    V().visit(mod.tree)
    return out


# PTL007 — PATROL_* environment reads must use names declared in the
# utils/config.py knob registry

_knob_names_cache: Optional[Set[str]] = None

# The one module allowed to read the environment through a computed
# name: the registry's own typed accessors.
_CONFIG_SEAM = "patrol_tpu_torch/utils/config.py"


def known_knob_names() -> Set[str]:
    """``KNOBS`` from the port's utils/config.py, loaded by file path
    (like :func:`native_effects`). Empty on load failure — the check then
    degrades to silence."""
    global _knob_names_cache
    if _knob_names_cache is not None:
        return _knob_names_cache
    try:
        import importlib.util

        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "utils",
            "config.py",
        )
        spec = importlib.util.spec_from_file_location(
            "_patrol_torch_knob_names", path
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _knob_names_cache = set(mod.KNOBS)
    except Exception:  # pragma: no cover - stdlib-only module; belt&braces
        _knob_names_cache = set()
    return _knob_names_cache


def _os_aliases(tree: ast.AST) -> Tuple[Set[str], Set[str], Set[str]]:
    """Names bound to the os module / os.environ / os.getenv in this
    module (``import os as _os``, ``from os import environ`` …)."""
    os_names: Set[str] = set()
    environ_names: Set[str] = set()
    getenv_names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "os":
                    os_names.add(a.asname or "os")
        elif isinstance(node, ast.ImportFrom) and node.module == "os":
            for a in node.names:
                if a.name == "environ":
                    environ_names.add(a.asname or "environ")
                elif a.name == "getenv":
                    getenv_names.add(a.asname or "getenv")
    return os_names, environ_names, getenv_names


def check_env_registry(mod: Module) -> List[Finding]:
    known = known_knob_names()
    if not known or mod.relpath == _CONFIG_SEAM:
        return []
    os_names, environ_names, getenv_names = _os_aliases(mod.tree)
    out: List[Finding] = []

    def is_environ(expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name) and expr.id in environ_names:
            return True
        return (
            isinstance(expr, ast.Attribute)
            and expr.attr == "environ"
            and isinstance(expr.value, ast.Name)
            and expr.value.id in os_names
        )

    def flag(node: ast.AST, name_arg: Optional[ast.AST], how: str) -> None:
        if mod.suppressed("PTL007", node.lineno):
            return
        if isinstance(name_arg, ast.Constant) and isinstance(
            name_arg.value, str
        ):
            name = name_arg.value
            if name.startswith("PATROL_") and name not in known:
                out.append(
                    Finding(
                        "PTL007",
                        mod.relpath,
                        node.lineno,
                        f"{how} of undeclared knob {name!r}: every PATROL_* "
                        "environment name must be registered in "
                        "utils/config.py::KNOBS (default + doc) so the "
                        "README knob table cannot drift from the code",
                    )
                )
        else:
            out.append(
                Finding(
                    "PTL007",
                    mod.relpath,
                    node.lineno,
                    f"{how} with a computed environment name: it cannot be "
                    "verified against utils/config.py::KNOBS — use a string "
                    "literal, or go through the utils/config.py accessors "
                    "(the one declared seam for dynamic reads)",
                )
            )

    class V(_ScopedVisitor):
        def visit_Call(self, node):  # noqa: N802
            f = node.func
            if (isinstance(f, ast.Name) and f.id in getenv_names) or (
                isinstance(f, ast.Attribute)
                and f.attr == "getenv"
                and isinstance(f.value, ast.Name)
                and f.value.id in os_names
            ):
                flag(node, node.args[0] if node.args else None, "os.getenv()")
            elif (
                isinstance(f, ast.Attribute)
                and f.attr in ("get", "pop", "setdefault")
                and is_environ(f.value)
            ):
                flag(
                    node,
                    node.args[0] if node.args else None,
                    f"os.environ.{f.attr}()",
                )
            self.generic_visit(node)

        def visit_Subscript(self, node):  # noqa: N802
            if is_environ(node.value):
                flag(node, node.slice, "os.environ[...]")
            self.generic_visit(node)

    V().visit(mod.tree)
    return out


# ---------------------------------------------------------------------------
# Drivers

PER_MODULE_CHECKS = (
    check_wall_clock,
    check_lock_order,
    check_dtype_discipline,
    check_counter_registry,
    check_env_registry,
)
ALL_CODES = (
    "PTL001",
    "PTL002",
    "PTL003",
    "PTL004",
    "PTL005",
    "PTL006",
    "PTL007",
)


def _stale_finding(relpath: str, line: int, tok: str) -> Finding:
    return Finding(
        "PTL006",
        relpath,
        line,
        f"stale suppression `{tok}`: nothing on this line needs it — "
        "remove the directive (a suppression that pardons nothing today "
        "silently pardons whatever lands here tomorrow)",
    )


def stale_suppression_findings(
    mods: Sequence[Module],
    family: str = "PTL",
    markers: Sequence[str] = LINT_MARKERS,
) -> List[Finding]:
    """PTL006 sweep: directive tokens of ``family`` (code prefix) or in
    ``markers`` that suppressed nothing. Must run AFTER the checks whose
    suppressions it audits — usage is recorded by Module.suppressed. A
    ``PTL006`` token on the line self-suppresses the sweep there."""
    out: List[Finding] = []
    for m in mods:
        for line, toks in sorted(m.directives.items()):
            if "PTL006" in toks:
                continue
            for tok in sorted(toks):
                if not (tok.startswith(family) or tok in markers):
                    continue
                if (line, tok) not in m.used:
                    out.append(_stale_finding(m.relpath, line, tok))
    return out


def lint_modules(
    mods: Sequence[Module], cuda_sources: Optional[Dict[str, str]] = None
) -> List[Finding]:
    out: List[Finding] = []
    for m in mods:
        for chk in PER_MODULE_CHECKS:
            out.extend(chk(m))
    out.extend(check_launch_sync(mods, cuda_sources))
    out.extend(stale_suppression_findings(mods))
    return sorted(out, key=lambda f: (f.path, f.line, f.check))


def lint_sources(
    sources: Dict[str, str], cuda_sources: Optional[Dict[str, str]] = None
) -> List[Finding]:
    """Lint in-memory sources ({relpath: source}) — the self-test entry.
    ``cuda_sources`` ({relpath: .cu source}) turns on PTL002's scan of
    the ``extern "C"`` entries the launch roots call."""
    return lint_modules(
        [Module(rp, src) for rp, src in sorted(sources.items())], cuda_sources
    )


def repo_sources(root: str) -> Dict[str, str]:
    """{repo-relative path: source} of every Python file of the port's
    package under ``root``."""
    srcs: Dict[str, str] = {}
    pkg = os.path.join(root, PACKAGE)
    for dirpath, _dirnames, filenames in os.walk(pkg):
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, "r", encoding="utf-8") as f:
                srcs[rel] = f.read()
    return srcs


def repo_cuda_sources(root: str) -> Dict[str, str]:
    """{repo-relative path: source} of the port's ``csrc/*.cu``."""
    srcs: Dict[str, str] = {}
    d = os.path.join(root, CSRC)
    for fn in sorted(os.listdir(d)) if os.path.isdir(d) else ():
        if fn.endswith(".cu"):
            with open(os.path.join(d, fn), "r", encoding="utf-8") as f:
                srcs[f"{CSRC}/{fn}"] = f.read()
    return srcs


def lint_repo(root: str) -> List[Finding]:
    """Lint every Python source under <root>/patrol_tpu_torch, and the
    CUDA entries its launch roots call."""
    return lint_sources(repo_sources(root), repo_cuda_sources(root))


def apply_suppressions(
    findings: Sequence[Finding],
    repo_root: str,
    stale_family: Optional[str] = None,
    inline_used: Optional[Set[Tuple[str, int, str]]] = None,
) -> List[Finding]:
    """Filter findings through the flagged files' inline ``# patrol-lint:``
    directives — the shared back half of every stage driver (lint runs the
    directives during the checks themselves; the other stages produce
    findings first and filter here). Files that cannot be read or parsed
    (e.g. a finding anchored in a .cpp source) keep their findings: a
    suppression that cannot be located must not silently win.

    ``stale_family`` (a code prefix: "PTC", "PTA", "PTN", "PTR", "PTP",
    "PTD") turns
    on the PTL006 stale sweep for that family: every directive token with
    the prefix anywhere under ``<repo_root>/patrol_tpu_torch`` that
    suppressed nothing in this run is appended as a PTL006 finding — so
    each stage audits its own suppressions for free.

    ``inline_used`` covers checkers (race) that honor directives DURING
    the checks, on their own Module instances: (path, line, token)
    triples recorded there count as used here."""
    mods: Dict[str, Optional[Module]] = {}
    kept: List[Finding] = []
    for f in findings:
        if f.path not in mods:
            path = os.path.join(repo_root, f.path)
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    mods[f.path] = Module(f.path, fh.read())
            except (OSError, SyntaxError):
                mods[f.path] = None
        mod = mods[f.path]
        if mod is not None and mod.suppressed(f.check, f.line):
            continue
        kept.append(f)
    if stale_family is not None:
        for rel, src in sorted(repo_sources(repo_root).items()):
            mod = mods.get(rel)
            used = mod.used if mod is not None else set()
            dirs = mod.directives if mod is not None else directive_map(src)
            for line, toks in sorted(dirs.items()):
                if "PTL006" in toks:
                    continue
                for tok in sorted(toks):
                    if not tok.startswith(stale_family):
                        continue
                    if (line, tok) in used:
                        continue
                    if inline_used and (rel, line, tok) in inline_used:
                        continue
                    kept.append(_stale_finding(rel, line, tok))
    return kept
