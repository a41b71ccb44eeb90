"""patrol-prove over the port's kernels (stage 4; counterpart of the JAX
package's ``analysis/prove.py``).

The convergence story rests on algebraic claims the kernels only state
in prose: every join is max-based, so replicas reach one state whatever
the delivery order, duplication or loss. This stage checks those claims
over the roots registered in
:data:`patrol_tpu_torch.ops.obligations.PROVE_ROOTS`, on the CPU (the
kernels' plain versions) or on the card (``device="cuda"``: the models
run through the wrappers, so the CUDA kernels are what they prove).

A jaxpr has no torch counterpart, so the structural pass watches the
program as it runs:

1. **PTP001, structural** — each root runs once on its operand builder's
   small tensors under a :class:`~torch.utils._python_dispatch.TorchDispatchMode`.
   The mode taints the CRDT state planes and every tensor derived from
   them. On a ``join`` root a tainted value may only flow through the
   join ops (:data:`JOIN_OPS`, ``scatter_reduce``/``index_reduce`` with
   ``amax``) and the layout ops (:data:`TRANSPARENT_OPS`: views, gathers,
   copies, comparisons); an overwrite of a plane (``index_put_``,
   ``index_copy_``, ``copy_``, ``scatter_``) is allowed only with values
   that are themselves plane-derived. ``add``, ``sub``, ``mul``, ``sum``,
   a scatter-add and a float cast on a plane are findings. Index math on
   the ``rows`` tensor is never tainted (the JAX package's stage reports
   its own ``read_rows`` for an ``add`` in the negative-index wrap; the
   port's gather clamps and stays clean). On every root, ``join`` or
   ``callbacks`` (the delta roots, whose local adds are the point), a
   host-device sync is a finding: ``.item()`` and its kin, ``nonzero``,
   a boolean-mask index, ``unique``, a device-to-host copy. On the CPU a
   sync inside a kernel's plain version or a wrapper's CPU branch is
   exempt (the rules of the lint's PTL002: those run only for a state on
   the CPU); on the card nothing is. For a root whose kernel joins in
   CUDA C++, the kernel's join functions in ``csrc/*.cu`` are scanned
   too: a join is ``atomicMax`` (``RED.E.MAX.S64`` in SASS) or a store
   of a max, never ``atomicAdd`` or a store of a sum into a plane.
2. **PTP002-PTP004, the models** — the 17 small-domain models of the
   reference, each over the same domain and property, bit-exact. A
   domain has up to ~10^5 combinations and a launch costs microseconds,
   so no model launches once per combination: each combination owns its
   own rows of one state ``[C·B, N, 2]``, its requests address those
   rows, and one launch covers a chunk of :data:`_CHUNK` combinations.
   Each model counts its combinations; the driver counts its launches.
3. **PTP005** — every state output keeps its plane's integer dtype,
   shape and device; a pure read (the lifecycle probe) leaves the planes
   bit for bit as they were.
4. **PTP006, registration** — every ``_build.LAUNCHES`` key is declared
   by a root, every ``count_launch`` caller is reached from a root, and
   every ``ops`` function the engine files call on the state is a root,
   reached from one, or in ``PROVE_EXEMPT``.

Obligation codes:

====== =======================================================
PTP001 join allowlist / sync-free run (structural pass)
PTP002 commutativity over the small lattice domain
PTP003 idempotence under duplication / round-trip stability
PTP004 monotonicity (join and take never shrink a plane)
PTP005 dtype-, shape- and device-stability of the state planes
PTP006 registration completeness (static sweep)
====== =======================================================

Findings reuse :class:`patrol_tpu_torch.analysis.lint.Finding` and its
inline suppression machinery (``# patrol-lint: disable=PTP001``), with
the stale sweep over the ``PTP`` family. Driver:
``python -m patrol_tpu_torch.scripts.prove_repo [--device cpu|cuda]``.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import inspect
import itertools
import os
import re
import sys
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from patrol_tpu_torch.analysis.lint import (
    CSRC,
    PACKAGE,
    SYNC_BOUNDARIES,
    Finding,
    Module,
    _FuncIndex,
    _is_count_launch,
    _is_cpu_branch,
    repo_cuda_sources,
    repo_sources,
)

__all__ = [
    "ProveRoot",
    "Operands",
    "prove_root",
    "prove_all",
    "prove_repo",
    "ALL_CODES",
]

# Per-root obligation codes; PTP006 is the repo-level sweep.
ALL_CODES = ("PTP001", "PTP002", "PTP003", "PTP004", "PTP005")

_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG_DIR = os.path.dirname(_ANALYSIS_DIR)
_REPO_DIR = os.path.dirname(_PKG_DIR)

# ---------------------------------------------------------------------------
# The structural pass's allowlists (aten op names without the in-place
# underscore), in code review's line of sight.

# Ops that JOIN lattice values (the whole CRDT argument).
JOIN_OPS = {"maximum", "amax", "max"}
# Reductions that join when their reduce argument is "amax".
_REDUCE_JOIN_OPS = {"scatter_reduce", "index_reduce"}

# Ops that move, reshape or select lattice values without combining them
# arithmetically (a float cast through _to_copy is flagged separately).
TRANSPARENT_OPS = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "permute",
    "transpose", "t", "squeeze", "unsqueeze", "slice", "select", "narrow",
    "index", "index_select", "gather", "cat", "stack", "clone", "contiguous",
    "_to_copy", "alias", "detach", "lift_fresh", "flip", "as_strided", "split",
    "split_with_sizes", "unbind", "chunk", "repeat", "roll",
    "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "logical_not", "where",
}
# Bitwise ops allowed on boolean values only (masks, not planes).
_BOOL_OPS = {"bitwise_and", "bitwise_or", "bitwise_not", "__and__", "__or__"}
# Overwrites: allowed when the written values are themselves
# plane-derived (a copy of lattice values), a finding otherwise.
# op → index of the written-values argument (None: a constant).
OVERWRITE_OPS: Dict[str, Optional[int]] = {
    "copy": 1, "index_put": 2, "index_copy": 3, "scatter": 3,
    "masked_scatter": 2, "slice_scatter": 1, "select_scatter": 1,
    "fill": None, "zero": None, "index_fill": None, "masked_fill": None,
}
# Ops that make a fresh tensor from a shape, reading no values.
_CREATION_OPS = {
    "zeros_like", "empty_like", "ones_like", "full_like", "new_zeros",
    "new_empty", "new_full", "new_ones", "empty", "zeros", "ones", "full",
    "arange", "scalar_tensor", "empty_strided", "new_empty_strided",
    "is_same_size", "_has_compatible_shallow_copy_type", "record_stream",
}
# Ops that make the host wait on the device (or read a device value).
SYNC_OPS = {
    "_local_scalar_dense": ".item() / int() / float() / bool() of a tensor",
    "is_nonzero": "bool() of a tensor",
    "nonzero": "nonzero",
    "masked_select": "masked_select",
    "_unique2": "unique",
    "unique_dim": "unique",
    "unique_consecutive": "unique_consecutive",
    "equal": "torch.equal",
}
# The sign-bit flip (xor with INT64_MIN) maps unsigned order onto signed
# order: merge_dense's u64 max goes through it, as the reference's
# bitcast_convert_type did.
_I64_MIN = -(2**63)


def _op_name(func) -> str:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    return name


# ---------------------------------------------------------------------------
# Registry types. The registry itself (PROVE_ROOTS) lives next to the
# kernels in patrol_tpu_torch/ops/obligations.py.


@dataclasses.dataclass
class Operands:
    """One root's call on small tensors: ``args`` for the root, the CRDT
    state planes among them (``state_in``: the taint sources and PTP005's
    reference), and ``state_out(result)`` → the planes the call returns
    (None: a pure read, whose planes must come back unchanged)."""

    args: tuple
    state_in: tuple
    state_out: Optional[Callable[[object], tuple]] = None
    shapes_match: bool = True


@dataclasses.dataclass(frozen=True)
class ProveRoot:
    """One registered kernel root and its declared obligations.

    ``module``/``attr`` are resolved at prove time (so a monkeypatched or
    mutated kernel is what gets checked). ``structural`` selects the
    PTP001 profile (``"join"``, ``"callbacks"``, or None for host-side
    Python roots); ``model`` is the model tag; ``operands(device)``
    builds the structural run's :class:`Operands`. ``launches`` are the
    ``_build.LAUNCHES`` keys the root's run drives on the card;
    ``cuda_joins`` are ``(csrc file, join functions, plane names)`` of
    the CUDA kernel the root joins through."""

    name: str
    module: str
    attr: str
    obligations: Tuple[str, ...]
    structural: Optional[str] = None  # "join" | "callbacks" | None
    model: Optional[str] = None
    operands: Optional[Callable[[object], Operands]] = None
    launches: Tuple[str, ...] = ()
    cuda_joins: Tuple[Tuple[str, Tuple[str, ...], Tuple[str, ...]], ...] = ()

    def resolve(self) -> Callable:
        return getattr(importlib.import_module(self.module), self.attr)


@dataclasses.dataclass
class _Ctx:
    """What a model gets: the root, the resolved callable, the finding
    site, the device, and the counters it fills."""

    root: ProveRoot
    fn: Callable
    site: Tuple[str, int]
    device: object  # torch.device
    combinations: int = 0
    notes: List[str] = dataclasses.field(default_factory=list)

    def finding(self, code: str, msg: str) -> Finding:
        return Finding(code, self.site[0], self.site[1], f"[{self.root.name}] {msg}")


# ---------------------------------------------------------------------------
# Finding sites.


def _relpath(path: str) -> str:
    """Absolute → repo-relative ("patrol_tpu_torch/..."), best-effort."""
    norm = os.path.abspath(path)
    if norm.startswith(_REPO_DIR + os.sep):
        return os.path.relpath(norm, _REPO_DIR).replace(os.sep, "/")
    return norm.replace(os.sep, "/")


def _def_site(fn: Callable, root: ProveRoot) -> Tuple[str, int]:
    try:
        target = inspect.unwrap(fn)
        path = inspect.getsourcefile(target) or ""
        _, line = inspect.getsourcelines(target)
        return _relpath(path), line
    except (TypeError, OSError):
        return root.module.replace(".", "/") + ".py", 1


_TORCH_DIR: Optional[str] = None
_STDLIB_DIR = os.path.dirname(os.__file__)


def _frames():
    """Frames of the calling stack outside torch, the standard library
    and this module, innermost first."""
    global _TORCH_DIR
    if _TORCH_DIR is None:
        import torch

        _TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
    f = sys._getframe(1)
    here = os.path.abspath(__file__)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if not (fn.startswith(_TORCH_DIR) or fn.startswith(_STDLIB_DIR) or fn == here
                or f.f_code.co_filename.startswith("<frozen")):
            yield f
        f = f.f_back


# (abs path) → line ranges on which a sync is exempt on the CPU: a
# wrapper's CPU branch and the plain versions of SYNC_BOUNDARIES.
_EXEMPT_RANGES: Dict[str, List[Tuple[int, int]]] = {}


def _exempt_ranges(path: str) -> List[Tuple[int, int]]:
    if path in _EXEMPT_RANGES:
        return _EXEMPT_RANGES[path]
    rel = _relpath(path)
    ranges: List[Tuple[int, int]] = []
    if rel.startswith(PACKAGE + "/") and not rel.startswith(PACKAGE + "/analysis/"):
        try:
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
        except (OSError, SyntaxError):
            tree = None
        bounds = SYNC_BOUNDARIES.get(rel, {})
        for node in ast.walk(tree) if tree is not None else ():
            if _is_cpu_branch(node) and node.body:
                ranges.append((node.body[0].lineno, node.body[-1].end_lineno))
            elif isinstance(node, ast.FunctionDef) and node.name in bounds:
                ranges.append((node.lineno, node.end_lineno))
    _EXEMPT_RANGES[path] = ranges
    return ranges


def _sync_exempt() -> bool:
    for f in _frames():
        for lo, hi in _exempt_ranges(os.path.abspath(f.f_code.co_filename)):
            if lo <= f.f_lineno <= hi:
                return True
    return False


def _op_site(default: Tuple[str, int]) -> Tuple[str, int]:
    """The innermost frame outside torch and this module: the line of
    the program that issued the op."""
    for f in _frames():
        return _relpath(f.f_code.co_filename), f.f_lineno
    return default


# ---------------------------------------------------------------------------
# Pass 1 — the structural run.


class _Lattice:
    """The taint state and findings of one structural run."""

    def __init__(self, root: ProveRoot, site: Tuple[str, int], join: bool, cpu: bool):
        self.root = root
        self.site = site
        self.join = join
        self.cpu = cpu
        self._tainted: Dict[int, "weakref.ref"] = {}
        self.findings: List[Finding] = []
        self._seen: Set[Tuple[str, int, str]] = set()

    def taint(self, t) -> None:
        import torch

        if not isinstance(t, torch.Tensor) or self.tainted(t):
            return
        tid = id(t)
        self._tainted[tid] = weakref.ref(t, lambda _r, tid=tid: self._tainted.pop(tid, None))

    def tainted(self, t) -> bool:
        r = self._tainted.get(id(t))
        return r is not None and r() is t

    def emit(self, msg: str) -> None:
        path, line = _op_site(self.site)
        key = (path, line, msg)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding("PTP001", path, line, f"[{self.root.name}] {msg}"))

    def check(self, func, args, kwargs, out) -> None:
        import torch
        from torch.utils._pytree import tree_leaves

        name = _op_name(func)
        leaves = [x for x in tree_leaves((args, kwargs)) if isinstance(x, torch.Tensor)]
        sync = self._sync(name, args, kwargs, leaves)
        if sync is not None and not (self.cpu and _sync_exempt()):
            self.emit(
                f"host-device sync ({sync}) inside a kernel root: every engine "
                "tick would wait on the card"
            )
        hot = [t for t in leaves if self.tainted(t)]
        if not hot or not self.join:
            return
        outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        if name in _CREATION_OPS:
            return
        if name in OVERWRITE_OPS:
            dst = args[0] if args else None
            at = OVERWRITE_OPS[name]
            if name == "index_put" and (len(args) > 3 and args[3] or kwargs.get("accumulate")):
                self.emit(self._arith("index_put_ (accumulate=True: a scatter-add)"))
            elif isinstance(dst, torch.Tensor) and self.tainted(dst):
                src = args[at] if at is not None and len(args) > at else None
                if not (isinstance(src, torch.Tensor) and self.tainted(src)):
                    self.emit(
                        f"overwrite scatter ('{func.overloadpacket.__name__}') of a "
                        "merged CRDT state plane with values no join produced: "
                        "last-writer-wins loses concurrent lanes"
                    )
            for t in outs:
                self.taint(t)
            if isinstance(dst, torch.Tensor):
                self.taint(dst)
            return
        if any(t.is_floating_point() for t in outs):
            dtypes = sorted({str(t.dtype) for t in outs if t.is_floating_point()})
            self.emit(
                f"float cast ({', '.join(dtypes)}) on a nanotoken state plane "
                f"('{name}'): bit-determinism across replicas is lost (PTL004 "
                "at the op level)"
            )
        elif name in JOIN_OPS or name in TRANSPARENT_OPS:
            pass
        elif name in _REDUCE_JOIN_OPS and self._reduce(args, kwargs) == "amax":
            pass
        elif name in _BOOL_OPS and all(t.dtype == torch.bool for t in hot):
            pass
        elif name in ("bitwise_xor", "__xor__") and self._sign_flip(args):
            pass
        else:
            self.emit(self._arith(f"'{name}'"))
        for t in outs:
            self.taint(t)

    @staticmethod
    def _arith(what: str) -> str:
        return (
            f"aten op {what} outside the join allowlist consumes a merged CRDT "
            "state plane; joins must stay max-based (commutative/associative/"
            "idempotent) or convergence breaks under reordering/duplication"
        )

    @staticmethod
    def _reduce(args, kwargs):
        if "reduce" in kwargs:
            return kwargs["reduce"]
        for a in args[3:]:
            if isinstance(a, str):
                return a
        return None

    @staticmethod
    def _sign_flip(args) -> bool:
        return len(args) == 2 and not hasattr(args[1], "dtype") and args[1] == _I64_MIN

    @staticmethod
    def _sync(name: str, args, kwargs, leaves) -> Optional[str]:
        import torch

        if name in SYNC_OPS:
            return SYNC_OPS[name]
        if name in ("index", "index_put") and len(args) > 1:
            idx = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
            if any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                   for i in idx):
                return "a boolean-mask index"
        if name == "_to_copy" and leaves:
            dst = kwargs.get("device")
            if dst is not None and torch.device(dst).type == "cpu" and leaves[0].device.type != "cpu":
                return "a device-to-host copy"
        if name == "copy" and len(args) > 1:
            dst, src = args[0], args[1]
            if isinstance(src, torch.Tensor) and dst.device.type != src.device.type:
                if dst.device.type == "cpu":
                    return "a device-to-host copy"
                if not (kwargs.get("non_blocking") or (len(args) > 2 and args[2])):
                    return "a blocking host-to-device copy"
        return None


def _mode_cls():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _LatticeMode(TorchDispatchMode):
        def __init__(self, lattice: _Lattice):
            super().__init__()
            self.lattice = lattice

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            self.lattice.check(func, args, kwargs, out)
            return out

    return _LatticeMode


def _structural_run(root: ProveRoot, fn: Callable, device, site) -> Tuple[List[Finding], List[Finding]]:
    """One run of ``fn`` on the root's operands under the lattice mode →
    (PTP001 findings, PTP005 findings)."""
    import torch

    ops = root.operands(device)
    before = [t.clone() for t in ops.state_in]
    lat = _Lattice(root, site, root.structural == "join", device.type == "cpu")
    for t in ops.state_in:
        lat.taint(t)
    with _mode_cls()(lat):
        result = fn(*ops.args)
    stab: List[Finding] = []

    def bad(msg: str) -> None:
        stab.append(Finding("PTP005", site[0], site[1], f"[{root.name}] {msg}"))

    if ops.state_out is None:
        for i, (t, b) in enumerate(zip(ops.state_in, before)):
            if not torch.equal(t, b):
                bad(f"state plane {i} changed under a pure read: a probe must not "
                    "mutate limiter state")
    else:
        outs = ops.state_out(result)
        for i, out in enumerate(outs):
            ref = ops.state_in[i] if i < len(ops.state_in) else ops.state_in[-1]
            if out.is_floating_point():
                bad(f"state output {i} has float dtype {out.dtype}: nanotoken planes "
                    "must stay integral for bit-deterministic convergence")
            elif out.dtype != ref.dtype:
                bad(f"state output {i} dtype {out.dtype} != declared plane dtype {ref.dtype}")
            if ops.shapes_match and tuple(out.shape) != tuple(ref.shape):
                bad(f"state output {i} shape {tuple(out.shape)} != input plane shape "
                    f"{tuple(ref.shape)}")
            if out.device != ref.device:
                bad(f"state output {i} is on {out.device}, its plane on {ref.device}")
    return lat.findings, stab


# --- the .cu half of PTP001 ---------------------------------------------------

_CU_BAD_ATOMIC = re.compile(r"\b(atomicAdd|atomicSub|atomicExch|atomicInc|atomicDec|atomicCAS)\s*\(")
_CU_MAX = re.compile(r"\b(atomicMax|max64|smax|max)\s*\(")


def _cu_function(text: str, name: str) -> Optional[Tuple[int, int]]:
    """(start, end) offsets of the body of the device function ``name``
    in comment-blanked ``text``."""
    m = re.search(r"\b" + re.escape(name) + r"\s*\([^;{]*\)\s*(const\s*)?\{", text)
    if m is None:
        return None
    depth, i = 0, m.end() - 1
    while i < len(text):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return m.end(), i
        i += 1
    return None


def cuda_join_findings(
    root: ProveRoot, cuda_sources: Dict[str, str]
) -> List[Finding]:
    """PTP001's CUDA half: in each declared join function, no atomic
    other than ``atomicMax`` writes a plane, no store of a sum lands in a
    plane, and some max is there at all."""
    out: List[Finding] = []
    blank = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
    for fname, funcs, planes in root.cuda_joins:
        rel = f"{CSRC}/{fname}"
        src = cuda_sources.get(rel)
        if src is None:
            out.append(Finding("PTP001", rel, 1, f"[{root.name}] {fname} not found"))
            continue
        text = blank.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)), src)
        plane_re = re.compile(r"\b(" + "|".join(map(re.escape, planes)) + r")\b")
        for func in funcs:
            span = _cu_function(text, func)

            def line_of(off: int) -> int:
                return text.count("\n", 0, off) + 1

            if span is None:
                out.append(Finding("PTP001", rel, 1,
                                   f"[{root.name}] join function {func}() not found in {fname}"))
                continue
            lo, hi = span
            body = text[lo:hi]
            for m in _CU_BAD_ATOMIC.finditer(body):
                close = body.find(";", m.end())
                if plane_re.search(body[m.end():close]):
                    out.append(Finding(
                        "PTP001", rel, line_of(lo + m.start()),
                        f"[{root.name}] {m.group(1)}() on a merged plane in {func}(): "
                        "a CUDA join is atomicMax (RED.E.MAX.S64) or a store of a max",
                    ))
            for m in re.finditer(r"([^;{}]*?)(\+=|-=|(?<![=!<>+\-*/])=(?!=))([^;]*);", body):
                lhs, op, rhs = m.group(1), m.group(2), m.group(3)
                if not plane_re.search(lhs) or re.search(r"\b(const\s+)?(long|int|auto|longlong2|int4)\b", lhs):
                    continue
                if op != "=" or (re.search(r"[^+\-][+\-][^+\-=>]", rhs) and not _CU_MAX.search(rhs)):
                    out.append(Finding(
                        "PTP001", rel, line_of(lo + m.start(2)),
                        f"[{root.name}] a store of a sum into a merged plane in {func}(): "
                        "a CUDA join is atomicMax (RED.E.MAX.S64) or a store of a max",
                    ))
            if not _CU_MAX.search(body) and not re.search(r"\bmax\w*\(", body):
                out.append(Finding(
                    "PTP001", rel, line_of(lo),
                    f"[{root.name}] join function {func}() holds no max",
                ))
    return out


# ---------------------------------------------------------------------------
# Pass 2 — the small-domain models. Helpers shared by all of them.

_CHUNK = 65536


def _torch():
    import torch

    return torch


def _dev(a: np.ndarray, device):
    """A fresh tensor on ``device`` holding ``a`` (always a copy: the
    kernels write in place, and the models keep their inputs)."""
    return _torch().from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _grid(*groups: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Cross product over groups of co-indexed arrays (a group's arrays
    stay paired) → the flattened per-array views, in order."""
    sizes = [len(g[0]) for g in groups]
    idx = np.meshgrid(*[np.arange(s) for s in sizes], indexing="ij")
    idx = [i.reshape(-1) for i in idx]
    out: List[np.ndarray] = []
    for g, i in zip(groups, idx):
        out.extend(a[i] for a in g)
    return out


def _first_bad(eq_mask: np.ndarray) -> Optional[int]:
    bad = np.flatnonzero(~eq_mask)
    return int(bad[0]) if len(bad) else None


def _states_eq(a, b) -> np.ndarray:
    pn_eq = (a[0] == b[0]).reshape(len(a[0]), -1).all(axis=1)
    el_eq = (a[1] == b[1]).reshape(len(a[1]), -1).all(axis=1)
    return pn_eq & el_eq


def _states_ge(a, b) -> np.ndarray:
    pn_ge = (a[0] >= b[0]).reshape(len(a[0]), -1).all(axis=1)
    el_ge = (a[1] >= b[1]).reshape(len(a[1]), -1).all(axis=1)
    return pn_ge & el_ge


@dataclasses.dataclass
class JoinDomain:
    """The tiny lattice domain a batched-join model enumerates: B×N state,
    single-delta batches over (row, slot, added, taken, elapsed)."""

    B: int = 2
    N: int = 2
    vals: Tuple[int, ...] = (0, 1, 3)
    pair_vals: Tuple[int, ...] = (0, 3)

    def deltas(self, vals) -> np.ndarray:
        """→ int64[M, 5] rows of (row, slot, a, t, e)."""
        return np.array(
            list(itertools.product(range(self.B), range(self.N), vals, vals, vals)), np.int64
        )

    def states(self, vals) -> Tuple[np.ndarray, np.ndarray]:
        """Zero, top, and every single-delta image of zero. →
        (pn[M,B,N,2], el[M,B])."""
        top = max(vals)
        pns = [np.zeros((self.B, self.N, 2), np.int64),
               np.full((self.B, self.N, 2), top, np.int64)]
        els = [np.zeros(self.B, np.int64), np.full(self.B, top, np.int64)]
        for r, s, a, t, e in self.deltas(vals):
            pn = np.zeros((self.B, self.N, 2), np.int64)
            pn[r, s, 0], pn[r, s, 1] = a, t
            el = np.zeros(self.B, np.int64)
            el[r] = e
            pns.append(pn)
            els.append(el)
        pn_arr, el_arr = np.stack(pns), np.stack(els)
        flat = np.concatenate([pn_arr.reshape(len(pn_arr), -1), el_arr], axis=1)
        _, keep = np.unique(flat, axis=0, return_index=True)
        keep.sort()
        return pn_arr[keep], el_arr[keep]


def _run_states(
    ctx: _Ctx, S_pn: np.ndarray, S_el: np.ndarray, reqs: np.ndarray,
    row_cols: Sequence[int], step: Callable,
) -> List[np.ndarray]:
    """Apply ``step`` to every combination, a chunk at a time: the
    combinations' states stack into one state ``[m·B, N, 2]`` and each
    request's row columns are offset onto its own B rows. ``step(state,
    reqs_chunk)`` → (state, *extras with leading dim m) as tensors. →
    [pn[M,B,N,2], el[M,B], *extras] as numpy."""
    from patrol_tpu_torch.models.limiter import LimiterState

    M, B = S_el.shape
    N = S_pn.shape[2]
    parts: List[List[np.ndarray]] = []
    for lo in range(0, M, _CHUNK):
        hi = min(M, lo + _CHUNK)
        m = hi - lo
        pn = _dev(S_pn[lo:hi].reshape(m * B, N, 2), ctx.device)
        el = _dev(S_el[lo:hi].reshape(m * B), ctx.device)
        r = reqs[lo:hi].copy()
        off = np.arange(m, dtype=np.int64) * B
        for c in row_cols:
            r[:, c] += off
        res = step(LimiterState(pn, el), r)
        st, extras = res[0], res[1:]
        chunk = [_np(st.pn).reshape(m, B, N, 2), _np(st.elapsed).reshape(m, B)]
        chunk += [_np(x) for x in extras]
        parts.append(chunk)
    ctx.combinations += M
    return [np.concatenate([p[i] for p in parts]) for i in range(len(parts[0]))]


def _fmt_delta(d) -> str:
    return f"(row={d[0]}, slot={d[1]}, a={d[2]}, t={d[3]}, e={d[4]})"


# --- join adapters: [m, 5] deltas (rows already offset) → a kernel's batch.


def _col(d: np.ndarray, i: int, device):
    return _dev(d[:, i].astype(np.int64), device)


def _as_merge_batch(d, device, n):
    from patrol_tpu_torch.ops.merge import MergeBatch

    return MergeBatch(*(_col(d, i, device) for i in range(5)))


def _as_folded_batch(d, device, n):
    from patrol_tpu_torch.ops.merge import FoldedMergeBatch

    return FoldedMergeBatch(
        _col(d, 0, device), _col(d, 1, device), _col(d, 2, device), _col(d, 3, device),
        _col(d, 0, device), _col(d, 4, device),
    )


def _as_rows_dense(d, device, n):
    from patrol_tpu_torch.ops.merge import RowDenseBatch

    upd = np.zeros((len(d), n, 2), np.int64)
    upd[np.arange(len(d)), d[:, 1], 0] = d[:, 2]
    upd[np.arange(len(d)), d[:, 1], 1] = d[:, 3]
    return RowDenseBatch(_col(d, 0, device), _dev(upd, device), _col(d, 4, device))


def _as_commit_blocks(d, device, n):
    # One block of m pairs: the m combinations' rows ascend, so the flat
    # view is sorted and unique, as the ring's contract says.
    packed = np.stack([d[:, 0], d[:, 1], d[:, 2], d[:, 3], d[:, 0], d[:, 4]])[:, None, :]
    return _dev(packed.astype(np.int64), device)


def _as_delta_batch(d, device, n):
    from patrol_tpu_torch.ops.delta import DeltaBatch

    return DeltaBatch(*(_col(d, i, device) for i in range(5)))


JOIN_BATCH_ADAPTERS: Dict[str, Callable] = {
    "merge_batch": _as_merge_batch,
    "folded": _as_folded_batch,
    "rows_dense": _as_rows_dense,
    "commit_blocks": _as_commit_blocks,
    "delta_fold": _as_delta_batch,
}


def _model_join_batch(ctx: _Ctx, as_batch: Callable, domain: Optional[JoinDomain] = None) -> List[Finding]:
    """Single-delta batched joins: idempotence under duplication,
    monotonicity, commutativity, bit-exact over the enumerated domain."""
    dom = domain or JoinDomain()
    obl = ctx.root.obligations
    findings: List[Finding] = []

    def step(st, d):
        return (ctx.fn(st, as_batch(d, ctx.device, dom.N)),)

    def apply(S_pn, S_el, D):
        return _run_states(ctx, S_pn, S_el, D, (0,), step)

    if "PTP003" in obl or "PTP004" in obl:
        pn0, el0 = dom.states(dom.vals)
        S_pn, S_el, D = _grid((pn0, el0), (dom.deltas(dom.vals),))
        once = apply(S_pn, S_el, D)
        if "PTP003" in obl:
            twice = apply(once[0], once[1], D)
            i = _first_bad(_states_eq(twice, once))
            if i is not None:
                findings.append(ctx.finding(
                    "PTP003", f"join is not idempotent: re-applying delta {_fmt_delta(D[i])} "
                    "moved the state again (duplicated packets would diverge replicas)"))
        if "PTP004" in obl:
            i = _first_bad(_states_ge(once, (S_pn, S_el)))
            if i is not None:
                findings.append(ctx.finding(
                    "PTP004", f"join is not monotone: applying delta {_fmt_delta(D[i])} shrank "
                    "a state plane (a replayed stale delta could roll back converged state)"))
    if "PTP002" in obl:
        pn0, el0 = dom.states(dom.pair_vals)
        deltas = dom.deltas(dom.pair_vals)
        S_pn, S_el, D1, D2 = _grid((pn0, el0), (deltas,), (deltas,))
        ab = apply(S_pn, S_el, D1)
        ab = apply(ab[0], ab[1], D2)
        ba = apply(S_pn, S_el, D2)
        ba = apply(ba[0], ba[1], D1)
        i = _first_bad(_states_eq(ab, ba))
        if i is not None:
            findings.append(ctx.finding(
                "PTP002", f"join does not commute: deltas {_fmt_delta(D1[i])} then "
                f"{_fmt_delta(D2[i])} != the reverse order (replicas receiving different "
                "delivery orders would diverge)"))
    return findings


def _enum_states(vals, B: int = 1, N: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    elems = B * N * 2 + B
    combos = np.array(list(itertools.product(vals, repeat=elems)), np.int64)
    return combos[:, : B * N * 2].reshape(-1, B, N, 2), combos[:, B * N * 2:].reshape(-1, B)


def _model_dense_join(ctx: _Ctx) -> List[Finding]:
    """Full-state binary join: commutativity, associativity, idempotence,
    monotonicity over an exhaustive tiny state space."""
    from patrol_tpu_torch.models.limiter import LimiterState

    obl = ctx.root.obligations
    findings: List[Finding] = []

    def app(pa, ea, pb, eb):
        out = []
        for lo in range(0, len(pa), _CHUNK):
            hi = lo + _CHUNK
            m = len(pa[lo:hi])
            a = LimiterState(_dev(pa[lo:hi].reshape(m, -1, 2), ctx.device),
                             _dev(ea[lo:hi].reshape(m), ctx.device))
            b = LimiterState(_dev(pb[lo:hi].reshape(m, -1, 2), ctx.device),
                             _dev(eb[lo:hi].reshape(m), ctx.device))
            r = ctx.fn(a, b)
            out.append((_np(r.pn).reshape(pa[lo:hi].shape), _np(r.elapsed).reshape(m, 1)))
        ctx.combinations += len(pa)
        return np.concatenate([o[0] for o in out]), np.concatenate([o[1] for o in out])

    pn0, el0 = _enum_states((0, 1, 3))
    A_pn, A_el, B_pn, B_el = _grid((pn0, el0), (pn0, el0))
    ab = app(A_pn, A_el, B_pn, B_el)
    if "PTP002" in obl:
        ba = app(B_pn, B_el, A_pn, A_el)
        i = _first_bad(_states_eq(ab, ba))
        if i is not None:
            findings.append(ctx.finding(
                "PTP002", f"dense join does not commute: merge(a, b) != merge(b, a) at "
                f"pn_a={A_pn[i].ravel().tolist()}, pn_b={B_pn[i].ravel().tolist()}"))
    if "PTP003" in obl:
        aa = app(pn0, el0, pn0, el0)
        i = _first_bad(_states_eq(aa, (pn0, el0)))
        if i is not None:
            findings.append(ctx.finding(
                "PTP003", f"dense join is not idempotent: merge(a, a) != a at "
                f"pn_a={pn0[i].ravel().tolist()} (anti-entropy replays would inflate state)"))
    if "PTP004" in obl:
        i = _first_bad(_states_ge(ab, (A_pn, A_el)) & _states_ge(ab, (B_pn, B_el)))
        if i is not None:
            findings.append(ctx.finding(
                "PTP004", "dense join is not monotone (not an upper bound of its inputs) at "
                f"pn_a={A_pn[i].ravel().tolist()}, pn_b={B_pn[i].ravel().tolist()}"))
    if "PTP002" in obl:
        pn2, el2 = _enum_states((0, 3))
        A_pn, A_el, B_pn, B_el, C_pn, C_el = _grid((pn2, el2), (pn2, el2), (pn2, el2))
        ab = app(A_pn, A_el, B_pn, B_el)
        ab_c = app(ab[0], ab[1], C_pn, C_el)
        bc = app(B_pn, B_el, C_pn, C_el)
        a_bc = app(A_pn, A_el, bc[0], bc[1])
        i = _first_bad(_states_eq(ab_c, a_bc))
        if i is not None:
            findings.append(ctx.finding(
                "PTP002", "dense join is not associative: merge(merge(a,b),c) != "
                f"merge(a,merge(b,c)) at pn_a={A_pn[i].ravel().tolist()}, "
                f"pn_b={B_pn[i].ravel().tolist()}, pn_c={C_pn[i].ravel().tolist()}"))
    return findings


def _tree_stack_app(ctx: _Ctx, S_pn: np.ndarray, S_el: np.ndarray):
    """``tree_reduce_states(pn[R, B', N, 2], el[R, B'])`` over every stack
    at once: the M stacks lie side by side along the bucket dim."""
    M, R, B, N, _ = S_pn.shape
    pn = _dev(S_pn.transpose(1, 0, 2, 3, 4).reshape(R, M * B, N, 2), ctx.device)
    el = _dev(S_el.transpose(1, 0, 2).reshape(R, M * B), ctx.device)
    out = ctx.fn(pn, el)
    return _np(out.pn).reshape(M, B, N, 2), _np(out.elapsed).reshape(M, B)


def _converge_rows_app(ctx: _Ctx, S_pn: np.ndarray, S_el: np.ndarray):
    """The converge kernel over every stack at once: T = M·B canonical
    rows, each stack's R copies in the scratch ``spn[R, T, N, 2]``."""
    torch = _torch()
    M, R, B, N, _ = S_pn.shape
    T = M * B
    spn = _dev(S_pn.transpose(1, 0, 2, 3, 4).reshape(R, T, N, 2), ctx.device)
    sel = _dev(S_el.transpose(1, 0, 2).reshape(R, T), ctx.device)
    pn = torch.zeros((T, N, 2), dtype=torch.int64, device=ctx.device)
    el = torch.zeros((T,), dtype=torch.int64, device=ctx.device)
    rows = torch.arange(T, dtype=torch.int64, device=ctx.device)
    ctx.fn(pn, el, rows, spn, sel)
    return _np(pn).reshape(M, B, N, 2), _np(el).reshape(M, B)


def _model_tree_converge(ctx: _Ctx, app: Callable = _tree_stack_app) -> List[Finding]:
    """The converge of R replica states, for R power-of-two and ragged:
    equal to the flat elementwise max (PTP002), invariant under leaf
    permutation (PTP002), absorbing a duplicated leaf (PTP003), an upper
    bound of every leaf (PTP004)."""
    obl = ctx.root.obligations
    findings: List[Finding] = []
    pn0, el0 = _enum_states((0, 1, 3))
    M = len(pn0)

    def run(spn, sel):
        ctx.combinations += len(spn)
        return app(ctx, spn, sel)

    for R in (2, 3, 4, 8):
        idx = (np.arange(M)[:, None] + np.arange(R)[None, :]) % M
        S_pn, S_el = pn0[idx], el0[idx]
        want = (S_pn.max(axis=1), S_el.max(axis=1))
        got = run(S_pn, S_el)
        if "PTP002" in obl:
            i = _first_bad(_states_eq(got, want))
            if i is not None:
                findings.append(ctx.finding(
                    "PTP002", f"tree converge diverges from the flat join at R={R}: reducing "
                    f"pn={S_pn[i].reshape(R, -1).tolist()} != the elementwise max (replicas "
                    "on different reduction paths would disagree)"))
            perm = np.roll(np.arange(R), 1)
            got_p = run(S_pn[:, perm], S_el[:, perm])
            i = _first_bad(_states_eq(got_p, got))
            if i is not None:
                findings.append(ctx.finding(
                    "PTP002", f"tree converge is leaf-order dependent at R={R}: permuting the "
                    "replica stack changed the join (reduction-tree shape must not matter)"))
        if "PTP003" in obl:
            got_d = run(np.concatenate([S_pn, S_pn[:, :1]], axis=1),
                        np.concatenate([S_el, S_el[:, :1]], axis=1))
            i = _first_bad(_states_eq(got_d, want))
            if i is not None:
                findings.append(ctx.finding(
                    "PTP003", f"tree converge is not idempotent under a duplicated leaf at "
                    f"R={R}+1 (a replica heard twice would inflate the join)"))
        if "PTP004" in obl:
            ok_pn = (got[0][:, None] >= S_pn).all(axis=(1, 2, 3, 4))
            ok_el = (got[1][:, None] >= S_el).all(axis=(1, 2))
            i = _first_bad(ok_pn & ok_el)
            if i is not None:
                findings.append(ctx.finding(
                    "PTP004", f"tree converge is not an upper bound of its replica inputs at "
                    f"R={R} (converge rolled a replica's state back down the lattice)"))
    return findings


def _model_converge_rows(ctx: _Ctx) -> List[Finding]:
    return _model_tree_converge(ctx, _converge_rows_app)


def _take_reqs(nreqs) -> np.ndarray:
    from patrol_tpu_torch.models.limiter import NANO

    return np.array(
        [
            (row, now, freq, per, count, nreq, cap, created)
            for row in (0, 1)
            for now in (0, NANO, 3 * NANO)
            for freq in (0, 2)
            for per in (0, NANO)
            for count in (0, NANO)
            for nreq in nreqs
            for cap in (0, 2 * NANO)
            for created in (0, NANO)
        ],
        np.int64,
    )


def _locality(out_pn, S_pn, node_slot: int) -> np.ndarray:
    other = np.ones(S_pn.shape[2], bool)
    other[node_slot] = False
    return (out_pn[:, :, other] == S_pn[:, :, other]).reshape(len(S_pn), -1).all(axis=1)


def _model_take_monotone(ctx: _Ctx) -> List[Finding]:
    """PTP004 for the take: lanes and elapsed only grow, and only the own
    lane moves, over a grid of states × requests."""
    from patrol_tpu_torch.models.limiter import NANO
    from patrol_tpu_torch.ops.take import TakeRequest

    findings: List[Finding] = []
    node_slot = 0
    dom = JoinDomain(B=2, N=2, vals=(0, NANO, 3 * NANO))
    pn0, el0 = dom.states(dom.vals)
    S_pn, S_el, R = _grid((pn0, el0), (_take_reqs((0, 2)),))

    def step(st, r):
        req = TakeRequest(*(_dev(r[:, i], ctx.device) for i in range(8)))
        out, _res = ctx.fn(st, req, node_slot)
        return (out,)

    out = _run_states(ctx, S_pn, S_el, R, (0,), step)
    i = _first_bad(_states_ge(out, (S_pn, S_el)))
    if i is not None:
        findings.append(ctx.finding(
            "PTP004", f"take shrank a state plane at request {R[i].tolist()}: lanes must stay "
            "monotone G-counters or max-joins resurrect forfeited tokens"))
    i = _first_bad(_locality(out[0], S_pn, node_slot))
    if i is not None:
        findings.append(ctx.finding(
            "PTP004", f"take wrote a PN lane other than its own (node_slot={node_slot}) at "
            f"request {R[i].tolist()}: remote lanes may change only by max-merge"))
    return findings


def _model_take_n_laws(ctx: _Ctx) -> List[Finding]:
    """The coalesced take-n: one row with ``nreq = n`` commits and admits
    what n unit takes at the same timestamp do, replayed on the
    registered per-ticket kernel (PTP002); a fully denied row commits
    nothing (PTP003); monotone lanes and own-lane locality (PTP004)."""
    from patrol_tpu_torch.models.limiter import NANO
    from patrol_tpu_torch.ops.take import take_n_batch as reference_take_n

    torch = _torch()
    obl = ctx.root.obligations
    findings: List[Finding] = []
    node_slot = 0
    max_n = 3
    dom = JoinDomain(B=2, N=2, vals=(0, NANO, 3 * NANO))
    pn0, el0 = dom.states(dom.vals)
    S_pn, S_el, R = _grid((pn0, el0), (_take_reqs((0, 1, max_n)),))

    def step(st, r):
        from patrol_tpu_torch.models.limiter import LimiterState

        seq = LimiterState(st.pn.clone(), st.elapsed.clone())
        packed = _dev(r.T, ctx.device)
        b_state, b_out = ctx.fn(st, packed.clone(), node_slot)
        adm = torch.zeros(len(r), dtype=torch.int64, device=ctx.device)
        for j in range(max_n):
            unit = packed.clone()
            unit[5] = (packed[5] > j).to(torch.int64)
            seq, s_out = reference_take_n(seq, unit, node_slot)
            adm += s_out[1]
        return b_state, b_out[1], seq.pn, seq.elapsed, adm

    b_pn, b_el, b_adm, s_pn, s_el, s_adm = _run_states(ctx, S_pn, S_el, R, (0,), step)
    s_pn = s_pn.reshape(b_pn.shape)
    s_el = s_el.reshape(b_el.shape)
    if "PTP002" in obl:
        i = _first_bad(_states_eq((b_pn, b_el), (s_pn, s_el)) & (b_adm == s_adm))
        if i is not None:
            findings.append(ctx.finding(
                "PTP002", f"coalesced take-n diverges from the sequential replay at request "
                f"{R[i].tolist()}: one row with nreq=n must commit exactly what n unit takes "
                f"at the same timestamp commit (admitted {int(b_adm[i])} vs {int(s_adm[i])})"))
    if "PTP003" in obl:
        moved = ~_states_eq((b_pn, b_el), (S_pn, S_el))
        i = _first_bad(~((b_adm == 0) & moved))
        if i is not None:
            findings.append(ctx.finding(
                "PTP003", f"a fully denied row mutated state at request {R[i].tolist()}: "
                "denies must be a fixpoint or a replayed deny storm drifts the bucket"))
    if "PTP004" in obl:
        i = _first_bad(_states_ge((b_pn, b_el), (S_pn, S_el)))
        if i is not None:
            findings.append(ctx.finding(
                "PTP004", f"take-n shrank a state plane at request {R[i].tolist()}: lanes "
                "must stay monotone G-counters or max-joins resurrect forfeited tokens"))
        i = _first_bad(_locality(b_pn, S_pn, node_slot))
        if i is not None:
            findings.append(ctx.finding(
                "PTP004", f"take-n wrote a PN lane other than its own (node_slot={node_slot}) "
                f"at request {R[i].tolist()}: remote lanes change only by merge"))
    return findings


def _model_take_split_fifo(ctx: _Ctx) -> List[Finding]:
    """The host-side grant split: FIFO first-k-of-m against a sequential
    ledger (PTP002); a deny storm hands every ticket the same untouched
    balance (PTP003)."""
    from patrol_tpu_torch.models.limiter import NANO

    findings: List[Finding] = []
    want_002 = "PTP002" in ctx.root.obligations
    want_003 = "PTP003" in ctx.root.obligations
    for have in (-NANO, 0, NANO // 2, NANO, 2 * NANO, 3 * NANO, 5 * NANO + 7):
        for count in (NANO, 2 * NANO):
            for nreq in range(5):
                for admitted in range(nreq + 1):
                    ctx.combinations += 1
                    got = [(int(r), bool(ok)) for r, ok in ctx.fn(have, admitted, count, nreq)]
                    bal, want = have, []
                    for _ in range(admitted):
                        bal -= count
                        want.append((max(bal, 0) // NANO, True))
                    post = max(have - admitted * count, 0) // NANO
                    want.extend((post, False) for _ in range(admitted, nreq))
                    if want_002 and got != want:
                        findings.append(ctx.finding(
                            "PTP002", "grant split diverges from the FIFO first-k-of-m ledger "
                            f"at (have={have}, admitted={admitted}, count={count}, "
                            f"nreq={nreq}): got {got}, sequential replay says {want}"))
                        want_002 = False
                    if want_003 and admitted == 0 and nreq > 0:
                        fixed = (max(have, 0) // NANO, False)
                        if any(entry != fixed for entry in got):
                            findings.append(ctx.finding(
                                "PTP003", f"deny storm drifted the reported balance at "
                                f"(have={have}, count={count}, nreq={nreq}): every denied "
                                f"ticket must see {fixed}, got {got}"))
                            want_003 = False
    return findings


def _model_scalar_monotone(ctx: _Ctx) -> List[Finding]:
    """PTP004 for the deficit-attribution merge: monotone, and only the
    sender's (row, slot) cell moves."""
    from patrol_tpu_torch.ops.merge import MergeBatch

    findings: List[Finding] = []
    dom = JoinDomain(B=2, N=2, vals=(0, 1, 3))
    pn0, el0 = dom.states(dom.vals)
    S_pn, S_el, D = _grid((pn0, el0), (dom.deltas(dom.vals),))

    def step(st, d):
        return (ctx.fn(st, MergeBatch(*(_col(d, i, ctx.device) for i in range(5)))),)

    out = _run_states(ctx, S_pn, S_el, D, (0,), step)
    i = _first_bad(_states_ge(out, (S_pn, S_el)))
    if i is not None:
        findings.append(ctx.finding(
            "PTP004", f"scalar merge shrank a state plane at delta {_fmt_delta(D[i])}"))
    moved = out[0] != S_pn
    own = np.zeros_like(moved)
    own[np.arange(len(D)), D[:, 0], D[:, 1], :] = True
    i = _first_bad(~(moved & ~own).reshape(len(D), -1).any(axis=1))
    if i is not None:
        findings.append(ctx.finding(
            "PTP004", f"scalar merge wrote a PN cell other than the sender's "
            f"(row={D[i][0]}, slot={D[i][1]})"))
    return findings


def _model_lifecycle_iszero(ctx: _Ctx) -> List[Finding]:
    """The lifecycle conservation suite: a "full" verdict is sound (a
    take against the re-created row sees what the original row gives,
    through the registered take, PTP002); the verdict is monotone in time
    (PTP004); zero is the join's bottom and the verdict is stable under
    self-join (PTP003)."""
    from patrol_tpu_torch.models.limiter import NANO, LimiterState
    from patrol_tpu_torch.ops.lifecycle import LifecycleProbe
    from patrol_tpu_torch.ops.merge import merge_dense
    from patrol_tpu_torch.ops.take import TakeRequest, take_batch

    torch = _torch()
    obl = ctx.root.obligations
    findings: List[Finding] = []
    node_slot = 0
    dom = JoinDomain(B=2, N=2, vals=(0, NANO, 3 * NANO))
    pn0, el0 = dom.states(dom.vals)
    probes = np.array(
        [
            (row, now, per, cap, created)
            for row in (0, 1)
            for now in (0, NANO, 4 * NANO)
            for per in (0, NANO)
            for cap in (0, NANO, 2 * NANO)
            for created in (0, NANO)
        ],
        np.int64,
    )
    S_pn, S_el, P = _grid((pn0, el0), (probes,))

    def verdict(spn, sel, p):
        def step(st, q):
            view = ctx.fn(st, LifecycleProbe(*(_dev(q[:, i], ctx.device) for i in range(5))),
                          node_slot)
            return st, view.full.to(torch.bool)

        return _run_states(ctx, spn, sel, p, (0,), step)[2].astype(bool)

    full = verdict(S_pn, S_el, P)

    def fmt(i) -> str:
        p = P[i]
        return (f"(row={p[0]}, now={p[1]}, per={p[2]}, cap={p[3]}, created={p[4]}, "
                f"pn={S_pn[i].ravel().tolist()}, el={S_el[i].ravel().tolist()})")

    if "PTP002" in obl and full.any():
        sel = np.flatnonzero(full)

        def take_have(spn, sel_el, p, off, created):
            q = np.concatenate([p, off[:, None], created[:, None]], axis=1)

            def step(st, r):
                req = TakeRequest(
                    rows=_dev(r[:, 0], ctx.device),
                    now_ns=_dev(r[:, 1] + r[:, 5], ctx.device),
                    freq=_dev(r[:, 3] // NANO, ctx.device),
                    per_ns=_dev(r[:, 2], ctx.device),
                    count_nt=_dev(np.full(len(r), NANO, np.int64), ctx.device),
                    nreq=_dev(np.full(len(r), 2, np.int64), ctx.device),
                    cap_base_nt=_dev(r[:, 3], ctx.device),
                    created_ns=_dev(r[:, 6], ctx.device),
                )
                _, res = take_batch(st, req, node_slot)
                return st, res.have_nt, res.admitted

            out = _run_states(ctx, spn, sel_el, q, (0,), step)
            return out[2], out[3]

        for off in (0, NANO):
            offs = np.full(len(sel), off, np.int64)
            h_old = take_have(S_pn[sel], S_el[sel], P[sel], offs, P[sel][:, 4])
            h_new = take_have(np.zeros_like(S_pn[sel]), np.zeros_like(S_el[sel]), P[sel], offs,
                              P[sel][:, 1])
            i = _first_bad((h_old[0] == h_new[0]) & (h_old[1] == h_new[1]))
            if i is not None:
                findings.append(ctx.finding(
                    "PTP002", f"IsZero verdict is unsound at {fmt(sel[i])}+{off}ns: a take "
                    f"against the reclaimed-and-recreated row gives (have={h_new[0][i]}, "
                    f"admitted={h_new[1][i]}) but the original row gives (have="
                    f"{h_old[0][i]}, admitted={h_old[1][i]}) — reclaiming here loses admitted "
                    "tokens (or invents new ones)"))
                break
    if "PTP004" in obl:
        for off in (1, NANO, 16 * NANO):
            P2 = P.copy()
            P2[:, 1] += off
            full2 = verdict(S_pn, S_el, P2)
            i = _first_bad(~(full & ~full2))
            if i is not None:
                findings.append(ctx.finding(
                    "PTP004", f"IsZero verdict is not monotone in time at {fmt(i)}: full now "
                    f"but not full {off}ns later with no new spend — a delayed sweep would "
                    "wrongly keep (or wrongly drop) the bucket"))
                break
    if "PTP003" in obl:
        a = LimiterState(_dev(pn0.reshape(-1, 2, 2), ctx.device), _dev(el0.reshape(-1), ctx.device))
        z = LimiterState(torch.zeros_like(a.pn), torch.zeros_like(a.elapsed))
        back = merge_dense(z, a)
        ctx.combinations += len(pn0)
        i = _first_bad(_states_eq((_np(back.pn).reshape(pn0.shape), _np(back.elapsed).reshape(el0.shape)),
                                  (pn0, el0)))
        if i is not None:
            findings.append(ctx.finding(
                "PTP003", f"zero lanes are not the join's bottom at pn={pn0[i].ravel().tolist()}: "
                "a reclaimed bucket re-entering via the max-lattice join would not reconstruct "
                "the peer's view exactly"))
        s = LimiterState(_dev(S_pn.reshape(-1, 2, 2), ctx.device), _dev(S_el.reshape(-1), ctx.device))
        joined = merge_dense(LimiterState(s.pn.clone(), s.elapsed.clone()), s)
        full_j = verdict(_np(joined.pn).reshape(S_pn.shape), _np(joined.elapsed).reshape(S_el.shape), P)
        i = _first_bad(full == full_j)
        if i is not None:
            findings.append(ctx.finding(
                "PTP003", f"IsZero verdict flips under self-join at {fmt(i)}: duplicated "
                "re-entry of the same state changed a reclaim decision"))
    return findings


def _model_rate_algebra(ctx: _Ctx) -> List[Finding]:
    """Rate algebra: tokens monotone in elapsed time (PTP004); parse of
    format is the identity (PTP003)."""
    from patrol_tpu_torch.ops import rate as rate_mod

    findings: List[Finding] = []
    if "PTP004" in ctx.root.obligations:
        d_grid = [0, 1, 2, 5, 10**6, 10**9, 2 * 10**9, 10**12]
        done = False
        for freq in (0, 1, 2, 3, 7, 50):
            for per in (0, 1, 3, 10**6, 10**9, 60 * 10**9):
                ctx.combinations += len(d_grid)
                r = rate_mod.Rate(freq=freq, per_ns=per)
                toks = [r.tokens(d) for d in d_grid]
                if any(b < a for a, b in zip(toks, toks[1:])):
                    findings.append(ctx.finding(
                        "PTP004", f"Rate({freq}:{per}ns).tokens is not monotone in elapsed time"))
                    done = True
                    break
            if done:
                break
    if "PTP003" in ctx.root.obligations:
        for freq in (0, 1, 2, 50, 10**6):
            for per in ("1s", "500ms", "1m30s", "1h", "1ns", "2h45m"):
                ctx.combinations += 1
                r = rate_mod.Rate(freq=freq, per_ns=rate_mod.parse_duration(per))
                back = rate_mod.parse_rate(str(r))
                if back != r:
                    findings.append(ctx.finding(
                        "PTP003", f"parse(format({r})) = {back}: rate round-trip is not stable"))
    return findings


def _model_wire_roundtrip(ctx: _Ctx) -> List[Finding]:
    """Wire codec: decode∘encode identity and byte-stable re-encode over
    every trailer form, and scalar/vector sanitize agreement (PTP003)."""
    import math

    from patrol_tpu_torch.ops import wire

    findings: List[Finding] = []
    NANO = wire.NANO

    def ws(**kw):
        base = dict(name="b", added=1.5, taken=0.5, elapsed_ns=7)
        base.update(kw)
        return wire.WireState(**base)

    states = []
    for name in ("", "a", "bucket-µ≠ascii"):
        for added, taken, elapsed in ((0.0, 0.0, 0), (1.5, 0.5, 7), (9.0, 2.0, -5)):
            common = dict(name=name, added=added, taken=taken, elapsed_ns=elapsed)
            states += [
                ws(**common),
                ws(**common, origin_slot=3),
                ws(**common, origin_slot=3, multi_ok=True),
                ws(**common, origin_slot=3, cap_nt=10 * NANO),
                ws(**common, origin_slot=3, cap_nt=10 * NANO, lane_added_nt=2 * NANO,
                   lane_taken_nt=NANO),
                ws(**common, origin_slot=1, cap_nt=10 * NANO,
                   lanes=((0, NANO, 0), (1, 2 * NANO, NANO)), multi_ok=True),
            ]
    for s in states:
        ctx.combinations += 1
        pkt = wire.encode(s)
        back = wire.decode(pkt)
        if back != s:
            findings.append(ctx.finding(
                "PTP003", f"decode(encode(x)) != x for {s!r}: wire round-trip must be exact "
                "or replicas fork on relay"))
            break
        if wire.encode(back) != pkt:
            findings.append(ctx.finding(
                "PTP003", f"re-encode of a decoded packet is not byte-stable for {s!r}"))
            break
    hostile = [0.0, -1.0, -0.0, 0.5, 1.5, 1e30, float("inf"), float("-inf"), float("nan"),
               float(2**53), 9.3e9, 1e-12, (1 << 62) / NANO]
    vec = wire.sanitize_nt_array(hostile)
    for i, v in enumerate(hostile):
        ctx.combinations += 1
        scalar = wire._sanitize_nt(v)
        if int(vec[i]) != scalar:
            shown = "nan" if math.isnan(v) else repr(v)
            findings.append(ctx.finding(
                "PTP003", f"sanitize divergence at {shown}: scalar={scalar} vector="
                f"{int(vec[i])} — native-rx and python-rx peers would merge the same packet "
                "differently"))
            break
    return findings


def _model_delta_roundtrip(ctx: _Ctx) -> List[Finding]:
    """Wire-v2 delta codec: decode∘encode identity, byte-stable
    re-encode, every truncation rejected, every byte flip detected
    (PTP003)."""
    from patrol_tpu_torch.ops import wire

    findings: List[Finding] = []

    def bad(msg: str) -> None:
        findings.append(ctx.finding("PTP003", msg))

    big = (1 << 62) + 7
    names = ["", "a", "bucket-µ≠ascii", "x" * 200]
    entries = [
        wire.DeltaEntry(n, s, c, a, t, e)
        for n in names
        for s in (0, 3)
        for c, a, t, e in ((0, 0, 0, 0), (big, 1, 2, 3), (5, big, big, big))
    ]
    cases = [
        (0, (), ()),
        (1, (1, 2, 3), tuple(entries[:4])),
        (0xFFFFFFFF, tuple(range(100, 132)), tuple(entries)),
        (7, (), tuple(entries[:1])),
    ]
    for seq, acks, ents in cases:
        ctx.combinations += 1
        pkt, n = ctx.fn(3, seq, acks, ents)
        back = wire.decode_delta_packet(pkt)
        if back is None:
            bad(f"decode(encode(...)) rejected a legal interval (seq={seq})")
            break
        expect = wire.DeltaPacket(3, seq, tuple(acks)[: wire.DELTA_MAX_ACKS], tuple(ents[:n]))
        if back != expect:
            bad(f"decode(encode(x)) != x at seq={seq}: interval round-trip must be exact or "
                "replicas fork on relay")
            break
        repkt, _ = ctx.fn(back.sender_slot, back.seq, back.acks, back.entries)
        if repkt != pkt:
            bad(f"re-encode of a decoded interval is not byte-stable (seq={seq})")
            break
    if not findings:
        pkt, n = ctx.fn(1, 9, (4, 5), tuple(entries[:6]))
        for i in range(len(pkt)):
            ctx.combinations += 1
            if wire.decode_delta_packet(pkt[:i]) is not None:
                bad(f"truncation to {i} bytes decoded as a valid interval")
                break
        for i in range(len(pkt)):
            ctx.combinations += 1
            flipped = bytearray(pkt)
            flipped[i] ^= 0x41
            if wire.decode_delta_packet(bytes(flipped)) is not None:
                bad(f"byte flip at offset {i} went undetected")
                break
    return findings


def _model_raw_ingest(ctx: _Ctx) -> List[Finding]:
    """The raw-plane decode+fold against the Python wire decoder and a
    reference join over real dv2 bytes: agreement and packet-order
    commutativity (PTP002), duplicated-plane idempotence and strict
    all-or-nothing corruption rejection (PTP003), monotonicity (PTP004)."""
    from patrol_tpu_torch.models.limiter import LimiterState
    from patrol_tpu_torch.ops import ingest as ingest_ops
    from patrol_tpu_torch.ops import wire

    torch = _torch()
    obl = ctx.root.obligations
    findings: List[Finding] = []

    def bad(code: str, msg: str) -> None:
        findings.append(ctx.finding(code, msg))

    B, N, ROW = 8, 2, 512
    E = ingest_ops.max_entries(ROW)
    names = ["a", "b", "", "bucket-µ"]
    name_rows = {nm: i for i, nm in enumerate(names)}
    big = (1 << 62) + 5
    ents = [
        wire.DeltaEntry(nm, s, c, a, t, e)
        for nm in names
        for s in (0, 1)
        for c, a, t, e in ((0, 0, 0, 0), (3, 1, 2, big), (5, big, 4, 1))
    ]
    pkts: List[bytes] = []
    i = 0
    while i < len(ents):
        data, k = wire.encode_delta_packet(1, len(pkts) + 1, (7,), ents[i:], max_size=ROW)
        pkts.append(data)
        i += k

    def run(packets, seed=None):
        ctx.combinations += len(packets)
        pl = np.full((len(packets), ROW), 0xA5, np.uint8)  # stale tails
        ln = np.zeros(len(packets), np.int32)
        for j, b in enumerate(packets):
            pl[j, : len(b)] = np.frombuffer(b, np.uint8)
            ln[j] = len(b)
        rws = np.full((len(packets), E), 10**9, np.int32)
        for j, b in enumerate(packets):
            pk = wire.decode_delta_packet(b)
            for k, e in enumerate(pk.entries if pk is not None else ()):
                rws[j, k] = name_rows.get(e.name, 10**9)
        walk = ingest_ops.host_walk(pl, ln)
        eoff = np.maximum(walk.name_off - 1, 0).astype(np.int32)
        spn = np.zeros((B, N, 2), np.int64) if seed is None else seed[0]
        sel = np.zeros(B, np.int64) if seed is None else seed[1]
        st = LimiterState(_dev(spn, ctx.device), _dev(sel, ctx.device))
        out = ctx.fn(st, _dev(pl, ctx.device), _dev(ln, ctx.device), _dev(eoff, ctx.device),
                     _dev(rws, ctx.device),
                     torch.zeros((len(packets), E), dtype=torch.bool, device=ctx.device))
        return (_np(out[0].pn), _np(out[0].elapsed)), _np(out[1]).astype(bool)

    def eq(a, b) -> bool:
        return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    def reference(packets):
        rpn, rel = np.zeros((B, N, 2), np.int64), np.zeros(B, np.int64)
        for b in packets:
            pk = wire.decode_delta_packet(b)
            for e in pk.entries if pk is not None else ():
                r = name_rows[e.name]
                if e.slot >= N:
                    continue
                rpn[r, e.slot, 0] = max(rpn[r, e.slot, 0], e.added_nt)
                rpn[r, e.slot, 1] = max(rpn[r, e.slot, 1], e.taken_nt)
                rel[r] = max(rel[r], max(e.elapsed_ns, 0))
        return rpn, rel

    base, ok = run(pkts)
    if "PTP002" in obl:
        if not ok.all():
            bad("PTP002", "legal delta-interval planes rejected by the verdict")
        if not eq(base, reference(pkts)):
            bad("PTP002", "raw-plane decode+fold disagrees with the python decoder + reference "
                "join on the same datagram bytes")
        rev, _ = run(pkts[::-1])
        if not eq(rev, base):
            bad("PTP002", "raw ingest is packet-order dependent: reversed plane order produced "
                "a different state")
    if "PTP003" in obl:
        dup, _ = run(pkts + pkts)
        if not eq(dup, base):
            bad("PTP003", "raw ingest is not idempotent under duplicated planes")
        probe = pkts[0]
        variants = [probe[:j] for j in range(len(probe))]
        variants += [bytes(probe[:j]) + bytes([probe[j] ^ 0x41]) + bytes(probe[j + 1:])
                     for j in range(len(probe))]
        want = np.array([wire.decode_delta_packet(v) is not None for v in variants])
        got_state, got_ok = run(variants)
        if not np.array_equal(got_ok, want):
            j = _first_bad(got_ok == want)
            bad("PTP003", f"verdict diverges from wire.decode_delta_packet on hostile variant "
                f"{j} (truncation/flip sweep): all-or-nothing validation is the replica-fork "
                "guard")
        if not eq(got_state, reference(variants)):
            bad("PTP003", "a rejected (or corrupted) plane leaked values into state: invalid "
                "packets must merge nothing")
    if "PTP004" in obl:
        seed_pn = np.zeros((B, N, 2), np.int64)
        seed_pn[:4] = 2
        seed_el = np.full(B, 3, np.int64)
        grown, _ = run(pkts, seed=(seed_pn, seed_el))
        if not ((grown[0] >= seed_pn).all() and (grown[1] >= seed_el).all()):
            bad("PTP004", "raw ingest shrank a state plane: join must be monotone")
    return findings


def _model_gcra_laws(ctx: _Ctx) -> List[Finding]:
    """GCRA: bit-agreement with a literal request-by-request replay
    (PTP002), the TAT lane a max register (PTP004)."""
    from patrol_tpu_torch.models.limiter import TAKEN
    from patrol_tpu_torch.ops.gcra import GcraRequest

    obl = ctx.root.obligations
    findings: List[Finding] = []
    node_slot = 0
    dom = JoinDomain(B=2, N=2, vals=(0, 2, 5))
    pn0, el0 = dom.states(dom.vals)
    reqs = np.array(
        [(row, now, t, tol, nreq) for row in (0, 1) for now in (0, 2, 5) for t in (0, 1, 2)
         for tol in (0, 1, 3) for nreq in (0, 1, 3)],
        np.int64,
    )
    S_pn, S_el, R = _grid((pn0, el0), (reqs,))

    def step(st, r):
        out, res = ctx.fn(st, GcraRequest(*(_dev(r[:, i], ctx.device) for i in range(5))),
                          node_slot)
        return out, res.admitted

    out_pn, out_el, admitted = _run_states(ctx, S_pn, S_el, R, (0,), step)
    if "PTP002" in obl:
        exp_pn = S_pn.copy()
        exp_adm = np.zeros(len(S_pn), np.int64)
        for i in range(len(S_pn)):
            row, now, t, tol, nreq = (int(v) for v in R[i])
            tat = int(S_pn[i, row, :, TAKEN].max())
            k = 0
            while k < nreq and t > 0 and tat <= now + tol:
                tat = max(tat, now) + t
                k += 1
            exp_adm[i] = k
            if k:
                exp_pn[i, row, node_slot, TAKEN] = max(int(exp_pn[i, row, node_slot, TAKEN]), tat)
        i = _first_bad((admitted == exp_adm) & _states_eq((out_pn, out_el), (exp_pn, S_el)))
        if i is not None:
            findings.append(ctx.finding(
                "PTP002", f"GCRA diverged from the sequential replay at request {R[i].tolist()}: "
                f"admitted={int(admitted[i])} expected {int(exp_adm[i])} (or a lane other than "
                "the own TAT register moved)"))
    if "PTP004" in obl:
        i = _first_bad(_states_ge((out_pn, out_el), (S_pn, S_el)))
        if i is not None:
            findings.append(ctx.finding(
                "PTP004", f"GCRA shrank a state plane at request {R[i].tolist()}: the TAT lane "
                "is a max register and must stay monotone or joins resurrect spent windows"))
    return findings


def _model_conc_laws(ctx: _Ctx) -> List[Finding]:
    """Concurrency limit: bit-agreement with a literal release-then-
    acquire replay, the release clamped to the own lane pair (PTP002);
    monotone paired lanes (PTP004)."""
    from patrol_tpu_torch.models.limiter import ADDED, TAKEN
    from patrol_tpu_torch.ops.concurrency import ConcRequest

    obl = ctx.root.obligations
    findings: List[Finding] = []
    node_slot = 0
    dom = JoinDomain(B=2, N=2, vals=(0, 1, 3))
    pn0, el0 = dom.states(dom.vals)
    reqs = np.array(
        [(row, limit, count, nreq, rel) for row in (0, 1) for limit in (0, 2, 5)
         for count in (0, 1, 2) for nreq in (0, 1, 3) for rel in (0, 1, 4)],
        np.int64,
    )
    S_pn, S_el, R = _grid((pn0, el0), (reqs,))

    def step(st, r):
        out, res = ctx.fn(st, ConcRequest(*(_dev(r[:, i], ctx.device) for i in range(5))),
                          node_slot)
        return out, res.admitted, res.released_nt

    out_pn, out_el, admitted, released = _run_states(ctx, S_pn, S_el, R, (0,), step)
    if "PTP002" in obl:
        exp_pn = S_pn.copy()
        exp_adm = np.zeros(len(S_pn), np.int64)
        exp_rel = np.zeros(len(S_pn), np.int64)
        for i in range(len(S_pn)):
            row, limit, count, nreq, rel = (int(v) for v in R[i])
            own_a = int(S_pn[i, row, node_slot, ADDED])
            own_t = int(S_pn[i, row, node_slot, TAKEN])
            d_rel = min(max(rel, 0) * max(count, 0), max(own_t - own_a, 0))
            inflight = int(S_pn[i, row, :, TAKEN].sum()) - (int(S_pn[i, row, :, ADDED].sum()) + d_rel)
            k = 0
            while k < nreq and count > 0 and inflight + count <= limit:
                inflight += count
                k += 1
            exp_adm[i], exp_rel[i] = k, d_rel
            exp_pn[i, row, node_slot, ADDED] += d_rel
            exp_pn[i, row, node_slot, TAKEN] += k * count
        i = _first_bad((admitted == exp_adm) & (released == exp_rel)
                       & _states_eq((out_pn, out_el), (exp_pn, S_el)))
        if i is not None:
            findings.append(ctx.finding(
                "PTP002", f"concurrency kernel diverged from the sequential replay at request "
                f"{R[i].tolist()}: admitted={int(admitted[i])}/released={int(released[i])} "
                f"expected {int(exp_adm[i])}/{int(exp_rel[i])} — an uncapped release is a "
                "phantom release: converged replicas would over-admit forever"))
    if "PTP004" in obl:
        i = _first_bad(_states_ge((out_pn, out_el), (S_pn, S_el)))
        if i is not None:
            findings.append(ctx.finding(
                "PTP004", f"concurrency kernel shrank a state plane at request {R[i].tolist()}: "
                "acquire/release lanes are monotone G-counters"))
    return findings


def _model_quota_laws(ctx: _Ctx) -> List[Finding]:
    """Hierarchical quota: bit-agreement with a per-request replay that
    admits against every level and debits the whole path, shared rows
    accumulating (PTP002); monotone spends (PTP004)."""
    from patrol_tpu_torch.models.limiter import TAKEN
    from patrol_tpu_torch.ops.hierquota import QuotaRequest

    obl = ctx.root.obligations
    findings: List[Finding] = []
    node_slot = 0
    dom = JoinDomain(B=3, N=2, vals=(0, 1, 3))
    pn0, el0 = dom.states(dom.vals)
    reqs = np.array(
        [(rg, rt, 2, lg, lt, lu, count, nreq) for rg, rt in ((0, 1), (0, 0))
         for lg in (0, 2, 6) for lt in (0, 2, 6) for lu in (0, 2, 6) for count in (1, 2)
         for nreq in (0, 1, 3)],
        np.int64,
    )
    S_pn, S_el, R = _grid((pn0, el0), (reqs,))

    def step(st, r):
        out, res = ctx.fn(st, QuotaRequest(*(_dev(r[:, i], ctx.device) for i in range(8))),
                          node_slot)
        return out, res.admitted

    out_pn, out_el, admitted = _run_states(ctx, S_pn, S_el, R, (0, 1, 2), step)
    if "PTP002" in obl:
        exp_pn = S_pn.copy()
        exp_adm = np.zeros(len(S_pn), np.int64)
        for i in range(len(S_pn)):
            rg, rt, ru, lg, lt, lu, count, nreq = (int(v) for v in R[i])
            spend = [int(S_pn[i, r, :, TAKEN].sum()) for r in (rg, rt, ru)]
            heads = [lg - spend[0], lt - spend[1], lu - spend[2]]
            k = 0
            while k < nreq and count > 0 and min(heads) >= count:
                heads = [h - count for h in heads]
                k += 1
            exp_adm[i] = k
            for r in (rg, rt, ru):
                exp_pn[i, r, node_slot, TAKEN] += k * count
        i = _first_bad((admitted == exp_adm) & _states_eq((out_pn, out_el), (exp_pn, S_el)))
        if i is not None:
            findings.append(ctx.finding(
                "PTP002", f"quota kernel diverged from the per-level replay at request "
                f"{R[i].tolist()}: admitted={int(admitted[i])} expected {int(exp_adm[i])} — a "
                "partial (leaf-only) check or debit lets tenants overspend irreversibly"))
    if "PTP004" in obl:
        i = _first_bad(_states_ge((out_pn, out_el), (S_pn, S_el)))
        if i is not None:
            findings.append(ctx.finding(
                "PTP004", f"quota kernel shrank a state plane at request {R[i].tolist()}: quota "
                "debits are monotone G-counter spends"))
    return findings


def _model_cert_trailer_roundtrip(ctx: _Ctx) -> List[Finding]:
    """PTP003 for the family trailers (dispatched on ``root.attr``):
    decode∘encode identity, byte-stable re-encode, every single-bit
    corruption and wrong length rejected, and conc's released <=
    acquired."""
    from patrol_tpu_torch.ops import wire

    findings: List[Finding] = []
    big = wire._INT64_MAX
    kind = ctx.root.attr
    if "gcra" in kind:
        decode = wire.decode_gcra_trailer
        vals = [wire.GcraTrailer(own_slot=s, tat_ns=v) for s in (0, 7, 65535) for v in (0, 1, big)]
    elif "conc" in kind:
        decode = wire.decode_conc_trailer
        vals = [wire.ConcTrailer(own_slot=s, acquired_nt=a, released_nt=r)
                for s in (0, 65535) for a in (0, 5, big) for r in (0, 5, big) if r <= a]
    else:
        decode = wire.decode_quota_trailer
        vals = [wire.QuotaTrailer(own_slot=s, taken_global_nt=g, taken_tenant_nt=t,
                                  taken_user_nt=u)
                for s in (0, 65535) for g in (0, 3, big) for t in (0, 3, big) for u in (0, 3, big)]
    for t in vals:
        ctx.combinations += 1
        pkt = ctx.fn(t)
        back = decode(pkt)
        if back != t:
            findings.append(ctx.finding(
                "PTP003", f"decode(encode(x)) != x for {t!r}: peers relaying the trailer would "
                "fork on the lattice coordinate it carries"))
            break
        if ctx.fn(back) != pkt:
            findings.append(ctx.finding(
                "PTP003", f"re-encode of a decoded trailer is not byte-stable for {t!r}"))
            break
    pkt = ctx.fn(vals[-1])
    for i in range(len(pkt)):
        for bit in (0x01, 0x80):
            ctx.combinations += 1
            mutated = bytearray(pkt)
            mutated[i] ^= bit
            if decode(bytes(mutated)) is not None:
                findings.append(ctx.finding(
                    "PTP003", f"single-bit corruption at byte {i} decoded as valid: the trailer "
                    "checksum must reject damaged lattice coordinates"))
                return findings
    if decode(pkt[:-1]) is not None or decode(pkt + b"\x00") is not None:
        findings.append(ctx.finding("PTP003", "wrong-length trailer decoded as valid"))
    if "conc" in kind:
        phantom = wire.ConcTrailer(own_slot=0, acquired_nt=1, released_nt=2)
        if wire.decode_conc_trailer(wire.encode_conc_trailer(phantom)) is not None:
            findings.append(ctx.finding(
                "PTP003", "decoder accepted released > acquired: a phantom-release trailer must "
                "never merge"))
    return findings


def _model_pallas_interpret(ctx: _Ctx) -> List[Finding]:
    """The join kernel against its plain version on the reference's
    corpus (the JAX package ran its Pallas kernel in interpret mode
    against the XLA scatter): through ``fn`` (``tick_join``), pairs
    alone, a dense half with them, reversed and duplicated; and the
    ``pair_join`` and ``row_join`` wrappers on the same corpus. PTP002:
    bit-agreement and batch-order invariance; PTP003: duplication. On
    the CPU the wrappers run their plain versions, so this is plain
    against plain (noted in the output)."""
    from patrol_tpu_torch.ops import join_kernel as jk

    torch = _torch()
    obl = ctx.root.obligations
    findings: List[Finding] = []
    if ctx.device.type == "cpu":
        ctx.notes.append("plain against plain on the CPU")
    B, N = 512, 2
    rows = np.array([0, 0, 1, 1, 5, 5, 511, 0], np.int64)
    slots = np.array([0, 0, 1, 1, 0, 1, 1, 1], np.int64)
    big = (5 << 32) + 1
    added = np.array([9, 3, big, 1, 0, 7, 2, big - 1], np.int64)
    taken = np.array([1, 8, 2, big, 5, 0, 3, 4], np.int64)
    elapsed = np.array([4, 6, 2**40 + 3, 2**40 + 2, 0, 1, 9, 5], np.int64)
    upd = np.zeros((len(rows), N, 2), np.int64)
    upd[np.arange(len(rows)), slots, 0] = added
    upd[np.arange(len(rows)), slots, 1] = taken

    def pairs_of(r, s, a, t, e, dev):
        return tuple(_dev(x, dev) for x in (r, s, a, t, r, e))

    def fresh(dev):
        return (torch.zeros((B, N, 2), dtype=torch.int64, device=dev),
                torch.zeros((B,), dtype=torch.int64, device=dev))

    def run(call):
        ctx.combinations += 1
        pn, el = fresh(ctx.device)
        call(pn, el, ctx.device)
        return _np(pn), _np(el)

    def plain(call):
        pn, el = fresh("cpu")
        call(pn, el, "cpu")
        return pn.numpy(), el.numpy()

    def eq(a, b) -> bool:
        return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    order = (rows, slots, added, taken, elapsed)
    base = run(lambda p, e, d: ctx.fn(p, e, None, pairs_of(*order, d)))
    want = plain(lambda p, e, d: jk.pair_join_plain(p, e, *pairs_of(*order, d)))
    dense = lambda d: (_dev(rows, d), _dev(upd, d), _dev(elapsed, d))  # noqa: E731
    legs = {
        "tick_join with a dense half": (
            run(lambda p, e, d: ctx.fn(p, e, dense(d), pairs_of(*order, d))),
            plain(lambda p, e, d: jk.tick_join_plain(p, e, dense(d), pairs_of(*order, d)))),
        "pair_join": (run(lambda p, e, d: jk.pair_join(p, e, *pairs_of(*order, d))), want),
        "row_join": (
            run(lambda p, e, d: jk.row_join(p, e, *dense(d))),
            plain(lambda p, e, d: jk.row_join_plain(p, e, *dense(d)))),
    }
    if "PTP002" in obl:
        if not eq(base, want):
            findings.append(ctx.finding(
                "PTP002", "the join kernel disagrees with its plain version on the same batch "
                "(bit-exactness contract)"))
        for leg, (got, ref) in legs.items():
            if not eq(got, ref):
                findings.append(ctx.finding(
                    "PTP002", f"{leg} disagrees with its plain version on the same batch"))
        rev = run(lambda p, e, d: ctx.fn(p, e, None, pairs_of(*(x[::-1] for x in order), d)))
        if not eq(rev, base):
            findings.append(ctx.finding(
                "PTP002", "the join kernel is batch-order dependent: reversed delta order "
                "produced a different state"))
    if "PTP003" in obl:
        dup = run(lambda p, e, d: ctx.fn(
            p, e, None, pairs_of(*(np.concatenate([x, x]) for x in order), d)))
        if not eq(dup, base):
            findings.append(ctx.finding(
                "PTP003", "the join kernel is not idempotent under batch duplication"))
    return findings


def _model_pairmax_join(ctx: _Ctx) -> List[Finding]:
    """The row read-modify-write ``pairmax`` as a join on its int32
    domain (``int32[B, 8, 128]``, each row 512 signed int64 pairs seen as
    (lo, hi) halves): single-update batches over (row, pair, value) —
    idempotent (PTP003), monotone in signed int64 pair order (PTP004),
    commutative (PTP002). Each combination owns its rows, so update rows
    stay unique within a launch, as the kernel's contract asks."""
    torch = _torch()
    obl = ctx.root.obligations
    findings: List[Finding] = []
    B, PAIRS = 2, 512
    pairs_at = (0, 1, PAIRS - 1)

    def deltas(vals):
        return np.array(list(itertools.product(range(B), pairs_at, vals)), np.int64)

    def states(vals):
        out = [np.zeros((B, PAIRS), np.int64), np.full((B, PAIRS), max(vals), np.int64)]
        for r, p, v in deltas(vals):
            s = np.zeros((B, PAIRS), np.int64)
            s[r, p] = v
            out.append(s)
        return np.unique(np.stack(out), axis=0)

    def apply(S, D):
        res = []
        for lo in range(0, len(S), _CHUNK):
            s, d = S[lo:lo + _CHUNK], D[lo:lo + _CHUNK]
            m = len(s)
            st = _dev(s.reshape(m * B, PAIRS).view(np.int32).reshape(m * B, 8, 128), ctx.device)
            rows = (d[:, 0] + np.arange(m) * B).astype(np.int32)
            lo32 = (d[:, 2] & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
            hi32 = (d[:, 2] >> 32).astype(np.int32)
            out = ctx.fn(st, _dev(rows, ctx.device), _dev((d[:, 1] * 2).astype(np.int32), ctx.device),
                         _dev(lo32, ctx.device), _dev(hi32, ctx.device), "pairmax")
            res.append(_np(out.view(torch.int64)).reshape(m, B, PAIRS))
        ctx.combinations += len(S)
        return np.concatenate(res)

    def eq(a, b):
        return (a == b).reshape(len(a), -1).all(axis=1)

    vals = (0, 1, (1 << 32) + 3, -5)
    if "PTP003" in obl or "PTP004" in obl:
        S, D = _grid((states(vals),), (deltas(vals),))
        once = apply(S, D)
        if "PTP003" in obl:
            i = _first_bad(eq(apply(once, D), once))
            if i is not None:
                findings.append(ctx.finding(
                    "PTP003", f"pairmax is not idempotent: re-applying (row, pair, value) "
                    f"{D[i].tolist()} moved the state again"))
        if "PTP004" in obl:
            i = _first_bad((once >= S).reshape(len(S), -1).all(axis=1))
            if i is not None:
                findings.append(ctx.finding(
                    "PTP004", f"pairmax is not monotone: (row, pair, value) {D[i].tolist()} "
                    "shrank a pair"))
    if "PTP002" in obl:
        pv = (-5, (1 << 32) + 3)
        dl = deltas(pv)
        S, D1, D2 = _grid((states(pv),), (dl,), (dl,))
        ab = apply(apply(S, D1), D2)
        ba = apply(apply(S, D2), D1)
        i = _first_bad(eq(ab, ba))
        if i is not None:
            findings.append(ctx.finding(
                "PTP002", f"pairmax does not commute: {D1[i].tolist()} then {D2[i].tolist()} != "
                "the reverse order"))
    return findings


_MODELS: Dict[str, Callable[[_Ctx], List[Finding]]] = {
    "dense_join": _model_dense_join,
    "tree_converge": _model_tree_converge,
    "converge_rows": _model_converge_rows,
    "take_monotone": _model_take_monotone,
    "take_n_laws": _model_take_n_laws,
    "take_split_fifo": _model_take_split_fifo,
    "lifecycle_iszero": _model_lifecycle_iszero,
    "scalar_monotone": _model_scalar_monotone,
    "rate_algebra": _model_rate_algebra,
    "wire_roundtrip": _model_wire_roundtrip,
    "delta_roundtrip": _model_delta_roundtrip,
    "pallas_interpret": _model_pallas_interpret,
    "raw_ingest": _model_raw_ingest,
    "gcra_laws": _model_gcra_laws,
    "conc_laws": _model_conc_laws,
    "quota_laws": _model_quota_laws,
    "cert_trailer_roundtrip": _model_cert_trailer_roundtrip,
    "pairmax_join": _model_pairmax_join,
}


def _run_model(ctx: _Ctx) -> List[Finding]:
    tag = ctx.root.model
    if tag is None:
        return []
    if tag.startswith("join_batch:"):
        return _model_join_batch(ctx, JOIN_BATCH_ADAPTERS[tag.split(":", 1)[1]])
    return _MODELS[tag](ctx)


# ---------------------------------------------------------------------------
# Drivers.


def _device(device):
    from patrol_tpu_torch.models.limiter import resolve_device

    return resolve_device(device)


def prove_root(
    root: ProveRoot,
    fn: Optional[Callable] = None,
    device="cuda",
    stats: Optional[dict] = None,
    cuda_sources: Optional[Dict[str, str]] = None,
) -> List[Finding]:
    """Every declared obligation of one root on ``device`` → findings
    (unsuppressed). ``stats``, when given, gets the root's seconds,
    launches by kernel, combinations and notes."""
    from patrol_tpu_torch.ops import _build

    dev = _device(device)
    fn = fn if fn is not None else root.resolve()
    site = _def_site(fn, root)
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    findings: List[Finding] = []
    if root.operands is not None:
        devices = [_device("cpu")] + ([dev] if dev.type != "cpu" else [])
        for d in devices:
            ptp001, ptp005 = _structural_run(root, fn, d, site)
            if root.structural is not None and "PTP001" in root.obligations:
                findings.extend(f for f in ptp001 if f not in findings)
            if "PTP005" in root.obligations:
                findings.extend(f for f in ptp005 if f not in findings)
    if root.cuda_joins and "PTP001" in root.obligations:
        if cuda_sources is None:
            cuda_sources = repo_cuda_sources(_REPO_DIR)
        findings.extend(cuda_join_findings(root, cuda_sources))
    ctx = _Ctx(root, fn, site, dev)
    findings.extend(_run_model(ctx))
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)
    if stats is not None:
        stats.update({
            "seconds": time.perf_counter() - t0,
            "launches": {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]},
            "combinations": ctx.combinations,
            "notes": list(ctx.notes),
        })
    return findings


def prove_all(
    roots: Optional[Sequence[ProveRoot]] = None, device="cuda", stats: Optional[dict] = None
) -> List[Finding]:
    if roots is None:
        from patrol_tpu_torch.ops.obligations import PROVE_ROOTS

        roots = PROVE_ROOTS
    cuda_sources = repo_cuda_sources(_REPO_DIR)
    out: List[Finding] = []
    for root in roots:
        st: dict = {}
        out.extend(prove_root(root, device=device, stats=st, cuda_sources=cuda_sources))
        if stats is not None:
            stats[root.name] = st
    return sorted(out, key=lambda f: (f.path, f.line, f.check))


# ---------------------------------------------------------------------------
# PTP006 — registration completeness.

ENGINE_DISPATCH_FILES: Tuple[str, ...] = (
    f"{PACKAGE}/runtime/engine.py",
    f"{PACKAGE}/runtime/mesh_engine.py",
    f"{PACKAGE}/parallel/topology.py",
)
_OPS_PREFIX = f"{PACKAGE}/ops/"
_STATE_ARG = re.compile(r"\bstate\b|\.state\b|\bpn\b|\.pn\b")


def _rel_of(module: str) -> str:
    return module.replace(".", "/") + ".py"


def _aliases(tree: ast.AST) -> Dict[str, str]:
    """Module-level ``name = other_def`` aliases (``run = fused``)."""
    defs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    out: Dict[str, str] = {}
    for n in tree.body:
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name) and isinstance(n.value, ast.Name)
                and n.value.id in defs):
            out[n.targets[0].id] = n.value.id
    return out


class CallGraph:
    """The lint's :class:`_FuncIndex` over the port's sources, with
    module-level def aliases resolved, for reachability sweeps."""

    def __init__(self, sources: Dict[str, str]):
        self.mods = [Module(rel, src) for rel, src in sorted(sources.items())]
        self.index = _FuncIndex(self.mods)
        self.alias = {m.relpath: _aliases(m.tree) for m in self.mods}

    def resolve(self, rel: str, call: ast.Call, caller) -> Optional[Tuple[str, str]]:
        tgt = self.index.resolve(rel, call, caller=caller)
        if tgt is not None:
            return tgt
        f = call.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            mod = self.index.mod_aliases.get(rel, {}).get(f.value.id)
            if mod is not None:
                name = self.alias.get(mod, {}).get(f.attr)
                if name is not None and (mod, name) in self.index.funcs:
                    return (mod, name)
        return None

    def reach(self, starts) -> Set[Tuple[str, str]]:
        seen: Set[Tuple[str, str]] = set()
        frontier = [s for s in starts if s in self.index.funcs]
        while frontier:
            key = frontier.pop()
            if key in seen:
                continue
            seen.add(key)
            for node in ast.walk(self.index.funcs[key]):
                if isinstance(node, ast.Call):
                    tgt = self.resolve(key[0], node, key)
                    if tgt is not None and tgt in self.index.funcs and tgt not in seen:
                        frontier.append(tgt)
        return seen


def count_launch_callers(graph: CallGraph) -> List[Tuple[str, int, str]]:
    """(relpath, line, function key) of every function that calls
    ``count_launch``."""
    out = []
    for (rel, name), fn in sorted(graph.index.funcs.items()):
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and _is_count_launch(node):
                out.append((rel, node.lineno, name))
                break
    return out


def engine_state_calls(graph: CallGraph, engine_files=ENGINE_DISPATCH_FILES):
    """(relpath, line, ops relpath, function) of every ``ops`` function
    the engine files call on the state (first argument names the state
    or its planes), or pass as a value to another call (``launch``
    parameters)."""
    rows: Dict[Tuple[str, str, str], int] = {}
    for m in graph.mods:
        if m.relpath not in engine_files:
            continue
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            cands = []
            tgt = graph.resolve(m.relpath, node, None)
            if (tgt is not None and tgt[0].startswith(_OPS_PREFIX) and node.args
                    and _STATE_ARG.search(ast.unparse(node.args[0]))):
                cands.append(tgt)
            for a in node.args:
                if isinstance(a, ast.Attribute) and isinstance(a.value, ast.Name):
                    mod = graph.index.mod_aliases.get(m.relpath, {}).get(a.value.id)
                    if mod and mod.startswith(_OPS_PREFIX) and (mod, a.attr) in graph.index.funcs:
                        cands.append((mod, a.attr))
            for mod, name in cands:
                key = (m.relpath, mod, name)
                if key not in rows or node.lineno < rows[key]:
                    rows[key] = node.lineno
    return sorted((rel, line, mod, name) for (rel, mod, name), line in rows.items())


def registration_findings(
    sources: Dict[str, str],
    roots: Optional[Sequence[ProveRoot]] = None,
    exempt: Optional[Set[Tuple[str, str]]] = None,
    launch_keys: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """PTP006: every LAUNCHES key declared by a root; every count_launch
    caller reached from a root; every ops function the engine files call
    on the state a root, reached from one, or exempt."""
    if roots is None or exempt is None:
        from patrol_tpu_torch.ops.obligations import PROVE_EXEMPT, PROVE_ROOTS

        roots = PROVE_ROOTS if roots is None else roots
        exempt = set(PROVE_EXEMPT) if exempt is None else exempt
    if launch_keys is None:
        from patrol_tpu_torch.ops._build import LAUNCHES

        launch_keys = tuple(LAUNCHES)
    graph = CallGraph(sources)
    starts = {(_rel_of(r.module), r.attr) for r in roots}
    reached = graph.reach(starts)
    exempt_keys = {(_rel_of(mod), attr) for mod, attr in exempt}
    reg = f"{PACKAGE}/ops/obligations.py"
    out: List[Finding] = []
    declared = {k for r in roots for k in r.launches}
    for key in launch_keys:
        if key not in declared:
            out.append(Finding(
                "PTP006", f"{PACKAGE}/ops/_build.py", 1,
                f"kernel launch key {key!r} is declared by no PROVE_ROOTS root: its kernel has "
                f"no proof obligations on the card (declare it in {reg})"))
    for rel, line, name in count_launch_callers(graph):
        if (rel, name) not in reached and (rel, name) not in exempt_keys:
            out.append(Finding(
                "PTP006", rel, line,
                f"{name}() launches a kernel but no PROVE_ROOTS root reaches it — declare its "
                f"obligations (or its exemption, with the reason) in {reg}"))
    for rel, line, mod, name in engine_state_calls(graph):
        key = (mod, name)
        if key not in reached and key not in exempt_keys:
            dotted = mod[:-3].replace("/", ".")
            out.append(Finding(
                "PTP006", rel, line,
                f"{dotted}.{name} runs on the engine's state here but is registered in neither "
                f"PROVE_ROOTS nor PROVE_EXEMPT — declare its obligations in {reg}"))
    return sorted(out, key=lambda f: (f.path, f.line, f.check))


def prove_repo(repo_root: str, device="cuda", stats: Optional[dict] = None) -> List[Finding]:
    """Every registered root on ``device`` plus the PTP006 sweep, through
    the inline suppressions of the flagged files, with stale ``PTP``
    suppressions swept as PTL006."""
    from patrol_tpu_torch.analysis.lint import apply_suppressions

    findings = prove_all(device=device, stats=stats) + registration_findings(
        repo_sources(repo_root)
    )
    findings.sort(key=lambda f: (f.path, f.line, f.check))
    return apply_suppressions(findings, repo_root, stale_family="PTP")
