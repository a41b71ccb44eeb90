"""The findings and inline-suppression machinery the port's check stages
share (counterpart of the JAX package's ``analysis/lint.py``).

Only what the protocol, linearizability and ABI stages import is here:

* :class:`Finding`, one ``path:line: CODE message`` result;
* :class:`Module`, one parsed source with its suppression table, built
  from real comment tokens by :func:`directive_map`;
* :func:`apply_suppressions`, the back half of every stage driver, and
  :func:`stale_suppression_findings`, both of which report a directive
  that suppressed nothing as PTL006;
* :func:`native_effects`, the declared effects of the port's C ABI
  (``patrol_tpu_torch/native/__init__.py::NATIVE_EFFECTS``).

The reference's seven AST checks (PTL001-PTL007) with their tables keyed
to the port's files are not ported yet; :func:`repo_sources` walks the
port's package for the stale sweep only.

Suppressions are inline comments, as in the reference:

    x = risky()  # patrol-lint: disable=PTA001,PTN004

Every suppression is a *declaration*: greppable, reviewed like code. A
directive that suppresses nothing is itself a finding (PTL006): the
hazard it declared was fixed, and the comment would silently pardon
whatever lands on that line next. A ``disable=PTL006`` on the same line
self-suppresses (the one deliberate escape hatch).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Dict, List, Optional, Sequence, Set, Tuple

_DIRECTIVE_RE = re.compile(r"#\s*patrol-lint:\s*([A-Za-z0-9=,_\- ]+)")

# Marker tokens the lint stage owns (each aliases one PTL code).
LINT_MARKERS = ("clock-seam", "wire-f64")

# The package the stale-suppression sweep walks, relative to the repo root.
PACKAGE = "patrol_tpu_torch"


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
# C ABI. Loaded by file path when the package module is not imported yet,
# so a caller that only wants the table never builds the library.

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


def apply_suppressions(
    findings: Sequence[Finding],
    repo_root: str,
    stale_family: Optional[str] = None,
    inline_used: Optional[Set[Tuple[str, int, str]]] = None,
) -> List[Finding]:
    """Filter findings through the flagged files' inline ``# patrol-lint:``
    directives — the shared back half of every stage driver. Files that
    cannot be read or parsed (e.g. a finding anchored in a .cpp source)
    keep their findings: a suppression that cannot be located must not
    silently win.

    ``stale_family`` (a code prefix: "PTC", "PTA", "PTN") turns on the
    PTL006 stale sweep for that family: every directive token with the
    prefix anywhere under ``<repo_root>/patrol_tpu_torch`` that
    suppressed nothing in this run is appended as a PTL006 finding — so
    each stage audits its own suppressions for free.

    ``inline_used`` covers checkers that honor directives DURING the
    checks, on their own Module instances: (path, line, token) triples
    recorded there count as used here."""
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
