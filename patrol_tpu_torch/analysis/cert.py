"""patrol-cert — the stage-9 cross-stage certification meta-checker over
the port's own registry (counterpart of the JAX package's
``analysis/cert.py``).

Stages 4-8 each check what is REGISTERED with them; none of them can
see a family that quietly fails to register, a seeded mutation that
trips the wrong check, or a justification that went stale. This module
walks ``patrol_tpu_torch/ops/obligations.py::KERNEL_FAMILIES`` — the
single declarative record per lattice family — and closes those gaps:

  PTK001  stage reachability: every family reaches every applicable
          checking stage (prove roots, protocol-model hook, lin spec
          with a dispatchable algebra, the keys ``chip_smoke.py`` writes
          for the phase that runs the family's kernel end to end on the
          card) or carries a written exemption justification
  PTK002  mutation rejection: every seeded :class:`CertMutation` is
          demonstrably rejected with its EXACT registered code —
          payload mutations (drop-in mutant kernels, run through the
          wrappers on ``device``, and family-law payloads) are executed
          here; registry references are membership- and expect-checked
          against the stage-6/8 registries that execute them
  PTK003  absence justification: every obligation code a prove root
          does not declare carries a written justification in the
          family's ``absent`` map — and no justification is stale
          (naming a declared code or an unknown root)
  PTK004  registration completeness: every function under
          ``patrol_tpu_torch/ops/`` that launches a kernel
          (``_build.count_launch``) is reached from a registered prove
          root or carries a ``PROVE_EXEMPT`` entry, and every
          ``_build.LAUNCHES`` key is passed to ``count_launch`` by some
          function there — an unregistered kernel is itself a finding
  PTK005  registry integrity: unique names, nonempty domains, >= 2
          seeded mutations per family (or a justified exemption),
          resolvable mutation targets, well-formed expect codes, wire
          codecs that name a family root

Execution notes (the reference's): lin-stage mutations are NOT
re-executed here — their schedule suites are the dominant cost of stage
8, which runs them with exact-code assertions (PTN005); cert pins
registration + expect only. The two ``membership-*`` protocol mutations
belong to the membership layer rather than any kernel lattice family,
and stay claimed by stage 6 directly; the seam mutations stay with the
race stage and the dispatch mutations with the dispatch stage — cert
adds per-family pinning, it removes nothing.

PTK004 reads the prove stage's call graph (``analysis/prove.py``'s
:class:`CallGraph` and :func:`count_launch_callers`) over the port's
sources; the launch keys a caller can pass are read from its
``count_launch`` argument: a string, an f-string (its literal parts), or
a parameter of the caller, read at the caller's call sites.
"""

from __future__ import annotations

import ast
import os
import re
import time
from typing import Dict, List, Optional, Set, Tuple

from patrol_tpu_torch.analysis.lint import PACKAGE, Finding

# Every obligation code stage 4 can check; PTK003 requires a
# justification for each one a root does not declare.
PTP_CODES: Tuple[str, ...] = (
    "PTP001", "PTP002", "PTP003", "PTP004", "PTP005"
)

_CODE_RE = re.compile(r"^PT[A-Z]\d{3}$")
_STAGES = ("prove", "protocol", "lin")

_OBLIGATIONS_PATH = f"{PACKAGE}/ops/obligations.py"
_BUILD_PATH = f"{PACKAGE}/ops/_build.py"
_OPS_PREFIX = f"{PACKAGE}/ops/"
# The port's end-to-end run on the card: the phase that runs a family's
# kernel end to end writes the keys the family's ``bench_fields`` name.
SMOKE_PATH = "chip_smoke.py"


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def _family_site(name: str) -> Tuple[str, int]:
    """Best-effort line anchor: the ``name="<family>"`` literal in the
    registry file, so a finding lands on the record it indicts."""
    path = os.path.join(_repo_root(), _OBLIGATIONS_PATH)
    try:
        with open(path, encoding="utf-8") as fh:
            for lineno, line in enumerate(fh, start=1):
                if f'name="{name}"' in line or f"'{name}'" in line:
                    return _OBLIGATIONS_PATH, lineno
    except OSError:
        pass
    return _OBLIGATIONS_PATH, 1


def _codes(findings) -> Set[str]:
    return {f.check for f in findings}


# ---------------------------------------------------------------------------
# PTK001 — stage reachability.


def check_reachability(families=None) -> List[Finding]:
    from patrol_tpu_torch.analysis import linearizability as lin
    from patrol_tpu_torch.analysis import protocol as proto
    from patrol_tpu_torch.analysis.prove import _MODELS, JOIN_BATCH_ADAPTERS
    from patrol_tpu_torch.ops import obligations as ob

    families = ob.KERNEL_FAMILIES if families is None else families
    findings: List[Finding] = []

    smoke_src = ""
    try:
        with open(os.path.join(_repo_root(), SMOKE_PATH), encoding="utf-8") as fh:
            smoke_src = fh.read()
    except OSError:
        pass

    for fam in families:
        site = _family_site(fam.name)
        if not fam.prove_roots:
            findings.append(
                Finding(
                    "PTK001", *site,
                    f"[{fam.name}] no prove roots: the family never "
                    "reaches stage 4 — there is no unreachable-stage "
                    "exemption for prove; every lattice family has laws",
                )
            )
        for root in fam.prove_roots:
            if root.model is None:
                continue
            if root.model.startswith("join_batch:"):
                reachable = (
                    root.model.split(":", 1)[1] in JOIN_BATCH_ADAPTERS
                )
            else:
                reachable = root.model in _MODELS
            if not reachable:
                findings.append(
                    Finding(
                        "PTK001", *site,
                        f"[{fam.name}] root {root.name} names model "
                        f"'{root.model}' which stage 4 cannot dispatch",
                    )
                )

        if fam.protocol is None:
            if not fam.protocol_exempt:
                findings.append(
                    Finding(
                        "PTK001", *site,
                        f"[{fam.name}] no protocol-model hook and no "
                        "protocol_exempt justification: stage 6 never "
                        "sees this lattice",
                    )
                )
        elif fam.protocol not in proto.FAMILY_CHECKS:
            findings.append(
                Finding(
                    "PTK001", *site,
                    f"[{fam.name}] protocol key '{fam.protocol}' is not "
                    "in protocol.FAMILY_CHECKS: registered but "
                    "unreachable",
                )
            )

        if not fam.lin_specs:
            if not fam.lin_exempt:
                findings.append(
                    Finding(
                        "PTK001", *site,
                        f"[{fam.name}] no lin spec and no lin_exempt "
                        "justification: stage 8 never replays this "
                        "family against a sequential spec",
                    )
                )
        else:
            for spec in fam.lin_specs:
                if spec.algebra not in lin.ALGEBRAS:
                    findings.append(
                        Finding(
                            "PTK001", *site,
                            f"[{fam.name}] lin spec {spec.name} names "
                            f"algebra '{spec.algebra}' which stage 8 "
                            "cannot dispatch",
                        )
                    )

        if not fam.bench_fields:
            if not fam.bench_exempt:
                findings.append(
                    Finding(
                        "PTK001", *site,
                        f"[{fam.name}] no bench smoke fields and no "
                        "bench_exempt justification: the kernel never "
                        "runs end-to-end in the smoke gate",
                    )
                )
        else:
            for field in fam.bench_fields:
                if f'"{field}"' not in smoke_src:
                    findings.append(
                        Finding(
                            "PTK001", *site,
                            f"[{fam.name}] bench field '{field}' is not "
                            f"emitted anywhere in {SMOKE_PATH}",
                        )
                    )
    return findings


# ---------------------------------------------------------------------------
# PTK002 — every seeded mutation rejected with its exact code.


def check_mutations(
    families=None, execute: bool = True, device="cuda", stats: Optional[dict] = None
) -> List[Finding]:
    """``device`` runs the prove mutants through the wrappers there (the
    card by default, as the port's other stages). ``stats``, when given,
    gets per executed mutation its stage, codes, seconds and the kernel
    launches its run made."""
    from patrol_tpu_torch.analysis import linearizability as lin
    from patrol_tpu_torch.analysis import protocol as proto
    from patrol_tpu_torch.analysis.prove import prove_root
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.ops import obligations as ob

    families = ob.KERNEL_FAMILIES if families is None else families
    findings: List[Finding] = []

    for fam in families:
        site = _family_site(fam.name)
        roots = {r.name: r for r in fam.prove_roots}
        spec_names = {s.name for s in fam.lin_specs}

        for mut in fam.mutations:
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            if mut.stage == "prove":
                root = roots.get(mut.target)
                if root is None:
                    findings.append(
                        Finding(
                            "PTK002", *site,
                            f"[{fam.name}] mutation '{mut.name}' targets "
                            f"unknown prove root '{mut.target}'",
                        )
                    )
                    continue
                if mut.mutant is None:
                    findings.append(
                        Finding(
                            "PTK002", *site,
                            f"[{fam.name}] prove mutation '{mut.name}' "
                            "carries no mutant kernel to execute",
                        )
                    )
                    continue
                if not execute:
                    continue
                got = _codes(prove_root(root, fn=mut.mutant, device=device))
                if mut.expect not in got:
                    findings.append(
                        Finding(
                            "PTK002", *site,
                            f"[{fam.name}] seeded mutant '{mut.name}' was "
                            f"NOT rejected with {mut.expect} (got "
                            f"{sorted(got) or 'nothing'}): the model "
                            "suite that owns this hazard has gone soft",
                        )
                    )

            elif mut.stage == "protocol":
                if mut.laws is not None:
                    checker = proto.FAMILY_CHECKS.get(mut.target)
                    if checker is None or mut.target != fam.protocol:
                        findings.append(
                            Finding(
                                "PTK002", *site,
                                f"[{fam.name}] law mutation '{mut.name}' "
                                f"targets '{mut.target}', not the "
                                "family's own protocol hook",
                            )
                        )
                        continue
                    if not execute:
                        continue
                    got = _codes(checker(laws=mut.laws))
                else:
                    sem = proto.MUTATIONS.get(mut.target)
                    if sem is None:
                        findings.append(
                            Finding(
                                "PTK002", *site,
                                f"[{fam.name}] mutation '{mut.name}' "
                                f"references '{mut.target}', which is "
                                "not in protocol.MUTATIONS",
                            )
                        )
                        continue
                    if not execute:
                        continue
                    got = _codes(proto.check_protocol(sem))
                if mut.expect not in got:
                    findings.append(
                        Finding(
                            "PTK002", *site,
                            f"[{fam.name}] seeded mutation '{mut.name}' "
                            f"was NOT rejected with {mut.expect} (got "
                            f"{sorted(got) or 'nothing'})",
                        )
                    )

            elif mut.stage == "lin":
                reg = lin.LIN_MUTATIONS.get(mut.target)
                if reg is None:
                    findings.append(
                        Finding(
                            "PTK002", *site,
                            f"[{fam.name}] mutation '{mut.name}' "
                            f"references '{mut.target}', which is not "
                            "in linearizability.LIN_MUTATIONS",
                        )
                    )
                    continue
                if reg.expect != mut.expect:
                    findings.append(
                        Finding(
                            "PTK002", *site,
                            f"[{fam.name}] mutation '{mut.name}' pins "
                            f"{mut.expect} but stage 8 registers "
                            f"{reg.expect}: the two registries disagree "
                            "on which check owns this hazard",
                        )
                    )
                if reg.family not in spec_names:
                    findings.append(
                        Finding(
                            "PTK002", *site,
                            f"[{fam.name}] mutation '{mut.name}' runs "
                            f"against lin family '{reg.family}', which "
                            "this kernel family does not register",
                        )
                    )
                continue
            if stats is not None:
                stats[mut.name] = {
                    "stage": mut.stage,
                    "codes": sorted(got),
                    "seconds": time.perf_counter() - t0,
                    "launches": {
                        k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]
                    },
                }
    return findings


# ---------------------------------------------------------------------------
# PTK003 — absence justifications.


def check_absent_justifications(families=None) -> List[Finding]:
    from patrol_tpu_torch.ops import obligations as ob

    families = ob.KERNEL_FAMILIES if families is None else families
    findings: List[Finding] = []

    for fam in families:
        site = _family_site(fam.name)
        root_names = {r.name for r in fam.prove_roots}
        valid_keys: Set[str] = set()
        for root in fam.prove_roots:
            declared = set(root.obligations)
            for code in PTP_CODES:
                if code in declared:
                    continue
                key = f"{root.name}:{code}"
                valid_keys.add(key)
                if not str(fam.absent.get(key, "")).strip():
                    findings.append(
                        Finding(
                            "PTK003", *site,
                            f"[{fam.name}] {root.name} does not declare "
                            f"{code} and no justification is recorded "
                            f"under absent['{key}'] — silence is not a "
                            "design decision",
                        )
                    )
        for key in fam.absent:
            if key in valid_keys:
                continue
            root_name = key.rsplit(":", 1)[0]
            reason = (
                "names a code the root now declares (stale — delete it)"
                if root_name in root_names
                else "names a root this family does not register"
            )
            findings.append(
                Finding(
                    "PTK003", *site,
                    f"[{fam.name}] absent['{key}'] {reason}",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# PTK004 — unregistered kernel launchers in ops/.


def _calls_by_name(graph) -> Dict[str, List[Tuple[Tuple[str, str], ast.Call]]]:
    """Every call in the graph's functions, by the name it is spelled
    with (``f(...)`` or ``x.f(...)``), beside the function holding it."""
    out: Dict[str, List[Tuple[Tuple[str, str], ast.Call]]] = {}
    for key, fn in graph.index.funcs.items():
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                f = node.func
                name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
                if name is not None:
                    out.setdefault(name, []).append((key, node))
    return out


def _key_patterns(arg: ast.AST, graph, caller: Tuple[str, str], calls) -> List[str]:
    """Regexes for the launch keys a ``count_launch(arg)`` call can pass:
    a string is itself, an f-string its literal parts around ``.+``, a
    parameter of the caller whatever string its call sites (``calls``, of
    :func:`_calls_by_name`) pass there."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return [re.escape(arg.value)]
    if isinstance(arg, ast.JoinedStr):
        return ["".join(
            re.escape(v.value) if isinstance(v, ast.Constant) else ".+" for v in arg.values
        )]
    if not isinstance(arg, ast.Name):
        return []
    fn = graph.index.funcs[caller]
    params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    if arg.id not in params:
        return []
    pos = params.index(arg.id) - (1 if params and params[0] == "self" else 0)
    out: List[str] = []
    for key, node in calls.get(caller[1].rsplit(".", 1)[-1], ()):
        if graph.resolve(key[0], node, key) != caller:
            continue
        cands = [kw.value for kw in node.keywords if kw.arg == arg.id]
        if pos < len(node.args):
            cands.append(node.args[pos])
        out += [
            re.escape(c.value) for c in cands
            if isinstance(c, ast.Constant) and isinstance(c.value, str)
        ]
    return out


def launch_keys_passed(graph) -> Dict[str, Set[Tuple[str, str]]]:
    """LAUNCHES key → the functions of ``patrol_tpu_torch/ops/`` whose
    ``count_launch`` call can pass it."""
    from patrol_tpu_torch.analysis.lint import _is_count_launch
    from patrol_tpu_torch.analysis.prove import count_launch_callers
    from patrol_tpu_torch.ops import _build

    out: Dict[str, Set[Tuple[str, str]]] = {k: set() for k in _build.LAUNCHES}
    calls = _calls_by_name(graph)
    for rel, _line, name in count_launch_callers(graph):
        if not rel.startswith(_OPS_PREFIX):
            continue
        for node in ast.walk(graph.index.funcs[(rel, name)]):
            if not (isinstance(node, ast.Call) and _is_count_launch(node) and node.args):
                continue
            for pat in _key_patterns(node.args[0], graph, (rel, name), calls):
                for key in out:
                    if re.fullmatch(pat, key):
                        out[key].add((rel, name))
    return out


def _launch_key_line(key: str) -> int:
    try:
        with open(os.path.join(_repo_root(), _BUILD_PATH), encoding="utf-8") as fh:
            for lineno, line in enumerate(fh, start=1):
                if f'"{key}":' in line:
                    return lineno
    except OSError:
        pass
    return 1


def check_unregistered_kernels(sources: Optional[Dict[str, str]] = None) -> List[Finding]:
    """``sources`` ({repo-relative path: source}) defaults to the port's
    tree; the registered roots and exemptions are read from the registry
    at call time."""
    from patrol_tpu_torch.analysis.lint import repo_sources
    from patrol_tpu_torch.analysis.prove import CallGraph, _rel_of, count_launch_callers
    from patrol_tpu_torch.ops import obligations as ob

    graph = CallGraph(repo_sources(_repo_root()) if sources is None else sources)
    reached = graph.reach({(_rel_of(r.module), r.attr) for r in ob.PROVE_ROOTS})
    exempt = {(_rel_of(mod), attr) for mod, attr in ob.PROVE_EXEMPT}
    findings: List[Finding] = []
    for rel, line, name in count_launch_callers(graph):
        if not rel.startswith(_OPS_PREFIX) or (rel, name) in reached or (rel, name) in exempt:
            continue
        module = rel[:-3].replace("/", ".")
        findings.append(
            Finding(
                "PTK004", rel, line,
                f"kernel launcher '{module}.{name}' is reached by no root "
                "registered in any KernelFamily and carries no PROVE_EXEMPT "
                "justification: a lattice kernel cannot land uncertified",
            )
        )
    for key, callers in launch_keys_passed(graph).items():
        if not callers:
            findings.append(
                Finding(
                    "PTK004", _BUILD_PATH, _launch_key_line(key),
                    f"kernel launch key '{key}' is passed to count_launch by no "
                    f"function under {_OPS_PREFIX}: a counted kernel with no "
                    "launcher cannot be certified",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# PTK005 — registry integrity.


def check_registry_integrity(families=None) -> List[Finding]:
    from patrol_tpu_torch.ops import obligations as ob

    families = ob.KERNEL_FAMILIES if families is None else families
    findings: List[Finding] = []

    seen_fams: Dict[str, str] = {}
    seen_roots: Dict[str, str] = {}
    seen_specs: Dict[str, str] = {}
    seen_muts: Dict[str, str] = {}

    for fam in families:
        site = _family_site(fam.name)
        if fam.name in seen_fams:
            findings.append(
                Finding(
                    "PTK005", *site,
                    f"duplicate family name '{fam.name}'",
                )
            )
        seen_fams[fam.name] = fam.name

        if not fam.domain.strip():
            findings.append(
                Finding(
                    "PTK005", *site,
                    f"[{fam.name}] empty domain: the lattice must be "
                    "named in one line",
                )
            )

        for root in fam.prove_roots:
            if root.name in seen_roots:
                findings.append(
                    Finding(
                        "PTK005", *site,
                        f"[{fam.name}] prove root '{root.name}' is also "
                        f"claimed by family '{seen_roots[root.name]}'",
                    )
                )
            seen_roots[root.name] = fam.name
        for spec in fam.lin_specs:
            if spec.name in seen_specs:
                findings.append(
                    Finding(
                        "PTK005", *site,
                        f"[{fam.name}] lin spec '{spec.name}' is also "
                        f"claimed by family '{seen_specs[spec.name]}'",
                    )
                )
            seen_specs[spec.name] = fam.name

        if len(fam.mutations) < 2 and not fam.mutations_exempt:
            findings.append(
                Finding(
                    "PTK005", *site,
                    f"[{fam.name}] only {len(fam.mutations)} seeded "
                    "mutation(s): a family needs >= 2 (or a written "
                    "mutations_exempt justification) for the rejection "
                    "evidence to mean anything",
                )
            )

        for mut in fam.mutations:
            if mut.name in seen_muts:
                findings.append(
                    Finding(
                        "PTK005", *site,
                        f"[{fam.name}] mutation name '{mut.name}' is "
                        f"also used by family '{seen_muts[mut.name]}'",
                    )
                )
            seen_muts[mut.name] = fam.name
            if mut.stage not in _STAGES:
                findings.append(
                    Finding(
                        "PTK005", *site,
                        f"[{fam.name}] mutation '{mut.name}' names "
                        f"unknown stage '{mut.stage}'",
                    )
                )
            if not _CODE_RE.match(mut.expect):
                findings.append(
                    Finding(
                        "PTK005", *site,
                        f"[{fam.name}] mutation '{mut.name}' expect "
                        f"'{mut.expect}' is not a PT code",
                    )
                )

        if fam.wire_codec is not None and fam.wire_codec not in {
            r.name for r in fam.prove_roots
        }:
            findings.append(
                Finding(
                    "PTK005", *site,
                    f"[{fam.name}] wire_codec '{fam.wire_codec}' does "
                    "not name one of the family's own prove roots: the "
                    "codec would ship uncertified",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# The stage-9 gate.


def check_repo(
    execute_mutations: bool = True, device="cuda", stats: Optional[dict] = None
) -> List[Finding]:
    """Run the full certification meta-check: reachability, seeded-
    mutation rejection (payload mutations executed, the prove mutants on
    ``device``), absence justifications, the ops/ launcher sweep, and
    registry integrity."""
    findings: List[Finding] = []
    findings += check_registry_integrity()
    findings += check_reachability()
    findings += check_absent_justifications()
    findings += check_unregistered_kernels()
    findings += check_mutations(execute=execute_mutations, device=device, stats=stats)
    return findings
