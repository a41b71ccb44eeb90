"""Run patrol-cert — the kernel-certification meta-check over the port's
declarative ``KernelFamily`` registry (``patrol_tpu_torch/ops/obligations.py``;
stage 9, counterpart of the JAX package's ``scripts/cert_repo.py``).

    python -m patrol_tpu_torch.scripts.cert_repo [--device cuda|cpu] \\
        [--list] [--mutation NAME] [--no-execute]

Walks every registered lattice family and checks, cross-stage:

  PTK001  every family reaches every applicable checking stage
          (prove / protocol / lin / the keys chip_smoke.py writes for
          its kernel's end-to-end phase) or carries a written exemption
  PTK002  every seeded mutation is rejected with its EXACT registered
          code — mutant kernels (through the wrappers on ``--device``)
          and family-law payloads are executed here; stage-6/8 registry
          references are membership- and expect-checked
  PTK003  every obligation declared absent carries a justification
          string, and none has gone stale
  PTK004  every function under patrol_tpu_torch/ops/ that launches a
          kernel is reached from a registered root (or PROVE_EXEMPT,
          with the reason on record), and every launch key has one
  PTK005  registry integrity: unique names, >= 2 mutations per family,
          resolvable targets, well-formed codes

``--device cuda`` (the default, as the port's other stages) runs the
prove mutants through the CUDA kernels and raises without a card;
``--device cpu`` runs the kernels' plain versions. Each executed
mutation's line gives its codes, seconds and kernel launches.

Exit code 0 = clean (or, with ``--mutation``, the mutation was rejected
with its pinned code); 1 = findings printed one per line as
`path:line: CODE message` (or the mutation slipped through); 2 = unknown
``--mutation`` name. Inline ``# patrol-lint: disable=PTKxxx`` markers
suppress, as in every stage.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence


def _line(name: str, st: dict) -> str:
    launches = ",".join(f"{k}={v}" for k, v in sorted(st["launches"].items())) or "-"
    return (f"  {name} [{st['stage']}]: {','.join(st['codes']) or '-'} in "
            f"{st['seconds']:.3f} s, launches {launches}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    from patrol_tpu_torch.analysis import driver

    repo_root = driver.repo_root_for(__file__)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument(
        "--list",
        action="store_true",
        help="list registered families and their seeded mutations, then exit",
    )
    ap.add_argument(
        "--mutation",
        default=None,
        help="execute ONE named seeded mutation and print the verdict",
    )
    ap.add_argument(
        "--no-execute",
        action="store_true",
        help="registry/reachability checks only (skip mutation execution)",
    )
    args = ap.parse_args(argv)

    from patrol_tpu_torch.analysis import cert
    from patrol_tpu_torch.ops.obligations import KERNEL_FAMILIES

    if args.list:
        for fam in KERNEL_FAMILIES:
            stages = [
                "prove" if fam.prove_roots else "-",
                f"protocol={fam.protocol}" if fam.protocol else "protocol:exempt",
                "lin" if fam.lin_specs else "lin:exempt",
                "bench" if fam.bench_fields else "bench:exempt",
            ]
            print(f"family   {fam.name}  [{' '.join(stages)}]")
            for mut in fam.mutations:
                kind = "stage-ref" if mut.stage == "lin" else "executed"
                print(
                    f"mutation {mut.name}  → {mut.expect} "
                    f"[{mut.stage}, {kind}]"
                )
            if fam.mutations_exempt:
                print(f"mutation (exempt: {fam.mutations_exempt})")
        return 0

    if args.mutation:
        fam = next(
            (
                f
                for f in KERNEL_FAMILIES
                if any(m.name == args.mutation for m in f.mutations)
            ),
            None,
        )
        if fam is None:
            return driver.unknown_name("patrol-cert", "mutation", args.mutation)
        mut = next(m for m in fam.mutations if m.name == args.mutation)
        only = [dataclasses.replace(fam, mutations=(mut,))]
        stats: dict = {}
        findings = cert.check_mutations(families=only, execute=True, device=args.device,
                                        stats=stats)
        if mut.name in stats:
            print(_line(mut.name, stats[mut.name]))
        mine = [f for f in findings if f"'{args.mutation}'" in f.message]
        hit = not mine
        detail = (
            f"rejected with {mut.expect} (family {fam.name})"
            if hit
            else f"NOT rejected: {mine[0].message}"
        )
        return driver.mutation_verdict("patrol-cert", args.mutation, hit, detail)

    stats = {}
    findings = cert.check_repo(execute_mutations=not args.no_execute, device=args.device,
                               stats=stats)
    findings = driver.apply_stage_suppressions(findings, repo_root, "PTK")
    for name, st in stats.items():
        print(_line(name, st))

    executed = sum(
        1
        for f in KERNEL_FAMILIES
        for m in f.mutations
        if m.stage != "lin"
    )
    referenced = sum(
        1 for f in KERNEL_FAMILIES for m in f.mutations if m.stage == "lin"
    )
    return driver.finish(
        "patrol-cert",
        findings,
        lambda: (
            f"patrol-cert: clean ({len(KERNEL_FAMILIES)} families, "
            f"{executed} seeded mutations executed + {referenced} "
            "stage-8 references pinned, all rejected with their "
            "exact codes)"
        ),
    )


if __name__ == "__main__":
    sys.exit(main())
