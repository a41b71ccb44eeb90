"""Run patrol-lin — replication-aware linearizability checking against a
sequential limiter spec (arXiv:2502.19967) — over the port's registry
(stage 8; counterpart of the JAX package's ``scripts/lin_repo.py``).

    python -m patrol_tpu_torch.scripts.lin_repo [--list] [--mutation NAME]

For every kernel family registered in
``patrol_tpu_torch/ops/obligations.py::LIN_SPECS`` it enumerates bounded
schedules through the shared stage-6 enumerator
(``patrol_tpu_torch/analysis/protocol.py::enumerate_schedules`` — takes,
delivery, dup/drop, partition, heal, refill, GC) plus a sync-delivery
suite, and checks every outcome against the sequential spec under
explicit per-node visibility relations:

  PTN001  per-node sequential soundness (each take justified by a
          linearization of the ops visible to it)
  PTN002  global visibility-respecting linearization once converged
          (partition schedules: linearizable up to visibility)
  PTN003  sync-delivery schedules grant EXACTLY what the sequential
          spec grants — full linearizability, no replication slack
  PTN004  refills/GC/cap adoption never manufacture a grant the spec
          refuses under ANY visibility extension
  PTN005  meta: every seeded lin mutation rejected with its exact code,
          every mutation knob exercised (the trust story)

A clean run prints each seeded mutation's verdict (the gate rejected it
with its exact code) before the summary.

Exit code 0 = every family clean AND every seeded mutation caught;
1 = findings printed one per line as `path:line: CODE message`.

Pure python model (no torch, no accelerator); deterministic — a failure
replays exactly, and each finding carries its witness schedule.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from patrol_tpu_torch.analysis import driver

    repo_root = driver.repo_root_for(__file__)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--mutation",
        default=None,
        help="run ONE named mutation and print what catches it (debug aid)",
    )
    ap.add_argument(
        "--list",
        action="store_true",
        help="list registered spec families and mutations, then exit",
    )
    args = ap.parse_args(argv)

    from patrol_tpu_torch.analysis import linearizability as lin
    from patrol_tpu_torch.ops.obligations import LIN_SPECS

    if args.list:
        for spec in LIN_SPECS:
            flags = f"wire={spec.wire} algebra={spec.algebra}" + (
                " lifecycle" if spec.lifecycle else ""
            )
            print(f"family   {spec.name}  [{flags}]")
        for name, mut in lin.LIN_MUTATIONS.items():
            print(f"mutation {name}  → {mut.expect} on {mut.family}")
        return 0

    if args.mutation:
        mut = lin.LIN_MUTATIONS.get(args.mutation)
        if mut is None:
            return driver.unknown_name("patrol-lin", "mutation", args.mutation)
        spec = next((s for s in LIN_SPECS if s.name == mut.family), None)
        if spec is None:
            print(f"family not registered: {mut.family}", file=sys.stderr)
            return 2
        explored, findings = lin.check_family(
            spec, mut.laws, stop_at_first=False
        )
        driver.print_findings(findings)
        hit = any(f.check == mut.expect for f in findings)
        return driver.mutation_verdict(
            "patrol-lin",
            args.mutation,
            hit,
            (
                f"REJECTED by {mut.expect} (good)"
                if hit
                else f"NOT caught by {mut.expect} (bad)"
            )
            + f" — {explored} schedules",
        )

    explored, findings = lin.check_repo(LIN_SPECS)
    # check_repo runs every seeded mutation and reports one that was not
    # rejected with its exact code as a PTN005 naming it.
    for name, mut in lin.LIN_MUTATIONS.items():
        missed = any(f.check == "PTN005" and f"'{name}'" in f.message for f in findings)
        print(
            f"patrol-lin: mutation '{name}' "
            + (f"NOT caught by {mut.expect} (bad)" if missed else f"REJECTED by {mut.expect} (good)")
        )
    findings = driver.apply_stage_suppressions(
        findings, repo_root, stale_family="PTN"
    )
    return driver.finish(
        "patrol-lin",
        findings,
        "patrol-lin: clean "
        f"(schedules explored={explored} across {len(LIN_SPECS)} kernel "
        f"families, {len(lin.LIN_MUTATIONS)} seeded mutations all "
        "rejected with their exact codes)",
    )


if __name__ == "__main__":
    sys.exit(main())
