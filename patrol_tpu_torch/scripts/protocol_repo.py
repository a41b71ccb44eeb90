"""Run patrol-protocol — the bounded replication-protocol model checker —
over the port's copy of the model (stage 6; counterpart of the JAX
package's ``scripts/protocol_repo.py``).

    python -m patrol_tpu_torch.scripts.protocol_repo [--list] [--mutation NAME]

Enumerates bounded cluster schedules (2-3 nodes, bounded takes and fault
events) against the step-for-step protocol model in
``patrol_tpu_torch/analysis/protocol.py`` and machine-checks:

  PTC001  convergence-after-heal (all replicas = join of all state)
  PTC002  monotonicity of replicated state at every step
  PTC003  the AP bound: admitted <= limit x partition_sides
  PTC004  dup/reorder idempotence at ingest
  PTC005  meta: every seeded protocol mutation must be rejected
  PTC006  token conservation under GC, membership and the families' laws

Then every seeded mutation (the model's own and the family-law ones
registered in ``patrol_tpu_torch/ops/obligations.py``) runs once more
and prints its verdict; a registered mutation must be rejected with the
exact code the registry pins, else PTC005.

Exit code 0 = clean protocol passes AND every seeded mutation is caught;
1 = findings printed one per line as `path:line: CODE message`.

Pure python (no torch, no accelerator); deterministic — no randomness,
so a failure replays exactly.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence, Tuple


def mutation_findings(name: str) -> Tuple[Optional[list], Optional[str]]:
    """Run one seeded mutation → (findings, the code the registry pins or
    None); (None, None) for an unknown name."""
    from patrol_tpu_torch.analysis import protocol
    from patrol_tpu_torch.ops.obligations import MUTATIONS

    reg = {m.name: m for m in MUTATIONS if m.stage == "protocol"}
    m = reg.get(name)
    if m is not None and m.laws is not None:
        return protocol.FAMILY_CHECKS[m.target](laws=m.laws), m.expect
    sem = protocol.MUTATIONS.get(m.target if m is not None else name)
    if sem is None:
        return None, None
    return protocol.check_protocol(sem), (m.expect if m is not None else None)


def mutation_names() -> List[str]:
    """The model's seeded mutations, then the registry's family-law ones."""
    from patrol_tpu_torch.analysis import protocol
    from patrol_tpu_torch.ops.obligations import MUTATIONS

    laws = [m.name for m in MUTATIONS if m.stage == "protocol" and m.laws is not None]
    return list(protocol.MUTATIONS) + laws


def verdict(name: str, findings: list, expect: Optional[str]) -> Tuple[bool, str]:
    codes = sorted({f.check for f in findings})
    if expect is None:
        hit = bool(findings)
        return hit, f"{'REJECTED' if hit else 'NOT caught'} by {codes} ({'good' if hit else 'bad'})"
    hit = expect in codes
    if hit:
        return True, f"REJECTED by {expect} (good)"
    return False, f"NOT caught by {expect} (got: {codes or 'clean'}) (bad)"


def main(argv: Optional[Sequence[str]] = None) -> int:
    from patrol_tpu_torch.analysis import driver, protocol

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--mutation",
        default=None,
        help="run ONE named mutation and print what catches it (debug aid)",
    )
    ap.add_argument(
        "--list", action="store_true", help="list registered mutations and exit"
    )
    args = ap.parse_args(argv)

    if args.list:
        for name in mutation_names():
            print(name)
        return 0

    if args.mutation:
        findings, expect = mutation_findings(args.mutation)
        if findings is None:
            return driver.unknown_name("patrol-protocol", "mutation", args.mutation)
        driver.print_findings(findings)
        hit, detail = verdict(args.mutation, findings, expect)
        return driver.mutation_verdict("patrol-protocol", args.mutation, hit, detail)

    findings = list(protocol.check_repo())
    for name in mutation_names():
        caught, expect = mutation_findings(name)
        hit, detail = verdict(name, caught, expect)
        print(f"patrol-protocol: mutation '{name}' {detail}")
        if not hit:
            findings.append(
                protocol.Finding(
                    "PTC005", protocol._SELF, 0,
                    f"seeded protocol mutation '{name}' {detail}",
                )
            )

    def clean_line() -> str:
        explored, _ = protocol.check_async_schedules()
        return (
            "patrol-protocol: clean "
            f"(async states explored={explored}, "
            f"{len(mutation_names())} seeded mutations all rejected)"
        )

    return driver.finish("patrol-protocol", findings, clean_line)


if __name__ == "__main__":
    sys.exit(main())
