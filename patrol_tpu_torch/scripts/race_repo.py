"""Run patrol-race — the cross-seam concurrency prover + guarded-state
static analysis — over the port's own code (counterpart of the JAX
package's ``scripts/race_repo.py``, stage 7).

    python -m patrol_tpu_torch.scripts.race_repo [--list] [--mutation NAME] [--static-only]

Two halves (``patrol_tpu_torch/analysis/race.py``):

  dynamic  exhaustive deterministic interleavings of the C++ HTTP
           front's epoll-seam protocol model (pt_http_poll park/drain,
           completion-ring (slot, gen) tags, pt_http_complete_takes
           fan-in) across epoll-script / pump / completer actors:
    PTR001   lost wakeup / stalled completion (liveness)
    PTR002   completion-ring token conservation (safety)
           with three seeded mutations (completion-before-park,
           ring-slot reuse without fence, ack-without-holding-mutex)
           that must each be demonstrably rejected.

  static   over the port's engine/net thread-ensemble sources:
    PTR003   guarded attribute touched outside its declared lock
             (GUARDS registry), and retained-buffer ownership
             (owns_buffers/borrows_until) use-after-recycle
    PTR004   lock-graph cycle or declared-order inversion
             (_resize_mu -> _evict_mu -> _host_mu -> _state_mu, with
             NATIVE_EFFECTS.takes_host_mu call sites counted as
             _host_mu acquisitions)
    PTR005   condvar wait() without an enclosing predicate loop

Exit code 0 = the port proves clean AND every seeded seam mutation is
rejected; 1 = findings printed one per line as `path:line: CODE message`
(suppressible inline with `# patrol-lint: disable=PTRnnn`); 2 = unknown
``--mutation`` name.

Pure python (no torch, no native build); deterministic — no randomness,
so a failure replays exactly.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from patrol_tpu_torch.analysis import driver, race

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--mutation",
        default=None,
        help="run ONE named seam mutation and print what catches it",
    )
    ap.add_argument(
        "--list", action="store_true",
        help="list registered seam mutations and exit",
    )
    ap.add_argument(
        "--static-only", action="store_true",
        help="run only the static half (guarded state / lock graph / "
        "condvar / ownership)",
    )
    args = ap.parse_args(argv)
    repo_root = driver.repo_root_for(__file__)

    if args.list:
        for name in race.SEAM_MUTATIONS:
            print(name)
        return 0

    if args.mutation:
        entry = race.SEAM_MUTATIONS.get(args.mutation)
        if entry is None:
            return driver.unknown_name("patrol-race", "mutation", args.mutation)
        sem, code = entry
        findings = race.check_seam(sem)
        driver.print_findings(findings)
        hit = any(f.check == code for f in findings)
        return driver.mutation_verdict(
            "patrol-race",
            args.mutation,
            hit,
            f"REJECTED by {code} (good)" if hit else "NOT caught (bad)",
        )

    if args.static_only:
        used = set()
        findings = driver.apply_stage_suppressions(
            race.race_static(race.race_sources(repo_root), used_out=used),
            repo_root,
            stale_family="PTR",
            inline_used=used,
        )
    else:
        findings = race.race_repo(repo_root)

    def clean_line() -> str:
        explored = sum(
            race.explore_seam(sc)[0] for sc in race.builtin_seam_scenarios()
        )
        n_guards = sum(
            len(attrs)
            for per_cls in race.GUARDS.values()
            for attrs in per_cls.values()
        )
        return (
            "patrol-race: clean "
            f"(seam states explored={explored} across "
            f"{len(race.builtin_seam_scenarios())} scenarios, "
            f"{len(race.SEAM_MUTATIONS)} seeded mutations all rejected; "
            f"{n_guards} guarded attrs, "
            f"{len(race.RACE_FILES)} thread-ensemble files)"
        )

    return driver.finish("patrol-race", findings, clean_line)


if __name__ == "__main__":
    sys.exit(main())
