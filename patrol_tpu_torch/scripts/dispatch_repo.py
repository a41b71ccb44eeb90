"""Run patrol-dispatch — no hidden host wait on the serve graph, a
complete dispatch registry, and the witness of every serving path — over
the port (stage 10; counterpart of the JAX package's
``scripts/dispatch_repo.py``).

    python -m patrol_tpu_torch.scripts.dispatch_repo [--device cuda|cpu] \\
        [--mutation NAME] [--list] [--root DIR]

The static half (PTD003, PTD005) reads the sources. The witness (PTD004)
runs every path of ``ops/obligations.py::WITNESS_LAUNCHES`` on a small
engine on ``--device``: ``cuda`` (the default) counts each path's kernel
launches and event waits and runs its warm leg under
``torch.cuda.set_sync_debug_mode("error")``, and raises without a card; ``cpu`` runs the shape, dtype
and reached-wrapper half only, and says so.

Exit codes: 0 = clean (or, with ``--mutation``, the seeded mutation was
rejected with its code); 1 = findings printed one per line as

    path:line: CODE message

(or the mutation slipped through); 2 = unknown ``--mutation`` name.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from patrol_tpu_torch.analysis import driver

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=driver.repo_root_for(__file__),
                    help="repo root (default: this checkout)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--mutation", default=None, help="run one seeded mutation")
    ap.add_argument("--list", action="store_true",
                    help="list the specs, the witness paths, the declared waits")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)

    from patrol_tpu_torch.analysis import dispatch
    from patrol_tpu_torch.ops import obligations as ob

    if args.list:
        for s in ob.DISPATCH_SPECS:
            where = f"witness={s.witness}" if s.witness else f"absent: {s.witness_absent}"
            print(f"{s.name}  {s.module}.{s.attr}  launcher={s.launcher or '-'}  "
                  f"buckets={s.buckets}({s.bucket_lo}, {s.bucket_hi})  {where}")
        for path, launches in ob.WITNESS_LAUNCHES.items():
            print(f"path: {path}  {dict(launches)}")
        for p, q, w, why in ob.DECLARED_WAITS:
            print(f"wait: {p}::{q} {w}  ({why})")
        for code, why in ob.DISPATCH_ABSENT.items():
            print(f"absent: {code}  {why}")
        for name, (code, what, _) in dispatch.DISPATCH_MUTATIONS.items():
            print(f"mutation: {name} expects {code} ({what})")
        return 0
    if args.mutation is not None:
        if args.mutation not in dispatch.DISPATCH_MUTATIONS:
            return driver.unknown_name("patrol-dispatch", "mutation", args.mutation)
        code = dispatch.DISPATCH_MUTATIONS[args.mutation][0]
        findings = dispatch.mutation_findings(args.mutation, root, device=args.device)
        codes = sorted({f.check for f in findings})
        hit = code in codes
        detail = (f"REJECTED by {code} (good)" if hit else
                  f"NOT caught by {code} (got: {codes or 'clean'}) (bad)")
        return driver.mutation_verdict("patrol-dispatch", args.mutation, hit, detail)

    findings, report = dispatch.dispatch_repo(root, device=args.device)
    print(f"witness on {report.device} ({report.half}):")
    for path in report.paths:
        print(f"  {path}: {report.seconds[path]:.4f} s, launches {report.launches[path] or '{}'}, "
              f"reached {report.reached[path]}, waits {report.waits[path] or '{}'}")
    return driver.finish(
        "patrol-dispatch",
        findings,
        lambda: (f"patrol-dispatch: clean ({len(ob.DISPATCH_SPECS)} specs, "
                 f"{len(report.paths)} witness paths on {args.device}, "
                 f"{len(ob.DECLARED_WAITS)} declared waits; "
                 f"{', '.join(ob.DISPATCH_ABSENT)} absent on record)"),
    )


if __name__ == "__main__":
    sys.exit(main())
