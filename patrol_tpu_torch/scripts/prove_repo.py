"""Run patrol-prove — the CRDT obligations of every root registered in
``patrol_tpu_torch/ops/obligations.py::PROVE_ROOTS`` — over the port's
kernels (stage 4; counterpart of the JAX package's ``scripts/prove_repo.py``).

    python -m patrol_tpu_torch.scripts.prove_repo [--device cuda|cpu] \\
        [--mutation NAME] [--list] [--root DIR]

``--device cuda`` (the default, as the port's other scripts) runs the
models through the wrappers, so the CUDA kernels of ``csrc/*.cu`` are
what they prove, and raises without a card; ``--device cpu`` runs the
kernels' plain versions. Each root's line gives its seconds, the kernel
launches its run made and the combinations its model enumerated.

Exit codes: 0 = every obligation holds (or, with ``--mutation``, the
seeded mutation was rejected with its pinned code); 1 = findings printed
one per line as

    path:line: CODE message

(or the mutation slipped through); 2 = unknown ``--mutation`` name.
See ``patrol_tpu_torch/analysis/prove.py`` for the passes and
``# patrol-lint: disable=PTPxxx`` for the suppression format.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Sequence


def _line(name: str, st: dict) -> str:
    launches = ",".join(f"{k}={v}" for k, v in sorted(st["launches"].items())) or "-"
    notes = f" ({'; '.join(st['notes'])})" if st["notes"] else ""
    return (f"  {name}: {st['seconds']:.3f} s, launches {launches}, "
            f"combinations {st['combinations']}{notes}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    from patrol_tpu_torch.analysis import driver

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=driver.repo_root_for(__file__),
                    help="repo root (default: this checkout)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--mutation", default=None, help="run one seeded prove-stage mutation")
    ap.add_argument("--list", action="store_true", help="list the roots and the mutations")
    args = ap.parse_args(argv)

    from patrol_tpu_torch.analysis import prove
    from patrol_tpu_torch.ops.obligations import MUTATIONS, PROVE_EXEMPT, PROVE_ROOTS

    muts = {m.name: m for m in MUTATIONS if m.stage == "prove"}
    if args.list:
        for r in PROVE_ROOTS:
            print(f"{r.name}  [{','.join(r.obligations)}]  {r.module}.{r.attr}  "
                  f"structural={r.structural or '-'} model={r.model or '-'} "
                  f"launches={','.join(r.launches) or '-'}")
        for mod, attr in sorted(PROVE_EXEMPT):
            print(f"exempt: {mod}.{attr}")
        for m in muts.values():
            print(f"mutation: {m.name} -> {m.target} expects {m.expect}")
        return 0
    if args.mutation is not None:
        m = muts.get(args.mutation)
        if m is None:
            return driver.unknown_name("patrol-prove", "mutation", args.mutation)
        root = next(r for r in PROVE_ROOTS if r.name == m.target)
        findings = prove.prove_root(root, fn=m.mutant, device=args.device)
        codes = sorted({f.check for f in findings})
        hit = m.expect in codes
        detail = (f"REJECTED by {m.expect} (good)" if hit else
                  f"NOT caught by {m.expect} (got: {codes or 'clean'}) (bad)")
        return driver.mutation_verdict("patrol-prove", m.name, hit, detail)

    stats: dict = {}
    t0 = time.perf_counter()
    findings = prove.prove_repo(os.path.abspath(args.root), device=args.device, stats=stats)
    seconds = time.perf_counter() - t0
    for name, st in stats.items():
        print(_line(name, st))
    return driver.finish(
        "patrol-prove",
        findings,
        lambda: (f"patrol-prove: clean ({len(stats)} roots, {len(PROVE_EXEMPT)} exempt, "
                 f"on {args.device}, {seconds:.1f} s)"),
    )


if __name__ == "__main__":
    sys.exit(main())
