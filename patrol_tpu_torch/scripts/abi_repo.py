"""Run patrol-abi — the native-ABI conformance prover + cross-boundary
concurrency lint — over every obligation registered in
``patrol_tpu_torch/ops/obligations.py::ABI_OBLIGATIONS``, against the
port's own ``libpatrolhost.so`` (stage 5; counterpart of the JAX
package's ``scripts/abi_repo.py``).

    python -m patrol_tpu_torch.scripts.abi_repo [--device cuda|cpu] \\
        [--only NAME,...] [--list] [--root DIR]

The fold's kernel twins (``merge_batch``, ``merge_batch_folded``,
``merge_rows_dense``) run on ``--device``: ``cuda`` (the default, as the
port's other scripts) launches ``join.cu`` and raises without a card;
``cpu`` runs their plain versions. Everything else is host-side.

Exit codes: 0 = every obligation holds; 1 = findings printed one per
line as

    path:line: CODE message

77 = the port's native library cannot be built or loaded (a LOUD skip
on stderr — never a silent pass).

See ``patrol_tpu_torch/analysis/abi.py`` for the passes and the PTA code
table, and ``# patrol-lint: disable=PTAxxx`` for the (greppable,
reviewed-like-code) suppression format.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from patrol_tpu_torch.analysis import driver

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--root",
        default=driver.repo_root_for(__file__),
        help="repo root (default: this checkout)",
    )
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument(
        "--only",
        default=None,
        help="comma-separated obligation-name substrings (default: all)",
    )
    ap.add_argument(
        "--list", action="store_true", help="list registered obligations"
    )
    args = ap.parse_args(argv)

    from patrol_tpu_torch.analysis import abi
    from patrol_tpu_torch.ops.obligations import ABI_OBLIGATIONS

    if args.list:
        for ob in ABI_OBLIGATIONS:
            print(
                f"{ob.name}  [{','.join(ob.codes)}]  check={ob.check} "
                f"symbol={ob.symbol or '-'} twins={','.join(ob.twins) or '-'}"
            )
        return 0

    only = (
        [k.strip() for k in args.only.split(",") if k.strip()]
        if args.only
        else None
    )
    try:
        if only:
            findings = abi.abi_all(only=only, device=args.device)
        else:
            findings = abi.abi_repo(os.path.abspath(args.root), device=args.device)
    except abi.NativeUnavailable as exc:
        print(f"patrol-abi: SKIPPED — {exc}", file=sys.stderr)
        return 77

    for f in findings:
        print(f)
    if findings:
        print(
            f"patrol-abi: {len(findings)} finding(s) across "
            f"{len({f.path for f in findings})} file(s)",
            file=sys.stderr,
        )
        return 1
    print(
        f"patrol-abi: clean ({len(ABI_OBLIGATIONS)} obligations, all hold, "
        f"fold twins on {args.device})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
