"""Run the patrol-check AST lint over the port's own sources (counterpart
of the JAX package's ``scripts/lint_repo.py``).

    python -m patrol_tpu_torch.scripts.lint_repo [--root DIR]

Lints every Python file under ``patrol_tpu_torch/`` with PTL001-PTL007,
and the ``extern "C"`` entries of ``patrol_tpu_torch/csrc/*.cu`` that the
kernel launch roots call (PTL002's CUDA half). Exit code 0 = zero
findings; 1 = findings printed one per line as

    path:line: CODE message

See ``patrol_tpu_torch/analysis/lint.py`` for the checks and their
tables, and README.md for the suppression format. No torch, no
accelerator.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from patrol_tpu_torch.analysis import driver, lint

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--root",
        default=driver.repo_root_for(__file__),
        help="repo root (default: the checkout this script lives in)",
    )
    args = ap.parse_args(argv)
    findings = lint.lint_repo(args.root)
    return driver.finish(
        "patrol-lint",
        findings,
        "patrol-lint: clean",
        lambda fs: (
            f"patrol-lint: {len(fs)} finding(s) across "
            f"{len({f.path for f in fs})} file(s)"
        ),
    )


if __name__ == "__main__":
    sys.exit(main())
