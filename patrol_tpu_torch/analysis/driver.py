"""patrol-check stage-driver harness (shared by
``patrol_tpu_torch/scripts/*_repo.py``; counterpart of the JAX package's
``analysis/driver.py``).

Every stage entrypoint used to re-implement the same four fragments:
repo-root discovery relative to the script file, findings printed one
per line as ``path:line: CODE message``, inline-suppression application
with stale-directive detection, and the exit-code contract (0 = clean
summary on stdout, 1 = finding count on stderr). This module is the one
copy; the scripts keep only their ``sys.path`` bootstrap plus their
stage-specific check calls and summary text.

Used by ``protocol_repo.py`` and ``lin_repo.py``; imports neither torch
nor numpy, so the pure-python stages stay accelerator-free.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Iterable, List, Optional, Sequence, Set, Union


def repo_root_for(script_file: str) -> str:
    """The repo root for a ``patrol_tpu_torch/scripts/<stage>_repo.py``
    entrypoint: the script's great-grandparent directory."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(script_file)))
    )


def print_findings(findings: Iterable[object]) -> None:
    """One finding per line, ``path:line: CODE message`` — every stage's
    ``Finding.__str__`` renders that shape already."""
    for f in findings:
        print(f)


def apply_stage_suppressions(
    findings: Sequence[object],
    repo_root: str,
    stale_family: str,
    inline_used: Optional[Set] = None,
) -> List[object]:
    """Inline ``# patrol-lint: disable=…`` suppression + stale-directive
    detection for one stage's code family (late import, keeping the
    module graph lazy as the reference does)."""
    from patrol_tpu_torch.analysis.lint import apply_suppressions

    return apply_suppressions(
        findings, repo_root, stale_family=stale_family, inline_used=inline_used
    )


def finish(
    stage: str,
    findings: Sequence[object],
    clean_line: Union[str, Callable[[], str]],
    findings_line: Optional[Callable[[Sequence[object]], str]] = None,
) -> int:
    """The shared exit contract: print findings one per line; on any,
    summarize to stderr and return 1; otherwise print the stage's clean
    summary (lazily computed so clean-only counters never run on the
    failure path) and return 0."""
    print_findings(findings)
    if findings:
        line = (
            findings_line(findings)
            if findings_line is not None
            else f"{stage}: {len(findings)} finding(s)"
        )
        print(line, file=sys.stderr)
        return 1
    print(clean_line() if callable(clean_line) else clean_line)
    return 0


def mutation_verdict(stage: str, name: str, hit: bool, detail: str) -> int:
    """Shared ``--mutation`` verdict line: 0 when the seeded mutation was
    rejected, 1 when it slipped through (the mutation itself failing to
    be caught is the finding)."""
    print(f"{stage}: mutation '{name}' {detail}")
    return 0 if hit else 1


def unknown_name(stage: str, kind: str, name: str) -> int:
    """Shared usage-error path for ``--mutation``/``--only`` lookups."""
    print(f"unknown {kind}: {name}", file=sys.stderr)
    return 2
