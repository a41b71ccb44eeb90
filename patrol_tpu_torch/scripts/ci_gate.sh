#!/usr/bin/env bash
# ci_gate: the CI wrapper around the port's check runner
# (patrol_tpu_torch/scripts/check.sh; counterpart of scripts/ci_gate.sh)
# that makes stage skips a FAILURE instead of a notice.
#
# check.sh is tolerant by design (a host without LLVM still gets the
# other stages); CI must not be: a tidy stage that silently never runs is
# a hole in the gate. This gate
#
#   1. pins the toolchain floor: clang-tidy >= 14 must be on PATH
#      (unless explicitly waived with --allow-skip tidy);
#   2. runs check.sh (all stages, or --stage ...; --device goes through),
#      capturing the machine-readable `PATROL_CHECK stages=N pass=..
#      skip=.. fail=.. skipped=.. failed=..` summary line;
#   3. asserts `skipped=-` — every selected stage actually ran — modulo
#      an explicit, visible-in-CI-config --allow-skip list.
#
# Usage:
#   patrol_tpu_torch/scripts/ci_gate.sh                       # full gate, zero skips
#   patrol_tpu_torch/scripts/ci_gate.sh --allow-skip tidy     # host without LLVM
#   patrol_tpu_torch/scripts/ci_gate.sh --device cpu --stage lint,prove,abi
set -euo pipefail
cd "$(dirname "$0")/../.."

ALLOW_SKIP=""
CHECK_ARGS=()
while [[ $# -gt 0 ]]; do
  case "$1" in
    --allow-skip) ALLOW_SKIP="$2"; shift 2 ;;
    --allow-skip=*) ALLOW_SKIP="${1#*=}"; shift ;;
    --stage|--stages) CHECK_ARGS+=(--stage "$2"); shift 2 ;;
    --stage=*|--stages=*) CHECK_ARGS+=("$1"); shift ;;
    --device) CHECK_ARGS+=(--device "$2"); shift 2 ;;
    --device=*) CHECK_ARGS+=("$1"); shift ;;
    -h|--help) sed -n '2,21p' "$0" | sed 's/^# \{0,1\}//'; exit 0 ;;
    *) echo "ci_gate: unknown argument $1" >&2; exit 2 ;;
  esac
done

allowed() {  # allowed <stage> → 0 iff stage is in the --allow-skip list
  local IFS=','
  for a in $ALLOW_SKIP; do [[ "$a" == "$1" ]] && return 0; done
  return 1
}

# Toolchain floor: clang-tidy >= 14, pinned here so the tidy stage cannot
# degrade to a permanent skip on CI hosts.
if ! allowed tidy; then
  if ! command -v clang-tidy >/dev/null 2>&1; then
    echo "ci_gate: clang-tidy not installed (need >= 14); install LLVM or" \
         "waive explicitly with --allow-skip tidy" >&2
    exit 1
  fi
  ver=$(clang-tidy --version | grep -oE 'version [0-9]+' | grep -oE '[0-9]+' | head -1)
  if [[ -z "$ver" || "$ver" -lt 14 ]]; then
    echo "ci_gate: clang-tidy version '$ver' < 14 (the curated profile" \
         "needs modern checks); upgrade or --allow-skip tidy" >&2
    exit 1
  fi
fi

LOG=$(mktemp)
trap 'rm -f "$LOG"' EXIT
rc=0
bash patrol_tpu_torch/scripts/check.sh "${CHECK_ARGS[@]+"${CHECK_ARGS[@]}"}" 2>&1 | tee "$LOG" || rc=$?

SUMMARY=$(grep -E '^PATROL_CHECK ' "$LOG" | tail -1 || true)
if [[ -z "$SUMMARY" ]]; then
  echo "ci_gate: no PATROL_CHECK summary line emitted (check.sh died early)" >&2
  exit 1
fi
if [[ $rc -ne 0 ]]; then
  echo "ci_gate: check.sh failed (rc=$rc): $SUMMARY" >&2
  exit "$rc"
fi

skipped=$(sed -E 's/.* skipped=([^ ]+).*/\1/' <<<"$SUMMARY")
if [[ "$skipped" != "-" ]]; then
  IFS=',' read -r -a SKIPPED_LIST <<<"$skipped"
  for s in "${SKIPPED_LIST[@]}"; do
    if ! allowed "$s"; then
      echo "ci_gate: stage '$s' was SKIPPED ($SUMMARY); a skipped stage is" \
           "a silent hole in the gate — fix the toolchain or waive it" \
           "explicitly with --allow-skip $s" >&2
      exit 1
    fi
  done
  echo "ci_gate: skips [$skipped] explicitly waived (--allow-skip $ALLOW_SKIP)"
fi
echo "ci_gate: PASS — $SUMMARY"
