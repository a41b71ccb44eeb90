#!/usr/bin/env bash
# patrol-check for the PyTorch/CUDA port: the static-analysis + sanitizer
# + prover gate over patrol_tpu_torch/ (counterpart of scripts/check.sh).
#
# One command, one pass/fail exit code, ten stages (plus one opt-in). Each
# stage runs the port's driver, python -m patrol_tpu_torch.scripts.<stage>_repo,
# then the port's self-tests, tests/test_torch_<stage>.py -m <stage>, under
# JAX_PLATFORMS=cpu: those tests hold the port to the JAX package, so
# where the JAX package cannot be imported (a machine with the card and
# no jax) they are skipped with a notice and the driver's verdict stands.
#
#   lint    — the AST lint over patrol_tpu_torch/ (PTL001-007; PTL002: no
#             host-device sync reachable from a kernel launch).
#   tidy    — clang-tidy with the repo's curated profile (.clang-tidy) over
#             patrol_tpu_torch/native/. Skipped (77) with a notice when
#             clang-tidy is not installed.
#   san     — TSan, ASan (+LSan) and UBSan builds of both multi-threaded
#             drivers, patrol_tpu_torch/native/san/tsan_driver.cpp (UDP /
#             codec plane) and san_http_driver.cpp (epoll front, h1 parser,
#             h2 frame machine, in-front host-lane takes, the pump thread on
#             pt_http_poll), against patrol_tpu_torch/native/*.cpp. Any
#             sanitizer report fails the run.
#   prove   — the CRDT obligations of every kernel root, through the CUDA
#             kernels on --device (prove_repo).
#   abi     — the port's C++ library against the merge kernels on --device
#             and the Python references (abi_repo; exits 77 itself when the
#             library cannot build).
#   protocol— the bounded replication-protocol model checker. Pure Python.
#   race    — the epoll-seam explorer and the guarded-state analysis over
#             the port's thread ensemble. Pure Python.
#   lin     — replication-aware linearizability against sequential specs.
#             Pure Python.
#   cert    — the kernel-certification meta-check over KERNEL_FAMILIES, the
#             prove mutants executed on --device (cert_repo).
#   dispatch— no hidden host wait on the serve graph, a complete dispatch
#             registry, and the witness of every serving path on --device
#             (dispatch_repo).
#   asan-py — OPT-IN (select with --stage): the ctypes-facing pytest subset
#             (tests/test_torch_native*.py) under LD_PRELOAD=libasan with an
#             ASan-built libpatrolhost.so (PATROL_NATIVE_LIB) and the port's
#             LSan suppressions. Skips with a notice when the toolchain lacks
#             a preloadable libasan.
#
# Usage:   patrol_tpu_torch/scripts/check.sh [--device cuda|cpu] [--stage a,b]
#          --device (default cuda) goes to prove, abi, cert and dispatch; a
#          stage asked for the card raises without one (no CPU fallback).
# The final line is machine-readable (patrol_tpu_torch/scripts/ci_gate.sh
# asserts on it):
#          PATROL_CHECK stages=10 pass=9 skip=1 fail=0 skipped=tidy failed=-
set -euo pipefail
cd "$(dirname "$0")/../.."

DEFAULT_STAGES="lint,tidy,san,prove,abi,protocol,race,lin,cert,dispatch"
STAGES="$DEFAULT_STAGES"
DEVICE=cuda
while [[ $# -gt 0 ]]; do
  case "$1" in
    --stage|--stages) STAGES="$2"; shift 2 ;;
    --stage=*|--stages=*) STAGES="${1#*=}"; shift ;;
    --device) DEVICE="$2"; shift 2 ;;
    --device=*) DEVICE="${1#*=}"; shift ;;
    -h|--help)
      sed -n '2,49p' "$0" | sed 's/^# \{0,1\}//'
      exit 0 ;;
    *) echo "unknown argument: $1 (try --device cuda|cpu --stage lint,tidy,san,prove,abi,protocol,race,lin,cert,dispatch,asan-py)" >&2
       exit 2 ;;
  esac
done
[[ "$STAGES" == "all" ]] && STAGES="$DEFAULT_STAGES"
case "$DEVICE" in
  cuda|cpu) ;;
  *) echo "unknown device: '$DEVICE' (valid: cuda cpu)" >&2; exit 2 ;;
esac

# The self-tests import both packages: the JAX package is their reference.
have_selftests() { python -c "import pytest, jax, patrol_tpu" >/dev/null 2>&1; }

selftests() {  # selftests <stage> <test file>
  if have_selftests; then
    env JAX_PLATFORMS=cpu python -m pytest "$2" -q -m "$1" -p no:cacheprovider
  else
    echo "NOTICE: pytest or the JAX package is not importable here:" \
         "$1 self-tests ($2) skipped ($1_repo itself ran)"
  fi
}

# ---------------------------------------------------------------------------
# Toolchain probe (the reference's): g++ >= 12 (or clang >= 14) sanitizers
# intercept pthread_cond_clockwait, so the san stage builds with
# -DPT_STEADY_CV_WAIT, which puts pt_http_poll back on the steady-clock cv
# wait_for; an older toolchain keeps the wait_until(system_clock)
# workaround. One notice line either way.
GXX_MAJOR=$(g++ -dumpversion 2>/dev/null | cut -d. -f1 || echo 0)
CLANG_MAJOR=$(clang --version 2>/dev/null | grep -oE 'version [0-9]+' | grep -oE '[0-9]+' | head -1 || true)
SAN_CV_FLAGS=""
if [[ "${GXX_MAJOR:-0}" -ge 12 || "${CLANG_MAJOR:-0}" -ge 14 ]]; then
  SAN_CV_FLAGS="-DPT_STEADY_CV_WAIT"
  echo "patrol-check: toolchain probe: g++ ${GXX_MAJOR:-?} / clang ${CLANG_MAJOR:--} — modern sanitizers:" \
       "reverting the wait_until(system_clock) TSan workaround (steady-clock cv wait)"
else
  echo "patrol-check: toolchain probe: g++ ${GXX_MAJOR:-?} / clang ${CLANG_MAJOR:--} — pre-12/14 sanitizers:" \
       "keeping the wait_until(system_clock) TSan workaround"
fi

NATIVE=patrol_tpu_torch/native
SAN_DIR=$NATIVE/san

# Each stage runs in a subshell with its own `set -e`; exit 77 = skipped.

stage_lint() (
  set -euo pipefail
  echo "== patrol-check [lint] AST lint over patrol_tpu_torch/ =="
  python -m patrol_tpu_torch.scripts.lint_repo
  selftests lint tests/test_torch_lint.py
)

stage_tidy() (
  set -euo pipefail
  echo "== patrol-check [tidy] clang-tidy ($NATIVE/) =="
  if ! command -v clang-tidy >/dev/null 2>&1; then
    echo "clang-tidy not installed: SKIPPED (needs LLVM >= 14)"
    exit 77
  fi
  clang-tidy --version | head -2
  clang-tidy --config-file=.clang-tidy \
    "$NATIVE/patrol_host.cpp" \
    "$NATIVE/patrol_http.cpp" \
    -- -std=c++17 -x c++ -DPT_NO_MAIN
  echo "clang-tidy: clean"
)

stage_san() (
  set -euo pipefail
  echo "== patrol-check [san] sanitizer drivers ($SAN_DIR/) =="
  OUT=$(mktemp -d)
  trap 'rm -rf "$OUT"' EXIT

  build() {  # build <sanitizer> <driver>: one binary, its log beside it
    local san="$1" driver="$2" extra="" srcs
    [[ "$san" == undefined ]] && extra="-fno-sanitize-recover=all"
    case "$driver" in
      host) srcs="$SAN_DIR/tsan_driver.cpp $NATIVE/patrol_host.cpp" ;;
      http) srcs="$SAN_DIR/san_http_driver.cpp $NATIVE/patrol_host.cpp $NATIVE/patrol_http.cpp" ;;
    esac
    # SAN_CV_FLAGS (toolchain probe above) reverts the TSan condvar
    # workaround on toolchains whose libtsan intercepts clockwait.
    # shellcheck disable=SC2086
    g++ -std=c++17 -O1 -g -fsanitize="$san" $extra $SAN_CV_FLAGS -fPIC \
        -o "$OUT/${driver}_${san}" $srcs -DPT_NO_MAIN -lpthread -ldl \
        >"$OUT/${driver}_${san}.log" 2>&1
  }

  # The six builds at once (each compiles the whole library), then the
  # six runs one at a time, each binary alone on the machine.
  local_t0=$SECONDS
  declare -A pids
  for san in thread address undefined; do
    for driver in host http; do
      build "$san" "$driver" &
      pids["${driver}_${san}"]=$!
    done
  done
  built=0
  for b in "${!pids[@]}"; do
    if ! wait "${pids[$b]}"; then
      echo "-- build $b failed --"; cat "$OUT/$b.log"; built=1
    fi
  done
  [[ $built -eq 0 ]] || exit 1
  echo "-- six builds in $((SECONDS - local_t0)) s --"
  for san in thread address undefined; do
    case "$san" in
      thread)    runenv="TSAN_OPTIONS=halt_on_error=1" ;;
      address)   runenv="ASAN_OPTIONS=halt_on_error=1:detect_leaks=1" ;;
      undefined) runenv="UBSAN_OPTIONS=halt_on_error=1:print_stacktrace=1" ;;
    esac
    for driver in host http; do
      echo "-- $driver driver / $san --"
      t0=$SECONDS
      env "$runenv" "$OUT/${driver}_${san}"
      echo "-- $driver driver / $san: clean in $((SECONDS - t0)) s --"
    done
  done
)

stage_prove() (
  set -euo pipefail
  echo "== patrol-check [prove] CRDT obligations of every kernel root (--device $DEVICE) =="
  python -m patrol_tpu_torch.scripts.prove_repo --device "$DEVICE"
  selftests prove tests/test_torch_prove.py
)

stage_abi() (
  set -euo pipefail
  echo "== patrol-check [abi] native-ABI conformance (--device $DEVICE) =="
  # abi_repo exits 77 itself when the library cannot load: the stage skips
  # LOUDLY instead of vacuously passing.
  python -m patrol_tpu_torch.scripts.abi_repo --device "$DEVICE"
  selftests abi tests/test_torch_abi.py
)

stage_protocol() (
  set -euo pipefail
  echo "== patrol-check [protocol] bounded replication-protocol model checker =="
  python -m patrol_tpu_torch.scripts.protocol_repo
  selftests protocol tests/test_torch_protocol.py
)

stage_race() (
  set -euo pipefail
  echo "== patrol-check [race] cross-seam concurrency prover + guarded-state analysis =="
  python -m patrol_tpu_torch.scripts.race_repo
  selftests race tests/test_torch_race.py
)

stage_lin() (
  set -euo pipefail
  echo "== patrol-check [lin] replication-aware linearizability checker =="
  python -m patrol_tpu_torch.scripts.lin_repo
  selftests lin tests/test_torch_lin.py
)

stage_cert() (
  set -euo pipefail
  echo "== patrol-check [cert] kernel-certification meta-check (--device $DEVICE) =="
  python -m patrol_tpu_torch.scripts.cert_repo --device "$DEVICE"
  selftests cert tests/test_torch_cert_stage.py
)

stage_dispatch() (
  set -euo pipefail
  echo "== patrol-check [dispatch] dispatch discipline + witness (--device $DEVICE) =="
  python -m patrol_tpu_torch.scripts.dispatch_repo --device "$DEVICE"
  selftests dispatch tests/test_torch_dispatch.py
)

stage_asan_py() (
  set -euo pipefail
  echo "== patrol-check [asan-py] ctypes seam under LD_PRELOAD=libasan =="
  local_asan=$(gcc -print-file-name=libasan.so 2>/dev/null || true)
  if [[ "$local_asan" != /* || ! -e "$local_asan" ]]; then
    echo "no preloadable libasan.so (gcc -print-file-name): SKIPPED"
    exit 77
  fi
  if ! have_selftests; then
    echo "pytest or the JAX package is not importable (the subset's reference): SKIPPED"
    exit 77
  fi
  OUT=$(mktemp -d)
  trap 'rm -rf "$OUT"' EXIT
  echo "-- building ASan-instrumented libpatrolhost --"
  g++ -std=c++17 -O1 -g -shared -fPIC -fsanitize=address -pthread \
      -o "$OUT/libpatrolhost_asan.so" \
      "$NATIVE/patrol_host.cpp" "$NATIVE/patrol_http.cpp"
  # malloc_context_size keeps native allocation stacks within native
  # frames, so the interpreter-side LSan suppressions cannot mask a real
  # native leak (patrol_tpu_torch/native/san/lsan_python.supp).
  ASAN_PY_ENV=(
    LD_PRELOAD="$local_asan"
    PATROL_NATIVE_LIB="$OUT/libpatrolhost_asan.so"
    ASAN_OPTIONS="halt_on_error=1:detect_leaks=1:malloc_context_size=5:detect_odr_violation=0"
    LSAN_OPTIONS="suppressions=$PWD/$NATIVE/san/lsan_python.supp:print_suppressions=0"
    JAX_PLATFORMS=cpu
  )
  # Host tools the subset spawns (curl as an h2 client, g++ in the build
  # tests) are not under test and do not run under the preload (curl hangs
  # in its start-up; the linker's plugin leaks): each is reached through a
  # wrapper early on PATH that drops LD_PRELOAD.
  mkdir -p "$OUT/bin"
  for tool in curl g++; do
    real=$(command -v "$tool" || true)
    [[ -n "$real" ]] || continue
    printf '#!/bin/sh\nunset LD_PRELOAD\nexec %s "$@"\n' "$real" >"$OUT/bin/$tool"
    chmod +x "$OUT/bin/$tool"
  done
  ASAN_PY_ENV+=(PATH="$OUT/bin:$PATH")
  # The subset runs the port's engines, so torch must run under the
  # preload, and its reference comparisons trace the JAX package. Probe
  # each once; where one cannot run, drop the tests that need it and say
  # exactly what was dropped.
  SUBSET=(tests/test_torch_native.py tests/test_torch_native_http.py tests/test_torch_native_hls.py)
  KEXPR=""
  if ! env "${ASAN_PY_ENV[@]}" ASAN_OPTIONS="detect_leaks=0" \
      python -c "import torch; torch.ones(4).cumsum(0)" >/dev/null 2>&1; then
    echo "NOTICE: this toolchain's ASan cannot host torch under the preload;"
    echo "NOTICE: running the ctypes seam without the engines only" \
         "(tests/test_torch_native.py minus its engine-driven cases);" \
         "the pt_http_poll seam (test_torch_native_http.py, _hls.py) is dropped."
    SUBSET=(tests/test_torch_native.py)
    KEXPR="not engine"
  fi
  if ! env "${ASAN_PY_ENV[@]}" ASAN_OPTIONS="detect_leaks=0" \
      python -c "import jax; jax.jit(lambda x: x + 1)(1)" >/dev/null 2>&1; then
    echo "NOTICE: this toolchain's ASan cannot host jax tracing (its __cxa_throw" \
         "interceptor vs jaxlib's static libstdc++): dropped the two cases that run a" \
         "JAX node or engine (test_rx_dedup_..._like_the_jax_engine," \
         "test_mixed_cluster_on_native_fronts_converges); the port's seam runs whole."
    KEXPR="${KEXPR:+$KEXPR and }not jax_engine and not mixed_cluster"
  fi
  env "${ASAN_PY_ENV[@]}" \
      python -m pytest "${SUBSET[@]}" ${KEXPR:+-k "$KEXPR"} -q -p no:cacheprovider
)

PASS=() ; SKIP=() ; FAIL=()
run_stage() {
  # The stage runs as a plain command with errexit off out here: called in
  # an `||` list instead, bash would ignore `set -e` inside the stage's
  # subshell too, and a failure before its last command would be lost.
  local name="$1" fn="$2" rc t0=$SECONDS
  set +e
  "$fn"
  rc=$?
  set -e
  echo "patrol-check: stage '$name' rc=$rc in $((SECONDS - t0)) s"
  case "$rc" in
    0)  PASS+=("$name") ;;
    77) SKIP+=("$name") ;;
    *)  FAIL+=("$name"); echo "patrol-check: stage '$name' FAILED (rc=$rc)" >&2 ;;
  esac
}

IFS=',' read -r -a SELECTED <<<"$STAGES"
for s in "${SELECTED[@]}"; do
  case "$s" in
    lint|tidy|san|prove|abi|protocol|race|lin|cert|dispatch|asan-py) ;;
    *) echo "unknown stage: '$s' (valid: lint tidy san prove abi protocol race lin cert dispatch asan-py)" >&2; exit 2 ;;
  esac
done
for s in lint tidy san prove abi protocol race lin cert dispatch asan-py; do
  for sel in "${SELECTED[@]}"; do
    if [[ "$sel" == "$s" ]]; then
      case "$s" in
        lint)    run_stage lint    stage_lint ;;
        tidy)    run_stage tidy    stage_tidy ;;
        san)     run_stage san     stage_san ;;
        prove)   run_stage prove   stage_prove ;;
        abi)     run_stage abi     stage_abi ;;
        protocol) run_stage protocol stage_protocol ;;
        race)    run_stage race    stage_race ;;
        lin)     run_stage lin     stage_lin ;;
        cert)    run_stage cert    stage_cert ;;
        dispatch) run_stage dispatch stage_dispatch ;;
        asan-py) run_stage asan-py stage_asan_py ;;
      esac
    fi
  done
done

total=$(( ${#PASS[@]} + ${#SKIP[@]} + ${#FAIL[@]} ))
join() { local IFS=','; [[ $# -gt 0 ]] && echo "$*" || echo "-"; }
echo "PATROL_CHECK stages=$total pass=${#PASS[@]} skip=${#SKIP[@]} fail=${#FAIL[@]} skipped=$(join ${SKIP[@]+"${SKIP[@]}"}) failed=$(join ${FAIL[@]+"${FAIL[@]}"})"
if [[ ${#FAIL[@]} -gt 0 ]]; then
  exit 1
fi
echo "patrol-check: ALL CLEAN"
