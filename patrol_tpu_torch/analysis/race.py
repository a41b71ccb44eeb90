"""patrol-race over the port's own code — cross-seam deterministic
concurrency prover + guarded-state static analysis (counterpart of the JAX
package's ``analysis/race.py``, stage 7 of patrol-check). The laws, the
seam model and the checks are the reference's; the tables are keyed to
``patrol_tpu_torch/`` and name the port's own shared state (the scrape
epoch ``_state_gen`` and its refresh hint ``_mirror_want``, the mesh
engine's ``_state_gen``, and ``_resize_mu`` in the declared lock order).

The prover stack so far certifies the *algebra* (patrol-prove), the
*native twins* (patrol-abi, including the PTA004 host-lane-store schedule
explorer) and the *replication protocol* (patrol-protocol). What none of
them sees is the host-side thread ensemble itself: the engine runs five
cooperating threads (feeder, completer, anti-entropy worker, delta
flusher, replication rx) whose shared state is guarded by comment-level
convention ("cleared under ``_host_mu`` only AFTER the ``_state_mu``
merge lands"), and the C++ HTTP front's epoll thread talks to the Python
pump through a mutex/condvar/ring protocol that only TSan exercises —
and TSan only sees the interleavings a particular run happens to take.
"Automatically Verifying Replication-aware Linearizability"
(arXiv:2502.19967) closes this gap for replication protocols by model
checking implementations against specs; patrol-race is the concurrency
analogue for patrol's own seams. Two halves:

**Dynamic — the epoll-seam schedule explorer (PTR001, PTR002).** A
step-for-step Python model of the ``patrol_http.cpp`` front protocol —
``Server.mu``/``cv``, the parsed-take ring (``take_q``), (slot, gen)
completion tags, ``pt_http_poll`` park/drain, ``pt_http_complete_takes``
fan-in — explored over EVERY interleaving of three concurrent actors
(the epoll thread running arrival/close scripts, the Python pump's poll
loop, and a modeled completer), bounded and exhaustive with state
memoization. Steps that the real code runs under ``Server::mu`` are
atomic in the model (lock-based reduction: two critical sections on the
same mutex cannot interleave); seeded mutations split exactly the
accesses the real bug class would leave unprotected:

* ``completion-before-park`` — the pump checks the ring *before*
  becoming a waiter (predicate evaluated outside the mutex, then an
  unconditional park). An arrival between check and park is a LOST
  WAKEUP: its ``cv.notify`` finds no waiter, and the pump parks on work
  it will never be signalled for (PTR001 — in production the cost is a
  full poll timeout of tail latency per event, not a hang).
* ``ring-slot-reuse-without-fence`` — ``close_conn`` recycles the conn
  slot without bumping ``gen``; a completion for the dead request then
  matches the NEW connection occupying the slot and answers a request
  it never made (PTR002: completion-ring token conservation).
* ``ack-without-holding-mutex`` — the completion path reads conn
  liveness and appends the response as two unlocked steps; a concurrent
  close (or close+reuse) between them writes into a dead or recycled
  connection (PTR002).

The model checks, at every step and at every quiescent terminal state:
no request is polled or completed twice (ring token conservation), every
response lands on the connection incarnation that issued the request,
polled requests on still-live connections are answered, and the pump is
never parked against a non-empty ring at quiescence.

**Static — guarded-state, lock-order, condvar discipline (PTR003-005).**
A declared :data:`GUARDS` registry maps the shared attributes of the
engine/net thread ensemble to the lock that guards them; the AST walk
flags mutations (and, for ``rw``-mode attributes, reads) outside a
``with <lock>`` scope unless the enclosing method is a declared holder
(the ``*_locked`` caller-holds contract) (PTR003). The same walk builds
the full lock graph — every ``with``-statement nesting across the
analyzed files, plus ``NATIVE_EFFECTS.takes_host_mu`` call sites which
acquire ``_host_mu`` inside the .so — and rejects any cycle or any edge
inverting the declared ``_resize_mu`` → ``_evict_mu`` → ``_host_mu`` →
``_state_mu`` order (PTR004, generalizing PTL003 beyond the two named locks). Condvar
``wait()`` calls without an enclosing predicate loop are flagged
(PTR005: Mesa semantics allow spurious and stolen wakeups; ``wait_for``
with a predicate callable is the other sanctioned form).

The static half also consumes the ``owns_buffers``/``borrows_until``
ownership columns of ``native/__init__.py::NATIVE_EFFECTS``: a symbol
that RETAINS its numpy buffers past the call (``pt_dir_create``,
``pt_hls_create``) pins those attributes until the declared release
symbol runs — rebinding or resizing them is a use-after-recycle the .so
cannot survive. Completeness is enforced both ways, PTA005-style:
every retained-buffer call site must be declared in
:data:`RETAINED_BUFFERS`, every declaration must match the effects
table, and the columns themselves must be self-consistent.

Findings reuse :class:`patrol_tpu_torch.analysis.lint.Finding` and the
shared ``# patrol-lint: disable=PTR003`` suppression machinery. Driver:
``python -m patrol_tpu_torch.scripts.race_repo``; tests:
``tests/test_torch_race.py``.

====== ==============================================================
PTR001 epoll seam: lost wakeup / stalled completion (liveness)
PTR002 epoll seam: completion-ring token conservation (safety)
PTR003 guarded attribute access outside its declared lock; retained-
       buffer ownership (use-after-recycle) violations
PTR004 lock-graph cycle or declared-order inversion
PTR005 condvar wait without an enclosing predicate loop
====== ==============================================================

Pure python, no torch, no native library needed — the dynamic half runs
the *model* of the C++ protocol; deterministic by construction, so
failures replay exactly.

**The port's seam.** The model's line anchor reads the port's
``native/patrol_http.cpp``, which differs from the reference's front only
by the C2 repair (an h2 connection's first read may exceed the h1 read
cap) and a comment. ``pt_http_poll`` and ``pt_http_complete_takes`` are
the reference's, line for line: the pump parks in ``cv.wait_until(lk,
pred)`` with the ring-empty predicate evaluated under ``Server::mu`` and
drains ``take_q`` under the same lock (the ``park_check="locked"`` law);
a completion checks ``c.fd >= 0 && c.gen == gen`` and queues its
response in one ``s->mu`` critical section (``complete_lock="mutex"``);
``close_conn`` bumps ``c.gen`` (``slot_fence="gen"``). The model is
pinned to the port's running code as the reference's is to its own: the
san stage of the port's check runner (``scripts/check.sh``) builds
``native/san/san_http_driver.cpp`` — its pump thread on ``pt_http_poll``
racing the epoll thread on ``Server::mu`` — with the port's
``patrol_http.cpp`` under TSan, ASan and UBSan, and any report fails it.

**What the static walk cannot see.** It keys on ``self.<attr>`` inside
the guarded class's own methods: a write of another object's guarded
attribute is invisible to it. ``runtime/checkpoint.py::restore`` bumps
``engine._state_gen`` under ``engine._state_mu`` from outside the
engine; that write is correct and unchecked. The walk is the
reference's and is not widened here.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from patrol_tpu_torch.analysis.lint import Finding, Module, apply_suppressions

__all__ = [
    "ALL_CODES",
    "GUARDS",
    "RETAINED_BUFFERS",
    "SEAM_MUTATIONS",
    "SeamSemantics",
    "builtin_seam_scenarios",
    "check_seam",
    "check_seam_repo",
    "race_repo",
    "race_sources",
    "race_static",
]

ALL_CODES = ("PTR001", "PTR002", "PTR003", "PTR004", "PTR005")

_SELF = "patrol_tpu_torch/analysis/race.py"
_HTTP_CPP = "patrol_tpu_torch/native/patrol_http.cpp"
_NATIVE_INIT = "patrol_tpu_torch/native/__init__.py"


# ===========================================================================
# Dynamic half — the epoll-seam deterministic schedule explorer.
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class SeamSemantics:
    """The modeled seam's tunable laws. The clean protocol is the
    default; each mutation flips one law to the plausible-but-wrong
    alternative a refactor could introduce.

    * ``park_check`` — ``"locked"``: the pump evaluates the ring-empty
      predicate while holding the mutex and becomes a waiter atomically
      (the ``cv.wait_until(lk, pred)`` shape of ``pt_http_poll``);
      ``"unlocked"``: predicate read first, park decided later — the
      lost-wakeup window.
    * ``slot_fence`` — ``"gen"``: reopening a recycled conn slot bumps
      the generation so stale completion tags miss; ``"reuse"``: the
      slot is reused verbatim.
    * ``complete_lock`` — ``"mutex"``: liveness check + response append
      are one critical section (``pt_http_complete_takes`` under
      ``s->mu``); ``"none"``: two unlocked steps.
    """

    park_check: str = "locked"  # "locked" | "unlocked"
    slot_fence: str = "gen"  # "gen" | "reuse"
    complete_lock: str = "mutex"  # "mutex" | "none"


SEAM_CLEAN = SeamSemantics()

# Seeded seam bugs the explorer must reject → the code each must trip.
SEAM_MUTATIONS: Dict[str, Tuple[SeamSemantics, str]] = {
    "completion-before-park": (SeamSemantics(park_check="unlocked"), "PTR001"),
    "ring-slot-reuse-without-fence": (
        SeamSemantics(slot_fence="reuse"), "PTR002",
    ),
    "ack-without-holding-mutex": (
        SeamSemantics(complete_lock="none"), "PTR002",
    ),
}


@dataclasses.dataclass(frozen=True)
class SeamScenario:
    """One bounded epoll-thread script. ``script`` ops:
    ``("req", conn, req_id)`` — the epoll thread parses a request on
    ``conn`` and rings it; ``("close", conn)`` — the client hangs up
    (slot recycled); ``("open", conn)`` — a new client lands on the
    lowest free slot. ``conns`` names the initially-open connections."""

    name: str
    conns: Tuple[str, ...]
    script: Tuple[tuple, ...]
    poll_cap: int = 2


# Model state is one flat hashable tuple (for DFS memoization):
#   (ei, pump_pc, take_q, handoff, comp_pc, conn_slots, incarnations)
# pump_pc: "idle" | "parked" | ("checked", empty: bool)
# take_q:  ((req, slot, gen), ...)
# handoff: (batch, ...) each batch ((req, slot, gen), ...)
# comp_pc: None | ("mid", (req, slot, gen), rest_of_batch)  — the
#          unlocked completer's snapshot-taken-but-not-yet-appended item
# conn_slots: ((conn_name, slot) ...) for OPEN conns
# incarnations: per slot, a tuple of (gen, alive, expected, responses)
#          — the FULL history; the last entry is the current occupant.


_seam_site_cache: Optional[int] = None


def _seam_site_line() -> int:
    """Best-effort anchor: the ``pt_http_poll`` definition line in
    patrol_http.cpp (the modeled protocol's entry point)."""
    global _seam_site_cache
    if _seam_site_cache is not None:
        return _seam_site_cache
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    line = 1
    try:
        with open(os.path.join(root, _HTTP_CPP), encoding="utf-8") as fh:
            for lineno, text in enumerate(fh, start=1):
                if text.lstrip().startswith("int pt_http_poll("):
                    line = lineno
                    break
    except OSError:  # pragma: no cover - repo layout is fixed
        pass
    _seam_site_cache = line
    return line


class _SeamViolation(Exception):
    def __init__(self, check: str, message: str):
        self.check = check
        self.message = message
        super().__init__(message)


class _SeamState:
    """Mutable working copy of one model state (frozen for memoization
    via :meth:`key`)."""

    __slots__ = (
        "ei", "pump_pc", "take_q", "handoff", "comp_pc",
        "conn_slots", "slots",
    )

    def __init__(self, scenario: SeamScenario):
        self.ei = 0
        self.pump_pc = "idle"
        self.take_q: List[tuple] = []
        self.handoff: List[tuple] = []
        self.comp_pc = None
        self.conn_slots: Dict[str, int] = {
            c: i for i, c in enumerate(scenario.conns)
        }
        # slot → list of incarnation dicts {gen, alive, expected, responses}
        self.slots: List[List[dict]] = [
            [{"gen": 0, "alive": True, "expected": [], "responses": []}]
            for _ in scenario.conns
        ]

    def key(self) -> tuple:
        return (
            self.ei,
            self.pump_pc,
            tuple(self.take_q),
            tuple(self.handoff),
            self.comp_pc,
            tuple(sorted(self.conn_slots.items())),
            tuple(
                tuple(
                    (
                        inc["gen"], inc["alive"],
                        tuple(inc["expected"]), tuple(inc["responses"]),
                    )
                    for inc in slot
                )
                for slot in self.slots
            ),
        )

    def clone(self) -> "_SeamState":
        other = object.__new__(_SeamState)
        other.ei = self.ei
        other.pump_pc = self.pump_pc
        other.take_q = list(self.take_q)
        other.handoff = [tuple(b) for b in self.handoff]
        other.comp_pc = self.comp_pc
        other.conn_slots = dict(self.conn_slots)
        other.slots = [
            [
                {
                    "gen": inc["gen"], "alive": inc["alive"],
                    "expected": list(inc["expected"]),
                    "responses": list(inc["responses"]),
                }
                for inc in slot
            ]
            for slot in self.slots
        ]
        return other


def _seam_apply_epoll(
    st: _SeamState, op: tuple, sem: SeamSemantics
) -> None:
    """One epoll-thread critical section (atomic: runs under Server::mu
    in the real code for every one of these ops)."""
    st.ei += 1
    kind = op[0]
    if kind == "req":
        _, conn, req = op
        slot = st.conn_slots.get(conn)
        if slot is None:
            return  # request on a closed conn: parser drops it
        inc = st.slots[slot][-1]
        st.take_q.append((req, slot, inc["gen"]))
        inc["expected"].append(req)
        # cv.notify: wakes a PARKED waiter (Mesa — it re-checks on wake).
        # A pump mid-unlocked-check is NOT a waiter yet: the signal is
        # lost, which is exactly the mutation's bug window.
        if st.pump_pc == "parked":
            st.pump_pc = "idle"
    elif kind == "close":
        (_, conn) = op
        slot = st.conn_slots.pop(conn, None)
        if slot is not None:
            st.slots[slot][-1]["alive"] = False
    elif kind == "open":
        (_, conn) = op
        free = [
            i for i in range(len(st.slots)) if not st.slots[i][-1]["alive"]
        ]
        if free:
            slot = free[0]
            prev_gen = st.slots[slot][-1]["gen"]
            gen = prev_gen + 1 if sem.slot_fence == "gen" else prev_gen
            st.slots[slot].append(
                {"gen": gen, "alive": True, "expected": [], "responses": []}
            )
        else:
            slot = len(st.slots)
            st.slots.append(
                [{"gen": 0, "alive": True, "expected": [], "responses": []}]
            )
        st.conn_slots[conn] = slot
    else:  # pragma: no cover - scenario authoring error
        raise ValueError(f"unknown script op {op!r}")


def _seam_drain(st: _SeamState, cap: int) -> None:
    batch = tuple(st.take_q[:cap])
    del st.take_q[:cap]
    st.handoff.append(batch)


def _seam_complete_one(st: _SeamState, item: tuple, checked_gen: int) -> None:
    """Append the response for one completion tag whose liveness check
    already passed (atomically in the clean model; against a possibly
    stale snapshot under the ``complete_lock="none"`` mutation)."""
    req, slot, _gen = item
    inc = st.slots[slot][-1]
    if not inc["alive"]:
        raise _SeamViolation(
            "PTR002",
            f"completion for request {req} wrote into CLOSED conn slot "
            f"{slot} (use-after-close: the liveness check and the wbuf "
            "append were not one critical section)",
        )
    inc["responses"].append(req)
    if inc["gen"] != checked_gen:
        raise _SeamViolation(
            "PTR002",
            f"completion for request {req} crossed a recycled ring slot: "
            f"checked gen {checked_gen}, wrote into gen {inc['gen']} "
            f"(slot {slot})",
        )


def _seam_check_conservation(st: _SeamState, terminal: bool) -> None:
    """Completion-ring token conservation, on every state: each response
    must match a request issued on the SAME incarnation, at most once."""
    for slot, incs in enumerate(st.slots):
        for inc in incs:
            for req in set(inc["responses"]):
                n = inc["responses"].count(req)
                if req not in inc["expected"]:
                    raise _SeamViolation(
                        "PTR002",
                        f"conn slot {slot} gen {inc['gen']} was answered "
                        f"for request {req} it never made (a stale "
                        "completion tag matched a recycled slot)",
                    )
                if n > 1:
                    raise _SeamViolation(
                        "PTR002",
                        f"request {req} was completed {n}× on conn slot "
                        f"{slot} (double completion)",
                    )
    if not terminal:
        return
    # Quiescence: every polled request on a still-live incarnation must
    # have been answered, and the ring must be empty unless the pump is
    # still runnable.
    if st.take_q and st.pump_pc == "parked":
        raise _SeamViolation(
            "PTR001",
            f"lost wakeup: the pump is parked on the condvar while "
            f"{len(st.take_q)} request(s) sit in the ring with no further "
            "notify coming (the arrival's signal fired before the pump "
            "became a waiter)",
        )
    if st.handoff or st.comp_pc is not None:
        raise _SeamViolation(
            "PTR001",
            "stalled completion: polled requests were never completed "
            "although the completer had no more steps",
        )
    for slot, incs in enumerate(st.slots):
        inc = incs[-1]
        if not inc["alive"]:
            continue
        pending_reqs = {r for r, _, _ in st.take_q}
        for req in inc["expected"]:
            if req in pending_reqs:
                continue  # still in the ring (pump budget exhausted)
            if req not in inc["responses"]:
                raise _SeamViolation(
                    "PTR001",
                    f"request {req} on live conn slot {slot} was polled "
                    "but never answered (dropped completion)",
                )


def explore_seam(
    scenario: SeamScenario,
    sem: SeamSemantics = SEAM_CLEAN,
    max_states: int = 200_000,
) -> Tuple[int, List[Finding]]:
    """DFS every interleaving of epoll-script / pump / completer steps.
    Returns (distinct states explored, findings — capped at 3)."""
    site_line = _seam_site_line()
    findings: List[Finding] = []
    seen_msgs: Set[str] = set()
    seen: Set[tuple] = set()
    explored = 0
    budget = len(scenario.script) + 2  # pump polls; generous ⇒ full drain

    def emit(v: _SeamViolation, trace: Tuple[str, ...]) -> None:
        msg = (
            f"[{scenario.name}] schedule [{' '.join(trace)}] violates the "
            f"seam model: {v.message}"
        )
        if msg not in seen_msgs and len(findings) < 3:
            seen_msgs.add(msg)
            findings.append(Finding(v.check, _HTTP_CPP, site_line, msg))

    def moves(st: _SeamState, polls_left: int) -> List[tuple]:
        out: List[tuple] = []
        if st.ei < len(scenario.script):
            out.append(("epoll",))
        if st.pump_pc == "idle" and polls_left > 0:
            out.append(("pump",))
        elif isinstance(st.pump_pc, tuple):  # mid unlocked check
            out.append(("pump",))
        if st.comp_pc is not None or st.handoff:
            out.append(("comp",))
        return out

    def step(st: _SeamState, mv: tuple, polls_left: int) -> int:
        """Apply one move in place; returns the new polls_left."""
        if mv[0] == "epoll":
            _seam_apply_epoll(st, scenario.script[st.ei], sem)
            return polls_left
        if mv[0] == "pump":
            if sem.park_check == "locked":
                if st.take_q:
                    _seam_drain(st, scenario.poll_cap)
                    return polls_left - 1
                st.pump_pc = "parked"
                return polls_left
            # unlocked predicate: two steps with a wide-open race window
            if st.pump_pc == "idle":
                st.pump_pc = ("checked", not st.take_q)
                return polls_left
            _, was_empty = st.pump_pc
            st.pump_pc = "idle"
            if was_empty:
                st.pump_pc = "parked"  # parks even if the ring filled
                return polls_left
            if st.take_q:
                _seam_drain(st, scenario.poll_cap)
                return polls_left - 1
            return polls_left
        # completer
        if sem.complete_lock == "mutex":
            batch = st.handoff.pop(0)
            for item in batch:
                req, slot, gen = item
                inc = st.slots[slot][-1]
                if inc["alive"] and inc["gen"] == gen:
                    _seam_complete_one(st, item, inc["gen"])
            return polls_left
        # unlocked: per-item snapshot step, then append step
        if st.comp_pc is None:
            batch = list(st.handoff.pop(0))
            if not batch:
                return polls_left
            item, rest = batch[0], tuple(batch[1:])
            req, slot, gen = item
            inc = st.slots[slot][-1]
            if inc["alive"] and inc["gen"] == gen:
                st.comp_pc = ("mid", item, rest, inc["gen"])
            elif rest:
                st.handoff.insert(0, rest)
            return polls_left
        _, item, rest, checked_gen = st.comp_pc
        st.comp_pc = None
        if rest:
            st.handoff.insert(0, rest)
        _seam_complete_one(st, item, checked_gen)
        return polls_left

    def dfs(st: _SeamState, polls_left: int, trace: Tuple[str, ...]) -> None:
        nonlocal explored
        if len(findings) >= 3 or explored >= max_states:
            return
        k = (st.key(), polls_left)
        if k in seen:
            return
        seen.add(k)
        explored += 1
        mvs = moves(st, polls_left)
        if not mvs:
            try:
                _seam_check_conservation(st, terminal=True)
            except _SeamViolation as v:
                emit(v, trace)
            return
        for mv in mvs:
            st2 = st.clone()
            try:
                left2 = step(st2, mv, polls_left)
                _seam_check_conservation(st2, terminal=False)
            except _SeamViolation as v:
                emit(v, trace + (mv[0],))
                continue
            dfs(st2, left2, trace + (mv[0],))

    dfs(_SeamState(scenario), budget, ())
    return explored, findings


def builtin_seam_scenarios() -> Tuple[SeamScenario, ...]:
    """The shipped scenario set: bounded enough to enumerate exhaustively
    (hundreds to a few thousand distinct states each), wide enough to
    interleave arrivals against the park/poll window, conn close/reopen
    against in-flight completions, and a 2-conn request storm."""
    return (
        # Arrivals racing the pump's park decision: the lost-wakeup
        # window, plus the basic ring conservation over two requests.
        SeamScenario(
            name="park-vs-arrival",
            conns=("c0",),
            script=(("req", "c0", 0), ("req", "c0", 1)),
            poll_cap=1,
        ),
        # A request polled, then its conn closed and the slot recycled by
        # a new client issuing its own request: the stale completion tag
        # must MISS (gen fence), the fresh one must land exactly once.
        SeamScenario(
            name="slot-recycle",
            conns=("c0",),
            script=(
                ("req", "c0", 0),
                ("close", "c0"),
                ("open", "c1"),
                ("req", "c1", 1),
            ),
        ),
        # Two conns, interleaved requests, one mid-storm close+reuse:
        # exercises batched completion fan-in across generations.
        SeamScenario(
            name="two-conn-storm",
            conns=("c0", "c1"),
            script=(
                ("req", "c0", 0),
                ("req", "c1", 1),
                ("close", "c0"),
                ("open", "c2"),
                ("req", "c2", 2),
            ),
        ),
    )


def check_seam(sem: SeamSemantics = SEAM_CLEAN) -> List[Finding]:
    """Every builtin scenario under one semantics → findings."""
    findings: List[Finding] = []
    for scenario in builtin_seam_scenarios():
        _, f = explore_seam(scenario, sem)
        findings.extend(f)
    return findings


def check_seam_repo() -> List[Finding]:
    """The stage-7 dynamic gate: the clean seam model must explore every
    schedule violation-free, and every seeded mutation must be rejected
    by the code it targets (a mutation slipping through is itself a
    finding — the explorer must keep its teeth)."""
    findings = list(check_seam(SEAM_CLEAN))
    for name, (sem, code) in SEAM_MUTATIONS.items():
        caught = check_seam(sem)
        if not any(f.check == code for f in caught):
            findings.append(
                Finding(
                    code,
                    _SELF,
                    1,
                    f"seeded seam mutation '{name}' was NOT rejected by "
                    f"{code} — the schedule explorer has lost its teeth",
                )
            )
    return findings


# ===========================================================================
# Static half — guarded state (PTR003), lock graph (PTR004), condvar
# predicate loops (PTR005), retained-buffer ownership (PTR003).
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class Guard:
    """One guarded attribute: ``lock`` names the guarding lock attribute
    on the same instance; ``mode`` is ``"mutate"`` (stores, deletes, and
    mutating method calls need the lock; bare reads are the documented
    racy-read fast path) or ``"rw"`` (every access needs it)."""

    lock: str
    mode: str = "mutate"


# The files whose thread ensemble the guarded-state pass analyzes.
RACE_FILES: Tuple[str, ...] = (
    "patrol_tpu_torch/runtime/engine.py",
    "patrol_tpu_torch/runtime/mesh_engine.py",
    "patrol_tpu_torch/net/replication.py",
    "patrol_tpu_torch/net/native_replication.py",
    "patrol_tpu_torch/net/delta.py",
    "patrol_tpu_torch/net/antientropy.py",
    "patrol_tpu_torch/net/audit.py",
    # Zero-copy rx ring (device-resident ingest): the lease/commit
    # bookkeeping spans the rx thread and the engine completer.
    "patrol_tpu_torch/native/__init__.py",
)

# Additional files scanned for the lock graph (native-mutex call sites
# live behind the hoststore wrapper) and buffer ownership.
GRAPH_FILES: Tuple[str, ...] = RACE_FILES + (
    "patrol_tpu_torch/runtime/hoststore.py",
    "patrol_tpu_torch/runtime/directory.py",
)

# relpath → class → attr → Guard. THE registry: every entry encodes a
# discipline previously stated only in comments.
GUARDS: Dict[str, Dict[str, Dict[str, Guard]]] = {
    "patrol_tpu_torch/runtime/engine.py": {
        "StagingPool": {
            "_free": Guard("_mu", "rw"),
        },
        "DeviceEngine": {
            # Work queues: feeder drains, submitters append — both ends
            # under the work condvar's lock.
            "_takes": Guard("_cond", "mutate"),
            "_deltas": Guard("_cond", "mutate"),
            # Hot-key coalescer index (take-fold key → open _TakeFold):
            # submitters fold under the work condvar, the feeder's drain
            # closes folds under the same lock — an unlocked mutation
            # could append a ticket to an entry the feeder already
            # popped, stranding its caller forever.
            "_open_folds": Guard("_cond", "rw"),
            # "Set mutations run under _host_mu (drain/drop)" — the
            # feeder reads it under _cond, but every mutation site is a
            # _host_mu critical section (engine.py:799-802).
            "_promote_pending": Guard("_host_mu", "mutate"),
            # Completion pipeline handoff (feeder → completer).
            "_pending": Guard("_pcond", "mutate"),
            "_completing": Guard("_pcond", "mutate"),
            "_feeder_done": Guard("_pcond", "mutate"),
            # Host fast path: dict and flag array only ever change
            # together, under _host_mu; flag reads are the documented
            # racy O(1) residency probe.
            "_hosted": Guard("_host_mu", "mutate"),
            "_hosted_flag": Guard("_host_mu", "mutate"),
            "_promoting": Guard("_host_mu", "mutate"),
            # Graceful-shutdown flush bookkeeping.
            "_dirty_names": Guard("_dirty_mu", "rw"),
            # Bucket lifecycle (idle-bucket GC): sweep-window anchor,
            # reclaim/shed/compaction counters — mutated only under
            # _evict_mu (the lock that already serializes every
            # unbind/zero/recycle path); bare reads are the feeder's
            # cadence probe and the stats snapshot.
            "_gc_win_start": Guard("_evict_mu", "mutate"),
            # The host-fastpath GC kick flag rides the work condvar like
            # the queues it wakes.
            "_gc_due": Guard("_cond", "mutate"),
            # Live-resharding quiesce flag (mesh resize): raised/lowered
            # and read in the feeder's wait predicate under the same
            # condvar — a bare read could dispatch a tick into a mesh
            # swap.
            "_tick_paused": Guard("_cond", "rw"),
            "_gc_reclaimed": Guard("_evict_mu", "mutate"),
            "_gc_shed": Guard("_evict_mu", "mutate"),
            "_gc_sweeps": Guard("_evict_mu", "mutate"),
            "_gc_compactions": Guard("_evict_mu", "mutate"),
            # The scrape epoch's write half: every device-state write
            # outside a tick (eviction, GC reclaim, demotion, release, a
            # family call) bumps it under _state_mu, after the write it
            # stamps; bare reads are _scrape_epoch's documented racy
            # epoch read (a bump mid-read only makes the mirror stale).
            "_state_gen": Guard("_state_mu", "mutate"),
            # The scrape mirror's refresh hint: raised by a scrape that
            # found the mirror stale, cleared by the completer before
            # its refresh; both writes ride the completion condvar.
            "_mirror_want": Guard("_pcond", "mutate"),
        },
        # patrol-audit admitted-token window ledger: every field mutates
        # under its own leaf lock (taken strictly after any engine lock
        # released — note() runs on serve/completion threads, roll() on
        # the audit plane's flusher).
        "AuditLedger": {
            "_cur": Guard("_mu", "rw"),
            "_closed": Guard("_mu", "rw"),
            "_window": Guard("_mu", "rw"),
            "_start_ns": Guard("_mu", "rw"),
        },
    },
    "patrol_tpu_torch/runtime/mesh_engine.py": {
        "MeshEngine": {
            # Pod-scale tick accounting: the feeder mutates it after each
            # fused dispatch batch, API/stats threads read it — a leaf
            # lock of its own (never nested with the engine's shared
            # locks), so it adds no ordering edge.
            "_mesh_metrics": Guard("_mesh_mu", "rw"),
            # resize() raises/lowers the inherited quiesce flag — same
            # condvar discipline as the feeder's wait predicate.
            "_tick_paused": Guard("_cond", "mutate"),
            # resize() moves the inherited scrape epoch with the plan
            # swap, under _state_mu as every other bump.
            "_state_gen": Guard("_state_mu", "mutate"),
            # The planes over the mesh's pieces and what is derived from
            # them (the one piece's state, the first piece's device, the
            # cards): swapped together by resize() under _state_mu, read
            # by launches under it and by the quiesced feeder.
            "_placed": Guard("_state_mu", "mutate"),
            "state": Guard("_state_mu", "mutate"),
            "_cards": Guard("_state_mu", "mutate"),
        },
    },
    "patrol_tpu_torch/net/replication.py": {
        "PeerHealth": {
            "peers": Guard("_mu", "mutate"),
        },
        "SlotTable": {
            # resolve() double-checks: the unlocked read is the fast
            # path, every WRITE runs under _mu.
            "slot_of": Guard("_mu", "mutate"),
            "_next_dynamic": Guard("_mu", "rw"),
            # Elastic membership (patrol-membership): the active-member
            # map, the monotone membership epoch, and the lane
            # tombstones move together under _mu — admin calls arrive
            # from the API executor while membership datagrams land on
            # the rx context, and a torn view could hand out a retired
            # lane without its epoch.
            "_members": Guard("_mu", "rw"),
            "_epoch": Guard("_mu", "rw"),
            "_tombstones": Guard("_mu", "rw"),
        },
    },
    "patrol_tpu_torch/net/native_replication.py": {},
    "patrol_tpu_torch/net/delta.py": {
        "DeltaPlane": {
            "_dirty": Guard("_mu", "rw"),
            "_peers": Guard("_mu", "rw"),
            "_tick": Guard("_mu", "rw"),
            # Raw-ingest plane pool: leased on the rx thread, recycled by
            # the engine completer's release callback — its own leaf lock
            # (never nested with _mu or any engine lock).
            "_raw_free": Guard("_raw_mu", "rw"),
        },
    },
    "patrol_tpu_torch/net/antientropy.py": {
        "AntiEntropy": {
            "_jobs": Guard("_mu", "rw"),
            "_inflight": Guard("_mu", "rw"),
            "_refresh_timers": Guard("_mu", "rw"),
            "_last_trigger": Guard("_mu", "rw"),
            "_worker": Guard("_mu", "mutate"),
            "_stopped": Guard("_mu", "mutate"),
        },
    },
    # Zero-copy rx ring: the lease set mutates on the rx thread (lease)
    # and the engine completer (commit callback); the native free-list is
    # the authority, this mirror is observability/teardown — still
    # lock-disciplined like everything shared.
    "patrol_tpu_torch/native/__init__.py": {
        "RxRing": {
            "_leased": Guard("_mu", "rw"),
            "_closed": Guard("_mu", "rw"),
        },
    },
    # patrol-audit plane: the window store + divergence gauges mutate on
    # the flusher, rx, and compare-worker threads — all under the plane's
    # one leaf lock (never held across a send or an engine snapshot).
    "patrol_tpu_torch/net/audit.py": {
        "AuditPlane": {
            "_win": Guard("_mu", "rw"),
            "_tick": Guard("_mu", "rw"),
            "_local_window": Guard("_mu", "rw"),
            "_divergent": Guard("_mu", "rw"),
            "_divergence_since": Guard("_mu", "rw"),
            "_jobs": Guard("_mu", "rw"),
            "_worker": Guard("_mu", "mutate"),
            "_stopped": Guard("_mu", "mutate"),
        },
    },
}

# Methods that run with a lock already held by contract (the documented
# "caller holds X" / ``*_locked`` convention) — their bodies are checked
# as if the named locks were acquired at entry.
HOLDERS: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "patrol_tpu_torch/runtime/engine.py": {
        # "Caller holds ``_host_mu``." (engine.py:_promote_locked)
        "DeviceEngine._promote_locked": ("_host_mu",),
        # Hot-key coalescer: submit-side fold and feeder-side drain both
        # run inside the caller's ``with self._cond`` block.
        "DeviceEngine._enqueue_take_locked": ("_cond",),
        "DeviceEngine._drain_takes": ("_cond",),
        # "Body of _drop_hosted_rows; caller holds _host_mu": its callers
        # are _drop_hosted_rows (inside `with self._host_mu`) and the GC
        # reclaim's host-victim drop (inside `with self._host_mu`, under
        # _evict_mu).
        "DeviceEngine._drop_hosted_rows_locked": ("_host_mu",),
        # AuditLedger's *_locked helpers run under its leaf lock.
        "AuditLedger._close_locked": ("_mu",),
        "AuditLedger._clock_window": ("_mu",),
    },
    "patrol_tpu_torch/runtime/mesh_engine.py": {
        # Swaps the planes over the pieces: resize() calls it inside
        # `with self._state_mu`; _init_planes calls it from the
        # constructor, before the engine's threads (and its lock) exist.
        "MeshEngine._set_placed": ("_state_mu",),
    },
    "patrol_tpu_torch/net/audit.py": {
        "AuditPlane._join_window_locked": ("_mu",),
        "AuditPlane._absorb_ledger_locked": ("_mu",),
        "AuditPlane._evaluate_locked": ("_mu",),
    },
    "patrol_tpu_torch/net/delta.py": {
        "DeltaPlane._flush_peer_locked": ("_mu",),
        # _peer is the registry get-or-create helper; every caller
        # (mark_capable / capable_peers / flush / on_packet / stats /
        # on_peer_heal) is already inside `with self._mu`.
        "DeltaPlane._peer": ("_mu",),
        # "GC an acked interval ... Caller holds _mu": both callers, the
        # raw rx walk's ack loop and on_packet's, are inside
        # `with self._mu`.
        "DeltaPlane._on_ack_locked": ("_mu",),
    },
    "patrol_tpu_torch/native/__init__.py": {
        # The ring's release at the last commit after close: both
        # callers, commit() and close(), are inside `with self._mu`.
        "RxRing._release_if_done_locked": ("_mu",),
    },
    "patrol_tpu_torch/net/replication.py": {
        # Epoch arithmetic shared by add_member / remove_member /
        # rejoin; every caller is already inside `with self._mu`.
        "SlotTable._bump_epoch_locked": ("_mu",),
    },
}

# Condition variables whose acquisition context IS another lock: holding
# the condvar == holding the underlying lock (threading.Condition(lock)).
LOCK_ALIASES: Dict[str, Dict[str, Dict[str, str]]] = {
    "patrol_tpu_torch/net/antientropy.py": {"AntiEntropy": {"_cond": "_mu"}},
    "patrol_tpu_torch/net/audit.py": {"AuditPlane": {"_cond": "_mu"}},
}

# The engine's cross-cutting locks keep their bare names in the lock
# graph (they are shared across threads and — for _host_mu — with the
# .so); everything else is scoped per (relpath, class) so two classes'
# private `_mu` never alias.
SHARED_LOCKS: Tuple[str, ...] = (
    "_resize_mu", "_evict_mu", "_host_mu", "_state_mu", "_dirty_mu",
)
# Declared total order for the shared engine locks, OUTER first.
# Generalizes PTL003's two-name check: any observed nesting that inverts
# this order is a PTR004 finding even before it closes a cycle. The mesh
# engine's resize() takes _resize_mu → _cond → _state_mu
# (runtime/mesh_engine.py), and nothing takes _resize_mu under another.
DECLARED_ORDER: Tuple[str, ...] = ("_resize_mu", "_evict_mu", "_host_mu", "_state_mu")

_LOCK_ATTR_SUFFIXES = ("_mu",)
_LOCK_ATTR_NAMES = ("_cond", "_pcond", "_state_mu")

# Buffers the .so retains past the registering call (owns_buffers
# symbols): relpath → class → attr → retaining symbol. The ownership
# pass enforces this registry against NATIVE_EFFECTS both ways and
# forbids rebinding/resizing the attrs outside __init__.
RETAINED_BUFFERS: Dict[str, Dict[str, Dict[str, str]]] = {
    "patrol_tpu_torch/runtime/directory.py": {
        "BucketDirectory": {
            "name_bytes": "pt_dir_create",
            "name_len": "pt_dir_create",
            "cap_base_nt": "pt_hls_create",
            "created_ns": "pt_hls_create",
            "last_used_ns": "pt_hls_create",
        },
    },
    # The rx ring inverts the usual borrow: the .so OWNS the page-aligned
    # planes and Python's ``_views`` alias that memory zero-copy until
    # pt_rx_ring_destroy. Rebinding the views outside __init__ (or
    # destroying while a lease is out — the C side defers for that) is
    # the same use-after-recycle class, so the registry pins them.
    "patrol_tpu_torch/native/__init__.py": {
        "RxRing": {
            "_views": "pt_rx_ring_create",
        },
    },
}

_MUTATOR_METHODS = {
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "remove", "clear", "add", "discard", "update", "setdefault",
    "fill", "resize", "sort",
}


def _lock_attr_name(expr: ast.AST) -> Optional[str]:
    """``self.X`` where X looks like a lock/condvar attribute → X."""
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        name = expr.attr
        if name.endswith(_LOCK_ATTR_SUFFIXES) or name in _LOCK_ATTR_NAMES:
            return name
    return None


def _canon_lock(
    relpath: str, cls: str, name: str, aliases: Dict[str, Dict[str, Dict[str, str]]]
) -> str:
    name = aliases.get(relpath, {}).get(cls, {}).get(name, name)
    if name in SHARED_LOCKS:
        return name
    return f"{relpath}::{cls}.{name}"


@dataclasses.dataclass
class _Access:
    attr: str
    line: int
    kind: str  # "read" | "mutate"


def _collect_accesses(fn: ast.AST, attrs: Set[str]) -> List[Tuple[ast.AST, _Access]]:
    """Every ``self.<attr>`` touch in ``fn`` for attrs of interest,
    classified read vs mutate. Returns (node, access) pairs in source
    order; the caller decides lock context from the node's position."""
    out: List[Tuple[ast.AST, _Access]] = []

    def self_attr(expr: ast.AST) -> Optional[str]:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr in attrs
        ):
            return expr.attr
        return None

    class V(ast.NodeVisitor):
        def visit_Attribute(self, node):  # noqa: N802
            name = self_attr(node)
            if name is not None:
                kind = "read"
                if isinstance(node.ctx, (ast.Store, ast.Del)):
                    kind = "mutate"
                out.append((node, _Access(name, node.lineno, kind)))
            self.generic_visit(node)

        def visit_Subscript(self, node):  # noqa: N802
            # self.attr[i] = v  /  del self.attr[i]
            name = self_attr(node.value)
            if name is not None and isinstance(node.ctx, (ast.Store, ast.Del)):
                out.append((node, _Access(name, node.lineno, "mutate")))
            self.generic_visit(node)

        def visit_Call(self, node):  # noqa: N802
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _MUTATOR_METHODS:
                name = self_attr(f.value)
                if name is not None:
                    out.append((node, _Access(name, node.lineno, "mutate")))
            self.generic_visit(node)

        def visit_AugAssign(self, node):  # noqa: N802
            name = self_attr(node.target)
            if name is not None:
                out.append((node, _Access(name, node.lineno, "mutate")))
            self.generic_visit(node)

    V().visit(fn)
    return out


def _held_at(
    fn: ast.AST, relpath: str, cls: str,
    aliases: Dict[str, Dict[str, Dict[str, str]]],
) -> Dict[int, Tuple[str, ...]]:
    """node id → canonical lock names lexically held at that node (from
    enclosing ``with self.<lock>`` statements). Nested function bodies
    start fresh: a closure does not run under the definition-site
    lock."""
    held_map: Dict[int, Tuple[str, ...]] = {}

    def walk(node: ast.AST, held: Tuple[str, ...]) -> None:
        acquired: List[str] = []
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                name = _lock_attr_name(item.context_expr)
                if name is not None:
                    acquired.append(_canon_lock(relpath, cls, name, aliases))
        new_held = held + tuple(acquired)
        held_map[id(node)] = new_held
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                held_map[id(child)] = ()
                walk_fresh(child)
            else:
                walk(child, new_held)

    def walk_fresh(fn_node: ast.AST) -> None:
        for child in ast.iter_child_nodes(fn_node):
            walk(child, ())

    walk_fresh(fn)
    return held_map


def _class_methods(tree: ast.AST) -> Dict[str, Dict[str, ast.AST]]:
    out: Dict[str, Dict[str, ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            methods = {}
            for child in node.body:
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods[child.name] = child
            out[node.name] = methods
    return out


def check_guarded_state(
    mod: Module,
    guards: Optional[Dict[str, Dict[str, Dict[str, Guard]]]] = None,
    holders: Optional[Dict[str, Dict[str, Tuple[str, ...]]]] = None,
    aliases: Optional[Dict[str, Dict[str, Dict[str, str]]]] = None,
) -> List[Finding]:
    """PTR003: every registered shared attribute is touched only under
    its declared lock (mutations always; reads too in ``rw`` mode),
    except in ``__init__`` (construction happens-before publication) and
    in declared holder methods."""
    guards = GUARDS if guards is None else guards
    holders = HOLDERS if holders is None else holders
    aliases = LOCK_ALIASES if aliases is None else aliases
    file_guards = guards.get(mod.relpath)
    if not file_guards:
        return []
    out: List[Finding] = []
    classes = _class_methods(mod.tree)
    for cls, attr_guards in file_guards.items():
        methods = classes.get(cls, {})
        attrs = set(attr_guards)
        for mname, fn in methods.items():
            if mname == "__init__":
                continue
            contract = holders.get(mod.relpath, {}).get(f"{cls}.{mname}", ())
            contract_canon = tuple(
                _canon_lock(mod.relpath, cls, c, aliases) for c in contract
            )
            held_map = _held_at(fn, mod.relpath, cls, aliases)
            # Re-associate each access with the innermost enclosing node
            # we computed held-state for, by a parent-tracking pass.
            parents: Dict[int, ast.AST] = {}
            for parent in ast.walk(fn):
                for child in ast.iter_child_nodes(parent):
                    parents[id(child)] = parent
            for node, acc in _collect_accesses(fn, attrs):
                g = attr_guards[acc.attr]
                if g.mode == "mutate" and acc.kind == "read":
                    continue
                want = _canon_lock(mod.relpath, cls, g.lock, aliases)
                cur: Optional[ast.AST] = node
                held: Tuple[str, ...] = ()
                while cur is not None:
                    if id(cur) in held_map:
                        held = held_map[id(cur)]
                        break
                    cur = parents.get(id(cur))
                if want in held or want in contract_canon:
                    continue
                if mod.suppressed("PTR003", acc.line):
                    continue
                out.append(
                    Finding(
                        "PTR003",
                        mod.relpath,
                        acc.line,
                        f"{acc.kind} of guarded attribute self.{acc.attr} "
                        f"in {cls}.{mname}() outside `with self.{g.lock}` "
                        f"(declared guard; mode={g.mode}) — either take "
                        "the lock, declare the method a holder, or "
                        "suppress with a reason",
                    )
                )
    return out


# ---------------------------------------------------------------------------
# PTR004 — the full lock graph.


def _native_takes_host_mu() -> Set[str]:
    from patrol_tpu_torch.analysis.lint import native_effects

    return {
        sym
        for sym, eff in native_effects().items()
        if getattr(eff, "takes_host_mu", False)
    }


def check_lock_graph(
    mods: Sequence[Module],
    aliases: Optional[Dict[str, Dict[str, Dict[str, str]]]] = None,
    declared_order: Sequence[str] = DECLARED_ORDER,
    holders: Optional[Dict[str, Dict[str, Tuple[str, ...]]]] = None,
) -> List[Finding]:
    """PTR004: collect every lock-acquisition edge (held → acquired)
    from ``with`` nestings across the analyzed modules, treat
    ``NATIVE_EFFECTS.takes_host_mu`` call sites as acquisitions of
    ``_host_mu``, and reject (a) any edge inverting the declared
    order (:data:`DECLARED_ORDER`) and (b) any cycle
    in the whole graph (two locks ever taken in both orders deadlock
    under the right interleaving)."""
    aliases = LOCK_ALIASES if aliases is None else aliases
    holders = HOLDERS if holders is None else holders
    takes_mu = _native_takes_host_mu()
    rank = {name: i for i, name in enumerate(declared_order)}
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}  # edge → first site
    out: List[Finding] = []

    def record(src: str, dst: str, relpath: str, line: int) -> None:
        if src == dst:
            return
        edges.setdefault((src, dst), (relpath, line))

    for mod in mods:
        for cls, methods in _class_methods(mod.tree).items():
            for mname, fn in methods.items():
                # A declared holder method runs with its contract locks
                # already held: its acquisitions are edges FROM those.
                contract = holders.get(mod.relpath, {}).get(
                    f"{cls}.{mname}", ()
                )
                entry_held = tuple(
                    _canon_lock(mod.relpath, cls, c, aliases)
                    for c in contract
                )
                _walk_lock_edges(
                    fn, mod, cls, aliases, takes_mu, record, entry_held
                )
        # Module-level functions too (rare, but fixtures use them).
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _walk_lock_edges(node, mod, "<module>", aliases, takes_mu, record)

    # (a) declared-order inversions.
    for (src, dst), (relpath, line) in sorted(edges.items()):
        if src in rank and dst in rank and rank[src] > rank[dst]:
            out.append(
                Finding(
                    "PTR004",
                    relpath,
                    line,
                    f"acquiring {dst} while holding {src}: declared order "
                    f"is {' -> '.join(declared_order)} (outer first); the "
                    "inverse nesting deadlocks against any thread honoring "
                    "the declared order",
                )
            )
    # (b) cycles anywhere in the graph.
    graph: Dict[str, List[str]] = {}
    for (src, dst) in edges:
        graph.setdefault(src, []).append(dst)
    cycle = _find_cycle(graph)
    if cycle:
        # Anchor at the first edge of the cycle.
        relpath, line = edges[(cycle[0], cycle[1])]
        out.append(
            Finding(
                "PTR004",
                relpath,
                line,
                "lock-graph cycle: " + " -> ".join(cycle) + " — two "
                "threads taking these locks in opposite orders deadlock",
            )
        )
    return out


def _walk_lock_edges(
    fn, mod: Module, cls: str, aliases, takes_mu, record,
    entry_held: Tuple[str, ...] = (),
) -> None:
    relpath = mod.relpath

    def walk(node: ast.AST, held: Tuple[str, ...]) -> None:
        acquired: List[str] = []
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                name = _lock_attr_name(item.context_expr)
                if name is not None:
                    canon = _canon_lock(relpath, cls, name, aliases)
                    if not mod.suppressed("PTR004", node.lineno):
                        for h in held + tuple(acquired):
                            record(h, canon, relpath, node.lineno)
                    acquired.append(canon)
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in takes_mu:
                # The .so acquires the host-lane store mutex — which IS
                # the engine's _host_mu — inside this call.
                if not mod.suppressed("PTR004", node.lineno):
                    for h in held:
                        record(h, "_host_mu", relpath, node.lineno)
        new_held = held + tuple(acquired)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                walk_fresh(child)
            else:
                walk(child, new_held)

    def walk_fresh(fn_node: ast.AST) -> None:
        for child in ast.iter_child_nodes(fn_node):
            walk(child, ())

    for child in ast.iter_child_nodes(fn):
        walk(child, entry_held)


def _find_cycle(graph: Dict[str, List[str]]) -> Optional[List[str]]:
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(u: str) -> Optional[List[str]]:
        color[u] = GRAY
        stack.append(u)
        for v in sorted(graph.get(u, ())):
            c = color.get(v, WHITE)
            if c == GRAY:
                i = stack.index(v)
                return stack[i:] + [v]
            if c == WHITE:
                found = dfs(v)
                if found:
                    return found
        stack.pop()
        color[u] = BLACK
        return None

    for node in sorted(graph):
        if color.get(node, WHITE) == WHITE:
            found = dfs(node)
            if found:
                return found
    return None


# ---------------------------------------------------------------------------
# PTR005 — condvar waits must sit in a predicate loop.


def _condvar_attrs(tree: ast.AST) -> Dict[str, Set[str]]:
    """class → attrs assigned ``threading.Condition(...)`` or
    ``ProfiledCondition(...)`` in ``__init__``."""
    out: Dict[str, Set[str]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        attrs: Set[str] = set()
        for child in node.body:
            if not (
                isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                and child.name == "__init__"
            ):
                continue
            for stmt in ast.walk(child):
                if not isinstance(stmt, ast.Assign):
                    continue
                v = stmt.value
                if not isinstance(v, ast.Call):
                    continue
                f = v.func
                ctor = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else ""
                )
                if ctor not in ("Condition", "ProfiledCondition"):
                    continue
                for t in stmt.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        attrs.add(t.attr)
        if attrs:
            out[node.name] = attrs
    return out


def check_condvar_loops(mod: Module) -> List[Finding]:
    """PTR005: a ``<condvar>.wait()`` call must be lexically inside a
    ``while`` loop (the Mesa-semantics predicate re-check — a woken
    waiter owns no guarantee the predicate holds: wakeups are spurious,
    stolen by other waiters, or raced by a third thread changing state
    between notify and re-acquire). ``wait_for(predicate)`` carries its
    loop internally and is exempt."""
    cond_attrs = _condvar_attrs(mod.tree)
    if not cond_attrs:
        return []
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef) or node.name not in cond_attrs:
            continue
        attrs = cond_attrs[node.name]
        for fn in node.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            parents: Dict[int, ast.AST] = {}
            for parent in ast.walk(fn):
                for child in ast.iter_child_nodes(parent):
                    parents[id(child)] = parent
            for call in ast.walk(fn):
                if not isinstance(call, ast.Call):
                    continue
                f = call.func
                if not (
                    isinstance(f, ast.Attribute)
                    and f.attr == "wait"
                    and isinstance(f.value, ast.Attribute)
                    and isinstance(f.value.value, ast.Name)
                    and f.value.value.id == "self"
                    and f.value.attr in attrs
                ):
                    continue
                cur = parents.get(id(call))
                in_while = False
                while cur is not None and not isinstance(
                    cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    if isinstance(cur, ast.While):
                        in_while = True
                        break
                    cur = parents.get(id(cur))
                if in_while or mod.suppressed("PTR005", call.lineno):
                    continue
                out.append(
                    Finding(
                        "PTR005",
                        mod.relpath,
                        call.lineno,
                        f"self.{f.value.attr}.wait() in {node.name}."
                        f"{fn.name}() has no enclosing predicate loop: a "
                        "spurious or stolen wakeup proceeds on a false "
                        "predicate — wrap in `while not <pred>:` or use "
                        "wait_for(<pred>)",
                    )
                )
    return out


# ---------------------------------------------------------------------------
# Retained-buffer ownership (PTR003 emissions, PTA005-style completeness).


def check_ownership(
    mods: Sequence[Module],
    retained: Optional[Dict[str, Dict[str, Dict[str, str]]]] = None,
    effects: Optional[Dict[str, object]] = None,
) -> List[Finding]:
    """The ownership pass, three obligations:

    1. Column self-consistency + both-ways completeness against
       :data:`RETAINED_BUFFERS`: ``owns_buffers`` ⇔ ``borrows_until``
       names a registered release symbol; every ``owns_buffers`` symbol
       has declared retained attrs; every declared retaining symbol is
       ``owns_buffers`` in the effects table.
    2. Call-site discovery: any ``self.<attr>`` / ``<obj>.<attr>``
       buffer handed to an ``owns_buffers`` symbol must be a DECLARED
       retained attr (an undeclared retention is the exact blindness
       this column exists to fix).
    3. Use-after-recycle: a declared retained attr is never rebound
       (``self.<attr> = ...``) or ``resize()``d outside ``__init__`` —
       the .so keeps reading the old storage.
    """
    retained = RETAINED_BUFFERS if retained is None else retained
    if effects is None:
        from patrol_tpu_torch.analysis.lint import native_effects

        effects = native_effects()
    out: List[Finding] = []

    declared_symbols = {
        sym
        for per_cls in retained.values()
        for attr_map in per_cls.values()
        for sym in attr_map.values()
    }
    owning = set()
    for sym, eff in sorted(effects.items()):
        owns = bool(getattr(eff, "owns_buffers", False))
        until = getattr(eff, "borrows_until", "call")
        if owns:
            owning.add(sym)
        if owns != (until != "call"):
            out.append(
                Finding(
                    "PTR003",
                    _NATIVE_INIT,
                    1,
                    f"NATIVE_EFFECTS[{sym!r}] ownership columns disagree: "
                    f"owns_buffers={owns} but borrows_until={until!r} — "
                    "a retaining symbol must name its release symbol",
                )
            )
        if owns and until != "call" and until not in effects:
            out.append(
                Finding(
                    "PTR003",
                    _NATIVE_INIT,
                    1,
                    f"NATIVE_EFFECTS[{sym!r}].borrows_until names "
                    f"{until!r}, which is not a registered symbol",
                )
            )
    for sym in sorted(owning - declared_symbols):
        out.append(
            Finding(
                "PTR003",
                _NATIVE_INIT,
                1,
                f"{sym} is declared owns_buffers but no retained attrs "
                "are registered for it in analysis/race.py::"
                "RETAINED_BUFFERS — the static pass cannot protect "
                "buffers it does not know about",
            )
        )
    for sym in sorted(declared_symbols - owning):
        out.append(
            Finding(
                "PTR003",
                _NATIVE_INIT,
                1,
                f"RETAINED_BUFFERS declares attrs retained by {sym}, but "
                "NATIVE_EFFECTS does not mark it owns_buffers — the "
                "columns and the registry must agree both ways",
            )
        )

    declared_attrs: Set[str] = {
        attr
        for per_cls in retained.values()
        for attr_map in per_cls.values()
        for attr in attr_map
    }
    mod_by_path = {m.relpath: m for m in mods}

    # 2. call-site discovery across every analyzed module.
    for m in mods:
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute) and f.attr in owning):
                continue
            for arg in node.args:
                if not isinstance(arg, ast.Attribute):
                    continue
                if arg.attr in declared_attrs:
                    continue
                if m.suppressed("PTR003", arg.lineno):
                    continue
                out.append(
                    Finding(
                        "PTR003",
                        m.relpath,
                        arg.lineno,
                        f"buffer .{arg.attr} handed to {f.attr} (declared "
                        "owns_buffers: the .so retains the pointer) is not "
                        "registered in RETAINED_BUFFERS — declare it so "
                        "rebinds are caught",
                    )
                )

    # 3. use-after-recycle: no rebind/resize outside __init__.
    for relpath, per_cls in sorted(retained.items()):
        m = mod_by_path.get(relpath)
        if m is None:
            continue
        classes = _class_methods(m.tree)
        for cls, attr_map in sorted(per_cls.items()):
            methods = classes.get(cls, {})
            for mname, fn in sorted(methods.items()):
                if mname == "__init__":
                    continue
                for node in ast.walk(fn):
                    hit = None
                    if isinstance(node, ast.Assign):
                        for t in node.targets:
                            if (
                                isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"
                                and t.attr in attr_map
                            ):
                                hit = (t.attr, "rebinding", node.lineno)
                    elif isinstance(node, ast.Call):
                        f = node.func
                        if (
                            isinstance(f, ast.Attribute)
                            and f.attr == "resize"
                            and isinstance(f.value, ast.Attribute)
                            and isinstance(f.value.value, ast.Name)
                            and f.value.value.id == "self"
                            and f.value.attr in attr_map
                        ):
                            hit = (f.value.attr, "resizing", node.lineno)
                    if hit is None:
                        continue
                    attr, what, line = hit
                    if m.suppressed("PTR003", line):
                        continue
                    out.append(
                        Finding(
                            "PTR003",
                            relpath,
                            line,
                            f"use-after-recycle: {what} self.{attr} in "
                            f"{cls}.{mname}() while {attr_map[attr]} "
                            "(declared owns_buffers) still holds the old "
                            "pointer — the .so would read freed storage "
                            f"until {_release_of(attr_map[attr], effects)}",
                        )
                    )
    return out


def _release_of(sym: str, effects: Dict[str, object]) -> str:
    eff = effects.get(sym)
    return getattr(eff, "borrows_until", "call") if eff else "?"


# ---------------------------------------------------------------------------
# Drivers.


def race_sources(root: str) -> Dict[str, str]:
    srcs: Dict[str, str] = {}
    for rel in GRAPH_FILES:
        path = os.path.join(root, rel)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                srcs[rel] = fh.read()
        except OSError:  # pragma: no cover - repo layout is fixed
            continue
    return srcs


def race_static(
    sources: Dict[str, str],
    guards: Optional[Dict[str, Dict[str, Dict[str, Guard]]]] = None,
    holders: Optional[Dict[str, Dict[str, Tuple[str, ...]]]] = None,
    aliases: Optional[Dict[str, Dict[str, Dict[str, str]]]] = None,
    retained: Optional[Dict[str, Dict[str, Dict[str, str]]]] = None,
    effects: Optional[Dict[str, object]] = None,
    declared_order: Sequence[str] = DECLARED_ORDER,
    used_out: Optional[Set[Tuple[str, int, str]]] = None,
) -> List[Finding]:
    """The whole static half over in-memory sources ({relpath: source})
    — the self-test entry point. Registry arguments default to the
    shipped ones; fixtures override them. ``used_out`` collects the
    (path, line, token) suppressions the checks honored inline, for the
    PTL006 stale sweep downstream."""
    mods = [Module(rp, src) for rp, src in sorted(sources.items())]
    out: List[Finding] = []
    for m in mods:
        out.extend(check_guarded_state(m, guards, holders, aliases))
        out.extend(check_condvar_loops(m))
    out.extend(check_lock_graph(mods, aliases, declared_order, holders))
    out.extend(check_ownership(mods, retained, effects))
    if used_out is not None:
        for m in mods:
            used_out.update((m.relpath, ln, tok) for ln, tok in m.used)
    return sorted(out, key=lambda f: (f.path, f.line, f.check))


def race_repo(repo_root: str) -> List[Finding]:
    """Stage 7: static half over the analyzed repo files + the dynamic
    epoll-seam gate, with the shared inline-suppression filter (stale
    PTR suppressions come back as PTL006)."""
    used: Set[Tuple[str, int, str]] = set()
    findings = race_static(race_sources(repo_root), used_out=used)
    findings += check_seam_repo()
    return apply_suppressions(
        findings, repo_root, stale_family="PTR", inline_used=used
    )
