"""The port's kernel-family registry for its check stages (counterpart of
the JAX package's ``ops/obligations.py``, for the prove, ABI, protocol,
linearizability and dispatch stages).

Every limiter lattice family is registered HERE as one declarative
:class:`KernelFamily` record: the kernels it owns (:data:`KERNEL_ROOTS`),
its native-ABI twins (stage 5, ``analysis/abi.py``), its protocol-model
hook (stage 6, ``analysis/protocol.py``), its linearizability spec (stage
8, ``analysis/linearizability.py``), its wire codec, and the seeded
protocol and linearizability mutations the stages must demonstrably
reject. The registry lives next to the kernels, so adding a kernel
without declaring its obligations, or weakening one, is a diff on this
file, in code review's line of sight.

Kernel names stay the reference's (``ops.take.take_batch``,
``ops.merge.merge_batch_folded``, ...). :data:`KERNEL_ROOTS` maps each to
the port's module and function; the ABI stage resolves a twin through it
at call time, so a monkeypatched kernel is what gets compared.

Each family's prove roots (stage 4, ``analysis/prove.py``) carry their
obligation codes, their PTP001 profile, their model tag and, in place of
the reference's jaxpr tracer, an operand builder that makes the
structural run's small tensors on a given device; ``absent`` keeps the
per-root justifications for the obligation codes a root does not
declare. ``PROVE_EXEMPT`` holds the engine-dispatched functions with no
root, each with its reason. The six prove-stage mutations are plain
torch (or Python) drop-in replacements for their roots. The dispatch
registry (stage 10, ``analysis/dispatch.py``) is at the bottom:
``DISPATCH_SPECS``, one spec per kernel launch key, per ``count_launch``
caller and per plain-torch serving function, the witness paths' declared
launches (``WITNESS_LAUNCHES``) and waits (``WITNESS_WAITS``), the
engine's declared waits (``DECLARED_WAITS``) and the justified absences
of PTD001/PTD002. Stage 9 (cert, ``analysis/cert.py``) reads the family
records whole: every family reaches every stage it should (or says why
not), including the keys ``chip_smoke.py`` writes for the phase that
runs its kernel end to end (``bench_fields``).

The flat ``PROVE_ROOTS`` / ``LIN_SPECS`` / ``ABI_OBLIGATIONS`` tuples the
stage drivers and tests consume are DERIVED from the family records at
the bottom of this file — one source of truth.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

from patrol_tpu_torch.analysis.abi import AbiObligation
from patrol_tpu_torch.analysis.linearizability import LinSpecFamily
from patrol_tpu_torch.analysis.protocol import ConcLaws, GcraLaws, QuotaLaws
from patrol_tpu_torch.analysis.prove import Operands, ProveRoot

_P = "patrol_tpu_torch."


@dataclasses.dataclass(frozen=True)
class CertMutation:
    """One seeded mutation a family registers: a deliberately broken
    variant of the family's semantics that the checking stack MUST
    reject with ``expect`` (the exact PT code, pinned — a mutation that
    trips a *different* code means the check that was supposed to own
    this hazard has gone soft).

    ``stage`` selects the executor:

    * ``"prove"`` — ``mutant`` is a drop-in replacement for the prove
      root named by ``target``; executed via ``prove_root(root,
      fn=mutant)`` (``prove_repo --mutation NAME``).
    * ``"protocol"`` with ``laws`` — a family-law payload; executed via
      ``protocol.FAMILY_CHECKS[target](laws=laws)``.
    * ``"protocol"`` without ``laws`` — a reference to a
      ``protocol.MUTATIONS`` entry named ``target``, executed through
      ``check_protocol``.
    * ``"lin"`` — a reference to a ``linearizability.LIN_MUTATIONS``
      entry named ``target``, executed by stage 8's ``check_repo``.
    """

    name: str
    stage: str  # "prove" | "protocol" | "lin"
    target: str
    expect: str
    note: str = ""
    mutant: Optional[Callable] = None  # stage="prove" payload
    laws: Optional[object] = None  # stage="protocol" family-law payload


@dataclasses.dataclass(frozen=True)
class KernelFamily:
    """One certified lattice family.

    ``prove_roots`` are the kernels the family owns; :attr:`roots` maps
    each root's name to the port's (module, function). ``absent`` carries
    the justification strings for obligation codes a root deliberately
    does not declare, keyed ``"<root-name>:<code>"``. ``*_exempt`` fields
    carry justifications for a whole stage the family doesn't reach
    (empty string = not exempt, the stage is required)."""

    name: str
    domain: str  # the lattice, in one line
    prove_roots: Tuple[ProveRoot, ...]
    absent: Mapping[str, str] = dataclasses.field(default_factory=dict)
    lin_specs: Tuple[LinSpecFamily, ...] = ()
    lin_exempt: str = ""
    protocol: Optional[str] = None  # protocol.FAMILY_CHECKS key
    protocol_exempt: str = ""
    abi: Tuple[AbiObligation, ...] = ()
    wire_codec: Optional[str] = None  # root name of the codec
    # Keys chip_smoke.py writes for the phase that runs the family's kernel
    # end to end on the card (the reference's bench.py smoke fields).
    bench_fields: Tuple[str, ...] = ()
    bench_exempt: str = ""
    mutations: Tuple[CertMutation, ...] = ()
    mutations_exempt: str = ""
    note: str = ""

    @property
    def roots(self) -> Dict[str, Tuple[str, str]]:
        return {r.name: (r.module, r.attr) for r in self.prove_roots}


def _codec_absent(root_name: str) -> Dict[str, str]:
    """The shared absence record for host-side wire codec roots: pure
    Python byte codecs have no traced program to lint (PTP001/PTP005), no
    lattice algebra of their own (PTP002/PTP004) — round-trip exactness
    PTP003 is the whole contract."""
    why_py = "host-side python codec: no jaxpr, nothing to trace"
    why_alg = (
        "codecs carry lattice coordinates but compute no joins; "
        "PTP003 round-trip exactness is the entire obligation"
    )
    return {
        f"{root_name}:PTP001": why_py,
        f"{root_name}:PTP002": why_alg,
        f"{root_name}:PTP004": why_alg,
        f"{root_name}:PTP005": why_py,
    }


# ---------------------------------------------------------------------------
# Prove roots' operand builders: the structural run's small tensors on a
# given device (the reference traced these shapes abstractly). State
# planes lead; every builder returns fresh tensors.

_B, _N, _K = 4, 2, 3


def _t(values, device, dtype=None):
    import torch

    return torch.tensor(values, dtype=dtype or torch.int64, device=device)


def _state(device):
    import torch

    from patrol_tpu_torch.models.limiter import LimiterState

    pn = torch.arange(_B * _N * 2, dtype=torch.int64, device=device).view(_B, _N, 2) * 5
    return LimiterState(pn, torch.arange(_B, dtype=torch.int64, device=device) * 7)


def _vec(device, base: int = 11):
    return _t([base, 3 * base, 2 * base], device)


def _rows(device):
    return _t([2, 0, 3], device)


def _planes_out(res) -> tuple:
    return (res.pn, res.elapsed)


def _ops_merge_batch(device) -> Operands:
    from patrol_tpu_torch.ops.merge import MergeBatch

    st = _state(device)
    batch = MergeBatch(_rows(device), _t([1, 0, 1], device), _vec(device), _vec(device, 7),
                       _vec(device, 5))
    return Operands((st, batch), tuple(st), _planes_out)


def _ops_merge_batch_folded(device) -> Operands:
    from patrol_tpu_torch.ops.merge import FOLD_PAD_ROW, FoldedMergeBatch

    st = _state(device)
    batch = FoldedMergeBatch(_t([0, 3, FOLD_PAD_ROW], device), _t([1, 0, 0], device),
                             _vec(device), _vec(device, 7),
                             _t([0, 3, FOLD_PAD_ROW + 1], device), _vec(device, 5))
    return Operands((st, batch), tuple(st), _planes_out)


def _ops_merge_rows_dense(device) -> Operands:
    import torch

    from patrol_tpu_torch.ops.merge import RowDenseBatch

    st = _state(device)
    upd = torch.arange(_K * _N * 2, dtype=torch.int64, device=device).view(_K, _N, 2) * 3
    return Operands((st, RowDenseBatch(_rows(device), upd, _vec(device, 5))), tuple(st),
                    _planes_out)


def _ops_commit_blocks(device) -> Operands:
    import torch

    from patrol_tpu_torch.ops.merge import FOLD_PAD_ROW

    # A two-block ring: the flattened view sorted and unique, sentinel tail.
    st = _state(device)
    pad = FOLD_PAD_ROW
    flat = torch.tensor(
        [[0, 2, 3, pad, pad, pad],
         [1, 0, 1, 0, 1, 2],
         [9, 4, 6, 0, 0, 0],
         [2, 8, 5, 0, 0, 0],
         [0, 2, 3, pad, pad + 1, pad + 2],
         [7, 3, 9, 0, 0, 0]], dtype=torch.int64, device=device)
    return Operands((st, flat.view(6, 2, _K)), tuple(st), _planes_out)


def _ops_merge_dense(device) -> Operands:
    import torch

    from patrol_tpu_torch.models.limiter import LimiterState

    st = _state(device)
    other = LimiterState(torch.flip(st.pn, (0,)).contiguous(),
                         torch.flip(st.elapsed, (0,)).contiguous())
    return Operands((st, other), (*st, *other), _planes_out)


def _ops_tree_reduce(device) -> Operands:
    import torch

    pn = torch.arange(2 * _B * _N * 2, dtype=torch.int64, device=device).view(2, _B, _N, 2) % 7
    el = torch.arange(2 * _B, dtype=torch.int64, device=device).view(2, _B) % 5
    return Operands((pn, el), (pn, el), _planes_out, shapes_match=False)


def _ops_read_rows(device) -> Operands:
    st = _state(device)
    return Operands((st, _t([1, -1, 7], device)), tuple(st), _planes_out, shapes_match=False)


def _ops_take_batch(device) -> Operands:
    from patrol_tpu_torch.models.limiter import NANO
    from patrol_tpu_torch.ops.take import TakeRequest

    st = _state(device)
    req = TakeRequest(_rows(device), _vec(device, NANO), _t([2, 2, 0], device),
                      _t([NANO] * _K, device), _t([NANO] * _K, device), _t([1, 2, 0], device),
                      _t([2 * NANO] * _K, device), _t([0] * _K, device))
    return Operands((st, req, 1), tuple(st), lambda r: _planes_out(r[0]))


def _ops_take_n_batch(device) -> Operands:
    import torch

    from patrol_tpu_torch.models.limiter import NANO
    from patrol_tpu_torch.ops.take import TAKE_PACK_ROWS

    st = _state(device)
    packed = torch.zeros((TAKE_PACK_ROWS, _K), dtype=torch.int64, device=device)
    packed[0] = _rows(device)
    packed[1:5] = _t([[NANO], [2], [NANO], [NANO]], device)
    packed[5] = _t([1, 3, 0], device)
    packed[6] = 2 * NANO
    return Operands((st, packed, 1), tuple(st), lambda r: _planes_out(r[0]))


def _ops_delta_fold(device) -> Operands:
    from patrol_tpu_torch.ops.delta import DeltaBatch
    from patrol_tpu_torch.ops.merge import FOLD_PAD_ROW

    st = _state(device)
    batch = DeltaBatch(_t([3, 0, FOLD_PAD_ROW], device), _t([0, 1, 0], device), _vec(device),
                       _vec(device, 7), _vec(device, 5))
    return Operands((st, batch), tuple(st), _planes_out)


def _ops_decode_fold_raw(device) -> Operands:
    import numpy as np
    import torch

    from patrol_tpu_torch.ops import ingest as ingest_ops
    from patrol_tpu_torch.ops import wire

    # Two 512-byte planes: one real dv2 datagram, one all-zero (rejected).
    row = 512
    e = ingest_ops.max_entries(row)
    data, n = wire.encode_delta_packet(
        1, 5, (2,), [wire.DeltaEntry("a", 1, 3, 40, 9, 12), wire.DeltaEntry("b", 0, 3, 8, 2, 5)],
        max_size=row)
    planes = np.zeros((2, row), np.uint8)
    planes[0, : len(data)] = np.frombuffer(data, np.uint8)
    lengths = np.array([len(data), 0], np.int32)
    walk = ingest_ops.host_walk(planes, lengths)
    rows = np.full((2, e), 1 << 30, np.int32)
    rows[0, :n] = [0, 2]
    st = _state(device)

    def d(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    args = (st, d(planes), d(lengths), d(np.maximum(walk.name_off - 1, 0).astype(np.int32)),
            d(rows), torch.zeros((2, e), dtype=torch.bool, device=device))
    return Operands(args, tuple(st), lambda r: _planes_out(r[0]))


def _ops_lifecycle_probe(device) -> Operands:
    from patrol_tpu_torch.models.limiter import NANO
    from patrol_tpu_torch.ops.lifecycle import LifecycleProbe

    st = _state(device)
    probe = LifecycleProbe(_rows(device), _t([4 * NANO] * _K, device), _t([NANO] * _K, device),
                           _t([2 * NANO, 0, NANO], device), _t([0] * _K, device))
    # A pure read: no state outputs, the planes must come back unchanged.
    return Operands((st, probe, 1), tuple(st), None, shapes_match=False)


def _ops_gcra(device) -> Operands:
    from patrol_tpu_torch.ops.gcra import GcraRequest

    st = _state(device)
    req = GcraRequest(_rows(device), _vec(device, 50), _t([5, 0, 3], device),
                      _t([9] * _K, device), _t([2, 1, 0], device))
    return Operands((st, req, 1), tuple(st), lambda r: _planes_out(r[0]))


def _ops_conc(device) -> Operands:
    from patrol_tpu_torch.ops.concurrency import ConcRequest

    st = _state(device)
    req = ConcRequest(_rows(device), _t([100] * _K, device), _t([2, 0, 1], device),
                      _t([2, 1, 0], device), _t([1, 0, 2], device))
    return Operands((st, req, 1), tuple(st), lambda r: _planes_out(r[0]))


def _ops_quota(device) -> Operands:
    from patrol_tpu_torch.ops.hierquota import QuotaRequest

    st = _state(device)
    req = QuotaRequest(_t([0, 0, 0], device), _t([1, 1, 2], device), _t([3, 2, 3], device),
                       _t([500] * _K, device), _t([300] * _K, device), _t([200] * _K, device),
                       _t([2, 1, 0], device), _t([2, 1, 1], device))
    return Operands((st, req, 1), tuple(st), lambda r: _planes_out(r[0]))


def _ops_converge(device) -> Operands:
    import torch

    st = _state(device)
    spn = torch.arange(2 * 2 * _N * 2, dtype=torch.int64, device=device).view(2, 2, _N, 2) % 9
    sel = torch.arange(4, dtype=torch.int64, device=device).view(2, 2) % 3
    return Operands((*st, _t([0, 3], device), spn, sel), (*st, spn, sel), lambda _r: tuple(st))


def _ops_gather(device) -> Operands:
    import torch

    st = _state(device)
    spn = torch.zeros((2, 2, _N, 2), dtype=torch.int64, device=device)
    sel = torch.zeros((2, 2), dtype=torch.int64, device=device)
    return Operands((*st, _t([0, 3], device), spn, sel), (*st, spn, sel),
                    lambda _r: (spn, sel), shapes_match=False)


def _ops_row_rmw(device) -> Operands:
    import torch

    state = torch.arange(4 * 8 * 128, dtype=torch.int32, device=device).view(4, 8, 128) - 2000
    i32 = torch.int32
    args = (state, _t([2, 0], device, i32), _t([4, 1021], device, i32),
            _t([-7, 5], device, i32), _t([0, 3], device, i32), "pairmax")
    return Operands(args, (state,), lambda r: (r,))


_ALL = ("PTP001", "PTP002", "PTP003", "PTP004", "PTP005")
# (csrc file, its join functions, the names its planes go by there).
_JOIN_CU = (("join.cu", ("dense_row", "pair_word", "elapsed_entry"), ("pn", "elapsed", "dst")),)


def _root(name, module, attr, obligations, **kw) -> ProveRoot:
    return ProveRoot(name, _P + module, attr, tuple(obligations), **kw)


# ---------------------------------------------------------------------------
# Seeded prove-stage mutants (stage="prove" payloads): each is a drop-in
# copy of its root with exactly one seeded defect, and each must be
# rejected by the root's model with exactly its pinned code.


def _mutant_gcra_window_off_by_one(state, req, node_slot):
    """gcra_take_batch with the conformance window widened by one
    emission interval: admits a burst of burst+1."""
    import torch

    from patrol_tpu_torch.models.limiter import TAKEN
    from patrol_tpu_torch.ops import cert_kernel
    from patrol_tpu_torch.ops.gcra import GcraResult, pack

    pn = state.pn
    rows, now, t, tol, nreq = pack(req, pn.shape[0])
    g, in_range = cert_kernel.gather_index(rows, pn.shape[0])
    pn_rows = pn[g]
    own_tat = pn_rows[:, node_slot, TAKEN]
    tat = pn_rows[:, :, TAKEN].amax(dim=-1)
    base = torch.maximum(tat, now)
    deadline = now + tol + t  # SEEDED defect
    conforms = tat <= deadline
    zero = torch.zeros_like(tat)
    safe_t = torch.where(t <= 0, torch.ones_like(t), t)
    extras = torch.div(torch.clamp(deadline - base, min=0), safe_t, rounding_mode="floor")
    k = torch.where(conforms, 1 + extras, zero)
    k = torch.where(t > 0, k, zero)
    k = torch.minimum(torch.clamp(k, min=0), nreq)
    new_own = torch.where(k >= 1, base + k * t, own_tat)
    # Out-of-range rows scatter INT64_MIN into the clamped row: a no-op max.
    lane = pn[:, node_slot, TAKEN]
    lane.scatter_reduce_(0, g, torch.where(in_range, new_own, -(2**63)), reduce="amax")
    tat_out = torch.maximum(tat, new_own)
    return state, GcraResult(k, tat_out, torch.maximum(own_tat, new_own), tat_out - tol)


def _mutant_conc_release_unclamped(state, req, node_slot):
    """conc_acquire_batch without the own-lane release clamp: a phantom
    release drives ADDED past TAKEN and the cluster over-admits
    forever."""
    import torch

    from patrol_tpu_torch.models.limiter import ADDED, TAKEN
    from patrol_tpu_torch.ops import cert_kernel
    from patrol_tpu_torch.ops.concurrency import ConcResult, pack

    pn = state.pn
    rows, limit, count, nreq, releases = pack(req, pn.shape[0])
    g, in_range = cert_kernel.gather_index(rows, pn.shape[0])
    pn_rows = pn[g]
    own_added = pn_rows[:, node_slot, ADDED]
    own_taken = pn_rows[:, node_slot, TAKEN]
    sum_added = pn_rows[:, :, ADDED].sum(dim=-1)
    sum_taken = pn_rows[:, :, TAKEN].sum(dim=-1)
    want_rel = torch.clamp(releases, min=0) * torch.clamp(count, min=0)
    d_rel = want_rel  # SEEDED defect: clamp dropped
    inflight = sum_taken - (sum_added + d_rel)
    headroom = limit - inflight
    safe_count = torch.where(count <= 0, torch.ones_like(count), count)
    k = torch.div(headroom, safe_count, rounding_mode="floor")
    k = torch.minimum(torch.clamp(k, min=0), nreq)
    k = torch.where(count > 0, k, torch.zeros_like(k))
    d_acq = k * count
    pair = torch.stack([d_rel, d_acq], dim=1) * in_range.unsqueeze(1)
    pn[:, node_slot].index_put_((g,), pair, accumulate=True)
    return state, ConcResult(k, d_rel, inflight + d_acq, own_taken + d_acq, own_added + d_rel,
                             want_rel - d_rel)


def _mutant_quota_admit_leaf_only(state, req, node_slot):
    """quota_take_batch admitting against the leaf headroom only: a
    tenant's users collectively overrun the tenant/global budgets."""
    import torch

    from patrol_tpu_torch.models.limiter import TAKEN
    from patrol_tpu_torch.ops import cert_kernel
    from patrol_tpu_torch.ops.hierquota import QuotaResult, pack

    pn = state.pn
    rows_g, rows_t, rows_u, limit_g, limit_t, limit_u, count, nreq = pack(req, pn.shape[0])
    kb = rows_u.shape[0]
    rows = torch.cat([rows_g, rows_t, rows_u])
    g, in_range = cert_kernel.gather_index(rows, pn.shape[0])
    pn_rows = pn[g]
    spend = pn_rows[:, :, TAKEN].sum(dim=-1)
    head_g = limit_g - spend[:kb]
    head_t = limit_t - spend[kb:2 * kb]
    head_u = limit_u - spend[2 * kb:]
    head_min = head_u  # SEEDED defect: ancestors not consulted
    safe_count = torch.where(count <= 0, torch.ones_like(count), count)
    k = torch.div(head_min, safe_count, rounding_mode="floor")
    k = torch.minimum(torch.clamp(k, min=0), nreq)
    k = torch.where(count > 0, k, torch.zeros_like(k))
    d = k * count
    debit = torch.cat([d, d, d])
    pn[:, node_slot, TAKEN].index_put_((g,), debit * in_range, accumulate=True)
    return state, QuotaResult(k, head_g - d, head_t - d, head_u - d,
                              pn_rows[2 * kb:, node_slot, TAKEN] + d)


def _mutant_take_n_uncapped(state, packed, node_slot):
    """take_n_batch with the crowd-size clip dropped: the greedy grant
    admits ``have // count`` takes even past the ``nreq`` tickets
    actually waiting (and padding columns with ``nreq == 0`` start
    committing)."""
    from patrol_tpu_torch.ops.take import take_n_batch

    lifted = packed.clone()
    lifted[5] = 1 << 40  # SEEDED defect
    return take_n_batch(state, lifted, node_slot)


def _mutant_split_grant_lifo(have_nt, admitted, count_nt, nreq):
    """split_grant admitting the LAST k tickets instead of the first:
    late arrivals jump the crowd."""
    from patrol_tpu_torch.ops.take import remaining_for_request

    return [
        remaining_for_request(have_nt, admitted, count_nt, nreq - 1 - i)
        for i in range(nreq)  # SEEDED defect: arrival order reversed
    ]


def _mutant_split_deny_charges(have_nt, admitted, count_nt, nreq):
    """split_grant charging denied tickets as if they had committed: a
    deny storm walks the reported balance down a ledger nobody spent."""
    from patrol_tpu_torch.models.limiter import NANO

    out = []
    for i in range(nreq):
        remaining_nt = have_nt - (i + 1) * count_nt  # SEEDED defect
        out.append((max(remaining_nt, 0) // NANO, i < admitted))
    return out


# ---------------------------------------------------------------------------
# The families.


KERNEL_FAMILIES: Tuple[KernelFamily, ...] = (
    KernelFamily(
        name="merge-join",
        domain="per-lane max join over the shared PN planes (the CvRDT "
        "merge every replication path reduces to)",
        prove_roots=(
            _root("ops.merge.merge_batch", "ops.merge", "merge_batch", _ALL,
                  structural="join", model="join_batch:merge_batch",
                  operands=_ops_merge_batch, launches=("pair_join",), cuda_joins=_JOIN_CU),
            _root("ops.merge.merge_batch_folded", "ops.merge", "merge_batch_folded", _ALL,
                  structural="join", model="join_batch:folded",
                  operands=_ops_merge_batch_folded, launches=("pair_join",),
                  cuda_joins=_JOIN_CU),
            _root("ops.merge.merge_rows_dense", "ops.merge", "merge_rows_dense", _ALL,
                  structural="join", model="join_batch:rows_dense",
                  operands=_ops_merge_rows_dense, launches=("row_join",), cuda_joins=_JOIN_CU),
            # The block ring's one join: the port's commit_packed is the
            # reference's commit_blocks over the packed staging matrix.
            _root("ops.commit.commit_blocks", "ops.commit", "commit_packed", _ALL,
                  structural="join", model="join_batch:commit_blocks",
                  operands=_ops_commit_blocks, launches=("pair_join",), cuda_joins=_JOIN_CU),
            _root("ops.merge.merge_dense", "ops.merge", "merge_dense", _ALL,
                  structural="join", model="dense_join", operands=_ops_merge_dense),
            # The converge tree's plain form (parallel/topology.py): flat
            # vs tree equivalence, leaf permutation and duplication,
            # monotonicity, across power-of-two and ragged fan-ins.
            _root("parallel.topology.tree_reduce_states", "parallel.topology",
                  "tree_reduce_states", _ALL, structural="join", model="tree_converge",
                  operands=_ops_tree_reduce),
            _root("ops.merge.read_rows", "ops.merge", "read_rows", ("PTP001", "PTP005"),
                  structural="join", operands=_ops_read_rows),
            # The reference's Pallas scatter-max is the join kernel of
            # csrc/join.cu behind three wrappers; the root resolves to the
            # widest (tick_join, both halves in one launch) and its model
            # holds all three against their plain versions.
            _root("ops.pallas_merge.merge_batch_pallas", "ops.join_kernel", "tick_join",
                  ("PTP002", "PTP003"), model="pallas_interpret",
                  launches=("tick_join", "pair_join", "row_join")),
            # The mesh's converge kernel (csrc/converge.cu), the port's own
            # root: the mesh dispatches it, so it runs the tree_converge
            # model through the kernel.
            _root("ops.converge_kernel.converge", "ops.converge_kernel", "converge", _ALL,
                  structural="join", model="converge_rows", operands=_ops_converge,
                  launches=("converge",),
                  cuda_joins=(("converge.cu", ("converge_kernel",), ("pn", "elapsed")),)),
            # The mesh's scratch gather: T take rows copied into R replica
            # copies. No algebra of its own.
            _root("ops.converge_kernel.gather", "ops.converge_kernel", "gather",
                  ("PTP001", "PTP005"), structural="join", operands=_ops_gather,
                  launches=("mesh_gather",)),
            # The row read-modify-write's pairmax (csrc/row_rmw.cu): the
            # join model on its int32 domain.
            _root("ops.row_rmw_kernel.row_rmw", "ops.row_rmw_kernel", "row_rmw", _ALL,
                  structural="join", model="pairmax_join", operands=_ops_row_rmw,
                  launches=("row_rmw",),
                  cuda_joins=(("row_rmw.cu", ("row_rmw_kernel",), ("p", "row")),)),
        ),
        absent={
            "ops.merge.read_rows:PTP002": (
                "pure gather: no algebra to replay — bit-exactness is "
                "covered by the engines' own read-back differentials"
            ),
            "ops.merge.read_rows:PTP003": (
                "a read commits nothing; there is no inverse to be exact "
                "against"
            ),
            "ops.merge.read_rows:PTP004": (
                "reads don't move the lattice; monotonicity is vacuous"
            ),
            "ops.pallas_merge.merge_batch_pallas:PTP001": (
                "the kernel is CUDA C++, not a torch program to run under the "
                "dispatch mode: its join functions are scanned in csrc/join.cu "
                "under the merge_batch root, whose plain twin IS PTP001-checked, "
                "and this root's model holds it bit-exact against that twin"
            ),
            "ops.pallas_merge.merge_batch_pallas:PTP004": (
                "monotonicity is inherited from the bit-exact twin merge_batch "
                "via the pallas_interpret differential"
            ),
            "ops.pallas_merge.merge_batch_pallas:PTP005": (
                "the wrappers update the planes in place; their dtype, shape and "
                "device checks raise on anything else, and the twin "
                "differential compares the planes whole"
            ),
            "ops.converge_kernel.gather:PTP002": (
                "pure gather into the scratch: no algebra to replay — the "
                "converge root's model covers what the scratch feeds"
            ),
            "ops.converge_kernel.gather:PTP003": (
                "a copy commits nothing to the canonical planes; there is no "
                "inverse to be exact against"
            ),
            "ops.converge_kernel.gather:PTP004": (
                "the canonical planes are not written; monotonicity is vacuous"
            ),
        },
        lin_exempt=(
            "joins are the replication substrate the lin model itself "
            "applies between events; ops.take.take_batch's spec covers "
            "the admission-facing surface"
        ),
        protocol="bucket-full",
        # Phase 3's main path: the deltas its ticks join and how they
        # committed (commit_split's labels and counters).
        bench_fields=("deltas_per_s", "commits"),
        abi=(
            AbiObligation(
                "native.pt_fold_hybrid", "pt_fold_hybrid",
                ("PTA001", "PTA002", "PTA003"), "fold_conformance",
                twins=(
                    "ops.merge.merge_batch",
                    "ops.merge.merge_batch_folded",
                    "ops.merge.merge_rows_dense",
                ),
            ),
        ),
        mutations=(
            CertMutation(
                "merge-sums-instead-of-maxes", "protocol",
                "merge-sums-instead-of-maxes", "PTC001",
                note="join degenerates to a counter sum; replayed "
                "deliveries double-count",
            ),
            CertMutation(
                "merge-assigns-lww", "protocol", "merge-assigns-lww",
                "PTC002",
                note="last-writer-wins assignment loses concurrent lanes",
            ),
            CertMutation(
                "resync-overwrites-instead-of-joins", "protocol",
                "resync-overwrites-instead-of-joins", "PTC002",
                note="anti-entropy that overwrites forks the replicas it "
                "was meant to heal",
            ),
        ),
    ),
    KernelFamily(
        name="scalar-merge",
        domain="lossy scalar deficit attribution against reference peers "
        "(documented non-CRDT: PTP002/PTP003 deliberately absent)",
        prove_roots=(
            _root("ops.merge.merge_scalar_batch", "ops.merge", "merge_scalar_batch",
                  ("PTP001", "PTP004", "PTP005"), structural="callbacks",
                  model="scalar_monotone", operands=_ops_merge_batch,
                  launches=("pair_join",)),
        ),
        absent={
            "ops.merge.merge_scalar_batch:PTP002": (
                "deficit attribution against reference peers is documented "
                "as lossy (kernel docstring): declaring only PTP004 "
                "records that design decision machine-checkably"
            ),
            "ops.merge.merge_scalar_batch:PTP003": (
                "no inverse exists for a lossy attribution; exactness is "
                "not claimed anywhere it could be relied on"
            ),
        },
        lin_exempt=(
            "the scalar plane is advisory (observability), never an "
            "admission input; no grants to linearize"
        ),
        protocol_exempt=(
            "not a replicated lattice: scalar deficits ride inside v1 "
            "datagrams and are re-derived, not joined"
        ),
        bench_exempt=(
            "no standalone device leg: no phase of chip_smoke.py sends a "
            "trailer-less v1 state; the attribution is plain torch ahead of "
            "pair_join, the join whose launches phase 3's main path counts "
            "for merge-join, and phase 3m drives this root through pair_join "
            "on the card"
        ),
        mutations_exempt=(
            "documented-lossy family with a single monotone law; the "
            "scalar_monotone model's internal self-test already flips it"
        ),
    ),
    KernelFamily(
        name="bucket",
        domain="token bucket: greedy admission against the summed PN "
        "view, refill arithmetic in nanotokens",
        prove_roots=(
            _root("ops.take.take_batch", "ops.take", "take_batch",
                  ("PTP001", "PTP004", "PTP005"), structural="callbacks",
                  model="take_monotone", operands=_ops_take_batch, launches=("take_n",)),
            # The hot-key take-n serving kernel: PTP002 one coalesced row ==
            # n sequential unit takes (replayed on the registered kernel),
            # PTP003 a denied row is a fixpoint, PTP004 monotone own lanes.
            _root("ops.take.take_n_batch", "ops.take", "take_n_batch", _ALL,
                  structural="callbacks", model="take_n_laws", operands=_ops_take_n_batch,
                  launches=("take_n",)),
            # The host-side FIFO grant split behind take-n coalescing.
            _root("ops.take.split_grant", "ops.take", "split_grant", ("PTP002", "PTP003"),
                  model="take_split_fifo"),
            _root("ops.rate", "ops.rate", "parse_rate", ("PTP003", "PTP004"),
                  model="rate_algebra"),
            _root("ops.wire.codec", "ops.wire", "encode", ("PTP003",), model="wire_roundtrip"),
        ),
        absent={
            "ops.take.take_batch:PTP002": (
                "admission is order-sensitive by design (greedy grants); "
                "the commutative core is the join it scatters through, "
                "certified in merge-join"
            ),
            "ops.take.take_batch:PTP003": (
                "grants are not invertible — the forfeit clamp "
                "deliberately discards over-capacity remainder"
            ),
            "ops.take.split_grant:PTP001": (
                "host-side python fan-out: no jaxpr, nothing to trace"
            ),
            "ops.take.split_grant:PTP004": (
                "the split moves no lattice state — it fans one already-"
                "committed row's grant out to tickets; monotonicity "
                "lives in the take-n kernel root it serves"
            ),
            "ops.take.split_grant:PTP005": (
                "host-side python fan-out: no jaxpr, nothing to trace"
            ),
            "ops.rate:PTP001": (
                "host-side python parser: no jaxpr, nothing to trace"
            ),
            "ops.rate:PTP002": (
                "rate parsing has no join; PTP003 canonical-form "
                "round-trip plus PTP004 ordering are the whole algebra"
            ),
            "ops.rate:PTP005": (
                "host-side python parser: no jaxpr, nothing to trace"
            ),
            **_codec_absent("ops.wire.codec"),
        },
        lin_specs=(
            LinSpecFamily(
                "ops.take.take_batch", _P + "ops.take", "take_batch",
                wire="full",
                note="classic take: v1 full-state broadcast, admission "
                "from the full local view with the over-capacity forfeit "
                "clamp",
            ),
            LinSpecFamily(
                "ops.take.take_n_batch", _P + "ops.take",
                "take_n_batch", wire="full",
                note="hot-key coalesced take-n: the SAME sequential "
                "bucket spec — one row carrying nreq=n must hand out "
                "exactly the outcomes of n serialized takes, so "
                "coalescing is invisible to linearizability",
            ),
        ),
        protocol="bucket-full",
        abi=(
            AbiObligation(
                "native.pt_rx_classify", "pt_rx_classify",
                ("PTA001", "PTA002", "PTA003"), "classify_conformance",
                twins=("ops.wire.codec",),
            ),
            AbiObligation(
                "native.hls_schedules", "pt_hls_take_probe", ("PTA004",),
                "hls_interleavings",
            ),
        ),
        wire_codec="ops.wire.codec",
        # Phase 3's takes through take_n on the main path.
        bench_fields=("takes", "takes_per_s"),
        mutations=(
            CertMutation(
                "take-n-uncapped-crowd", "prove", "ops.take.take_n_batch", "PTP002",
                note="crowd-size clip dropped: one coalesced row admits past its "
                "waiting tickets, diverging from the sequential per-ticket replay",
                mutant=_mutant_take_n_uncapped,
            ),
            CertMutation(
                "take-split-lifo", "prove", "ops.take.split_grant", "PTP002",
                note="grant split admits the LAST k tickets: late arrivals jump "
                "the FIFO crowd",
                mutant=_mutant_split_grant_lifo,
            ),
            CertMutation(
                "take-split-deny-drift", "prove", "ops.take.split_grant", "PTP003",
                note="denied tickets charged as if committed: the reported "
                "balance drifts under a deny storm",
                mutant=_mutant_split_deny_charges,
            ),
            CertMutation(
                "take-ignores-remote-lanes", "protocol",
                "take-ignores-remote-lanes", "PTC003",
                note="own-lane-only admission view breaks the AP "
                "overspend bound",
            ),
            CertMutation(
                "incast-gate-bypass", "protocol", "incast-gate-bypass",
                "PTC003",
                note="the incast admission gate is part of the bucket's "
                "bound; bypassing it over-admits under fan-in",
            ),
            CertMutation(
                "take-ignores-visible-remote-spend", "lin",
                "take-ignores-visible-remote-spend", "PTN001",
                note="delivered remote lanes excluded from the admission "
                "view",
            ),
            CertMutation(
                "grant-exceeds-spec-on-sync-schedule", "lin",
                "grant-exceeds-spec-on-sync-schedule", "PTN003",
                note="over-grant on a fully synchronous schedule",
            ),
            CertMutation(
                "visibility-violating-linearization-accepted", "lin",
                "visibility-violating-linearization-accepted", "PTN002",
                note="checker soundness: an illegal witness order must "
                "not be accepted",
            ),
        ),
    ),
    KernelFamily(
        name="delta",
        domain="wire-v2 absolute own-lane intervals: delta-fold ingest, "
        "device-resident raw decode, watermark visibility",
        prove_roots=(
            _root("ops.delta.delta_fold", "ops.delta", "delta_fold", _ALL, structural="join",
                  model="join_batch:delta_fold", operands=_ops_delta_fold,
                  launches=("pair_join",), cuda_joins=_JOIN_CU),
            # Device-resident ingest: raw dv2 planes decoded, validated and
            # max-folded in one launch, against the Python decoder.
            _root("ops.ingest.decode_fold_raw", "ops.ingest", "decode_fold_raw", _ALL,
                  structural="join", model="raw_ingest", operands=_ops_decode_fold_raw,
                  launches=("decode_fold",),
                  cuda_joins=(("decode_fold.cu", ("decode_fold_kernel",),
                               ("pn", "elapsed", "dst")),)),
            _root("ops.wire.delta_codec", "ops.wire", "encode_delta_packet", ("PTP003",),
                  model="delta_roundtrip"),
        ),
        absent=_codec_absent("ops.wire.delta_codec"),
        lin_specs=(
            LinSpecFamily(
                "ops.delta.delta_fold", _P + "ops.delta",
                "delta_fold", wire="delta",
                note="delta-fold ingest: wire-v2 absolute own-lane "
                "intervals, visibility carried by the folded watermarks",
            ),
        ),
        protocol="bucket-delta",
        abi=(
            AbiObligation(
                # Zero-copy rx ring (device-resident ingest): every
                # interleaving of lease (rx thread) vs commit (engine
                # completer) against a lowest-free-first model, plus the
                # double-commit / stray-index refusals that guard the
                # use-after-recycle class.
                "native.rx_ring_schedules", "pt_rx_ring_lease", ("PTA004",),
                "rxring_interleavings",
            ),
        ),
        wire_codec="ops.wire.delta_codec",
        # Phase 3b: raw dv2 planes through decode_fold at the ring's batch.
        bench_fields=("raw_deltas_per_s",),
        mutations=(
            CertMutation(
                "delta-ships-increments-not-absolutes", "protocol",
                "delta-ships-increments-not-absolutes", "PTC001",
                note="increments on the wire double-apply under redelivery",
            ),
            CertMutation(
                "delta-gc-before-ack", "protocol", "delta-gc-before-ack",
                "PTC001",
                note="eager delta GC drops intervals a slow peer never saw",
            ),
        ),
    ),
    KernelFamily(
        name="lifecycle",
        domain="idle-bucket GC: the IsZero reclaim predicate and "
        "tombstoned own-lane re-creation",
        prove_roots=(
            # The IsZero predicate: PTP002 a "full" verdict is sound against
            # the take kernel, PTP003 zero is the join's bottom, PTP004 the
            # verdict is monotone in time; a pure read (PTP005).
            _root("ops.lifecycle.lifecycle_probe", "ops.lifecycle", "lifecycle_probe", _ALL,
                  structural="callbacks", model="lifecycle_iszero",
                  operands=_ops_lifecycle_probe, launches=("lifecycle_probe",)),
        ),
        lin_specs=(
            LinSpecFamily(
                "ops.lifecycle.lifecycle_probe", _P + "ops.lifecycle",
                "lifecycle_probe", wire="full", lifecycle=True,
                note="lifecycle GC re-creation: IsZero reclaim with the "
                "tombstoned own lane, refills in the schedule alphabet",
            ),
        ),
        protocol="lifecycle-gc",
        # Phase 3h: the sweeps' reclaims through lifecycle_probe.
        bench_fields=("reclaimed",),
        mutations=(
            CertMutation(
                "gc-drops-admitted-tokens", "protocol",
                "gc-drops-admitted-tokens", "PTC006",
                note="reclaiming a non-zero row un-spends admitted tokens",
            ),
            CertMutation(
                "gc-treats-collected-as-unknown", "protocol",
                "gc-treats-collected-as-unknown", "PTC001",
                note="a tombstone read back as bottom resurrects "
                "collected spend",
            ),
            CertMutation(
                "gc-forgets-visible-admits", "lin",
                "gc-forgets-visible-admits", "PTN004",
                note="reclaim erases grants the visibility ledger still "
                "carries",
            ),
        ),
    ),
    KernelFamily(
        name="gcra",
        domain="GCRA / sliding window: the Theoretical Arrival Time as a "
        "per-lane max register, conformance iff TAT <= now + tol",
        prove_roots=(
            _root("ops.gcra.gcra_take_batch", "ops.gcra", "gcra_take_batch",
                  ("PTP001", "PTP002", "PTP004", "PTP005"), structural="callbacks",
                  model="gcra_laws", operands=_ops_gcra, launches=("gcra_admit",)),
            _root("ops.wire.gcra_trailer", "ops.wire", "encode_gcra_trailer", ("PTP003",),
                  model="cert_trailer_roundtrip"),
        ),
        absent={
            "ops.gcra.gcra_take_batch:PTP003": (
                "admission is not invertible (a conforming grant advances "
                "the TAT permanently); exactness lives in the trailer "
                "codec root's PTP003"
            ),
            **_codec_absent("ops.wire.gcra_trailer"),
        },
        lin_specs=(
            LinSpecFamily(
                "ops.gcra.gcra_take_batch", _P + "ops.gcra",
                "gcra_take_batch", wire="delta", algebra="gcra",
                note="TAT max register: per-partition-side sequential "
                "GCRA replay (SequentialGcra) over the protocol-model "
                "cluster, shared injected clock in the alphabet",
            ),
        ),
        protocol="gcra",
        wire_codec="ops.wire.gcra_trailer",
        # Phase 3i: the cert leg's admitted count through the engine.
        bench_fields=("cert_gcra_admitted",),
        mutations=(
            CertMutation(
                "gcra-window-off-by-one", "prove", "ops.gcra.gcra_take_batch", "PTP002",
                note="conformance window widened by one emission interval: "
                "burst+1 admitted",
                mutant=_mutant_gcra_window_off_by_one,
            ),
            CertMutation(
                "gcra-conformance-own-lane-only", "protocol", "gcra",
                "PTC006",
                note="judging conformance from the own TAT lane ignores "
                "merged remote watermarks: overspend past the AP bound",
                laws=GcraLaws(view="own"),
            ),
        ),
    ),
    KernelFamily(
        name="concurrency",
        domain="in-flight concurrency limit: paired PN lanes (TAKEN = "
        "acquires, ADDED = releases), inflight = sum difference",
        prove_roots=(
            _root("ops.concurrency.conc_acquire_batch", "ops.concurrency",
                  "conc_acquire_batch", ("PTP001", "PTP002", "PTP004", "PTP005"),
                  structural="callbacks", model="conc_laws", operands=_ops_conc,
                  launches=("conc_admit",)),
            _root("ops.wire.conc_trailer", "ops.wire", "encode_conc_trailer", ("PTP003",),
                  model="cert_trailer_roundtrip"),
        ),
        absent={
            "ops.concurrency.conc_acquire_batch:PTP003": (
                "acquire/release ticks are not invertible on monotone "
                "lanes (that is the point of the clamp); exactness lives "
                "in the trailer codec root's PTP003"
            ),
            **_codec_absent("ops.wire.conc_trailer"),
        },
        lin_specs=(
            LinSpecFamily(
                "ops.concurrency.conc_acquire_batch",
                _P + "ops.concurrency", "conc_acquire_batch",
                wire="delta", algebra="conc",
                note="client-owned leases: per-side sequential replay "
                "(SequentialConc) — the own-lane release clamp IS lease "
                "ownership in the sequential limit",
            ),
        ),
        protocol="concurrency",
        wire_codec="ops.wire.conc_trailer",
        # Phase 3i: the cert leg's admitted count through the engine.
        bench_fields=("cert_conc_admitted",),
        mutations=(
            CertMutation(
                "conc-release-unclamped", "prove", "ops.concurrency.conc_acquire_batch",
                "PTP002",
                note="phantom release: ADDED lane driven past TAKEN, capacity "
                "returned that was never held",
                mutant=_mutant_conc_release_unclamped,
            ),
            CertMutation(
                "conc-phantom-release-model", "protocol", "concurrency",
                "PTC006",
                note="the model twin of the clamp: uncapped releases "
                "break held <= limit x sides",
                laws=ConcLaws(release="uncapped"),
            ),
        ),
    ),
    KernelFamily(
        name="hierquota",
        domain="hierarchical quotas global→tenant→user: path-minimum "
        "admission, all-or-nothing three-level debit in one scatter",
        prove_roots=(
            _root("ops.hierquota.quota_take_batch", "ops.hierquota", "quota_take_batch",
                  ("PTP001", "PTP002", "PTP004", "PTP005"), structural="callbacks",
                  model="quota_laws", operands=_ops_quota, launches=("quota_admit",)),
            _root("ops.wire.quota_trailer", "ops.wire", "encode_quota_trailer", ("PTP003",),
                  model="cert_trailer_roundtrip"),
        ),
        absent={
            "ops.hierquota.quota_take_batch:PTP003": (
                "debits are permanent on monotone G-counter lanes; "
                "exactness lives in the trailer codec root's PTP003"
            ),
            **_codec_absent("ops.wire.quota_trailer"),
        },
        lin_specs=(
            LinSpecFamily(
                "ops.hierquota.quota_take_batch",
                _P + "ops.hierquota", "quota_take_batch",
                wire="delta", algebra="quota",
                note="path-minimum admission: per-side sequential replay "
                "(SequentialQuota) against the three-level model cluster",
            ),
        ),
        protocol="hierquota",
        wire_codec="ops.wire.quota_trailer",
        # Phase 3i: the cert leg's admitted count through the engine.
        bench_fields=("cert_quota_admitted",),
        mutations=(
            CertMutation(
                "quota-admit-leaf-only", "prove", "ops.hierquota.quota_take_batch", "PTP002",
                note="leaf-only headroom: users collectively overrun the "
                "tenant/global pools",
                mutant=_mutant_quota_admit_leaf_only,
            ),
            CertMutation(
                "quota-debit-leaf-only", "protocol", "hierquota", "PTC006",
                note="the model twin: leaf-only debits break per-level "
                "conservation whenever an ancestor limit is tighter",
                laws=QuotaLaws(debit="leaf-only"),
            ),
        ),
    ),
)


# ---------------------------------------------------------------------------
# Toolchain-wide ABI obligations that belong to no single lattice family
# (the effects-table sweep covers every bound and exported native symbol).
TOOLCHAIN_ABI: Tuple[AbiObligation, ...] = (
    AbiObligation(
        "native.effects_table", None, ("PTA005",), "effects_table",
    ),
)


# ---------------------------------------------------------------------------
# Derived flat registries; order follows the family declaration order.

PROVE_ROOTS: Tuple[ProveRoot, ...] = tuple(
    root for fam in KERNEL_FAMILIES for root in fam.prove_roots
)

KERNEL_ROOTS: Dict[str, Tuple[str, str]] = {
    name: where for fam in KERNEL_FAMILIES for name, where in fam.roots.items()
}

LIN_SPECS: Tuple[LinSpecFamily, ...] = tuple(
    spec for fam in KERNEL_FAMILIES for spec in fam.lin_specs
)

ABI_OBLIGATIONS: Tuple[AbiObligation, ...] = (
    tuple(ob for fam in KERNEL_FAMILIES for ob in fam.abi) + TOOLCHAIN_ABI
)

MUTATIONS: Tuple[CertMutation, ...] = tuple(
    m for fam in KERNEL_FAMILIES for m in fam.mutations
)


# --- PTP006 (registration completeness): functions the engines run on the
# state that are deliberately NOT in PROVE_ROOTS, each with the reason on
# record. analysis/prove.py sweeps the engine files and flags any such
# function found in neither registry (nor reached from a root).
PROVE_EXEMPT: frozenset = frozenset(
    {
        # zero_rows writes constant zeros into selected rows — a pure
        # scatter of the lattice bottom with no algebra of its own. Its
        # lattice-facing laws are certified where they matter: the
        # lifecycle_iszero model proves reclaim-then-recreate (which IS
        # zero_rows + re-seed) take-observation-equivalent and join-
        # re-entry exact (PTP002/PTP003 on ops.lifecycle.lifecycle_probe).
        (_P + "ops.merge", "zero_rows"),
    }
)


# ---------------------------------------------------------------------------
# Dispatch-discipline registry (stage 10, analysis/dispatch.py). Every
# kernel launch key of ops/_build.py::LAUNCHES, every count_launch caller
# and every plain-torch serving function declares here the function the
# engine reaches on every device, its launcher, the shape-bucket law of
# its call sites (engine._pad_size's lo/hi), and the witness path that
# re-drives it warm under the launch counts (on the card, under torch's
# sync detector) — or a written reason why no path can.


@dataclasses.dataclass(frozen=True)
class DispatchSpec:
    """One serving function's dispatch contract.

    ``module``/``attr`` name the function the engine reaches on both
    devices (the witness counts its calls on the CPU); ``launcher`` is the
    ``count_launch`` caller in ``launcher_module`` (default: ``module``),
    empty for a plain-torch function. ``buckets`` is the call sites' shape
    law: ``"pow2"`` — padded by ``engine._pad_size`` with the declared
    ``(bucket_lo, bucket_hi)`` (ast text, compared with the engine files'
    ``_pad_size`` sites by PTD005); ``"fixed"`` — one pinned geometry;
    ``"caller"`` — the caller's shapes. ``witness`` names a path of
    :data:`WITNESS_LAUNCHES`; ``witness_absent`` is the reason when no
    path can reach it."""

    name: str  # a LAUNCHES key, or the plain function's name
    module: str
    attr: str
    launcher: str = ""
    launcher_module: str = ""
    buckets: str = "pow2"  # "pow2" | "fixed" | "caller"
    bucket_lo: str = "8"
    bucket_hi: str = "MAX_MERGE_ROWS"
    witness: str = ""
    witness_absent: str = ""
    note: str = ""


DISPATCH_SPECS: Tuple[DispatchSpec, ...] = (
    DispatchSpec(
        "pair_join", _P + "ops.join_kernel", "pair_join", launcher="_launch",
        witness="merge_folded",
        note="K (row, slot) pairs + Ke elapsed entries: merge_batch, the folded "
        "batch, the commit ring, delta fold, the scalar merge's commit",
    ),
    DispatchSpec(
        "row_join", _P + "ops.join_kernel", "row_join", launcher="_launch",
        bucket_hi="MAX_ROW_DENSE", witness="merge_rows_dense",
        note="whole-row lane windows: the dense half of the fold-to-dense hybrid",
    ),
    DispatchSpec(
        "tick_join", _P + "ops.join_kernel", "tick_join", launcher="_launch",
        witness="merge_packed",
        note="one merge tick, both halves in one launch: the feeder's commit",
    ),
    DispatchSpec(
        "take_n", _P + "ops.take_kernel", "take_n", launcher="take_n",
        bucket_hi="MAX_TAKE_ROWS", witness="take_n",
        note="packed [8, K] request / [7, K] result: the feeder's take tick",
    ),
    DispatchSpec(
        "decode_fold", _P + "ops.ingest_kernel", "decode_fold", launcher="decode_fold",
        buckets="fixed", bucket_hi="rx-ring planes", witness="raw_ingest",
        note="the rx ring's [P, ROW] planes + [P]/[P, E] framing, geometry pinned by "
        "the ring allocation",
    ),
    DispatchSpec(
        "row_rmw", _P + "ops.row_rmw_kernel", "row_rmw", launcher="row_rmw",
        buckets="caller", witness="row_rmw",
        note="the probe's per-row read-modify-write; its entry point drives fixed K",
    ),
    DispatchSpec(
        "lifecycle_probe", _P + "ops.lifecycle", "lifecycle_probe", launcher="probe",
        launcher_module=_P + "ops.lifecycle_kernel", bucket_hi="1 << 20",
        witness="lifecycle_probe", note="pure read: the GC sweep's idle/full probe",
    ),
    DispatchSpec(
        "gcra_admit", _P + "ops.gcra", "gcra_take_packed", launcher="fused",
        launcher_module=_P + "ops.cert_kernel", bucket_hi="1 << 62", witness="gcra",
    ),
    DispatchSpec(
        "conc_admit", _P + "ops.concurrency", "conc_acquire_packed", launcher="fused",
        launcher_module=_P + "ops.cert_kernel", bucket_hi="1 << 62", witness="conc",
    ),
    DispatchSpec(
        "quota_admit", _P + "ops.hierquota", "quota_take_packed", launcher="fused",
        launcher_module=_P + "ops.cert_kernel", bucket_hi="1 << 62", witness="quota",
    ),
    DispatchSpec(
        "mesh_gather", _P + "ops.converge_kernel", "gather", launcher="_launch",
        bucket_hi="MESH_WARM_MAX", witness="converge",
        note="the mesh dispatch's scratch gather (R > 1 with takes)",
    ),
    DispatchSpec(
        "converge", _P + "ops.converge_kernel", "converge", launcher="_launch",
        bucket_hi="MESH_WARM_MAX", witness="converge",
        note="the mesh dispatch's converge of the R replica copies",
    ),
    DispatchSpec(
        "zero_rows", _P + "ops.merge", "zero_rows", buckets="caller", witness="zero_rows",
        note="plain torch: eviction, GC reclaim, idle demotion, release_bucket; host "
        "rows in, one copy and one index fill per plane out",
    ),
    DispatchSpec(
        "read_rows", _P + "ops.merge", "read_rows", buckets="caller", witness="read_rows",
        note="plain torch: the gather behind every snapshot, scrape and demotion read",
    ),
    DispatchSpec(
        "merge_dense", _P + "ops.merge", "merge_dense", buckets="caller",
        witness_absent="no serving path runs it: checkpoint restore max-joins the "
        "planes in numpy and the mesh converges through its own kernel; its algebra "
        "is the dense_join model's (ops.merge.merge_dense prove root)",
    ),
)

# Witness path → the launches its second (warm) run makes on the card, by
# LAUNCHES key; every key not listed must stay at 0. On the CPU the same
# counts are the calls of each spec's ``attr`` (no kernel launches there).
WITNESS_LAUNCHES: Dict[str, Mapping[str, int]] = {
    "take": {"take_n": 8},
    "take_n": {"take_n": 1},
    "merge_packed": {"tick_join": 1},
    "merge_folded": {"pair_join": 1},
    "commit_blocks": {"pair_join": 1},
    "merge_rows_dense": {"row_join": 1},
    "merge_scalar": {"pair_join": 1},
    "zero_rows": {},
    "lifecycle_probe": {"lifecycle_probe": 1},
    "gcra": {"gcra_admit": 1},
    "conc": {"conc_admit": 1},
    "quota": {"quota_admit": 1},
    "delta_fold": {"pair_join": 1},
    "raw_ingest": {"decode_fold": 1},
    "read_rows": {},
    "mesh_step": {"pair_join": 1},
    "row_rmw": {"row_rmw": 1},
    "converge": {"mesh_gather": 1, "pair_join": 2, "take_n": 1, "converge": 1},
    # A take on a row of shard 0 over eight pieces (R = 2): the two
    # pieces that hold shard 0 gather and converge; every piece joins its
    # share of the padding merges; one take-n on the take's home block.
    "mesh_pieces": {"mesh_gather": 2, "pair_join": 8, "take_n": 1, "converge": 2},
    # Over the same eight pieces, on a row of every shard: one launch on
    # the gathered copy; the gather, the write-back and the zeroing are
    # copies and index ops, no kernel.
    "mesh_pieces_quota": {"quota_admit": 1},
    "mesh_pieces_read_rows": {},
    "mesh_pieces_zero_rows": {},
}

# Witness path → the declared waits (DECLARED_WAITS qualnames) its second
# run reaches on the card: the event waits torch's sync detector cannot
# see, counted by the witness where they happen. Every other declared
# wait must stay at 0 on that path, and a wait at no declared site is a
# finding. The commit timing's wait is there only while
# PATROL_DEVICE_TIMING is on (the default).
_TIMED = "DeviceEngine._observe_device_commit.done"
WITNESS_WAITS: Dict[str, Tuple[str, ...]] = {
    "take": ("DeviceEngine._apply_takes.complete",),
    "take_n": (),
    "merge_packed": (_TIMED,),
    "merge_folded": (),
    "commit_blocks": (),
    "merge_rows_dense": (),
    "merge_scalar": (_TIMED,),
    "zero_rows": (),  # its take re-creates the name as a host lane
    "lifecycle_probe": ("DeviceEngine._probe_device_rows",),
    "gcra": ("DeviceEngine._cert_call",),
    "conc": ("DeviceEngine._cert_call",),
    "quota": ("DeviceEngine._cert_call",),
    "delta_fold": (_TIMED,),
    "raw_ingest": (_TIMED,),
    "read_rows": ("DeviceEngine.read_rows",),
    "mesh_step": (_TIMED,),
    "row_rmw": (),
    "converge": ("MeshEngine._read_back.complete",),
    # One event a card (one card here: the pieces share it).
    "mesh_pieces": ("MeshEngine._read_back.complete",),
    "mesh_pieces_quota": ("DeviceEngine._cert_call",),
    "mesh_pieces_read_rows": ("DeviceEngine.read_rows",),
    "mesh_pieces_zero_rows": (),
}

# The engine's own readbacks: (file, function qualname, spelling) of each
# wait on the serve graph PTD003 accepts. Each is one event wait behind
# the launch it reads back, outside _state_mu, and invisible to torch's
# sync detector (an event's synchronize is not a stream sync).
DECLARED_WAITS: Tuple[Tuple[str, str, str, str], ...] = (
    ("patrol_tpu_torch/runtime/engine.py", "DeviceEngine._probe_device_rows",
     ".synchronize()", "the GC sweep's one probe readback"),
    ("patrol_tpu_torch/runtime/engine.py", "DeviceEngine.ingest_raw_planes._commit_plane",
     ".synchronize()", "the rx plane's copy, before the caller's plane is reused "
     "(on the completer)"),
    ("patrol_tpu_torch/runtime/engine.py", "DeviceEngine._absorb_raw_hosted",
     ".synchronize()", "the host-lane split's decoded fields, one readback"),
    ("patrol_tpu_torch/runtime/engine.py", "DeviceEngine._cert_call",
     ".synchronize()", "a family call's result matrix, one readback"),
    ("patrol_tpu_torch/runtime/engine.py", "DeviceEngine.read_rows",
     ".synchronize()", "the scrape/snapshot gather's readback"),
    ("patrol_tpu_torch/runtime/engine.py", "DeviceEngine._observe_device_commit.done",
     ".synchronize()", "the completer's commit timing"),
    ("patrol_tpu_torch/runtime/engine.py", "DeviceEngine._apply_takes.complete",
     ".synchronize()", "the completer's take results"),
    ("patrol_tpu_torch/runtime/mesh_engine.py", "MeshEngine._read_back.complete",
     ".synchronize()", "the mesh completer's take results, one event a card"),
)

# The reference's PTD001 (retrace risk) and PTD002 (donation) have no CUDA
# counterpart in the port; their absences, on record.
DISPATCH_ABSENT: Mapping[str, str] = {
    "PTD001": "no jit cache: every call launches the same hand-written kernel for "
    "any shape, so a raw size cannot compile a fresh variant; the pow2 bucket laws "
    "stay declared and PTD005 holds them to the engine's _pad_size sites",
    "PTD002": "nothing is donated: every kernel updates the state planes in place "
    "(ops/merge.py's contract), so there is no donated buffer to reuse after its "
    "dispatch",
}
