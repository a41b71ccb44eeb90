"""The port's kernel-family registry for its check stages (counterpart of
the JAX package's ``ops/obligations.py``, for the protocol, linearizability
and ABI stages).

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

Not here yet (the reference's stage 4, 9 and 10 records): the prove
roots' tracers and models, ``PROVE_EXEMPT``, the dispatch specs, and the
six prove-stage mutations; ``ROADMAP.md`` lists their CUDA analogues.
``absent`` keeps the reference's per-root justifications for the
obligation codes a root does not declare, for the roots the port has.

The flat ``LIN_SPECS`` / ``ABI_OBLIGATIONS`` tuples the stage drivers and
tests consume are DERIVED from the family records at the bottom of this
file — one source of truth.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

from patrol_tpu_torch.analysis.abi import AbiObligation
from patrol_tpu_torch.analysis.linearizability import LinSpecFamily
from patrol_tpu_torch.analysis.protocol import ConcLaws, GcraLaws, QuotaLaws

_P = "patrol_tpu_torch."


@dataclasses.dataclass(frozen=True)
class CertMutation:
    """One seeded mutation a family registers: a deliberately broken
    variant of the family's semantics that the checking stack MUST
    reject with ``expect`` (the exact PT code, pinned — a mutation that
    trips a *different* code means the check that was supposed to own
    this hazard has gone soft).

    ``stage`` selects the executor:

    * ``"protocol"`` with ``laws`` — a family-law payload; executed via
      ``protocol.FAMILY_CHECKS[target](laws=laws)``.
    * ``"protocol"`` without ``laws`` — a reference to a
      ``protocol.MUTATIONS`` entry named ``target``, executed through
      ``check_protocol``.
    * ``"lin"`` — a reference to a ``linearizability.LIN_MUTATIONS``
      entry named ``target``, executed by stage 8's ``check_repo``.
    """

    name: str
    stage: str  # "protocol" | "lin"
    target: str
    expect: str
    note: str = ""
    laws: Optional[object] = None  # stage="protocol" family-law payload


@dataclasses.dataclass(frozen=True)
class KernelFamily:
    """One certified lattice family.

    ``roots`` maps each kernel name the family owns to the port's
    (module, function). ``absent`` carries the justification strings for
    obligation codes a root deliberately does not declare, keyed
    ``"<root-name>:<code>"``. ``*_exempt`` fields carry justifications
    for a whole stage the family doesn't reach (empty string = not
    exempt, the stage is required)."""

    name: str
    domain: str  # the lattice, in one line
    roots: Mapping[str, Tuple[str, str]]
    absent: Mapping[str, str] = dataclasses.field(default_factory=dict)
    lin_specs: Tuple[LinSpecFamily, ...] = ()
    lin_exempt: str = ""
    protocol: Optional[str] = None  # protocol.FAMILY_CHECKS key
    protocol_exempt: str = ""
    abi: Tuple[AbiObligation, ...] = ()
    wire_codec: Optional[str] = None  # root name of the codec
    mutations: Tuple[CertMutation, ...] = ()
    mutations_exempt: str = ""
    note: str = ""


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
# The families.


KERNEL_FAMILIES: Tuple[KernelFamily, ...] = (
    KernelFamily(
        name="merge-join",
        domain="per-lane max join over the shared PN planes (the CvRDT "
        "merge every replication path reduces to)",
        roots={
            "ops.merge.merge_batch": (_P + "ops.merge", "merge_batch"),
            "ops.merge.merge_batch_folded": (_P + "ops.merge", "merge_batch_folded"),
            "ops.merge.merge_rows_dense": (_P + "ops.merge", "merge_rows_dense"),
            # The block ring's one join: the port's commit_packed is the
            # reference's commit_blocks over the packed staging matrix.
            "ops.commit.commit_blocks": (_P + "ops.commit", "commit_packed"),
            "ops.merge.merge_dense": (_P + "ops.merge", "merge_dense"),
            "parallel.topology.tree_reduce_states": (
                _P + "parallel.topology", "tree_reduce_states",
            ),
            "ops.merge.read_rows": (_P + "ops.merge", "read_rows"),
        },
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
        },
        lin_exempt=(
            "joins are the replication substrate the lin model itself "
            "applies between events; ops.take.take_batch's spec covers "
            "the admission-facing surface"
        ),
        protocol="bucket-full",
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
        roots={
            "ops.merge.merge_scalar_batch": (_P + "ops.merge", "merge_scalar_batch"),
        },
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
        mutations_exempt=(
            "documented-lossy family with a single monotone law; the "
            "scalar_monotone model's internal self-test already flips it"
        ),
    ),
    KernelFamily(
        name="bucket",
        domain="token bucket: greedy admission against the summed PN "
        "view, refill arithmetic in nanotokens",
        roots={
            "ops.take.take_batch": (_P + "ops.take", "take_batch"),
            "ops.take.take_n_batch": (_P + "ops.take", "take_n_batch"),
            "ops.take.split_grant": (_P + "ops.take", "split_grant"),
            "ops.rate": (_P + "ops.rate", "parse_rate"),
            "ops.wire.codec": (_P + "ops.wire", "encode"),
        },
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
        mutations=(
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
        roots={
            "ops.delta.delta_fold": (_P + "ops.delta", "delta_fold"),
            "ops.ingest.decode_fold_raw": (_P + "ops.ingest", "decode_fold_raw"),
            "ops.wire.delta_codec": (_P + "ops.wire", "encode_delta_packet"),
        },
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
        roots={
            "ops.lifecycle.lifecycle_probe": (_P + "ops.lifecycle", "lifecycle_probe"),
        },
        lin_specs=(
            LinSpecFamily(
                "ops.lifecycle.lifecycle_probe", _P + "ops.lifecycle",
                "lifecycle_probe", wire="full", lifecycle=True,
                note="lifecycle GC re-creation: IsZero reclaim with the "
                "tombstoned own lane, refills in the schedule alphabet",
            ),
        ),
        protocol="lifecycle-gc",
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
        roots={
            "ops.gcra.gcra_take_batch": (_P + "ops.gcra", "gcra_take_batch"),
            "ops.wire.gcra_trailer": (_P + "ops.wire", "encode_gcra_trailer"),
        },
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
        mutations=(
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
        roots={
            "ops.concurrency.conc_acquire_batch": (
                _P + "ops.concurrency", "conc_acquire_batch",
            ),
            "ops.wire.conc_trailer": (_P + "ops.wire", "encode_conc_trailer"),
        },
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
        mutations=(
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
        roots={
            "ops.hierquota.quota_take_batch": (
                _P + "ops.hierquota", "quota_take_batch",
            ),
            "ops.wire.quota_trailer": (_P + "ops.wire", "encode_quota_trailer"),
        },
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
        mutations=(
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
