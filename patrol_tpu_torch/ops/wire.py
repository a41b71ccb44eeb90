"""Wire codec: the reference's 25-byte-header / ≤256-byte UDP packet format.

Byte layout (bucket.go:34-91):

====  =====  =====================================================
off   size   field
====  =====  =====================================================
0     8      added, big-endian IEEE-754 float64 (tokens)
8     8      taken, big-endian IEEE-754 float64 (tokens)
16    8      elapsed, big-endian uint64 (nanoseconds, two's compl.)
24    1      name length L (≤ 231)
25    L      name bytes
====  =====  =====================================================

``created`` is deliberately NOT serialized (bucket.go:28-31): only relative
elapsed time crosses the wire, which is what makes the protocol clock-skew
independent (README.md:49-62).

This module adds a *backward-compatible* v2 extension: because the reference
decoder reads exactly ``data[25:25+L]`` and ignores any trailing bytes, we
may append a trailer carrying patrol_tpu metadata. Reference nodes
interoperate unchanged; patrol_tpu nodes use it to address the sender's
PN-counter lane. Four trailer forms (``flags`` bits select):

* base (6 B):     ``b"P2" | u8 flags=0 | u16 slot | u8 checksum``
* with-cap (14B): ``b"P2" | u8 flags=1 | u16 slot | u64 cap_nt | u8 checksum``
* lane (30 B):    ``b"P2" | u8 flags=3 | u16 slot | u64 cap_nt |``
  ``u64 lane_added_nt | u64 lane_taken_nt | u8 checksum``
* multi (15+18K): ``b"P2" | u8 flags=5 | u16 own_slot | u64 cap_nt | u8 K |``
  ``K × (u16 slot | u64 added_nt | u64 taken_nt) | u8 checksum``

(checksum = sum of the preceding trailer bytes mod 256, a guard against a
name that happens to end in "P2").

The **multi** form carries a whole bucket's non-zero PN lanes in ONE
packet — the compact incast reply (the reference answers an incast with
one packet, repo.go:86-90; per-lane replies would storm a cold-starting
node with up to N packets per hot bucket). Flag bit ``0x04`` doubles as a
*capability advert*: an incast REQUEST whose base trailer sets it tells
the receiver the requester can parse multi replies; receivers without the
bit get per-lane replies. Decoders that predate the multi form read its
flags (0x05) as the with-cap form, whose checksum byte lands on ``K`` —
a 255/256 rejection that degrades the packet to v1 aggregate handling
(capacity-subtracted deficit attribution: conservative, never inflating).

**Rolling-upgrade gate** (``wire_mode``, ADVICE r2): senders before the
dual-payload scheme put raw own-lane values in the float64 header with a
base trailer; receivers of that era merge whatever the header holds into
the sender's single lane. Sending them today's capacity-included AGGREGATE
header with a lane trailer they cannot parse would permanently inflate
their PN state (lanes are monotone). Both replication backends therefore
take ``wire_mode``:

* ``"aggregate"`` (default) — today's dual-payload form. Requires every
  patrol_tpu node in the cluster to be lane-trailer-capable (any build
  including the lane trailer): a FLAG-DAY upgrade from pre-lane-trailer
  builds. Mixed clusters with *reference* (v1) nodes are always fine —
  v1 nodes ignore trailers and expect exactly the aggregate header.
* ``"compat"`` — raw own-lane headers + base trailers, parseable by every
  patrol_tpu build ever shipped. Run the whole cluster in this mode while
  rolling out a lane-capable build, then flip to ``aggregate``. (v1
  reference peers see own-lane scalars in this mode — they under-count
  other nodes' takes until the flip, which is within the reference's own
  lossy-scalar-merge semantics.)

Mixed-cluster interop hinges on the **dual payload**: the float64 header
``added``/``taken`` carry the sender's *aggregate scalar view* of the bucket
(capacity-included, like the reference's ``bucket.added`` after lazy init,
bucket.go:194-196) — exactly the full-state scalars a reference node
max-merges — while the trailer carries the sender's *exact own-lane*
PN-counter values in int64 nanotokens for patrol_tpu receivers. Without the
aggregate header, a reference peer max-merging our lane-only ``taken``
against its global scalar would lose takes; without the lane trailer,
patrol_tpu peers would double-count echoed aggregates. ``cap_nt`` is the
sender's lazily-initialized capacity base, which receivers adopt for rows
whose capacity is still unknown.

The device state is int64 nanotokens; the wire is float64 tokens — this codec
is the conversion boundary. float64 represents integers exactly up to 2^53,
i.e. ~9.0e6 tokens at nanotoken resolution; beyond that the wire value is
rounded (observable semantics are preserved within float64's own precision,
which is all the reference ever had).

**Wire protocol v2: delta-interval datagrams** (Almeida et al.,
arXiv:1410.2803; ROADMAP item 3). The per-take full-state packet above
ships ONE bucket per ≤256-B datagram. The delta plane instead ships
*join-decompositions*: each entry is one bucket's absolute PN-lane values
(cap base, lane added/taken, elapsed) — absolute monotone values, so an
entry IS its own join-decomposition: delivering it twice, late, or out of
order is a no-op under the lattice max. Hundreds of entries pack into one
datagram under this framing:

====  ======  ====================================================
off   size    field
====  ======  ====================================================
0     24      zeros (v1 header: added=0, taken=0, elapsed=0)
24    1       L = len(DELTA_CHANNEL_NAME) (= 7)
25    L       ``\\x00pt!dv2`` — the reserved control-channel name
25+L  1       version (= 2)
+1    2       sender_slot (u16, the sender's PN lane)
+3    4       seq (u32 interval number; 0 = bare ack, no payload)
+7    1       K = ack-vector length (≤ 32)
+8    4×K     ack vector: interval seqs received from the DESTINATION
+..   2       N = entry count
+..   ...     N × entry: u8 name_len | name | u16 slot |
              u64 cap_nt | u64 added_nt | u64 taken_nt | u64 elapsed
last  1       checksum (sum of payload bytes mod 256)
====  ======  ====================================================

The first 25+L bytes make the datagram a *v1 zero-state packet for a
reserved name*: a reference node reads it as an incast request for a
bucket that cannot exist (the API rejects NUL-led names), misses, and
stays silent; pre-delta patrol builds dispatch it to the control channel
and ignore the unknown name. Both ignore the payload because every v1
decoder reads exactly ``data[25:25+L]`` — the same invisibility argument
as the P2 trailer. Validation is all-or-nothing (version, checksum,
entry bounds, bit-63 guards): a truncated or mangled delta datagram is
rejected whole, never partially merged. Senders ship deltas only to
peers that advertised the capability (and their receive size) on the
control channel — see net/delta.py.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple

NANO = 1_000_000_000

FIXED_SIZE = 25  # 8 + 8 + 8 + 1 (bucket.go:36)
PACKET_SIZE = 256  # no-fragmentation bound (bucket.go:38-41)
MAX_NAME_LENGTH = PACKET_SIZE - FIXED_SIZE - 30  # room for the lane trailer
MAX_NAME_LENGTH_V1 = PACKET_SIZE - FIXED_SIZE  # the reference's 231 (bucket.go:43-44)

_HEADER = struct.Struct(">ddQ")
# Trace-context trailer (patrol-scope cross-node take tracing): appended
# AFTER whichever P2 trailer form the packet carries. Every decoder in
# the fleet reads its trailer by self-described size and ignores trailing
# bytes (the reference reads exactly data[25:25+L]; the C++ batch decoder
# checks `tail_len >= tsz`), so the trace trailer is invisible to v1
# peers and to pre-trace patrol builds alike — compat-free by the same
# argument as the P2 trailer itself. Magic + checksum guard against a
# random tail parsing as a trace id. Best-effort: emitted only when the
# packet has room (and only for sampled takes), dropped silently
# otherwise.
_TRACE_TRAILER = struct.Struct(">2sQB")  # magic | u64 trace_id | checksum
_TRACE_MAGIC = b"PT"
TRACE_TRAILER_SIZE = _TRACE_TRAILER.size
_TRAILER = struct.Struct(">2sBHB")
_TRAILER_CAP = struct.Struct(">2sBHQB")
_TRAILER_LANE = struct.Struct(">2sBHQQQB")
_MULTI_HEAD = struct.Struct(">2sBHQB")  # magic|flags|own_slot|cap|K
_MULTI_LANE = struct.Struct(">HQQ")  # per-lane: slot|added_nt|taken_nt
_TRAILER_MAGIC = b"P2"
_FLAG_CAP = 0x01
_FLAG_LANE = 0x02
_FLAG_MULTI = 0x04
TRAILER_SIZE = _TRAILER.size
TRAILER_CAP_SIZE = _TRAILER_CAP.size
TRAILER_LANE_SIZE = _TRAILER_LANE.size


def multi_trailer_size(k: int) -> int:
    return _MULTI_HEAD.size + k * _MULTI_LANE.size + 1  # +1 checksum


def max_multi_lanes(name_len: int) -> int:
    """How many lanes fit in one multi packet for a given name length."""
    room = PACKET_SIZE - FIXED_SIZE - name_len - _MULTI_HEAD.size - 1
    return max(0, min(255, room // _MULTI_LANE.size))


class NameTooLargeError(ValueError):
    """Bucket name exceeds the wire limit (bucket.go:46-48)."""

    def __init__(self, limit: int = MAX_NAME_LENGTH_V1) -> None:
        super().__init__(f"bucket name larger than {limit}")


class ShortBufferError(ValueError):
    """Packet shorter than its self-described size (bucket.go:72-74,83-85)."""


@dataclasses.dataclass(frozen=True)
class WireState:
    """One bucket state as it crosses the wire."""

    name: str
    added: float  # tokens (float64, as on the wire): the sender's AGGREGATE
    # scalar view, capacity-included — what a reference node max-merges
    taken: float
    elapsed_ns: int  # signed int64 nanoseconds
    origin_slot: Optional[int] = None  # v2 trailer; None for v1 packets
    cap_nt: Optional[int] = None  # sender's capacity base (nanotokens);
    # None on v1 / base-trailer packets — the receiver then falls back to
    # scalar (reference) merge semantics for this delta
    lane_added_nt: Optional[int] = None  # exact own-lane PN values (grants-
    lane_taken_nt: Optional[int] = None  # only, nanotokens); lane trailer
    lanes: Optional[Tuple[Tuple[int, int, int], ...]] = None  # multi
    # trailer: ((slot, added_nt, taken_nt), …) — a whole bucket's non-zero
    # PN lanes in one packet (the compact incast reply)
    multi_ok: bool = False  # sender advertised multi-reply capability
    # (flag bit 0x04 on its trailer — set on incast requests)
    trace_id: Optional[int] = None  # patrol-scope trace context (sampled
    # takes only): propagates the sender's take span id so the receiver's
    # decode/merge spans join it (utils/trace.py)

    def is_zero(self) -> bool:
        """The incast-request marker (bucket.go:163-170, repo.go:78-90)."""
        return self.added == 0 and self.taken == 0 and self.elapsed_ns == 0

    @property
    def added_nt(self) -> int:
        return _sanitize_nt(self.added)

    @property
    def taken_nt(self) -> int:
        return _sanitize_nt(self.taken)


_INT64_MAX = (1 << 63) - 1


def _sanitize_nt(tokens: float) -> int:
    """float64 wire value → int64 nanotokens, hardened against hostile
    packets: NaN → 0, ±Inf / out-of-range clamp to the int64 edge, negatives
    clamp to 0 (device state is a non-negative G-counter pair). The float64
    reference absorbs such values silently (bucket.go:78-79); the int64
    device path must not crash on them."""
    if tokens != tokens:  # NaN
        return 0
    if tokens <= 0.0:
        return 0
    nt = tokens * NANO
    if nt >= _INT64_MAX:
        return _INT64_MAX
    return round(nt)


def sanitize_nt_array(tokens) -> "np.ndarray":
    """Vectorized :func:`_sanitize_nt` for the batch rx path: float64[n]
    wire tokens → int64[n] nanotokens with identical NaN/Inf/range/negative
    hardening (round-half-even like Python's round). Bit-identical to the
    scalar form on every input — native-rx and python-rx peers MUST merge
    the same packet to the same state or replicas diverge permanently."""
    import numpy as np

    t = np.asarray(tokens, dtype=np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        nt = t * NANO
        out = np.zeros(len(t), dtype=np.int64)
        # NaN fails both comparisons → stays 0, like the scalar form.
        edge = nt >= _INT64_MAX  # +Inf and overflowing products included
        mid = (nt > 0) & ~edge
        out[mid] = np.rint(nt[mid]).astype(np.int64)
        out[edge] = _INT64_MAX
    return out


def from_nanotokens(
    name: str,
    added_nt: int,
    taken_nt: int,
    elapsed_ns: int,
    origin_slot: Optional[int] = None,
    cap_nt: Optional[int] = None,
    lane_added_nt: Optional[int] = None,
    lane_taken_nt: Optional[int] = None,
    trace_id: Optional[int] = None,
) -> WireState:
    return WireState(
        name=name,
        added=added_nt / NANO,
        taken=taken_nt / NANO,
        elapsed_ns=elapsed_ns,
        origin_slot=origin_slot,
        cap_nt=cap_nt,
        lane_added_nt=lane_added_nt,
        lane_taken_nt=lane_taken_nt,
        trace_id=trace_id,
    )


def encode(state: WireState) -> bytes:
    """Serialize to the reference wire format (bucket.go:51-68), appending the
    v2 origin-slot trailer when ``origin_slot`` is set."""
    # surrogateescape: reference names are raw bytes (bucket.go:64-88);
    # non-UTF8 bytes must round-trip exactly or distinct buckets would
    # collapse into one and fork CRDT state across the cluster.
    name_bytes = state.name.encode("utf-8", errors="surrogateescape")
    with_multi = state.origin_slot is not None and state.cap_nt is not None and state.lanes
    with_cap = (
        not with_multi
        and state.origin_slot is not None
        and state.cap_nt is not None
    )
    with_lane = (
        with_cap
        and state.lane_added_nt is not None
        and state.lane_taken_nt is not None
    )
    if state.origin_slot is None:
        limit = MAX_NAME_LENGTH_V1
    elif with_multi:
        limit = PACKET_SIZE - FIXED_SIZE - multi_trailer_size(len(state.lanes))
    elif with_lane:
        limit = PACKET_SIZE - FIXED_SIZE - TRAILER_LANE_SIZE
    elif with_cap:
        limit = PACKET_SIZE - FIXED_SIZE - TRAILER_CAP_SIZE
    else:
        limit = PACKET_SIZE - FIXED_SIZE - TRAILER_SIZE
    if len(name_bytes) > limit:
        raise NameTooLargeError(limit)

    elapsed_u64 = state.elapsed_ns & 0xFFFFFFFFFFFFFFFF  # two's-complement wrap
    out = bytearray(_HEADER.pack(state.added, state.taken, elapsed_u64))
    out.append(len(name_bytes))
    out += name_bytes
    if state.origin_slot is not None:
        if with_multi:
            trailer = bytearray(
                _MULTI_HEAD.pack(
                    _TRAILER_MAGIC, _FLAG_CAP | _FLAG_MULTI, state.origin_slot,
                    state.cap_nt & 0xFFFFFFFFFFFFFFFF, len(state.lanes),
                )
            )
            for slot, a_nt, t_nt in state.lanes:
                trailer += _MULTI_LANE.pack(
                    slot, a_nt & 0xFFFFFFFFFFFFFFFF, t_nt & 0xFFFFFFFFFFFFFFFF
                )
            trailer.append(0)
        elif with_lane:
            trailer = bytearray(
                _TRAILER_LANE.pack(
                    _TRAILER_MAGIC, _FLAG_CAP | _FLAG_LANE, state.origin_slot,
                    state.cap_nt & 0xFFFFFFFFFFFFFFFF,
                    state.lane_added_nt & 0xFFFFFFFFFFFFFFFF,
                    state.lane_taken_nt & 0xFFFFFFFFFFFFFFFF, 0,
                )
            )
        elif with_cap:
            trailer = bytearray(
                _TRAILER_CAP.pack(
                    _TRAILER_MAGIC, _FLAG_CAP, state.origin_slot,
                    state.cap_nt & 0xFFFFFFFFFFFFFFFF, 0,
                )
            )
        else:
            # The MULTI bit on a base trailer is the capability advert
            # (incast requests): old decoders parse it as a plain base
            # trailer (their flag check masks only CAP|LANE).
            flags = _FLAG_MULTI if state.multi_ok else 0
            trailer = bytearray(
                _TRAILER.pack(_TRAILER_MAGIC, flags, state.origin_slot, 0)
            )
        trailer[-1] = sum(trailer[:-1]) & 0xFF
        out += trailer
        if (
            state.trace_id is not None
            and 0 < state.trace_id < 1 << 63
            and len(out) + TRACE_TRAILER_SIZE <= PACKET_SIZE
        ):
            tt = bytearray(
                _TRACE_TRAILER.pack(_TRACE_MAGIC, state.trace_id, 0)
            )
            tt[-1] = sum(tt[:-1]) & 0xFF
            out += tt
    assert len(out) <= PACKET_SIZE
    return bytes(out)


def decode(data: bytes) -> WireState:
    """Deserialize a packet (bucket.go:71-91), detecting the v2 trailer."""
    if len(data) < FIXED_SIZE:
        raise ShortBufferError("short buffer")

    added, taken, elapsed_u64 = _HEADER.unpack_from(data)
    name_len = data[24]
    if len(data) - FIXED_SIZE < name_len:
        raise ShortBufferError("short buffer")
    name = data[FIXED_SIZE : FIXED_SIZE + name_len].decode(
        "utf-8", errors="surrogateescape"
    )

    elapsed_ns = elapsed_u64 - (1 << 64) if elapsed_u64 >= 1 << 63 else elapsed_u64

    origin_slot: Optional[int] = None
    cap_nt: Optional[int] = None
    lane_added_nt: Optional[int] = None
    lane_taken_nt: Optional[int] = None
    lanes: Optional[Tuple[Tuple[int, int, int], ...]] = None
    multi_ok = False
    consumed = 0  # bytes of tail a VALID P2 trailer occupied (trace scan)
    tail = data[FIXED_SIZE + name_len :]
    if len(tail) >= TRAILER_SIZE and tail[:2] == _TRAILER_MAGIC:
        flags = tail[2]
        # Values are non-negative int64 nanotoken counts by contract; a
        # bit-63 value is a hostile packet. Validation is all-or-nothing:
        # a trailer with ANY invalid field is discarded whole (the packet
        # degrades to v1 — conservative deficit-attribution ingest), never
        # partially honored. A partially-honored lane trailer would merge
        # the header's AGGREGATE into the sender's single lane and
        # permanently inflate the PN sum (one crafted packet per bucket).
        if (
            flags & _FLAG_MULTI
            and flags & _FLAG_CAP
            and not flags & _FLAG_LANE
            and len(tail) >= _MULTI_HEAD.size + 1
        ):
            _m, _f, slot, cap_u64, k = _MULTI_HEAD.unpack_from(tail)
            tsz = multi_trailer_size(k)
            if len(tail) >= tsz and tail[tsz - 1] == sum(tail[: tsz - 1]) & 0xFF:
                vals = []
                good = cap_u64 < 1 << 63
                off = _MULTI_HEAD.size
                for _ in range(k):
                    ls, la, lt = _MULTI_LANE.unpack_from(tail, off)
                    off += _MULTI_LANE.size
                    good &= la < 1 << 63 and lt < 1 << 63
                    vals.append((ls, la, lt))
                if good:
                    origin_slot = slot
                    cap_nt = cap_u64
                    lanes = tuple(vals)
                    multi_ok = True
                    consumed = tsz
        elif flags & _FLAG_LANE and flags & _FLAG_CAP and len(tail) >= TRAILER_LANE_SIZE:
            _m, _f, slot, cap_u64, la_u64, lt_u64, ck = _TRAILER_LANE.unpack_from(tail)
            if (
                ck == sum(tail[: TRAILER_LANE_SIZE - 1]) & 0xFF
                and cap_u64 < 1 << 63
                and la_u64 < 1 << 63
                and lt_u64 < 1 << 63
            ):
                origin_slot = slot
                cap_nt = cap_u64
                lane_added_nt = la_u64
                lane_taken_nt = lt_u64
                consumed = TRAILER_LANE_SIZE
        elif flags & _FLAG_CAP and not flags & _FLAG_LANE and len(tail) >= TRAILER_CAP_SIZE:
            _magic, _flags, slot, cap_u64, checksum = _TRAILER_CAP.unpack_from(tail)
            if checksum == sum(tail[: TRAILER_CAP_SIZE - 1]) & 0xFF and cap_u64 < 1 << 63:
                origin_slot = slot
                cap_nt = cap_u64
                consumed = TRAILER_CAP_SIZE
        elif not flags & (_FLAG_CAP | _FLAG_LANE):
            _magic, _flags, slot, checksum = _TRAILER.unpack_from(tail)
            if checksum == sum(tail[: TRAILER_SIZE - 1]) & 0xFF:
                origin_slot = slot
                multi_ok = bool(flags & _FLAG_MULTI)  # capability advert
                consumed = TRAILER_SIZE

    trace_id: Optional[int] = None
    if consumed and len(tail) >= consumed + TRACE_TRAILER_SIZE:
        tt = tail[consumed : consumed + TRACE_TRAILER_SIZE]
        if tt[:2] == _TRACE_MAGIC and tt[-1] == sum(tt[:-1]) & 0xFF:
            tid = int.from_bytes(tt[2:10], "big")
            if 0 < tid < 1 << 63:
                trace_id = tid

    return WireState(
        name=name,
        added=added,
        taken=taken,
        elapsed_ns=elapsed_ns,
        origin_slot=origin_slot,
        cap_nt=cap_nt,
        lane_added_nt=lane_added_nt,
        lane_taken_nt=lane_taken_nt,
        lanes=lanes,
        multi_ok=multi_ok,
        trace_id=trace_id,
    )


def pack_multi(states: Sequence[WireState]) -> List[WireState]:
    """Pack per-lane snapshot states of ONE bucket into as few multi
    packets as fit (the compact incast reply, repo.go:86-90: the reference
    answers with one packet; per-lane replies would send up to N). Falls
    back to the input unchanged when the states lack lane/cap data or only
    one lane exists (the 30 B lane trailer is smaller than a 33 B 1-lane
    multi). Every packet repeats the full aggregate header — idempotent
    under the reference's scalar max-merge, like the per-lane form.

    Amplification bound: the reply to one incast request is EXACTLY
    ⌈non-zero lanes / max_multi_lanes(len(name))⌉ packets — ~12 lanes per
    packet at short names, so a flagship-shape 256-lane bucket answers in
    ~22 packets where the per-lane form would send 256 (the reference
    sends 1, but carries one scalar pair where we carry every PN lane).
    Responder-side pacing on top of this bound lives in
    net/replication.py ``ReplyGate``: one burst per (bucket, requester)
    per TTL, so a cold-start storm's reply traffic is bounded by
    distinct-requesters × ⌈lanes/per-packet⌉ per TTL window, regardless
    of request rate."""
    if len(states) <= 1:
        return list(states)
    first = states[0]
    if first.cap_nt is None or any(
        s.lane_added_nt is None or s.lane_taken_nt is None or s.origin_slot is None
        for s in states
    ):
        return list(states)
    per_packet = max_multi_lanes(
        len(first.name.encode("utf-8", errors="surrogateescape"))
    )
    if per_packet < 2:
        return list(states)
    out: List[WireState] = []
    for lo in range(0, len(states), per_packet):
        chunk = states[lo : lo + per_packet]
        out.append(
            dataclasses.replace(
                first,
                lanes=tuple(
                    (s.origin_slot, s.lane_added_nt, s.lane_taken_nt) for s in chunk
                ),
            )
        )
    return out


# ---------------------------------------------------------------------------
# Wire protocol v2: delta-interval datagrams (framing in the module docs).

# Rides the reserved control-channel namespace (net/replication.CTRL_PREFIX):
# no legal bucket name starts with NUL, so v1 peers read a delta datagram as
# an incast request for an impossible bucket and stay silent.
DELTA_CHANNEL_NAME = "\x00pt!dv2"
_DELTA_NAME_BYTES = DELTA_CHANNEL_NAME.encode()
_DELTA_BASE = FIXED_SIZE + len(_DELTA_NAME_BYTES)  # payload offset (32)
# Default delta datagram bound. Deliberately larger than the v1 PACKET_SIZE:
# the 256-B bound exists so per-take datagrams never fragment; the delta
# plane is paced and batched, and datacenter paths (and loopback) carry
# multi-KB UDP fine. Each peer advertises its own receive bound on the
# control channel (the native recvmmsg backend can only take PACKET_SIZE),
# and senders pack to min(own tx bound, peer's advertised rx bound).
DELTA_PACKET_SIZE = 8192
DELTA_VERSION = 2
DELTA_MAX_ACKS = 32  # ack-vector entries per datagram
_DELTA_HEAD = struct.Struct(">BHIB")  # version | sender_slot | seq | n_acks
_DELTA_ACK = struct.Struct(">I")
_DELTA_COUNT = struct.Struct(">H")
_DELTA_ENTRY = struct.Struct(">HQQQQ")  # slot | cap | added | taken | elapsed


@dataclasses.dataclass(frozen=True)
class DeltaEntry:
    """One bucket's join-decomposition: the ABSOLUTE values of one PN lane
    (plus cap base and the elapsed G-counter). Monotone, so shipping the
    current value subsumes every earlier interval — retransmits re-read
    state instead of replaying history."""

    name: str
    slot: int
    cap_nt: int
    added_nt: int
    taken_nt: int
    elapsed_ns: int


@dataclasses.dataclass(frozen=True)
class DeltaPacket:
    sender_slot: int
    seq: int  # 0 = bare ack (no payload interval)
    acks: Tuple[int, ...]  # interval seqs received from the destination
    entries: Tuple[DeltaEntry, ...]


def delta_entry_size(name: str) -> int:
    return 1 + len(name.encode("utf-8", errors="surrogateescape")) + _DELTA_ENTRY.size


def delta_capacity(max_size: int, name_len: int) -> int:
    """How many entries of a given name length fit one delta datagram."""
    room = max_size - _DELTA_BASE - _DELTA_HEAD.size - _DELTA_COUNT.size - 1
    return max(0, room // (1 + name_len + _DELTA_ENTRY.size))


def encode_delta_packet(
    sender_slot: int,
    seq: int,
    acks: Sequence[int],
    entries: Sequence[DeltaEntry],
    max_size: int = DELTA_PACKET_SIZE,
) -> Tuple[bytes, int]:
    """Pack ``acks`` (≤ 32 kept) and as many ``entries`` as fit under
    ``max_size`` → (datagram, number of entries packed). The caller loops
    with fresh seqs for the remainder. ``seq=0`` with no entries is a bare
    ack. Values are clamped non-negative (the bit-63 decode guard is the
    receiving side's contract)."""
    envelope = bytearray(_DELTA_BASE)
    envelope[24] = len(_DELTA_NAME_BYTES)
    envelope[FIXED_SIZE:] = _DELTA_NAME_BYTES
    acks = list(acks)[:DELTA_MAX_ACKS]
    body = bytearray(
        _DELTA_HEAD.pack(
            DELTA_VERSION, sender_slot & 0xFFFF, seq & 0xFFFFFFFF, len(acks)
        )
    )
    for a in acks:
        body += _DELTA_ACK.pack(a & 0xFFFFFFFF)
    count_off = len(body)
    body += _DELTA_COUNT.pack(0)
    budget = max_size - _DELTA_BASE - len(body) - 1  # −1 checksum
    packed = 0
    for e in entries:
        nb = e.name.encode("utf-8", errors="surrogateescape")
        if len(nb) > 255:
            raise NameTooLargeError(255)
        sz = 1 + len(nb) + _DELTA_ENTRY.size
        if sz > budget or packed >= 0xFFFF:
            break
        body.append(len(nb))
        body += nb
        body += _DELTA_ENTRY.pack(
            e.slot & 0xFFFF,
            min(max(e.cap_nt, 0), _INT64_MAX),
            min(max(e.added_nt, 0), _INT64_MAX),
            min(max(e.taken_nt, 0), _INT64_MAX),
            min(max(e.elapsed_ns, 0), _INT64_MAX),
        )
        budget -= sz
        packed += 1
    _DELTA_COUNT.pack_into(body, count_off, packed)
    body.append(sum(body) & 0xFF)
    return bytes(envelope) + bytes(body), packed


def decode_delta_packet(data: bytes) -> Optional[DeltaPacket]:
    """Strict all-or-nothing decode of a v2 delta datagram; ``None`` for
    anything malformed (wrong envelope, bad version/checksum, truncated or
    overlong body, out-of-range values) — a hostile or corrupted datagram
    must never be partially merged."""
    end = len(data) - 1
    if end < _DELTA_BASE + _DELTA_HEAD.size + _DELTA_COUNT.size:
        return None
    if (
        data[:24] != b"\x00" * 24
        or data[24] != len(_DELTA_NAME_BYTES)
        or data[FIXED_SIZE:_DELTA_BASE] != _DELTA_NAME_BYTES
    ):
        return None
    if data[end] != sum(data[_DELTA_BASE:end]) & 0xFF:
        return None
    version, sender_slot, seq, n_acks = _DELTA_HEAD.unpack_from(data, _DELTA_BASE)
    if version != DELTA_VERSION or n_acks > DELTA_MAX_ACKS:
        return None
    off = _DELTA_BASE + _DELTA_HEAD.size
    if off + n_acks * _DELTA_ACK.size + _DELTA_COUNT.size > end:
        return None
    acks = tuple(
        _DELTA_ACK.unpack_from(data, off + i * _DELTA_ACK.size)[0]
        for i in range(n_acks)
    )
    off += n_acks * _DELTA_ACK.size
    (count,) = _DELTA_COUNT.unpack_from(data, off)
    off += _DELTA_COUNT.size
    entries = []
    for _ in range(count):
        if off >= end:
            return None
        name_len = data[off]
        off += 1
        if off + name_len + _DELTA_ENTRY.size > end:
            return None
        name = data[off : off + name_len].decode("utf-8", errors="surrogateescape")
        off += name_len
        slot, cap, added, taken, elapsed = _DELTA_ENTRY.unpack_from(data, off)
        off += _DELTA_ENTRY.size
        if max(cap, added, taken, elapsed) > _INT64_MAX:
            return None
        entries.append(DeltaEntry(name, slot, cap, added, taken, elapsed))
    if off != end:
        return None  # trailing garbage ⇒ reject whole, like the P2 trailers
    return DeltaPacket(sender_slot, seq, acks, tuple(entries))


def is_delta_packet(data: bytes) -> bool:
    """Cheap envelope test — routes rx traffic to the delta decoder before
    the generic control-channel dispatch."""
    return (
        len(data) > _DELTA_BASE
        and data[24] == len(_DELTA_NAME_BYTES)
        and data[FIXED_SIZE:_DELTA_BASE] == _DELTA_NAME_BYTES
        and data[:24] == b"\x00" * 24
    )


# ---------------------------------------------------------------------------
# patrol-fleet: metrics-lattice gossip datagrams (``\x00pt!mtr``).
#
# The histograms in utils/histogram.py are G-Counter lattices (per-node
# monotone lanes, join = per-lane-per-bucket max) and the profiling
# counters are monotone scalars — so cluster-wide aggregation is exactly
# the delta-mutation move of Almeida et al. (arXiv:1410.2803): ship
# join-decompositions of the CURRENT lattice state, pairwise, on a paced
# cadence, and let receivers max-join. Dup/reorder/stale delivery are
# no-ops by construction; a dropped packet is subsumed by the next flush.
#
# Envelope: identical invisibility argument as the dv2 delta channel —
# the first 25+L bytes form a v1 zero-state packet for a reserved name a
# real bucket can never have, so reference peers read an incast request
# for an unknown bucket and stay silent, and pre-fleet patrol builds
# dispatch it to the control channel and ignore the unknown name.
#
# Payload (after the 32-byte envelope, all big-endian):
#
#   u8  version (= 1)
#   u16 sender_slot
#   u8  K  | K × (u16 slot | u8 len | name)          node-name map
#   u16 Nc | Nc × (u8 len | name | u16 slot | u64 value)   counter lanes
#   u16 Nh | Nh × (u8 len | name | u8 ulen | unit | u16 slot |
#                  u64 sum | u8 B | B × (u8 bucket | u64 count))
#   u8  checksum (sum of payload bytes mod 256)
#
# A histogram-lane entry may carry ANY SUBSET of its buckets: each
# (histogram, lane, bucket) count is itself a join-decomposition under
# the per-bucket max, so a lane too large for one datagram splits across
# several and the receiver's joins reassemble it exactly. Validation is
# all-or-nothing, like the dv2 framing.

METRICS_CHANNEL_NAME = "\x00pt!mtr"
_METRICS_NAME_BYTES = METRICS_CHANNEL_NAME.encode()
_METRICS_BASE = FIXED_SIZE + len(_METRICS_NAME_BYTES)  # payload offset (32)
METRICS_VERSION = 1
_MTR_HEAD = struct.Struct(">BH")  # version | sender_slot
_MTR_U16 = struct.Struct(">H")
_MTR_LANE_VAL = struct.Struct(">HQ")  # slot | u64 value
_MTR_BUCKET = struct.Struct(">BQ")  # bucket index | u64 count


@dataclasses.dataclass(frozen=True)
class MetricsLane:
    """One histogram lane's join-decomposition: the ABSOLUTE monotone
    bucket counts (possibly a subset) plus the lane's value sum."""

    name: str
    unit: str
    slot: int
    sum: int
    buckets: Tuple[Tuple[int, int], ...]  # ((bucket_index, count), ...)


@dataclasses.dataclass(frozen=True)
class MetricsPacket:
    sender_slot: int
    node_names: Tuple[Tuple[int, str], ...]
    counters: Tuple[Tuple[str, int, int], ...]  # (name, slot, value)
    hists: Tuple[MetricsLane, ...]


def _mtr_envelope() -> bytearray:
    env = bytearray(_METRICS_BASE)
    env[24] = len(_METRICS_NAME_BYTES)
    env[FIXED_SIZE:] = _METRICS_NAME_BYTES
    return env


def metrics_lane_size(name: str, unit: str, n_buckets: int) -> int:
    """Encoded size of one histogram-lane entry carrying n_buckets."""
    return (
        1 + len(name.encode("utf-8", "surrogateescape"))
        + 1 + len(unit.encode())
        + _MTR_LANE_VAL.size + 1 + n_buckets * _MTR_BUCKET.size
    )


def encode_metrics_packets(
    sender_slot: int,
    node_names: Sequence[Tuple[int, str]],
    counters: Sequence[Tuple[str, int, int]],
    hists: Sequence[MetricsLane],
    max_size: int = DELTA_PACKET_SIZE,
) -> List[bytes]:
    """Pack the metric lattice's join-decompositions into as many
    ``\\x00pt!mtr`` datagrams as fit under ``max_size``. Histogram lanes
    whose buckets overflow the packet split across packets (per-bucket
    counts are independent join-decompositions); an entry that cannot fit
    even in an otherwise-empty packet is dropped (never truncated into an
    undecodable tail). The node-name map rides every packet."""
    out: List[bytes] = []
    name_map = []
    for slot, nm in node_names:
        raw = nm.encode("utf-8", "surrogateescape")[:64]
        name_map.append((slot & 0xFFFF, raw))
    name_map = name_map[:255]
    map_bytes = bytearray([len(name_map)])
    for slot, raw in name_map:
        map_bytes += _MTR_U16.pack(slot)
        map_bytes.append(len(raw))
        map_bytes += raw
    head_cost = (
        _METRICS_BASE + _MTR_HEAD.size + len(map_bytes)
        + 2 * _MTR_U16.size + 1  # the two section counts + checksum
    )
    budget0 = max_size - head_cost
    if budget0 <= 0:
        raise ValueError(f"metrics packet head exceeds max_size {max_size}")

    c_todo = list(counters)
    h_todo = [
        (lane, list(lane.buckets)) for lane in hists
    ]  # (lane, remaining buckets)
    while c_todo or h_todo:
        budget = budget0
        c_now: List[Tuple[bytes, int, int]] = []
        while c_todo:
            nm, slot, val = c_todo[0]
            raw = nm.encode("utf-8", "surrogateescape")
            sz = 1 + len(raw) + _MTR_LANE_VAL.size
            if sz > budget:
                if not c_now and sz > budget0:
                    c_todo.pop(0)  # undeliverable at this MTU: drop whole
                    continue
                break
            c_todo.pop(0)
            c_now.append((raw, slot, val))
            budget -= sz
        h_now: List[Tuple[MetricsLane, bytes, bytes, List[Tuple[int, int]]]] = []
        while h_todo and len(h_now) < 0xFFFF:
            lane, rem = h_todo[0]
            raw = lane.name.encode("utf-8", "surrogateescape")
            uraw = lane.unit.encode()
            head = 1 + len(raw) + 1 + len(uraw) + _MTR_LANE_VAL.size + 1
            if head > budget0:
                h_todo.pop(0)  # name/unit can never fit: drop whole
                continue
            if head + _MTR_BUCKET.size > budget and rem:
                if head + _MTR_BUCKET.size > budget0:
                    h_todo.pop(0)  # never fits with even one bucket: drop
                    continue
                break  # not even one bucket fits this packet
            fit = min(
                len(rem),
                max(0, (budget - head) // _MTR_BUCKET.size),
                255,
            )
            if head > budget:
                break
            take_b, rest = rem[:fit], rem[fit:]
            h_now.append((lane, raw, uraw, take_b))
            budget -= head + len(take_b) * _MTR_BUCKET.size
            if rest:
                h_todo[0] = (lane, rest)
                break  # packet is full (or nearly): ship it
            h_todo.pop(0)
        if not c_now and not h_now:
            break  # nothing fit (all undeliverable): stop, never spin
        body = bytearray(
            _MTR_HEAD.pack(METRICS_VERSION, sender_slot & 0xFFFF)
        )
        body += map_bytes
        body += _MTR_U16.pack(len(c_now))
        for raw, slot, val in c_now:
            body.append(len(raw))
            body += raw
            body += _MTR_LANE_VAL.pack(
                slot & 0xFFFF, min(max(val, 0), _INT64_MAX)
            )
        body += _MTR_U16.pack(len(h_now))
        for lane, raw, uraw, buckets in h_now:
            body.append(len(raw))
            body += raw
            body.append(len(uraw))
            body += uraw
            body += _MTR_LANE_VAL.pack(
                lane.slot & 0xFFFF, min(max(lane.sum, 0), _INT64_MAX)
            )
            body.append(len(buckets))
            for b, c in buckets:
                body += _MTR_BUCKET.pack(b & 0xFF, min(max(c, 0), _INT64_MAX))
        body.append(sum(body) & 0xFF)
        out.append(bytes(_mtr_envelope()) + bytes(body))
    return out


def decode_metrics_packet(data: bytes) -> Optional[MetricsPacket]:
    """Strict all-or-nothing decode of a metrics-gossip datagram; ``None``
    for anything malformed — a corrupted lattice delta must never be
    partially joined."""
    end = len(data) - 1
    if end < _METRICS_BASE + _MTR_HEAD.size + 1 + 2 * _MTR_U16.size:
        return None
    if (
        data[:24] != b"\x00" * 24
        or data[24] != len(_METRICS_NAME_BYTES)
        or data[FIXED_SIZE:_METRICS_BASE] != _METRICS_NAME_BYTES
    ):
        return None
    if data[end] != sum(data[_METRICS_BASE:end]) & 0xFF:
        return None
    version, sender_slot = _MTR_HEAD.unpack_from(data, _METRICS_BASE)
    if version != METRICS_VERSION:
        return None
    off = _METRICS_BASE + _MTR_HEAD.size
    try:
        k = data[off]
        off += 1
        names = []
        for _ in range(k):
            (slot,) = _MTR_U16.unpack_from(data, off)
            off += _MTR_U16.size
            ln = data[off]
            off += 1
            if off + ln > end:
                return None
            names.append(
                (slot, data[off : off + ln].decode("utf-8", "surrogateescape"))
            )
            off += ln
        (nc,) = _MTR_U16.unpack_from(data, off)
        off += _MTR_U16.size
        counters = []
        for _ in range(nc):
            ln = data[off]
            off += 1
            if off + ln + _MTR_LANE_VAL.size > end:
                return None
            nm = data[off : off + ln].decode("utf-8", "surrogateescape")
            off += ln
            slot, val = _MTR_LANE_VAL.unpack_from(data, off)
            off += _MTR_LANE_VAL.size
            if val > _INT64_MAX:
                return None
            counters.append((nm, slot, val))
        (nh,) = _MTR_U16.unpack_from(data, off)
        off += _MTR_U16.size
        hists = []
        for _ in range(nh):
            ln = data[off]
            off += 1
            if off + ln + 1 > end:
                return None
            nm = data[off : off + ln].decode("utf-8", "surrogateescape")
            off += ln
            ul = data[off]
            off += 1
            if off + ul + _MTR_LANE_VAL.size + 1 > end:
                return None
            unit = data[off : off + ul].decode("utf-8", "surrogateescape")
            off += ul
            slot, total = _MTR_LANE_VAL.unpack_from(data, off)
            off += _MTR_LANE_VAL.size
            nb = data[off]
            off += 1
            if off + nb * _MTR_BUCKET.size > end or total > _INT64_MAX:
                return None
            buckets = []
            for _ in range(nb):
                b, c = _MTR_BUCKET.unpack_from(data, off)
                off += _MTR_BUCKET.size
                if c > _INT64_MAX:
                    return None
                buckets.append((b, c))
            hists.append(MetricsLane(nm, unit, slot, total, tuple(buckets)))
    except (IndexError, struct.error):
        return None
    if off != end:
        return None  # trailing garbage ⇒ reject whole
    return MetricsPacket(sender_slot, tuple(names), tuple(counters), tuple(hists))


# ---------------------------------------------------------------------------
# patrol-audit: consistency-audit datagrams (``\x00pt!adt``).
#
# The third observability plane (net/audit.py) measures how consistent the
# cluster actually IS: read-only divergence digests (no resync — that is
# anti-entropy's job) and the windowed admitted-token G-counter lanes the
# AP-overshoot auditor joins cluster-wide. Same envelope invisibility
# argument as ``dv2``/``mtr``: the first 25+L bytes form a v1 zero-state
# packet for a reserved name no real bucket can carry, so reference peers
# read an incast request for an unknown bucket and stay silent, and
# pre-audit patrol builds dispatch it to the control channel and ignore
# the unknown name.
#
# Payload (after the 32-byte envelope, all big-endian):
#
#   u8  version (= 1)
#   u16 sender_slot
#   u16 Nd | Nd × (u64 name_hash | u64 state_digest)     divergence digests
#   u8  Nw | Nw × window:
#         u64 window_id | u16 sides | u8 closed | u64 duration_ns
#         u16 Na | Na × (u8 len | name | u16 slot |
#                        u64 admitted_nt | u64 limit_nt)
#   u8  checksum (sum of payload bytes mod 256)
#
# Every admitted-lane entry is an ABSOLUTE monotone own-lane value for
# (window, bucket, lane) — its own join-decomposition, so dup/reorder/
# stale delivery max-join to a no-op, and a window's lanes may split
# across any number of datagrams (the window header repeats). Validation
# is all-or-nothing, like the dv2/mtr framings.

AUDIT_CHANNEL_NAME = "\x00pt!adt"
_AUDIT_NAME_BYTES = AUDIT_CHANNEL_NAME.encode()
_AUDIT_BASE = FIXED_SIZE + len(_AUDIT_NAME_BYTES)  # payload offset (32)
AUDIT_VERSION = 1
_ADT_HEAD = struct.Struct(">BH")  # version | sender_slot
_ADT_U16 = struct.Struct(">H")
_ADT_DIGEST = struct.Struct(">QQ")  # name_hash | state_digest
_ADT_WIN_HEAD = struct.Struct(">QHBQ")  # window_id | sides | closed | dur
_ADT_LANE_TAIL = struct.Struct(">HQQ")  # slot | admitted_nt | limit_nt


@dataclasses.dataclass(frozen=True)
class AuditLane:
    """One (bucket, node-lane) of an audit window's admitted-token
    G-counter: the ABSOLUTE cumulative nanotokens that lane admitted
    inside the window, plus the sender's view of the window limit."""

    name: str
    slot: int
    admitted_nt: int
    limit_nt: int


@dataclasses.dataclass(frozen=True)
class AuditWindow:
    window_id: int
    sides: int  # sender's partition-sides estimate for the window (max-joined)
    closed: bool  # the sender's ledger has closed this window locally
    duration_ns: int  # observed window span (refill term of the limit)
    lanes: Tuple[AuditLane, ...]


@dataclasses.dataclass(frozen=True)
class AuditPacket:
    sender_slot: int
    digests: Tuple[Tuple[int, int], ...]  # (name_hash, state_digest)
    windows: Tuple[AuditWindow, ...]


def _adt_envelope() -> bytearray:
    env = bytearray(_AUDIT_BASE)
    env[24] = len(_AUDIT_NAME_BYTES)
    env[FIXED_SIZE:] = _AUDIT_NAME_BYTES
    return env


def audit_lane_size(name: str) -> int:
    return 1 + len(name.encode("utf-8", "surrogateescape")) + _ADT_LANE_TAIL.size


def encode_audit_packets(
    sender_slot: int,
    digests: Sequence[Tuple[int, int]],
    windows: Sequence[AuditWindow],
    max_size: int = DELTA_PACKET_SIZE,
) -> List[bytes]:
    """Pack the audit exchange into as many ``\\x00pt!adt`` datagrams as
    fit under ``max_size``. Digest entries and window lanes both split
    freely across packets (each is an independent join-decomposition; the
    window header repeats per packet). A lane whose name cannot fit even
    an otherwise-empty packet is dropped whole, never truncated."""
    out: List[bytes] = []
    head_cost = _AUDIT_BASE + _ADT_HEAD.size + _ADT_U16.size + 1 + 1  # +checksum
    budget0 = max_size - head_cost
    if budget0 <= 0:
        raise ValueError(f"audit packet head exceeds max_size {max_size}")
    d_todo = list(digests)
    w_todo: List[Tuple[AuditWindow, List[AuditLane]]] = [
        (w, list(w.lanes)) for w in windows
    ]
    # Header-only windows (no lanes) still ship once: they carry the
    # sides estimate and the closed flag.
    while d_todo or w_todo:
        budget = budget0
        d_now: List[Tuple[int, int]] = []
        while d_todo and _ADT_DIGEST.size <= budget and len(d_now) < 0xFFFF:
            d_now.append(d_todo.pop(0))
            budget -= _ADT_DIGEST.size
        w_now: List[Tuple[AuditWindow, List[AuditLane]]] = []
        while w_todo and len(w_now) < 0xFF:
            win, rem = w_todo[0]
            head = _ADT_WIN_HEAD.size + _ADT_U16.size
            if head > budget:
                break
            lanes_fit: List[AuditLane] = []
            b = budget - head
            while rem:
                sz = audit_lane_size(rem[0].name)
                if sz > budget0 - head:
                    rem.pop(0)  # undeliverable at this MTU: drop whole
                    continue
                if sz > b or len(lanes_fit) >= 0xFFFF:
                    break
                lanes_fit.append(rem.pop(0))
                b -= sz
            if rem and not lanes_fit:
                break  # not even one lane fits this packet: next packet
            w_now.append(
                (dataclasses.replace(win, lanes=tuple(lanes_fit)), rem)
            )
            budget = b
            if rem:
                w_todo[0] = (win, rem)
                break  # packet is full: ship it
            w_todo.pop(0)
        if not d_now and not w_now:
            break  # nothing fit (all undeliverable): stop, never spin
        body = bytearray(_ADT_HEAD.pack(AUDIT_VERSION, sender_slot & 0xFFFF))
        body += _ADT_U16.pack(len(d_now))
        for h, d in d_now:
            body += _ADT_DIGEST.pack(
                h & 0xFFFFFFFFFFFFFFFF, d & 0xFFFFFFFFFFFFFFFF
            )
        body.append(len(w_now))
        for win, _rem in w_now:
            body += _ADT_WIN_HEAD.pack(
                win.window_id & 0xFFFFFFFFFFFFFFFF,
                min(max(win.sides, 0), 0xFFFF),
                1 if win.closed else 0,
                min(max(win.duration_ns, 0), _INT64_MAX),
            )
            body += _ADT_U16.pack(len(win.lanes))
            for lane in win.lanes:
                raw = lane.name.encode("utf-8", "surrogateescape")
                body.append(len(raw))
                body += raw
                body += _ADT_LANE_TAIL.pack(
                    lane.slot & 0xFFFF,
                    min(max(lane.admitted_nt, 0), _INT64_MAX),
                    min(max(lane.limit_nt, 0), _INT64_MAX),
                )
        body.append(sum(body) & 0xFF)
        out.append(bytes(_adt_envelope()) + bytes(body))
    return out


def decode_audit_packet(data: bytes) -> Optional[AuditPacket]:
    """Strict all-or-nothing decode of an audit datagram; ``None`` for
    anything malformed — a corrupted audit frame must never be partially
    joined (a torn admitted lane would inflate the measured overshoot)."""
    end = len(data) - 1
    if end < _AUDIT_BASE + _ADT_HEAD.size + _ADT_U16.size + 1:
        return None
    if (
        data[:24] != b"\x00" * 24
        or data[24] != len(_AUDIT_NAME_BYTES)
        or data[FIXED_SIZE:_AUDIT_BASE] != _AUDIT_NAME_BYTES
    ):
        return None
    if data[end] != sum(data[_AUDIT_BASE:end]) & 0xFF:
        return None
    version, sender_slot = _ADT_HEAD.unpack_from(data, _AUDIT_BASE)
    if version != AUDIT_VERSION:
        return None
    off = _AUDIT_BASE + _ADT_HEAD.size
    try:
        (nd,) = _ADT_U16.unpack_from(data, off)
        off += _ADT_U16.size
        if off + nd * _ADT_DIGEST.size > end:
            return None
        digests = tuple(
            _ADT_DIGEST.unpack_from(data, off + i * _ADT_DIGEST.size)
            for i in range(nd)
        )
        off += nd * _ADT_DIGEST.size
        nw = data[off]
        off += 1
        windows = []
        for _ in range(nw):
            if off + _ADT_WIN_HEAD.size + _ADT_U16.size > end:
                return None
            wid, sides, closed, dur = _ADT_WIN_HEAD.unpack_from(data, off)
            off += _ADT_WIN_HEAD.size
            if closed > 1 or dur > _INT64_MAX:
                return None
            (na,) = _ADT_U16.unpack_from(data, off)
            off += _ADT_U16.size
            lanes = []
            for _ in range(na):
                if off >= end:
                    return None
                ln = data[off]
                off += 1
                if off + ln + _ADT_LANE_TAIL.size > end:
                    return None
                nm = data[off : off + ln].decode("utf-8", "surrogateescape")
                off += ln
                slot, adm, lim = _ADT_LANE_TAIL.unpack_from(data, off)
                off += _ADT_LANE_TAIL.size
                if adm > _INT64_MAX or lim > _INT64_MAX:
                    return None
                lanes.append(AuditLane(nm, slot, adm, lim))
            windows.append(
                AuditWindow(wid, sides, bool(closed), dur, tuple(lanes))
            )
    except (IndexError, struct.error):
        return None
    if off != end:
        return None  # trailing garbage ⇒ reject whole
    return AuditPacket(sender_slot, digests, tuple(windows))


# ---------------------------------------------------------------------------
# Membership channel (``\x00pt!mbr``) — elastic-membership events
# (net/membership.py, ROADMAP 3b). Same envelope trick as dv2/mtr/adt:
# a v1 zero-state packet whose reserved name no bucket can have, with the
# real payload after the name — invisible to reference peers. One event
# per datagram, bounded well under the v1 PACKET_SIZE so the native
# recvmmsg backend (fixed 256-B slots) receives it unconditionally.
# Events are idempotent facts about the lane-lifecycle lattice (join /
# leave-tombstone / rejoin-handshake), so loss and duplication are both
# safe: a re-announce is a no-op, a lost announce is repaired the next
# time the sender emits (or at the admin's retry). Validation is
# all-or-nothing like the other framings — a torn membership event must
# never half-apply (a lane adoption without its epoch would be exactly
# the lane-reuse bug the tombstone rule forbids).

MEMBER_CHANNEL_NAME = "\x00pt!mbr"
_MEMBER_NAME_BYTES = MEMBER_CHANNEL_NAME.encode()
_MEMBER_BASE = FIXED_SIZE + len(_MEMBER_NAME_BYTES)  # payload offset (32)
MEMBER_VERSION = 1
MEMBER_JOIN = 1  # subject address admitted on a fresh lane
MEMBER_LEAVE = 2  # subject's lane tombstoned at `epoch`
MEMBER_REJOIN = 3  # subject re-attaches to `lane` by presenting `epoch`
_MBR_HEAD = struct.Struct(">BHI")  # version | sender_slot | sender_epoch
_MBR_EVENT = struct.Struct(">BHI")  # op | lane | tombstone/assign epoch
_MEMBER_MAX_ADDR = PACKET_SIZE - _MEMBER_BASE - _MBR_HEAD.size - _MBR_EVENT.size - 2


@dataclasses.dataclass(frozen=True)
class MemberEvent:
    op: int  # MEMBER_JOIN | MEMBER_LEAVE | MEMBER_REJOIN
    lane: int  # subject lane (join: assigned lane; leave/rejoin: the lane)
    epoch: int  # leave: tombstone epoch; rejoin: presented epoch; join: assign epoch
    addr: str  # subject "host:port"


@dataclasses.dataclass(frozen=True)
class MemberPacket:
    sender_slot: int
    sender_epoch: int  # sender's membership epoch AFTER the event
    event: MemberEvent


def encode_member_packet(
    sender_slot: int, sender_epoch: int, event: MemberEvent
) -> bytes:
    """One membership event as one ``\\x00pt!mbr`` datagram (≤256 B)."""
    raw = event.addr.encode("utf-8", "surrogateescape")
    if len(raw) > _MEMBER_MAX_ADDR:
        raise ValueError(f"member address too long ({len(raw)} bytes)")
    env = bytearray(_MEMBER_BASE)
    env[24] = len(_MEMBER_NAME_BYTES)
    env[FIXED_SIZE:] = _MEMBER_NAME_BYTES
    body = bytearray(
        _MBR_HEAD.pack(
            MEMBER_VERSION, sender_slot & 0xFFFF, sender_epoch & 0xFFFFFFFF
        )
    )
    body += _MBR_EVENT.pack(
        event.op & 0xFF, event.lane & 0xFFFF, event.epoch & 0xFFFFFFFF
    )
    body.append(len(raw))
    body += raw
    body.append(sum(body) & 0xFF)
    out = bytes(env) + bytes(body)
    assert len(out) <= PACKET_SIZE
    return out


def is_member_packet(data: bytes) -> bool:
    return (
        len(data) > _MEMBER_BASE
        and data[:24] == b"\x00" * 24
        and data[24] == len(_MEMBER_NAME_BYTES)
        and data[FIXED_SIZE:_MEMBER_BASE] == _MEMBER_NAME_BYTES
    )


def decode_member_packet(data: bytes) -> Optional[MemberPacket]:
    """Strict all-or-nothing decode; ``None`` for anything malformed."""
    end = len(data) - 1
    if end < _MEMBER_BASE + _MBR_HEAD.size + _MBR_EVENT.size + 1:
        return None
    if (
        data[:24] != b"\x00" * 24
        or data[24] != len(_MEMBER_NAME_BYTES)
        or data[FIXED_SIZE:_MEMBER_BASE] != _MEMBER_NAME_BYTES
    ):
        return None
    if data[end] != sum(data[_MEMBER_BASE:end]) & 0xFF:
        return None
    try:
        version, sender_slot, sender_epoch = _MBR_HEAD.unpack_from(
            data, _MEMBER_BASE
        )
        if version != MEMBER_VERSION:
            return None
        off = _MEMBER_BASE + _MBR_HEAD.size
        op, lane, epoch = _MBR_EVENT.unpack_from(data, off)
        off += _MBR_EVENT.size
        if op not in (MEMBER_JOIN, MEMBER_LEAVE, MEMBER_REJOIN):
            return None
        ln = data[off]
        off += 1
        if off + ln > end:
            return None
        addr = data[off : off + ln].decode("utf-8", "surrogateescape")
        off += ln
    except (IndexError, struct.error):
        return None
    if off != end:
        return None  # trailing garbage ⇒ reject whole
    return MemberPacket(sender_slot, sender_epoch, MemberEvent(op, lane, epoch, addr))


# ---------------------------------------------------------------------------
# patrol-cert: certified-kernel lane trailers ("PK").
#
# Each certified limiter family beyond the token bucket ships its own
# exact own-lane watermarks in a self-sized trailer appended AFTER the
# P2 (and trace) trailers, invisible to every peer that does not know
# it — the same self-described-size argument as the P2 trailer itself:
# v1 reference nodes read exactly data[25:25+L], patrol decoders read
# trailers by magic + size and skip unknown tails. Magic "PK" + a kind
# byte select the family; version + checksum make a random tail
# unparseable. Validation is all-or-nothing (PTP003: the obligations
# registry declares encode->decode bit-exact round-trip for every
# trailer below; a torn trailer must never half-apply).
#
# Payloads are the families' OWN-LANE lattice coordinates — monotone
# watermarks a receiver max-merges, never aggregates:
#   GCRA   u64 own TAT watermark (ns)
#   CONC   u64 own acquired, u64 own released (nanotokens)
#   QUOTA  u64 own taken per path level (global, tenant, user)

CERT_TRAILER_MAGIC = b"PK"
CERT_TRAILER_VERSION = 1
CERT_KIND_GCRA = 1
CERT_KIND_CONC = 2
CERT_KIND_QUOTA = 3
_CERT_GCRA = struct.Struct(">2sBBHQB")  # magic|ver|kind|own_slot|tat|ck
_CERT_CONC = struct.Struct(">2sBBHQQB")  # …|acquired|released|ck
_CERT_QUOTA = struct.Struct(">2sBBHQQQB")  # …|taken g|t|u|ck
CERT_GCRA_TRAILER_SIZE = _CERT_GCRA.size
CERT_CONC_TRAILER_SIZE = _CERT_CONC.size
CERT_QUOTA_TRAILER_SIZE = _CERT_QUOTA.size


@dataclasses.dataclass(frozen=True)
class GcraTrailer:
    own_slot: int
    tat_ns: int  # this node's TAT watermark (max-register lane)


@dataclasses.dataclass(frozen=True)
class ConcTrailer:
    own_slot: int
    acquired_nt: int  # own TAKEN lane (monotone acquires)
    released_nt: int  # own ADDED lane (monotone releases, clamp-kept <=)


@dataclasses.dataclass(frozen=True)
class QuotaTrailer:
    own_slot: int
    taken_global_nt: int  # own TAKEN lane of each path level's row
    taken_tenant_nt: int
    taken_user_nt: int


def _cert_clamp(v: int) -> int:
    """Lane watermarks are non-negative int64 on device; clamp before the
    u64 pack so a hostile in-process value cannot wrap."""
    return min(max(int(v), 0), _INT64_MAX)


def _cert_seal(packed: bytes) -> bytes:
    return packed[:-1] + bytes([sum(packed[:-1]) & 0xFF])


def _cert_open(data: bytes, st: struct.Struct, kind: int):
    """Shared all-or-nothing frame checks → unpacked payload or None."""
    if len(data) != st.size:
        return None
    if data[-1] != sum(data[:-1]) & 0xFF:
        return None
    fields = st.unpack(data)
    if fields[0] != CERT_TRAILER_MAGIC or fields[1] != CERT_TRAILER_VERSION:
        return None
    if fields[2] != kind:
        return None
    if any(v > _INT64_MAX for v in fields[4:-1]):
        return None
    return fields


def encode_gcra_trailer(t: GcraTrailer) -> bytes:
    return _cert_seal(
        _CERT_GCRA.pack(
            CERT_TRAILER_MAGIC,
            CERT_TRAILER_VERSION,
            CERT_KIND_GCRA,
            t.own_slot & 0xFFFF,
            _cert_clamp(t.tat_ns),
            0,
        )
    )


def decode_gcra_trailer(data: bytes) -> Optional[GcraTrailer]:
    f = _cert_open(data, _CERT_GCRA, CERT_KIND_GCRA)
    if f is None:
        return None
    return GcraTrailer(own_slot=f[3], tat_ns=f[4])


def encode_conc_trailer(t: ConcTrailer) -> bytes:
    return _cert_seal(
        _CERT_CONC.pack(
            CERT_TRAILER_MAGIC,
            CERT_TRAILER_VERSION,
            CERT_KIND_CONC,
            t.own_slot & 0xFFFF,
            _cert_clamp(t.acquired_nt),
            _cert_clamp(t.released_nt),
            0,
        )
    )


def decode_conc_trailer(data: bytes) -> Optional[ConcTrailer]:
    f = _cert_open(data, _CERT_CONC, CERT_KIND_CONC)
    if f is None:
        return None
    if f[5] > f[4]:
        return None  # released > acquired can never leave a clamped kernel
    return ConcTrailer(own_slot=f[3], acquired_nt=f[4], released_nt=f[5])


def encode_quota_trailer(t: QuotaTrailer) -> bytes:
    return _cert_seal(
        _CERT_QUOTA.pack(
            CERT_TRAILER_MAGIC,
            CERT_TRAILER_VERSION,
            CERT_KIND_QUOTA,
            t.own_slot & 0xFFFF,
            _cert_clamp(t.taken_global_nt),
            _cert_clamp(t.taken_tenant_nt),
            _cert_clamp(t.taken_user_nt),
            0,
        )
    )


def decode_quota_trailer(data: bytes) -> Optional[QuotaTrailer]:
    f = _cert_open(data, _CERT_QUOTA, CERT_KIND_QUOTA)
    if f is None:
        return None
    return QuotaTrailer(
        own_slot=f[3],
        taken_global_nt=f[4],
        taken_tenant_nt=f[5],
        taken_user_nt=f[6],
    )
