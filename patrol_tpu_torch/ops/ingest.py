"""Device-resident ingest: decode + fold raw wire-v2 delta datagrams on
the card (counterpart of ``patrol_tpu/ops/ingest.py``).

The rx path ships the **raw datagram byte planes** (uint8[P, 8192] rows)
and ONE launch performs the framing walk, entry extraction,
checksum/validation verdicts, sentinel-padding of invalid packets, and
the scatter-max fold into state (:func:`decode_fold_raw`, through the
hand-written kernel of :mod:`patrol_tpu_torch.ops.ingest_kernel`).

Division of labor with the host (the part a device kernel cannot do):

* **row resolution** — bucket names live in the host directory's hash
  table, so the host runs a *vectorized structure walk*
  (:func:`host_walk`, numpy: one python-level iteration per entry
  ordinal, vectorized across all packets) that extracts per-entry name
  offsets/hashes and the header/ack fields, resolves rows through the
  existing directory pass, and hands the kernel a ``rows[P, E]`` plan
  (``FOLD_PAD_ROW`` marks entries the fold must skip: directory-miss
  drops, control-channel names, out-of-range slots);
* **host-lane split** — rows currently host-resident are flagged in the
  ``hosted[P, E]`` input; the kernel masks them OUT of the fold and
  returns a ``hosted_mask`` output (valid ∩ hosted) plus the decoded
  entry values.

Validation is **bit-identical to ops/wire.py::decode_delta_packet** —
all-or-nothing per packet: envelope (24 zero bytes, reserved name),
checksum, version, ack-vector bounds, per-entry framing bounds, bit-63
value guards, exact end-of-payload. The host half below (``dv2_mask``,
``host_walk``, ``gather_name_rows``) is the reference's numpy code as it
is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from patrol_tpu_torch.models.limiter import LimiterState
from patrol_tpu_torch.ops import ingest_kernel
from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.ops.ingest_kernel import (
    ACK as _ACK,
    BASE as _BASE,
    COUNT as _COUNT,
    ENTRY_TAIL as _ENTRY_TAIL,
    HEAD as _HEAD,
    MIN_LEN as _MIN_LEN,
)

RAW_PLANE_BYTES = wire.DELTA_PACKET_SIZE  # 8192: the rx ring row width
_NAME = np.frombuffer(ingest_kernel.NAME, np.uint8)
_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)

def max_entries(row_bytes: int) -> int:
    """Entry-ordinal bound for one plane row: the most entries a legal
    packet of ``row_bytes`` can carry (minimum entry = empty name)."""
    return max(1, (row_bytes - _MIN_LEN) // (1 + _ENTRY_TAIL))


MAX_RAW_ENTRIES = max_entries(RAW_PLANE_BYTES)  # 232 at the 8-KiB row


def dv2_mask(planes: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Vectorized envelope test over a recv batch: which rows are dv2
    delta datagrams (the numpy twin of wire.is_delta_packet) — routes
    the raw batch path before the generic per-packet dispatch."""
    n = len(sizes)
    if n == 0:
        return np.zeros(0, dtype=bool)
    head = planes[:n, :_BASE]
    return (
        (np.asarray(sizes[:n]) > _BASE)
        & (head[:, :24] == 0).all(axis=1)
        & (head[:, 24] == len(_NAME))
        & (head[:, 25:_BASE] == _NAME).all(axis=1)
    )


class RawWalk(NamedTuple):
    """The host structure walk's view of one plane batch: packet
    verdicts + header/ack fields (the delta plane's bookkeeping) and the
    per-entry name structure the directory pass consumes. Shapes:
    scalars ``[P]``, entry fields ``[P, E]``; entries past a packet's
    count (or of an invalid packet) are zero-filled."""

    ok: np.ndarray  # bool[P] — the all-or-nothing packet verdict
    sender_slot: np.ndarray  # int32[P]
    seq: np.ndarray  # int64[P] (u32 on the wire)
    n_acks: np.ndarray  # int32[P]
    acks: np.ndarray  # int64[P, 32]
    count: np.ndarray  # int32[P] live entries (0 when not ok)
    name_off: np.ndarray  # int32[P, E] offset of the name bytes
    name_len: np.ndarray  # int32[P, E]
    name_hash: np.ndarray  # uint64[P, E] FNV-1a (directory routing)
    slot: np.ndarray  # int64[P, E]
    cap: np.ndarray  # int64[P, E]
    added: np.ndarray  # int64[P, E]
    taken: np.ndarray  # int64[P, E]
    elapsed: np.ndarray  # int64[P, E]


def _np_be(planes: np.ndarray, pi: np.ndarray, off: np.ndarray, nbytes: int):
    """Big-endian uint read at per-row offsets → uint64[P] (vectorized
    gather; callers guarantee off+nbytes stays inside the plane row)."""
    acc = np.zeros(len(pi), np.uint64)
    for k in range(nbytes):
        acc = (acc << np.uint64(8)) | planes[pi, off + k].astype(np.uint64)
    return acc


def host_walk(planes: np.ndarray, lengths: np.ndarray) -> "RawWalk":
    """The vectorized host structure walk: verdicts bit-identical to
    ``wire.decode_delta_packet`` plus the name structure (offset, length,
    FNV hash) the directory pass needs and the numeric fields the
    host-lane absorb and cap-adoption tails use. One python-level loop
    iteration per entry ORDINAL (≤ :data:`MAX_RAW_ENTRIES`), each
    vectorized across every packet still walking — not per entry."""
    planes = np.asarray(planes)
    P, row = planes.shape
    E = max_entries(row)
    lengths = np.asarray(lengths, np.int64)
    pidx = np.arange(P)
    end = lengths - 1  # checksum byte offset
    safe_end = np.clip(end, 0, row - 1)

    ok = (lengths >= _MIN_LEN) & (lengths <= row)
    ok &= (planes[:, :24] == 0).all(axis=1)
    ok &= planes[:, 24] == len(_NAME)
    ok &= (planes[:, 25:_BASE] == _NAME).all(axis=1)
    # Checksum: sum(data[32:end]) & 0xFF == data[end]. Bytes past the
    # datagram length are stale ring contents and MUST NOT contribute.
    col = np.arange(row)
    body = np.where(
        (col[None, :] >= _BASE) & (col[None, :] < end[:, None]), planes, 0
    )
    ok &= (body.sum(axis=1) & 0xFF) == planes[pidx, safe_end]
    ok &= planes[:, _BASE] == wire.DELTA_VERSION
    sender_slot = (
        planes[:, _BASE + 1].astype(np.int32) << 8
    ) | planes[:, _BASE + 2]
    seq = _np_be(planes, pidx, np.full(P, _BASE + 3), 4).astype(np.int64)
    n_acks = planes[:, _BASE + 7].astype(np.int32)
    ok &= n_acks <= wire.DELTA_MAX_ACKS
    off0 = _BASE + _HEAD + _ACK * n_acks.astype(np.int64)
    ok &= off0 + _COUNT <= end
    # The STRUCTURE walk below is gated only on walkability (safe cursor
    # bounds), NOT on the envelope/checksum/version verdicts: the offsets
    # are a framing PROPOSAL for the device kernel, which re-validates
    # everything itself and must stay the verdict authority — a host
    # walk that withheld offsets from checksum-failed packets would mask
    # an in-kernel validation bug from the prover's mutation sweep.
    walkable = (
        (lengths >= _MIN_LEN)
        & (lengths <= row)
        & (n_acks <= wire.DELTA_MAX_ACKS)
        & (off0 + _COUNT <= end)
    )
    acks = np.zeros((P, wire.DELTA_MAX_ACKS), np.int64)
    for k in range(wire.DELTA_MAX_ACKS):
        sel = ok & (n_acks > k)
        if sel.any():
            si = np.flatnonzero(sel)
            acks[si, k] = _np_be(
                planes, si, (_BASE + _HEAD + _ACK * k) * np.ones(len(si), np.int64), 4
            ).astype(np.int64)
    count_off = np.clip(off0, 0, row - 2)
    count = (
        (planes[pidx, count_off].astype(np.int64) << 8)
        | planes[pidx, count_off + 1]
    ).astype(np.int64)
    count = np.where(walkable, count, 0)

    name_off = np.zeros((P, E), np.int32)
    name_len = np.zeros((P, E), np.int32)
    entry_seen = np.zeros((P, E), bool)

    # Structure walk: ONLY the cursor advance and framing bounds run
    # per-ordinal; field extraction happens once, flat, below (34 gathers
    # total instead of 34 per ordinal — the walk is the host hot path).
    off = np.where(walkable, off0 + _COUNT, 0).astype(np.int64)
    walking = walkable.copy()
    for i in range(E):
        active = walking & (count > i)
        if not active.any():
            break
        if active.all():
            # Flood fast path (every packet still walking — the common
            # recvmmsg-sweep shape): full-array ops, no index sets.
            in_bounds = off < end
            nl = planes[pidx, np.minimum(off, row - 1)].astype(np.int64)
            fits = in_bounds & (off + 1 + nl + _ENTRY_TAIL <= end)
            if fits.all():
                name_off[:, i] = off + 1
                name_len[:, i] = nl
                entry_seen[:, i] = True
                off = off + 1 + nl + _ENTRY_TAIL
                continue
        ai = np.flatnonzero(active)
        o = off[ai]
        # Python: ``if off >= end: return None`` then name_len = data[off];
        # off += 1; ``if off + nl + 34 > end: return None``.
        in_bounds = o < end[ai]
        nl = planes[ai, np.clip(o, 0, row - 1)].astype(np.int64)
        fits = in_bounds & (o + 1 + nl + _ENTRY_TAIL <= end[ai])
        bad = ai[~fits]
        walking[bad] = False
        ok[bad] = False
        gi = ai[fits]
        if gi.size:
            nlg = nl[fits]
            name_off[gi, i] = off[gi] + 1
            name_len[gi, i] = nlg
            entry_seen[gi, i] = True
            off[gi] = off[gi] + 1 + nlg + _ENTRY_TAIL
    # A count the walk could not finish (count > E physically cannot fit)
    # and a payload that does not end exactly at the checksum both reject.
    ok &= count <= E
    ok &= off == end

    # Flat field extraction over every structurally-walked entry. The
    # bit-63 guard applies here: any value ≥ 2^63 rejects the WHOLE
    # packet (decode_delta_packet's max(...) > _INT64_MAX check) — field
    # values never change the cursor walk, so deferring the check out of
    # the loop is exact.
    slot = np.zeros((P, E), np.int64)
    cap = np.zeros((P, E), np.int64)
    added = np.zeros((P, E), np.int64)
    taken = np.zeros((P, E), np.int64)
    elapsed = np.zeros((P, E), np.int64)
    spi, sei = np.nonzero(entry_seen)
    if spi.size:
        # One [n, 34] tail gather instead of 34 per-byte gathers (the
        # walked entries guarantee tail+34 ≤ end, so no clipping).
        tails = (name_off[spi, sei] + name_len[spi, sei]).astype(np.int64)
        b34 = planes[spi[:, None], tails[:, None] + np.arange(_ENTRY_TAIL)]
        b34 = b34.astype(np.uint64)

        def _be64(o: int) -> np.ndarray:
            acc = b34[:, o]
            for k in range(1, 8):
                acc = (acc << np.uint64(8)) | b34[:, o + k]
            return acc

        slot[spi, sei] = ((b34[:, 0] << np.uint64(8)) | b34[:, 1]).astype(
            np.int64
        )
        c = _be64(2)
        a = _be64(10)
        t = _be64(18)
        e = _be64(26)
        hi = np.uint64(1) << np.uint64(63)
        bit63 = ((c | a | t | e) & hi) != 0
        if bit63.any():
            ok[spi[bit63]] = False
        cap[spi, sei] = c.astype(np.int64)
        added[spi, sei] = a.astype(np.int64)
        taken[spi, sei] = t.astype(np.int64)
        elapsed[spi, sei] = e.astype(np.int64)
    count = np.where(ok, count, 0).astype(np.int32)

    # Zero the VALUE fields of rejected packets: a RawWalk never leaks
    # values from a packet its verdict refused (the engine masks on ok
    # anyway). The STRUCTURE fields (name_off/name_len) stay — they are
    # the kernel's framing proposal, and the kernel must judge even
    # packets the host verdict refused (see the walkable note above).
    dead = ~ok
    if dead.any():
        for arr in (slot, cap, added, taken, elapsed):
            arr[dead] = 0

    # FNV-1a over the live entry names, flattened: one vectorized loop
    # over byte POSITIONS (bounded by the longest live name, ≤255).
    name_hash = np.zeros((P, E), np.uint64)
    live = ok[:, None] & (np.arange(E)[None, :] < count[:, None])
    pi, ei = np.nonzero(live)
    if pi.size:
        offs = name_off[pi, ei].astype(np.int64)
        lens = name_len[pi, ei].astype(np.int64)
        h = np.full(pi.size, _FNV_OFFSET)
        maxlen = int(lens.max()) if lens.size else 0
        with np.errstate(over="ignore"):
            for k in range(maxlen):
                m = lens > k
                if not m.any():
                    break
                b = planes[pi[m], offs[m] + k].astype(np.uint64)
                h[m] = (h[m] ^ b) * _FNV_PRIME
        name_hash[pi, ei] = h

    return RawWalk(
        ok=ok,
        sender_slot=sender_slot.astype(np.int32),
        seq=seq,
        n_acks=np.where(ok, n_acks, 0).astype(np.int32),
        acks=acks,
        count=count,
        name_off=name_off,
        name_len=name_len,
        name_hash=name_hash,
        slot=slot,
        cap=cap,
        added=added,
        taken=taken,
        elapsed=elapsed,
    )


def gather_name_rows(
    planes: np.ndarray,
    pkt_idx: np.ndarray,
    name_off: np.ndarray,
    name_len: np.ndarray,
) -> np.ndarray:
    """Zero-padded uint8[n, 256] name rows for flat entries addressed by
    (packet index, byte offset) — the layout the directory's vectorized
    hash-table lookup verifies, built with one 2-D gather."""
    n = len(pkt_idx)
    out = np.zeros((n, 256), np.uint8)
    if n == 0:
        return out
    row = planes.shape[1]
    lens = np.minimum(name_len.astype(np.int64), 255)
    w = int(lens.max())
    if w == 0:
        return out
    # Gather only the longest live name's width (typical names are a few
    # bytes — a fixed 256-wide gather was the raw path's top host cost).
    cols = np.arange(w)[None, :]
    idx = np.clip(name_off.astype(np.int64)[:, None] + cols, 0, row - 1)
    vals = planes[pkt_idx.astype(np.int64)[:, None], idx]
    out[:, :w] = np.where(cols < lens[:, None], vals, 0)
    return out


def decode_fold_raw(
    state: LimiterState, planes, lengths, entry_off, rows, hosted
):
    """Raw dv2 byte planes → joined state + verdicts in one launch:
    → ``(state, ok[P], entry_ok[P,E], hosted_mask[P,E], slot, cap, added,
    taken, elapsed)``, the reference's ``decode_fold_raw`` layout. The
    state is updated IN PLACE (the returned state is the same object);
    see :func:`patrol_tpu_torch.ops.ingest_kernel.decode_fold` for the
    operand contract. A plan row in ``[-B, 0)`` wraps to ``row + B``
    first, as the reference's scatter wraps it (the kernel drops every
    row outside ``[0, B)``). On a CUDA state this launches the kernel or
    raises."""
    b = state.pn.shape[0]
    rows = torch.where(rows < 0, rows + b, rows)
    out = ingest_kernel.decode_fold(
        state.pn, state.elapsed, planes, lengths, entry_off, rows, hosted
    )
    return (state, *out)


def decode_fold_raw_plain(
    state: LimiterState, planes, lengths, entry_off, rows, hosted
):
    """:func:`decode_fold_raw` through the kernel's plain PyTorch version
    (same outputs, state updated in place) on any device."""
    out = ingest_kernel.decode_fold_plain(
        state.pn, state.elapsed, planes, lengths, entry_off, rows, hosted
    )
    return (state, *out)
