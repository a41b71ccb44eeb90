"""Raw wire-v2 decode + fold: the wrapper over ``csrc/decode_fold.cu`` and
its plain PyTorch version.

Replaces ``patrol_tpu/ops/ingest.py::decode_fold_raw_pallas`` (and the
XLA ``decode_fold_raw`` it shares its core with). One call takes P raw
datagram byte planes and, per packet, decides the all-or-nothing verdict
of ``wire.decode_delta_packet``, re-checks the host's framing proposal,
decodes every entry big-endian and max-joins the live, non-hosted
entries into state. See :func:`decode_fold` for the contract.

State (``pn``, ``elapsed``) is updated IN PLACE. On a CUDA state the
wrapper launches the kernel, or raises; the plain version runs only for a
state that lies on the CPU.

The wire-v2 framing constants live here, beside the decoder that checks
them; :mod:`patrol_tpu_torch.ops.ingest` (the host half) imports them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from patrol_tpu_torch.ops import _build
from patrol_tpu_torch.ops import wire
from patrol_tpu_torch.ops.join_kernel import _check_state, pair_join_plain
from patrol_tpu_torch.ops.merge import FOLD_PAD_ROW

# Framing constants, mirrored from ops/wire.py (the codec is the spec;
# these are the offsets its struct layout implies). csrc/decode_fold.cu
# carries the same values.
BASE = 32  # envelope: 25-byte v1 header + 7-byte reserved name
HEAD = 8  # version u8 | sender_slot u16 | seq u32 | n_acks u8
ACK = 4
COUNT = 2
ENTRY_TAIL = 34  # slot u16 | cap u64 | added u64 | taken u64 | elapsed u64
MIN_LEN = BASE + HEAD + COUNT + 1  # 43: header + count + checksum
NAME = wire.DELTA_CHANNEL_NAME.encode()

Outputs = Tuple[torch.Tensor, ...]


def decode_fold_plain(
    pn: torch.Tensor,
    elapsed: torch.Tensor,
    planes: torch.Tensor,
    lengths: torch.Tensor,
    entry_off: torch.Tensor,
    rows: torch.Tensor,
    hosted: torch.Tensor,
) -> Outputs:
    """The plain version: a vectorised transcription of the reference's
    ``_device_decode`` + ``_decode_fold_core`` (same checks, same order,
    same clipping of reads to the plane row), with the fold through
    :func:`pair_join_plain`. → ``(ok[P], entry_ok[P,E], hosted_mask[P,E],
    slot, cap, added, taken, elapsed_e)``, the last five int64[P,E]."""
    P, row = planes.shape
    E = entry_off.shape[1]
    dev = planes.device
    pl = planes.to(torch.int32)
    lengths = lengths.to(torch.int64)
    end = lengths - 1
    safe_end = end.clamp(0, row - 1)

    ok = (lengths >= MIN_LEN) & (lengths <= row)
    ok &= (pl[:, :24] == 0).all(dim=1)
    ok &= pl[:, 24] == len(NAME)
    name = torch.tensor(list(NAME), dtype=torch.int32, device=dev)
    ok &= (pl[:, 25:BASE] == name).all(dim=1)
    # Checksum over [BASE, end): bytes past the datagram are stale ring
    # contents and must not contribute.
    col = torch.arange(row, device=dev)
    body = torch.where((col[None, :] >= BASE) & (col[None, :] < end[:, None]), pl, 0)
    ok &= (body.sum(dim=1) & 0xFF) == pl.gather(1, safe_end[:, None])[:, 0]
    ok &= pl[:, BASE] == wire.DELTA_VERSION
    n_acks = pl[:, BASE + 7].to(torch.int64)
    ok &= n_acks <= wire.DELTA_MAX_ACKS
    off0 = BASE + HEAD + ACK * n_acks
    ok &= off0 + COUNT <= end
    count_off = off0.clamp(0, row - 2)
    cb = pl.gather(1, torch.stack([count_off, count_off + 1], dim=1)).to(torch.int64)
    count = (cb[:, 0] << 8) | cb[:, 1]
    count = torch.where(ok, count, 0)
    ok &= count <= E

    # Framing-chain re-validation of the host's proposal.
    eo = entry_off.to(torch.int64)
    cols = torch.arange(E, device=dev)[None, :]
    cmask = cols < torch.clamp(count, max=E)[:, None]
    nl = pl.gather(1, eo.clamp(0, row - 1)).to(torch.int64)
    tail = eo + 1 + nl
    nxt = tail + ENTRY_TAIL
    in_bounds = (eo < end[:, None]) & (nxt <= end[:, None])
    ok &= torch.where(cmask, in_bounds, True).all(dim=1)
    first_ok = torch.where(count > 0, eo[:, 0] == off0 + COUNT, True)
    succ_ok = torch.where(cmask[:, 1:], eo[:, 1:] == nxt[:, :-1], True).all(dim=1)
    last_idx = (count - 1).clamp(0, E - 1)
    last_end = nxt.gather(1, last_idx[:, None])[:, 0]
    end_ok = torch.where(count > 0, last_end == end, off0 + COUNT == end)
    ok &= first_ok & succ_ok & end_ok

    # Entry extraction: one [P, E, 34] byte gather, big-endian folds (the
    # int64 shifts wrap, so bit 63 lands in the sign).
    idx34 = (tail[:, :, None] + torch.arange(ENTRY_TAIL, device=dev)).clamp(0, row - 1)
    b34 = pl.gather(1, idx34.reshape(P, -1)).reshape(P, E, ENTRY_TAIL).to(torch.int64)
    slot = (b34[..., 0] << 8) | b34[..., 1]

    def be64(o: int) -> torch.Tensor:
        acc = b34[..., o]
        for k in range(1, 8):
            acc = (acc << 8) | b34[..., o + k]
        return acc

    cap = be64(2)
    added = be64(10)
    taken = be64(18)
    elapsed_e = be64(26)
    bit63 = (cap < 0) | (added < 0) | (taken < 0) | (elapsed_e < 0)
    ok &= ~torch.where(cmask, bit63, False).any(dim=1)
    count = torch.where(ok, count, 0)

    live = ok[:, None] & (cols < count[:, None])
    nodes = pn.shape[1]
    entry_ok = live & (slot >= 0) & (slot < nodes)
    hosted_mask = entry_ok & hosted
    fold = entry_ok & ~hosted
    frows = torch.where(fold, rows.to(torch.int64), FOLD_PAD_ROW).reshape(-1)
    pair_join_plain(
        pn, elapsed, frows,
        torch.where(fold, slot, 0).reshape(-1),
        torch.where(fold, added, 0).reshape(-1),
        torch.where(fold, taken, 0).reshape(-1),
        frows,
        torch.where(fold, elapsed_e.clamp(min=0), 0).reshape(-1),
    )
    return ok, entry_ok, hosted_mask, slot, cap, added, taken, elapsed_e


def check_bulk_copy(planes: torch.Tensor) -> None:
    """The kernel stages each plane row with one bulk asynchronous copy,
    which needs a 16-byte-aligned source and a size that is a multiple
    of 16: → raises ``ValueError`` unless the planes' base address and
    row width are both multiples of 16."""
    if planes.data_ptr() % 16 or planes.shape[-1] % 16:
        raise ValueError(
            "planes must start on a 16-byte boundary with a row width that is "
            f"a multiple of 16 (base % 16 = {planes.data_ptr() % 16}, "
            f"row = {planes.shape[-1]})"
        )


def output_bytes(P: int, E: int) -> int:
    """Size of the one uint8 buffer that holds a launch's outputs: the
    five decoded fields (int64[5, P, E]) first, then the two masks
    (bool[2, P, E]: ``entry_ok``, ``hosted_mask``), then ``ok`` (bool[P]).
    Its first ``42 * P * E`` bytes, fields and masks, come back to the
    host with one copy."""
    return 42 * P * E + P


def split_outputs(buf, P: int, E: int):
    """→ ``(ok[P], masks[2, P, E], fields[5, P, E])``: views into a buffer
    of :func:`output_bytes` laid out as that function says (a uint8 tensor
    or numpy array)."""
    f, m = 40 * P * E, 42 * P * E
    if isinstance(buf, torch.Tensor):
        return (
            buf[m:m + P].view(torch.bool),
            buf[f:m].view(torch.bool).view(2, P, E),
            buf[:f].view(torch.int64).view(5, P, E),
        )
    return (
        buf[m:m + P].view(bool),
        buf[f:m].view(bool).reshape(2, P, E),
        buf[:f].view("int64").reshape(5, P, E),
    )


def decode_fold(
    pn: torch.Tensor,
    elapsed: torch.Tensor,
    planes: torch.Tensor,
    lengths: torch.Tensor,
    entry_off: torch.Tensor,
    rows: torch.Tensor,
    hosted: torch.Tensor,
    out: Optional[torch.Tensor] = None,
) -> Outputs:
    """Decode P raw dv2 datagrams and fold them into state, in place.

    Operands, all contiguous on the state's device: ``planes`` uint8[P,
    ROW] (bytes past ``lengths[p]`` are stale and never read as data; on a
    CUDA state 16-byte aligned with ROW a multiple of 16, see
    :func:`check_bulk_copy`),
    ``lengths`` int32[P], ``entry_off`` int32[P, E] (the host walk's
    proposed offset of each entry's name-length byte; re-checked, never
    trusted), ``rows`` int32[P, E] (the host's row plan; rows outside
    ``[0, B)``, such as ``FOLD_PAD_ROW``, are not folded) and ``hosted``
    bool[P, E] (entries the fold must leave to the host-lane join).

    → ``(ok[P], entry_ok[P,E], hosted_mask[P,E], slot, cap, added, taken,
    elapsed_e)``. ``ok`` is bit-identical to ``wire.decode_delta_packet``'s
    verdict; ``entry_ok = ok ∧ e < count ∧ slot < N``; ``hosted_mask =
    entry_ok ∧ hosted``. The five decoded fields are int64[P, E] and are
    defined only where ``entry_ok`` holds (elsewhere they are scratch).
    Every ``entry_ok ∧ ¬hosted`` entry max-joins ``(added, taken)`` into
    ``pn[row, slot]`` and ``max(elapsed_e, 0)`` into ``elapsed[row]``.

    ``out``, when given, is a uint8 buffer of :func:`output_bytes` on the
    state's device: the outputs are written there and returned as views
    of it (see :func:`split_outputs`), so a caller reads the masks and
    fields back with one copy."""
    dev = _check_state(pn, elapsed)
    _build.check_operand("planes", planes, torch.uint8, dev)
    _build.check_operand("lengths", lengths, torch.int32, dev)
    _build.check_operand("entry_off", entry_off, torch.int32, dev)
    _build.check_operand("rows", rows, torch.int32, dev)
    _build.check_operand("hosted", hosted, torch.bool, dev)
    if planes.dim() != 2:
        raise ValueError(f"planes must be [P, ROW], got {tuple(planes.shape)}")
    P, row = planes.shape
    if entry_off.dim() != 2 or entry_off.shape[0] != P or entry_off.shape[1] < 1:
        raise ValueError(f"entry_off must be [{P}, E >= 1], got {tuple(entry_off.shape)}")
    E = entry_off.shape[1]
    for name, t in (("rows", rows), ("hosted", hosted)):
        if tuple(t.shape) != (P, E):
            raise ValueError(f"{name} must be [{P}, {E}], got {tuple(t.shape)}")
    if tuple(lengths.shape) != (P,):
        raise ValueError(f"lengths must be [{P}], got {tuple(lengths.shape)}")
    if out is not None and (
        out.dtype != torch.uint8 or out.device != dev or not out.is_contiguous()
        or tuple(out.shape) != (output_bytes(P, E),)
    ):
        raise ValueError(
            f"out must be contiguous uint8[{output_bytes(P, E)}] on {dev}, got "
            f"{out.dtype}{tuple(out.shape)} on {out.device}"
        )
    if dev.type == "cpu":
        res = decode_fold_plain(pn, elapsed, planes, lengths, entry_off, rows, hosted)
        if out is None:
            return res
        ok, masks, fields = split_outputs(out, P, E)
        views = (ok, masks[0], masks[1], *fields.unbind(0))
        for dst, src in zip(views, res):
            dst.copy_(src)
        return views
    check_bulk_copy(planes)
    if out is None:
        out = torch.empty(output_bytes(P, E), dtype=torch.uint8, device=dev)
    ok, masks, fields = split_outputs(out, P, E)
    if P == 0:
        return (ok, masks[0], masks[1], *fields.unbind(0))
    b, n, _ = pn.shape
    rc = _build.lib().patrol_decode_fold(
        pn.data_ptr(), elapsed.data_ptr(), b, n,
        planes.data_ptr(), P, row, lengths.data_ptr(), entry_off.data_ptr(),
        rows.data_ptr(), hosted.data_ptr(), E,
        ok.data_ptr(), masks.data_ptr(), fields.data_ptr(),
        _build.stream_handle(pn),
    )
    _build.check_rc(rc, "decode_fold")
    _build.count_launch("decode_fold")
    return (ok, masks[0], masks[1], *fields.unbind(0))
