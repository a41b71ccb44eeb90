"""Wire protocol v2 (dv2) delta-interval datagrams, as a peer writes them.

A frozen copy of the framing that patrol's port receives on its UDP port
(``patrol_tpu_torch/ops/wire.py``, "Wire protocol v2"), written with numpy
so that the benchmark's simulated peers can pack thousands of datagrams a
second from one process without importing the program. All integers are
big-endian::

    envelope  24 zero bytes | u8 7 | "\\x00pt!dv2"            (32 bytes)
    head      u8 version=2 | u16 sender_slot | u32 seq | u8 n_acks
    acks      n_acks x u32
    count     u16
    entries   count x (u8 name_len | name | u16 slot | u64 cap |
                       u64 added | u64 taken | u64 elapsed)
    checksum  u8: the sum of every byte after the envelope, mod 256

``seq`` 0 with no entries is a bare ack. The receiver acknowledges each
interval's ``seq`` in the ack vector of a later datagram to the sender.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

CHANNEL = b"\x00pt!dv2"
ENVELOPE = 24 + 1 + len(CHANNEL)  # 32
VERSION = 2
HEAD = 1 + 2 + 4 + 1  # version | sender_slot | seq | n_acks
COUNT = 2
ENTRY_TAIL = 2 + 4 * 8  # slot | cap | added | taken | elapsed
CHECKSUM = 1


def entry_size(name_len: int) -> int:
    return 1 + name_len + ENTRY_TAIL


def datagram_size(entries: int, name_len: int) -> int:
    """Bytes of a data datagram with no acks and ``entries`` entries."""
    return ENVELOPE + HEAD + COUNT + entries * entry_size(name_len) + CHECKSUM


def capacity(max_bytes: int, name_len: int) -> int:
    """The most entries of one name length that fit ``max_bytes``."""
    return (max_bytes - datagram_size(0, name_len)) // entry_size(name_len)


def _header_dtype() -> np.dtype:
    return np.dtype([
        ("env", "u1", (ENVELOPE,)), ("version", "u1"), ("slot", ">u2"),
        ("seq", ">u4"), ("n_acks", "u1"), ("count", ">u2"),
    ])


def _entry_dtype(name_len: int) -> np.dtype:
    return np.dtype([
        ("name_len", "u1"), ("name", "u1", (name_len,)), ("slot", ">u2"),
        ("cap", ">u8"), ("added", ">u8"), ("taken", ">u8"), ("elapsed", ">u8"),
    ])


_ENV = np.zeros(ENVELOPE, np.uint8)
_ENV[24] = len(CHANNEL)
_ENV[25:] = np.frombuffer(CHANNEL, np.uint8)


def encode(sender_slot: int, seqs, names, slot: int, cap, added, taken, elapsed) -> np.ndarray:
    """Pack D data datagrams of E entries each, with no acks.

    ``seqs`` is int[D]; ``names`` uint8[D, E, L] (every name L bytes);
    ``cap``, ``added``, ``taken`` and ``elapsed`` are int64[D, E] (or
    broadcast to it), all non-negative; every entry carries lane ``slot``.
    → uint8[D, datagram_size(E, L)], one datagram a row."""
    names = np.asarray(names, np.uint8)
    d, e, name_len = names.shape
    hd, ed = _header_dtype(), _entry_dtype(name_len)
    out = np.zeros((d, datagram_size(e, name_len)), np.uint8)
    head = out[:, : hd.itemsize].view(hd).reshape(d)
    head["env"] = _ENV
    head["version"] = VERSION
    head["slot"] = sender_slot
    head["seq"] = np.asarray(seqs, np.int64)
    head["n_acks"] = 0
    head["count"] = e
    body = out[:, hd.itemsize : hd.itemsize + e * ed.itemsize]
    ent = np.ascontiguousarray(body).view(ed).reshape(d, e)
    ent["name_len"] = name_len
    ent["name"] = names
    ent["slot"] = slot
    for key, val in (("cap", cap), ("added", added), ("taken", taken), ("elapsed", elapsed)):
        ent[key] = np.broadcast_to(np.asarray(val, np.int64), (d, e)).astype(np.uint64)
    out[:, hd.itemsize : hd.itemsize + e * ed.itemsize] = ent.view(np.uint8).reshape(d, -1)
    out[:, -1] = (out[:, ENVELOPE:-1].sum(axis=1, dtype=np.int64) & 0xFF).astype(np.uint8)
    return out


def acks_of(data: bytes) -> Optional[List[int]]:
    """The ack vector of a dv2 datagram, or None for any other datagram
    or a malformed one."""
    end = len(data) - 1
    if end < ENVELOPE + HEAD + COUNT:
        return None
    if data[:24] != bytes(24) or data[24] != len(CHANNEL) or data[25:ENVELOPE] != CHANNEL:
        return None
    if data[end] != sum(data[ENVELOPE:end]) & 0xFF:
        return None
    version, _slot, _seq, n_acks = struct.unpack_from(">BHIB", data, ENVELOPE)
    off = ENVELOPE + HEAD
    if version != VERSION or off + 4 * n_acks + COUNT > end:
        return None
    return list(struct.unpack_from(f">{n_acks}I", data, off))
