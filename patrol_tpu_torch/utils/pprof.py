"""Minimal pprof-protobuf writer — makes ``/debug/pprof/profile`` emit the
same artifact class as the reference's ``net/http/pprof`` (api.go:29-39):
a gzipped ``perftools.profiles.Profile`` message that ``go tool pprof``
and speedscope open directly.

Only the writer half of profile.proto is needed, and only five message
types (Profile, ValueType, Sample, Location+Line, Function), so this is a
hand-rolled protobuf encoder rather than a generated binding — protoc
output would be 50× the code for the same bytes. Wire format reference:
protobuf encoding docs; message schema: github.com/google/pprof
proto/profile.proto (stable since 2016).

Input model: a Counter over *stack tuples*, each stack a tuple of frames
leaf-first, each frame ``(function_name, filename, line)`` — exactly what
:class:`patrol_tpu_torch.utils.profiling.SamplingProfiler` collects.
"""

from __future__ import annotations

import gzip
import time
from collections import Counter
from typing import Dict, Tuple

Frame = Tuple[str, str, int]  # (function qualname, filename, line)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(num: int, val: int) -> bytes:
    if not val:
        return b""  # proto3 default elision
    return _varint(num << 3) + _varint(val)


def _field_bytes(num: int, data: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(data)) + data


def _value_type(type_idx: int, unit_idx: int) -> bytes:
    return _field_varint(1, type_idx) + _field_varint(2, unit_idx)


def build_profile_values(
    samples: Dict[tuple, Tuple[int, ...]],
    period_ns: int,
    duration_ns: int,
    sample_type: Tuple[Tuple[str, str], ...],
    period_type: Tuple[str, str] = ("cpu", "nanoseconds"),
) -> bytes:
    """Encode stack → value-tuple samples as a gzipped pprof Profile —
    the general writer behind the CPU, mutex, and block profiles. Each
    value tuple must be parallel to ``sample_type``."""
    strings: Dict[str, int] = {"": 0}

    def s(v: str) -> int:
        idx = strings.get(v)
        if idx is None:
            idx = strings[v] = len(strings)
        return idx

    functions: Dict[Tuple[str, str], int] = {}  # (name, file) -> id
    locations: Dict[Frame, int] = {}
    func_msgs = []
    loc_msgs = []

    def location_id(frame: Frame) -> int:
        lid = locations.get(frame)
        if lid is not None:
            return lid
        name, filename, line = frame
        fkey = (name, filename)
        fid = functions.get(fkey)
        if fid is None:
            fid = functions[fkey] = len(functions) + 1
            func_msgs.append(
                _field_varint(1, fid)
                + _field_varint(2, s(name))
                + _field_varint(3, s(name))
                + _field_varint(4, s(filename))
            )
        lid = locations[frame] = len(locations) + 1
        line_msg = _field_varint(1, fid) + _field_varint(2, line)
        loc_msgs.append(_field_varint(1, lid) + _field_bytes(4, line_msg))
        return lid

    sample_msgs = []
    for stack, values in samples.items():
        loc_ids = b"".join(_varint(location_id(f)) for f in stack)
        packed = b"".join(_varint(v) for v in values)
        # location_id (field 1) and value (field 2) are packed repeated.
        sample_msgs.append(_field_bytes(1, loc_ids) + _field_bytes(2, packed))

    out = bytearray()
    for t, u in sample_type:
        out += _field_bytes(1, _value_type(s(t), s(u)))
    for m in sample_msgs:
        out += _field_bytes(2, m)
    for m in loc_msgs:
        out += _field_bytes(4, m)
    for m in func_msgs:
        out += _field_bytes(5, m)
    # string_table: every index in insertion order (dict preserves it).
    for v in strings:
        out += _field_bytes(6, v.encode("utf-8", errors="replace"))
    out += _field_varint(9, time.time_ns())  # patrol-lint: clock-seam (pprof)
    out += _field_varint(10, duration_ns)
    out += _field_bytes(11, _value_type(s(period_type[0]), s(period_type[1])))
    out += _field_varint(12, period_ns)
    return gzip.compress(bytes(out))


def build_profile(
    stacks: Counter,
    period_ns: int,
    duration_ns: int,
    sample_type: Tuple[Tuple[str, str], ...] = (
        ("samples", "count"),
        ("cpu", "nanoseconds"),
    ),
) -> bytes:
    """Encode sampled stacks as a gzipped pprof Profile.

    Each stack's values are ``[count, count * period_ns]`` matching the
    default ``(samples/count, cpu/nanoseconds)`` sample types — the shape
    Go's sampled CPU profile uses, so pprof's top/graph/flame views all
    aggregate correctly.
    """
    return build_profile_values(
        {
            stack: (count, count * period_ns)
            for stack, count in stacks.most_common()
        },
        period_ns=period_ns,
        duration_ns=duration_ns,
        sample_type=sample_type,
    )
