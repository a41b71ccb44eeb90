"""The port's copied host modules against the JAX package's originals.

``ops/wire.py``, ``ops/rate.py`` and the ``TPURepo`` facade are copies
in the port (imports rewritten). A seeded fuzz corpus goes through both
packages' wire codecs — encodings must be byte-identical, decodes of
valid, truncated and bit-flipped datagrams identical (including which
ones raise) — and both packages' rate parsers; the repo facade's
Repo-seam methods give the same buckets on both engines.
"""

import dataclasses

import numpy as np
import pytest

from patrol_tpu.models.limiter import LimiterConfig as JConfig
from patrol_tpu.ops import rate as jrate
from patrol_tpu.ops import wire as jwire
from patrol_tpu.runtime import engine as jengine_mod
from patrol_tpu.runtime.bucket import Bucket as JBucket
from patrol_tpu.runtime.repo import TPURepo as JRepo
from patrol_tpu_torch.models.limiter import NANO
from patrol_tpu_torch.models.limiter import LimiterConfig as TConfig
from patrol_tpu_torch.ops import rate as trate
from patrol_tpu_torch.ops import wire as twire
from patrol_tpu_torch.runtime import engine as tengine_mod
from patrol_tpu_torch.runtime.bucket import Bucket as TBucket
from patrol_tpu_torch.runtime.engine import DeviceEngine as TEngine
from patrol_tpu_torch.runtime.repo import TPURepo as TRepo


def _states(rng, n):
    out = []
    for i in range(n):
        name = "".join(chr(int(c)) for c in rng.integers(97, 123, int(rng.integers(1, 40))))
        kind = i % 4
        kw = {}
        if kind >= 1:
            kw["origin_slot"] = int(rng.integers(0, 256))
        if kind >= 2:
            kw["cap_nt"] = int(rng.integers(0, 1 << 50))
        if kind == 3:
            kw["lane_added_nt"] = int(rng.integers(0, 1 << 50))
            kw["lane_taken_nt"] = int(rng.integers(0, 1 << 50))
        out.append(
            (name, int(rng.integers(0, 1 << 50)), int(rng.integers(0, 1 << 50)),
             int(rng.integers(-5, 1 << 40)), kw)
        )
    return out


def _decode(mod, data):
    try:
        return ("ok", dataclasses.astuple(mod.decode(data)))
    except ValueError as exc:
        return ("err", type(exc).__name__)


@pytest.mark.parametrize("seed", range(3))
def test_wire_codec_fuzz_matches_reference(seed):
    rng = np.random.default_rng(seed)
    checked = 0
    for name, a, t, e, kw in _states(rng, 60):
        jb = jwire.encode(jwire.from_nanotokens(name, a, t, e, **kw))
        tb = twire.encode(twire.from_nanotokens(name, a, t, e, **kw))
        assert tb == jb
        variants = [jb, jb[: int(rng.integers(0, len(jb)))], jb + b"\x00\x01"]
        flip = bytearray(jb)
        flip[int(rng.integers(0, len(jb)))] ^= 1 << int(rng.integers(0, 8))
        variants.append(bytes(flip))
        for v in variants:
            assert _decode(twire, v) == _decode(jwire, v)
            checked += 1
    assert checked == 240


@pytest.mark.parametrize("seed", range(2))
def test_delta_packets_match_reference(seed):
    rng = np.random.default_rng(10 + seed)
    entries = [
        (f"bucket-{i}", int(rng.integers(0, 256)), int(rng.integers(0, 1 << 40)),
         int(rng.integers(0, 1 << 40)), int(rng.integers(0, 1 << 40)),
         int(rng.integers(0, 1 << 40)))
        for i in range(80)
    ]
    acks = [int(x) for x in rng.integers(1, 1 << 31, 5)]
    jb, jn = jwire.encode_delta_packet(3, 77, acks, [jwire.DeltaEntry(*e) for e in entries])
    tb, tn = twire.encode_delta_packet(3, 77, acks, [twire.DeltaEntry(*e) for e in entries])
    assert (tb, tn) == (jb, jn) and tn > 10
    for v in (jb, jb[:-1], jb[:40]):
        jp, tp = jwire.decode_delta_packet(v), twire.decode_delta_packet(v)
        assert (tp is None) == (jp is None)
        if tp is not None:
            assert dataclasses.astuple(tp) == dataclasses.astuple(jp)


RATES = ["50:1s", "1:1m", "3:1h", "10", "5:ms", "0:1s", "7:1m30s", "2:1.5s",
         "x:1s", "1:", "-3:1s", "9:1us", "4:250ms", ""]


def test_rate_parsing_matches_reference():
    for v in RATES:
        try:
            want = ("ok", jrate.parse_rate(v))
        except ValueError:
            want = ("err", None)
        try:
            got = ("ok", trate.parse_rate(v))
        except ValueError:
            got = ("err", None)
        assert got[0] == want[0], v
        if got[0] == "ok":
            assert (got[1].freq, got[1].per_ns, str(got[1])) == (
                want[1].freq, want[1].per_ns, str(want[1])
            )


class Clock:
    def __init__(self, now=1000 * NANO):
        self.now = now

    def __call__(self):
        return self.now


def test_repo_seam_matches_reference(monkeypatch):
    monkeypatch.setattr(jengine_mod, "HOST_FASTPATH", False)
    monkeypatch.setattr(tengine_mod, "HOST_FASTPATH", False)

    def drive(repo, bucket_cls, rate_cls):
        out = []
        rate = rate_cls(freq=4, per_ns=NANO)
        out.append(repo.take("a", rate, 1))
        out.append(repo.take("a", rate, 2))
        b, existed = repo.get_bucket("a")
        out.append((b.added_nt, b.taken_nt, b.elapsed_ns, existed))
        b, existed = repo.get_bucket("fresh")
        out.append((b.added_nt, b.taken_nt, existed))
        v, existed = repo.upsert_bucket(
            bucket_cls(name="up", added_nt=9 * NANO, taken_nt=2 * NANO, elapsed_ns=5)
        )
        out.append((v.added_nt, v.taken_nt, v.elapsed_ns, existed))
        out.append((repo.tokens("a"), repo.tokens_if_known("nope")))
        out.append([dataclasses.astuple(s) for s in repo.snapshot("a")])
        return out

    jeng = jengine_mod.DeviceEngine(JConfig(64, 4), node_slot=0, clock=Clock())
    try:
        want = drive(JRepo(jeng), JBucket, jrate.Rate)
    finally:
        jeng.stop()
    teng = TEngine(TConfig(64, 4), node_slot=0, clock=Clock(), device="cpu")
    try:
        got = drive(TRepo(teng), TBucket, trate.Rate)
    finally:
        teng.stop()
    assert got == want


# -- the certified families' trailers (tests/test_cert_kernels.py::TestCertTrailers)

_TRAILERS = {
    "gcra": ("GcraTrailer", "encode_gcra_trailer", "decode_gcra_trailer"),
    "conc": ("ConcTrailer", "encode_conc_trailer", "decode_conc_trailer"),
    "quota": ("QuotaTrailer", "encode_quota_trailer", "decode_quota_trailer"),
}


def _trailer_both(kind, *fields):
    """Encode one trailer with each package's codec: → (jax bytes, port
    bytes, jax decode, port decode as field tuples); the bytes must match."""
    cls, enc, dec = _TRAILERS[kind]
    jdata = getattr(jwire, enc)(getattr(jwire, cls)(*fields))
    tdata = getattr(twire, enc)(getattr(twire, cls)(*fields))
    assert tdata == jdata
    return jdata, getattr(jwire, dec), getattr(twire, dec)


def _astuple(x):
    return None if x is None else dataclasses.astuple(x)


@pytest.mark.parametrize("kind, fields", [
    ("gcra", (7, 123456789)),
    ("conc", (3, 50, 20)),
    ("quota", (1, 9, 6, 4)),
])
def test_cert_trailer_roundtrip_matches_reference(kind, fields):
    data, jdec, tdec = _trailer_both(kind, *fields)
    assert _astuple(tdec(data)) == _astuple(jdec(data)) == fields


@pytest.mark.parametrize("kind", list(_TRAILERS))
def test_cert_trailer_truncation_and_corruption_match_reference(kind):
    fields = {"gcra": (0, 42), "conc": (0, 9, 4), "quota": (0, 3, 2, 1)}[kind]
    data, jdec, tdec = _trailer_both(kind, *fields)
    rng = np.random.default_rng(9)
    cases = [data[:-1], data[:1], b"", data + b"\x00",
             bytes([data[0] ^ 0xFF]) + data[1:]]
    for _ in range(64):
        i = int(rng.integers(0, len(data)))
        cases.append(data[:i] + bytes([data[i] ^ int(rng.integers(1, 256))]) + data[i + 1:])
    for case in cases:
        assert _astuple(tdec(case)) == _astuple(jdec(case))
    assert tdec(data[:-1]) is None and tdec(cases[4]) is None


def test_cert_trailer_kind_confusion_matches_reference():
    for kind, fields in (("gcra", (0, 42)), ("conc", (0, 9, 4)), ("quota", (0, 3, 2, 1))):
        data, _, _ = _trailer_both(kind, *fields)
        for other in set(_TRAILERS) - {kind}:
            dec = _TRAILERS[other][2]
            assert getattr(twire, dec)(data) is None
            assert getattr(jwire, dec)(data) is None


def test_cert_conc_released_above_acquired_matches_reference():
    data, jdec, tdec = _trailer_both("conc", 0, 1, 5)
    assert tdec(data) is None and jdec(data) is None


@pytest.mark.parametrize("kind, fields, want", [
    ("gcra", (0, -5), (0, 0)),
    ("conc", (2, -3, -9), (2, 0, 0)),
    ("quota", (4, -1, 7, -(1 << 63)), (4, 0, 7, 0)),
    ("gcra", (65535 + 3, 1 << 70), (2, (1 << 63) - 1)),
])
def test_cert_trailer_negative_watermarks_clamp_as_the_reference(kind, fields, want):
    data, jdec, tdec = _trailer_both(kind, *fields)
    assert _astuple(tdec(data)) == _astuple(jdec(data)) == want
