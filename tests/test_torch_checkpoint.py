"""The port's checkpoints against the JAX package's, exactly.

Twins of the JAX suite's checkpoint cases (``test_chaos.py``
``TestCheckpoint``, ``test_fastpath.py``'s two residency cases,
``test_hashdir.py``'s restore bindings, ``test_audit.py``'s tombstone
cases and ``test_membership.py``'s lane pin): each scenario runs on a JAX
engine and a port engine (``device="cpu"``; host lanes in Python and in
the C++ store) and the results must be equal. Then the format: a
checkpoint written by either package restores in the other with identical
planes, directory and tombstones, and a restore joins under signed int64
max (``jnp.maximum``), which differs from the port's unsigned merge on a
wrapped lane. Tolerance: exact equality.
"""

import json
import os
import socket
import types

import numpy as np
import pytest

from patrol_tpu.models.limiter import LimiterConfig as JConfig
from patrol_tpu.net.replication import SlotTable as JSlotTable
from patrol_tpu.ops import wire as jwire
from patrol_tpu.ops.rate import Rate as JRate
from patrol_tpu.runtime import checkpoint as jckpt
from patrol_tpu.runtime.engine import DeviceEngine as JEngine
from patrol_tpu.runtime.repo import TPURepo as JRepo
from patrol_tpu_torch import native
from patrol_tpu_torch.models.limiter import NANO, LimiterConfig
from patrol_tpu_torch.net.replication import SlotTable
from patrol_tpu_torch.ops import wire as twire
from patrol_tpu_torch.ops.rate import Rate
from patrol_tpu_torch.runtime import checkpoint as tckpt
from patrol_tpu_torch.runtime.engine import DeviceEngine
from patrol_tpu_torch.runtime.repo import TPURepo

JAX = types.SimpleNamespace(name="jax", ckpt=jckpt, Rate=JRate, wire=jwire, Repo=JRepo)
PORT = types.SimpleNamespace(name="port", ckpt=tckpt, Rate=Rate, wire=twire, Repo=TPURepo)
CFG = (64, 4)


class Clock:
    def __init__(self, now=1000):
        self.now = now

    def __call__(self):
        return self.now


def make(pkg, clock, cfg=CFG, lanes="python"):
    if pkg is JAX:
        return JEngine(JConfig(*cfg), node_slot=0, clock=clock)
    if lanes == "native" and native.load() is None:
        pytest.skip("the native host library does not build here")
    return DeviceEngine(LimiterConfig(*cfg), node_slot=0, clock=clock, device="cpu",
                        native_host=lanes == "native")


def rate(pkg, per=NANO):
    return pkg.Rate(freq=10, per_ns=per)


def state_of(eng):
    assert eng.flush(30)
    pn, el = eng.snapshot_planes()
    d = eng.directory
    return (dict(d._rows), {k: tuple(int(x) for x in v) for k, v in d.export_tombstones().items()},
            {r: (int(d.created_ns[r]), int(d.cap_base_nt[r])) for r in d._rows.values()},
            pn.tobytes(), el.tobytes())


def both(scenario, tmp_path, lanes="python"):
    """``scenario(pkg, dir, lanes)`` on each package; → the port's result,
    which must equal the JAX package's."""
    out = []
    for pkg in (JAX, PORT):
        d = tmp_path / pkg.name
        d.mkdir()
        out.append(scenario(pkg, str(d), lanes))
    assert out[1] == out[0]
    return out[1]


# -- twins of the JAX suite's checkpoint cases ----------------------------------


def test_save_restore_roundtrip(tmp_path):
    def sc(pkg, d, lanes):
        eng = make(pkg, Clock(1000))
        try:
            eng.take("a", rate(pkg), 3)
            eng.take("b", rate(pkg), 7)
            pkg.ckpt.save(d, eng)
        finally:
            eng.stop()
        eng2 = make(pkg, Clock(2000))
        try:
            n = pkg.ckpt.restore(d, eng2)
            row = eng2.directory.lookup("a")
            return (n, eng2.tokens("a"), eng2.tokens("b"), int(eng2.directory.created_ns[row]),
                    tuple(eng2.take("b", rate(pkg), 3)), state_of(eng2))
        finally:
            eng2.stop()

    n, a, b, created, took, _ = both(sc, tmp_path)
    assert (n, a, b, created, took) == (2, 7, 3, 1000, (0, True, False))


def test_restore_is_a_join_never_a_rollback(tmp_path):
    def sc(pkg, d, lanes):
        eng = make(pkg, Clock(0))
        try:
            eng.take("k", rate(pkg), 2)
            pkg.ckpt.save(d, eng)  # stale snapshot: taken 2
            eng.take("k", rate(pkg), 3)  # newer: taken 5
            pkg.ckpt.restore(d, eng)
            return eng.tokens("k"), state_of(eng)
        finally:
            eng.stop()

    assert both(sc, tmp_path)[0] == 5


def test_shape_mismatch_rejected(tmp_path):
    def sc(pkg, d, lanes):
        eng = make(pkg, Clock(0))
        try:
            pkg.ckpt.save(d, eng)
        finally:
            eng.stop()
        other = make(pkg, Clock(0), cfg=(32, 4))
        try:
            with pytest.raises(ValueError, match="shape mismatch") as err:
                pkg.ckpt.restore(d, other)
            return str(err.value)
        finally:
            other.stop()

    both(sc, tmp_path)


@pytest.mark.parametrize("lanes", ["python", "native"])
def test_checkpoint_save_includes_hosted(tmp_path, lanes):
    def sc(pkg, d, lanes):
        eng = make(pkg, Clock(0), lanes=lanes)
        try:
            eng.take("ck", rate(pkg), 6)
            hosted = eng.hosted_buckets
            pkg.ckpt.save(d, eng)
        finally:
            eng.stop()
        eng2 = make(pkg, Clock(0), lanes=lanes)
        try:
            return hosted, pkg.ckpt.restore(d, eng2), eng2.tokens_if_known("ck"), state_of(eng2)
        finally:
            eng2.stop()

    assert both(sc, tmp_path, lanes)[:3] == (1, 1, 4)


@pytest.mark.parametrize("lanes", ["python", "native"])
def test_checkpoint_save_keeps_residency(tmp_path, lanes):
    def sc(pkg, d, lanes):
        eng = make(pkg, Clock(0), lanes=lanes)
        try:
            eng.take("stay", rate(pkg), 2)
            pkg.ckpt.save(d, eng)
            kept = (eng.hosted_buckets, eng.tokens_if_known("stay"))
        finally:
            eng.stop()
        eng2 = make(pkg, Clock(0), lanes=lanes)
        try:
            pkg.ckpt.restore(d, eng2)
            return kept, eng2.tokens_if_known("stay")
        finally:
            eng2.stop()

    assert both(sc, tmp_path, lanes) == ((1, 8), 8)


def test_restored_buckets_are_hash_resolvable_and_evictable(tmp_path):
    from test_torch_hashdir import _buf

    def sc(pkg, d, lanes):
        eng = make(pkg, Clock(0))
        eng.take("ckpt-bucket", rate(pkg), 3)
        pkg.ckpt.save(d, eng)
        eng.stop()
        eng2 = make(pkg, Clock(0))
        try:
            n = pkg.ckpt.restore(d, eng2)
            buf, lens, hashes = _buf(["ckpt-bucket"])
            rows = eng2.directory.lookup_hashed_pinned(hashes, buf, lens, 5)
            resolved = int(rows[0]) == eng2.directory.lookup("ckpt-bucket")
            eng2.directory.unpin_rows(rows)
            return n, resolved, int(rows[0]) in eng2.directory.pick_victims(64)
        finally:
            eng2.stop()

    assert both(sc, tmp_path) == (1, True, True)


def reclaimed_engine(pkg, clock, lanes="python"):
    """An engine whose bucket "u" (5 of 10 taken) was reclaimed."""
    eng = make(pkg, clock, cfg=(16, 4), lanes=lanes)
    repo = pkg.Repo(eng, send_incast=lambda n: None)
    r = rate(pkg, per=3600 * NANO)
    repo.take("u", r, 5)
    eng.flush()
    clock.now += 3600 * NANO * 10  # refilled to full, and idle
    assert eng.gc_sweep(clock.now, force=True) == 1
    return eng, r


@pytest.mark.parametrize("lanes", ["python", "native"])
def test_checkpoint_roundtrips_tombstones(tmp_path, lanes):
    def sc(pkg, d, lanes):
        clock = Clock()
        eng, _ = reclaimed_engine(pkg, clock, lanes)
        toms = eng.directory.export_tombstones()
        try:
            pkg.ckpt.save(d, eng)
        finally:
            eng.stop()
        eng2 = make(pkg, clock, cfg=(16, 4), lanes=lanes)
        try:
            pkg.ckpt.restore(d, eng2)
            return eng2.directory.export_tombstones() == toms, dict(toms)
        finally:
            eng2.stop()

    same, toms = both(sc, tmp_path, lanes)
    assert same and "u" in toms


@pytest.mark.parametrize("lanes", ["python", "native"])
def test_restart_then_stale_echo_cannot_erase_reclaimed_spend(tmp_path, lanes):
    def sc(pkg, d, lanes):
        clock = Clock()
        eng, r = reclaimed_engine(pkg, clock, lanes)
        try:
            pkg.ckpt.save(d, eng)
        finally:
            eng.stop()
        eng2 = make(pkg, clock, cfg=(16, 4), lanes=lanes)
        try:
            pkg.ckpt.restore(d, eng2)
            repo2 = pkg.Repo(eng2, send_incast=lambda n: None)
            _, ok = repo2.take("u", r, 1)
            eng2.flush()
            row = eng2.directory.lookup("u")
            before = int(eng2.row_view(row)[0][0, 1])
            eng2.ingest_delta(
                pkg.wire.WireState(name="u", added=10.0, taken=5.0, elapsed_ns=0,
                                   origin_slot=0, cap_nt=10 * NANO, lane_added_nt=0,
                                   lane_taken_nt=5 * NANO),
                0,
            )
            eng2.flush()
            return ok, before, int(eng2.row_view(row)[0][0, 1])
        finally:
            eng2.stop()

    assert both(sc, tmp_path, lanes) == (True, 6 * NANO, 6 * NANO)


def test_restore_without_tombstone_key_is_compatible(tmp_path):
    def sc(pkg, d, lanes):
        clock = Clock()
        eng, _ = reclaimed_engine(pkg, clock)
        try:
            pkg.ckpt.save(d, eng)
        finally:
            eng.stop()
        path = os.path.join(d, "directory.json")
        with open(path) as f:
            meta = json.load(f)
        meta.pop("tombstones")
        with open(path, "w") as f:
            json.dump(meta, f)
        eng2 = make(pkg, clock, cfg=(16, 4))
        try:
            pkg.ckpt.restore(d, eng2)
            return eng2.directory.export_tombstones()
        finally:
            eng2.stop()

    assert both(sc, tmp_path) == {}


def test_self_slot_override_pins_rejoin_boot():
    a, b, d = "127.0.0.1:9001", "127.0.0.1:9002", "127.0.0.1:9005"
    tables = [cls(d, [a, b, d], max_slots=6, self_slot=1) for cls in (JSlotTable, SlotTable)]
    for st in tables:
        assert st.self_slot == 1
        assert sorted(v for k, v in st.slot_of.items() if k != ("127.0.0.1", 9005)) == [0, 2]
        assert st._next_dynamic == 3
    assert tables[1].view() == tables[0].view()


def test_restart_comes_back_on_the_checkpointed_lane(tmp_path):
    """A node restarted with ``checkpoint_dir`` takes the lane its
    checkpoint's membership view names (its spend lives there), not its
    rank in the new member list, and restores the checkpoint at boot."""
    from patrol_tpu_torch.command import Command
    from test_torch_api import Node, _free_port

    def udp():
        return f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}"

    cfg = LimiterConfig(256, 8)
    peers = [udp(), udp()]
    me = max(peers)  # rank 1 of the first member list
    cmd = Command(api_addr="127.0.0.1:0", node_addr=me, peer_addrs=peers, clock=Clock(),
                  config=cfg, handle_signals=False, device="cpu", http_front="python",
                  udp_backend="asyncio", checkpoint_dir=str(tmp_path))
    node = Node(cmd)
    try:
        assert cmd.engine.node_slot == 1
        cmd.engine.take("spent", Rate(freq=10, per_ns=3600 * NANO), 4)
    finally:
        node.close()
    assert tckpt.exists(str(tmp_path))
    assert tckpt.load_membership(str(tmp_path))["self_slot"] == 1
    # Restart alone under a new address, where rank order gives lane 0.
    cmd2 = Command(api_addr="127.0.0.1:0", node_addr=udp(), clock=Clock(), config=cfg,
                   handle_signals=False, device="cpu", http_front="python",
                   udp_backend="asyncio", checkpoint_dir=str(tmp_path))
    node2 = Node(cmd2)
    try:
        assert cmd2.engine.node_slot == 1
        assert cmd2.engine.tokens_if_known("spent") == 6
    finally:
        node2.close()


# -- the format across packages ---------------------------------------------------


def busy_engine(pkg, clock):
    """Spend on host lanes and device rows, a replicated lane, and a
    reclaimed bucket's tombstone."""
    eng = make(pkg, clock)
    r = rate(pkg)
    for i in range(6):
        eng.take(f"h{i}", r, i + 1)
    eng.ingest_delta(pkg.wire.from_nanotokens(
        "peer", 4 * NANO, 2 * NANO, 5, origin_slot=2, cap_nt=10 * NANO,
        lane_added_nt=4 * NANO, lane_taken_nt=2 * NANO), slot=2)
    eng.take("gone", r, 2)
    assert eng.flush(30)
    clock.now += 10 * NANO
    eng.take("h0", r, 1)  # touched: kept
    eng.flush()
    return eng


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)], ids=["jax-to-port", "port-to-jax"])
def test_checkpoint_restores_across_packages(tmp_path, writer, reader):
    clock = Clock(1000 * NANO)
    src = busy_engine(writer, clock)
    try:
        assert src.gc_sweep(clock.now, force=True) > 0
        assert src.directory.lookup("gone") is None and src.directory.lookup("h0") is not None
        want = state_of(src)
        writer.ckpt.save(str(tmp_path), src)
    finally:
        src.stop()
    assert want[1], "the source holds no tombstone"
    dst = make(reader, Clock(clock.now))
    try:
        n = reader.ckpt.restore(str(tmp_path), dst)
        assert n == len(want[0])
        assert state_of(dst) == want
    finally:
        dst.stop()


def test_restore_joins_under_signed_max(tmp_path):
    """A lane value that wrapped negative in the checkpoint loses to the
    engine's positive value under signed max (``jnp.maximum``); the port's
    unsigned merge would keep the wrapped one. Both packages restore the
    same planes."""
    clock = Clock(0)
    src = make(JAX, clock)
    try:
        src.take("w", rate(JAX), 3)
        jckpt.save(str(tmp_path), src)
    finally:
        src.stop()
    with np.load(tmp_path / "state.npz") as data:
        pn, el = data["pn"].copy(), data["elapsed"].copy()
    pn[0, 1, 1] = -5  # a wrapped lane in the checkpoint
    pn[0, 2, 0] = np.iinfo(np.int64).min
    el[1] = -1
    np.savez(tmp_path / "state.npz", pn=pn, elapsed=el)

    out = []
    for pkg in (JAX, PORT):
        eng = make(pkg, Clock(0))
        try:
            eng.ingest_delta(pkg.wire.from_nanotokens(
                "other", 7 * NANO, 3 * NANO, 9, origin_slot=1, cap_nt=10 * NANO,
                lane_added_nt=7 * NANO, lane_taken_nt=3 * NANO), slot=1)
            assert eng.flush(30)
            pkg.ckpt.restore(str(tmp_path), eng)
            out.append(state_of(eng))
        finally:
            eng.stop()
    assert out[1] == out[0]
    pn_out = np.frombuffer(out[1][3], np.int64).reshape(pn.shape)
    assert pn_out[0, 1, 1] == 3 * NANO  # the engine's value won, not -5
