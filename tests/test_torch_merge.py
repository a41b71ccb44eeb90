"""The scatter-max join of the PyTorch port against the JAX package.

Every entry point of the port's join family — ``merge_batch``,
``merge_batch_folded``, ``merge_rows_dense`` and ``commit_packed`` (whole
or cut at the fold's live counts), all routed through the join kernel's
wrappers (their plain version on a CPU state) — is held bit for bit to
the JAX function of the same name, and ``merge_batch`` also to the
Pallas kernel ``merge_batch_pallas`` run in interpret mode as
``tests/test_pallas_merge.py`` runs it. ``tick_join`` on
``fold_hybrid``'s two halves, staged as the engine stages them, is held
to the JAX package's ``merge_rows_dense`` then ``merge_batch_folded``.
Inputs come from a numpy seed; int64 equality is exact. The plain ops (``merge_scalar_batch``,
``merge_dense``, ``zero_rows``, ``read_rows``) are held to theirs too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from patrol_tpu.models.limiter import LimiterState as JState
from patrol_tpu.ops import commit as jcommit
from patrol_tpu.ops import merge as jmerge
from patrol_tpu.ops import pallas_merge
from patrol_tpu.runtime import engine as jengine_mod
from patrol_tpu.runtime.engine import DeviceEngine as JEngine
from patrol_tpu.runtime.engine import DeltaArrays as JDeltas
from patrol_tpu.runtime.engine import fold_hybrid as j_fold_hybrid
from patrol_tpu_torch.models.limiter import state_from_numpy, state_to_numpy
from patrol_tpu_torch.ops import commit as tcommit
from patrol_tpu_torch.ops import join_kernel
from patrol_tpu_torch.ops import merge as tmerge
from patrol_tpu_torch.runtime import engine as tengine

R = pallas_merge.ROWS_PER_BLOCK
B, N = 4 * R, 8
BIG = 1 << 40  # values past 2^32 exercise the full int64 width


def base_state(rng, zero=False):
    if zero:
        return np.zeros((B, N, 2), np.int64), np.zeros(B, np.int64)
    return (
        rng.integers(0, BIG, size=(B, N, 2), dtype=np.int64),
        rng.integers(0, BIG, size=(B,), dtype=np.int64),
    )


def rand_deltas(rng, k, dup_rows=None):
    rows = rng.integers(0, B, k) if dup_rows is None else rng.choice(dup_rows, k)
    return (
        rows.astype(np.int64),
        rng.integers(0, N, k).astype(np.int64),
        rng.integers(0, 2 * BIG, k).astype(np.int64),
        rng.integers(0, 2 * BIG, k).astype(np.int64),
        rng.integers(0, 2 * BIG, k).astype(np.int64),
    )


def jstate(pn, el):
    return JState(pn=jnp.asarray(pn), elapsed=jnp.asarray(el))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int64))


def assert_planes(tstate, jst):
    tpn, tel = state_to_numpy(tstate)
    np.testing.assert_array_equal(tpn, np.asarray(jst.pn))
    np.testing.assert_array_equal(tel, np.asarray(jst.elapsed))


CASES = {
    "random": dict(k=300),
    "duplicates": dict(k=400, dup_rows=[3, 3, 17, R + 1]),
    "single": dict(k=1),
    "wide": dict(k=2000),
}


@pytest.mark.parametrize("zero_base", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_batch(case, zero_base):
    rng = np.random.default_rng(2 * sorted(CASES).index(case) + zero_base)
    pn, el = base_state(rng, zero_base)
    rows, slots, a, tk, e = rand_deltas(rng, CASES[case]["k"], CASES[case].get("dup_rows"))
    want = jmerge.merge_batch(
        jstate(pn, el),
        jmerge.MergeBatch(
            jnp.asarray(rows, jnp.int32), jnp.asarray(slots, jnp.int32),
            jnp.asarray(a), jnp.asarray(tk), jnp.asarray(e),
        ),
    )
    got = tmerge.merge_batch(
        state_from_numpy(pn, el, "cpu"), tmerge.MergeBatch(t(rows), t(slots), t(a), t(tk), t(e))
    )
    assert_planes(got, want)


@pytest.mark.skipif(not pallas_merge.available(), reason="pallas unavailable")
@pytest.mark.parametrize("seed", [1, 2])
def test_merge_batch_matches_pallas_interpret(seed):
    rng = np.random.default_rng(seed)
    pn, el = base_state(rng, zero=seed == 1)
    rows, slots, a, tk, e = rand_deltas(rng, 300, dup_rows=[0, 5, R, 3 * R + 2] if seed == 2 else None)
    want = pallas_merge.merge_batch_pallas(
        jstate(pn, el), rows, slots, a, tk, e, interpret=True
    )
    got = tmerge.merge_batch(
        state_from_numpy(pn, el, "cpu"), tmerge.MergeBatch(t(rows), t(slots), t(a), t(tk), t(e))
    )
    assert_planes(got, want)


def _folded(rng, k):
    rows, slots, a, tk, e = rand_deltas(rng, k, dup_rows=rng.integers(0, B, k // 4))
    deltas = tengine.DeltaArrays(rows, slots, a, tk, e, np.zeros(k, bool))
    return tengine.pack_folded(*tengine.fold_core(deltas)), deltas


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_merge_batch_folded_with_sentinels(seed):
    rng = np.random.default_rng(seed)
    pn, el = base_state(rng, zero=seed == 3)
    packed, deltas = _folded(rng, 500)
    # The port's fold packs exactly the reference engine's matrix...
    np.testing.assert_array_equal(
        packed, JEngine._fold_lane_merges(JDeltas(*deltas))
    )
    # ...whose FOLD_PAD_ROW sentinel tail the join drops.
    assert (packed[0] >= tmerge.FOLD_PAD_ROW).any()
    want = jmerge.merge_batch_folded(
        jstate(pn, el),
        jmerge.FoldedMergeBatch(
            jnp.asarray(packed[0], jnp.int32), jnp.asarray(packed[1], jnp.int32),
            jnp.asarray(packed[2]), jnp.asarray(packed[3]),
            jnp.asarray(packed[4], jnp.int32), jnp.asarray(packed[5]),
        ),
    )
    got = tmerge.merge_batch_folded(
        state_from_numpy(pn, el, "cpu"), tmerge.FoldedMergeBatch(*t(packed).unbind(0))
    )
    assert_planes(got, want)


@pytest.mark.parametrize("seed", [6, 7])
def test_merge_rows_dense_via_fold_hybrid(seed):
    rng = np.random.default_rng(seed)
    pn, el = base_state(rng, zero=seed == 6)
    # A hot-row storm: few rows, every lane touched, so fold_hybrid
    # splits off a dense batch (and pads it with sentinel rows).
    rows, slots, a, tk, e = rand_deltas(rng, 600, dup_rows=[1, 9, R + 4, B - 1])
    rows[:300] = rng.integers(0, B, 300)
    deltas = tengine.DeltaArrays(rows, slots, a, tk, e, np.zeros(600, bool))
    packed, dense = tengine.fold_hybrid(deltas, N, 4)
    j_packed, j_dense = j_fold_hybrid(JDeltas(*deltas), N, 4)
    assert dense is not None
    np.testing.assert_array_equal(packed, j_packed)
    for x, y in zip(dense, j_dense):
        np.testing.assert_array_equal(x, y)
    d_rows, d_upd, d_el = dense
    want = jmerge.merge_rows_dense(
        jstate(pn, el),
        jmerge.RowDenseBatch(
            jnp.asarray(d_rows, jnp.int32), jnp.asarray(d_upd), jnp.asarray(d_el)
        ),
    )
    got = tmerge.merge_rows_dense(
        state_from_numpy(pn, el, "cpu"), tmerge.RowDenseBatch(t(d_rows), t(d_upd), t(d_el))
    )
    assert_planes(got, want)


@pytest.mark.parametrize("j", [2, 4])
def test_commit_blocks_ring(j):
    rng = np.random.default_rng(20 + j)
    pn, el = base_state(rng)
    block = 64
    rows, slots, a, tk, e = rand_deltas(rng, j * block * 2)
    deltas = tengine.DeltaArrays(rows, slots, a, tk, e, np.zeros(len(rows), bool))
    ur, us, ua, ut, er, ee = tengine.fold_core(deltas)
    ring = tcommit.pack_commit_blocks(ur, us, ua, ut, er, ee, block)
    np.testing.assert_array_equal(
        ring, jcommit.pack_commit_blocks(ur, us, ua, ut, er, ee, block)
    )
    assert tcommit.commit_shape(len(ur), block) == jcommit.commit_shape(len(ur), block)
    want = jcommit.commit_blocks(
        jstate(pn, el),
        jcommit.CommitBlocks(
            jnp.asarray(ring[0], jnp.int32), jnp.asarray(ring[1], jnp.int32),
            jnp.asarray(ring[2]), jnp.asarray(ring[3]),
            jnp.asarray(ring[4], jnp.int32), jnp.asarray(ring[5]),
        ),
    )
    got = tcommit.commit_packed(state_from_numpy(pn, el, "cpu"), t(ring))
    assert_planes(got, want)


def test_merge_scalar_batch_deficit_attribution():
    rng = np.random.default_rng(30)
    pn, el = base_state(rng)
    rows, slots, a, tk, e = rand_deltas(rng, 200, dup_rows=[2, 2, 40])
    a = a * 4  # big aggregates so attribution is often positive
    want = jmerge.merge_scalar_batch(
        jstate(pn, el),
        jmerge.MergeBatch(
            jnp.asarray(rows, jnp.int32), jnp.asarray(slots, jnp.int32),
            jnp.asarray(a), jnp.asarray(tk), jnp.asarray(e),
        ),
    )
    got = tmerge.merge_scalar_batch(
        state_from_numpy(pn, el, "cpu"), tmerge.MergeBatch(t(rows), t(slots), t(a), t(tk), t(e))
    )
    assert_planes(got, want)


def test_merge_dense_zero_and_read_rows():
    rng = np.random.default_rng(31)
    pn, el = base_state(rng)
    pn2, el2 = base_state(rng)
    want = jmerge.merge_dense(jstate(pn, el), jstate(pn2, el2))
    got = tmerge.merge_dense(
        state_from_numpy(pn, el, "cpu"), state_from_numpy(pn2, el2, "cpu")
    )
    assert_planes(got, want)
    zr = np.array([0, 5, 5, B - 1], np.int64)
    want = jmerge.zero_rows(want, jnp.asarray(zr, jnp.int32))
    got = tmerge.zero_rows(got, t(zr))
    assert_planes(got, want)
    rr = np.array([1, 5, 77], np.int64)
    jr = jmerge.read_rows(want, jnp.asarray(rr, jnp.int32))
    tr = tmerge.read_rows(got, t(rr))
    np.testing.assert_array_equal(tr.pn.numpy(), np.asarray(jr.pn))
    np.testing.assert_array_equal(tr.elapsed.numpy(), np.asarray(jr.elapsed))


def test_out_of_range_entries_dropped_not_clamped():
    pn = np.zeros((8, 2, 2), np.int64)
    el = np.zeros(8, np.int64)
    st = state_from_numpy(pn, el, "cpu")
    rows = t([tmerge.FOLD_PAD_ROW, 8, -1, 3, 3])
    slots = t([0, 0, 0, 2, 1])
    vals = t([9, 9, 9, 9, 5])
    join_kernel.pair_join(st.pn, st.elapsed, rows, slots, vals, vals, rows, vals)
    tpn, tel = state_to_numpy(st)
    assert tpn.sum() == 10 and tpn[3, 1].tolist() == [5, 5]
    # Elapsed entries are keyed by row only: row 3 keeps its max (9).
    assert tel.tolist() == [0, 0, 0, 9, 0, 0, 0, 0]


def test_join_wrappers_reject_bad_operands():
    st = state_from_numpy(np.zeros((4, 2, 2), np.int64), np.zeros(4, np.int64), "cpu")
    i32 = torch.zeros(3, dtype=torch.int32)
    i64 = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(TypeError):
        join_kernel.pair_join(st.pn, st.elapsed, i32, i64, i64, i64, i64, i64)
    with pytest.raises(ValueError):
        join_kernel.pair_join(st.pn, st.elapsed, i64, i64[:2], i64, i64, i64, i64)
    with pytest.raises(ValueError):
        join_kernel.row_join(st.pn, st.elapsed, i64, torch.zeros((3, 3, 2), dtype=torch.int64), i64)


def _hybrid_deltas(rng, n_dense):
    """A tick whose fold holds ``n_dense`` dense rows (every lane touched,
    some twice) and sparse rows touching fewer than 4 lanes each."""
    pool = rng.permutation(B)
    dense_rows, sparse_rows = pool[:n_dense], pool[n_dense:n_dense + 300]
    rows = [np.repeat(dense_rows, N + 2)]
    slots = [np.concatenate([rng.permutation(N), rng.integers(0, N, 2)]) for _ in dense_rows]
    for r in sparse_rows:
        lanes = rng.choice(N, int(rng.integers(1, 4)), replace=False)
        rows.append(np.full(len(lanes) + 1, r))
        slots.append(np.append(lanes, lanes[0]))  # one duplicate key a row
    rows = np.concatenate(rows).astype(np.int64)
    slots = np.concatenate(slots).astype(np.int64) if slots else np.zeros(0, np.int64)
    k = len(rows)
    vals = rng.integers(0, 2 * BIG, size=(3, k))
    return tengine.DeltaArrays(rows, slots, vals[0], vals[1], vals[2], np.zeros(k, bool))


@pytest.mark.parametrize("n_dense", [0, 1, 512])
def test_tick_join_on_fold_hybrid(n_dense):
    """One tick_join over fold_hybrid's two halves, staged in one lease
    and cut to their live prefixes as the engine does, against the JAX
    package's merge_rows_dense then merge_batch_folded on the padded
    arrays."""
    rng = np.random.default_rng(40 + n_dense)
    pn, el = base_state(rng)
    deltas = _hybrid_deltas(rng, n_dense)
    packed, dense = tengine.fold_hybrid(deltas, N, 4)
    j_packed, j_dense = j_fold_hybrid(JDeltas(*deltas), N, 4)
    np.testing.assert_array_equal(packed, j_packed)
    assert (dense is None) == (n_dense == 0) and (j_dense is None) == (n_dense == 0)
    want = jstate(pn, el)
    if dense is not None:
        for x, y in zip(dense, j_dense):
            np.testing.assert_array_equal(x, y)
        assert (dense[0] < tmerge.FOLD_PAD_ROW).sum() == n_dense
        want = jmerge.merge_rows_dense(
            want, jmerge.RowDenseBatch(
                jnp.asarray(dense[0], jnp.int32), jnp.asarray(dense[1]),
                jnp.asarray(dense[2]),
            ),
        )
    want = jmerge.merge_batch_folded(
        want, jmerge.FoldedMergeBatch(
            jnp.asarray(packed[0], jnp.int32), jnp.asarray(packed[1], jnp.int32),
            jnp.asarray(packed[2]), jnp.asarray(packed[3]),
            jnp.asarray(packed[4], jnp.int32), jnp.asarray(packed[5]),
        ),
    )
    eng = tengine.DeviceEngine(tengine.LimiterConfig(B, N), device="cpu")
    try:
        d_live, p_live = eng._stage_tick(packed, dense)
    finally:
        eng.stop()
    assert (d_live is None) == (n_dense == 0)
    if d_live is not None:
        assert d_live[0].numel() == n_dense
    assert (p_live[0] < B).all() and (p_live[4] < B).all()
    got = state_from_numpy(pn, el, "cpu")
    join_kernel.tick_join(got.pn, got.elapsed, d_live, p_live)
    assert_planes(got, want)


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("j", [1, 2, 8])
def test_commit_packed_live_counts(j, live):
    """commit_packed on a J-block ring, whole or cut at the fold's live
    counts, against the JAX engine's commit_packed."""
    rng = np.random.default_rng(60 + 2 * j + live)
    pn, el = base_state(rng)
    block = 32
    rows, slots, a, tk, e = rand_deltas(rng, j * block - block // 2 if j > 1 else 20)
    deltas = tengine.DeltaArrays(rows, slots, a, tk, e, np.zeros(len(rows), bool))
    ur, us, ua, ut, er, ee = tengine.fold_core(deltas)
    ring = tcommit.pack_commit_blocks(ur, us, ua, ut, er, ee, block)
    assert ring.shape == (6, j, block)
    want = jengine_mod._jit_commit_packed()(jstate(pn, el), jnp.asarray(ring))
    counts = (len(ur), len(er)) if live else (None, None)
    got = tcommit.commit_packed(state_from_numpy(pn, el, "cpu"), t(ring), *counts)
    assert_planes(got, want)


@pytest.mark.parametrize("which", ["pairs", "elapsed"])
def test_live_count_past_a_live_entry_raises(which):
    rng = np.random.default_rng(70)
    rows, slots, a, tk, e = rand_deltas(rng, 40)
    deltas = tengine.DeltaArrays(rows, slots, a, tk, e, np.zeros(40, bool))
    ur, us, ua, ut, er, ee = tengine.fold_core(deltas)
    ring = t(tcommit.pack_commit_blocks(ur, us, ua, ut, er, ee, 64))
    st = state_from_numpy(*base_state(rng), "cpu")
    n, ne = (len(ur) - 1, len(er)) if which == "pairs" else (len(ur), len(er) - 1)
    with pytest.raises(ValueError, match="past the live count"):
        tcommit.commit_packed(st, ring, n, ne)
    tcommit.commit_packed(st, ring, len(ur), len(er))


def test_tick_join_exact_for_duplicate_keys():
    """Duplicate pair keys, duplicate elapsed rows and a dense row that is
    also in the pair half (which the fold never sends) still join
    exactly: against the JAX package's merge_rows_dense then merge_batch."""
    rng = np.random.default_rng(71)
    pn, el = base_state(rng)
    rows, slots, a, tk, e = rand_deltas(rng, 300, dup_rows=[2, 2, 9, R + 3])
    d_rows = np.array([9, 40, R + 3], np.int64)
    d_upd = rng.integers(0, 2 * BIG, size=(3, N, 2))
    d_el = rng.integers(0, 2 * BIG, 3)
    want = jmerge.merge_rows_dense(
        jstate(pn, el),
        jmerge.RowDenseBatch(jnp.asarray(d_rows, jnp.int32), jnp.asarray(d_upd), jnp.asarray(d_el)),
    )
    want = jmerge.merge_batch(
        want, jmerge.MergeBatch(
            jnp.asarray(rows, jnp.int32), jnp.asarray(slots, jnp.int32),
            jnp.asarray(a), jnp.asarray(tk), jnp.asarray(e),
        ),
    )
    got = state_from_numpy(pn, el, "cpu")
    join_kernel.tick_join(
        got.pn, got.elapsed, (t(d_rows), t(d_upd), t(d_el)),
        (t(rows), t(slots), t(a), t(tk), t(rows), t(e)),
    )
    assert_planes(got, want)


_I32 = torch.zeros(3, dtype=torch.int32)
_I64 = torch.zeros(3, dtype=torch.int64)
_TICK_BAD = {
    "dense_int32_rows": (TypeError, (_I32, torch.zeros((3, 2, 2), dtype=torch.int64), _I64), None),
    "dense_wrong_width": (ValueError, (_I64, torch.zeros((3, 3, 2), dtype=torch.int64), _I64), None),
    "dense_short_evals": (ValueError, (_I64, torch.zeros((3, 2, 2), dtype=torch.int64), _I64[:2]), None),
    "dense_two_operands": (ValueError, (_I64, _I64), None),
    "pairs_int32_slots": (TypeError, None, (_I64, _I32, _I64, _I64, _I64, _I64)),
    "pairs_ragged": (ValueError, None, (_I64, _I64[:2], _I64, _I64, _I64, _I64)),
    "pairs_ragged_elapsed": (ValueError, None, (_I64, _I64, _I64, _I64, _I64, _I64[:1])),
    "pairs_noncontiguous": (ValueError, None, (_I64, _I64, _I64, _I64, torch.zeros(6, dtype=torch.int64)[::2], _I64)),
    "pairs_five_operands": (ValueError, None, (_I64, _I64, _I64, _I64, _I64)),
}


@pytest.mark.parametrize("case", sorted(_TICK_BAD))
def test_tick_join_rejects_bad_operands(case):
    err, dense, pairs = _TICK_BAD[case]
    st = state_from_numpy(np.zeros((4, 2, 2), np.int64), np.zeros(4, np.int64), "cpu")
    with pytest.raises(err):
        join_kernel.tick_join(st.pn, st.elapsed, dense, pairs)


# Negative and out-of-range indices (ROADMAP C1): a JAX scatter wraps a
# row in [-B, 0) and a slot in [-N, 0), numpy style, and drops the rest;
# its gather wraps, then clamps. Every (row, slot) pair of these sets
# goes through each wrapper against the JAX function of the same name.
EDGE_ROWS = [-B - 1, -1, 0, B - 1, B, tmerge.FOLD_PAD_ROW]
EDGE_SLOTS = [-N - 1, -1, 0, N - 1, N]
EDGE_PAIRS = [(r, s) for r in EDGE_ROWS for s in EDGE_SLOTS]


def _edge_values(rng, k):
    return (rng.integers(1, 2 * BIG, k).astype(np.int64) for _ in range(3))


def _j32(a):
    return jnp.asarray(np.asarray(a), jnp.int32)


@pytest.mark.parametrize("zero_base", [True, False])
@pytest.mark.parametrize("fn", ["merge_batch", "merge_scalar_batch", "delta_fold"])
def test_negative_indices_wrap_like_the_reference(fn, zero_base):
    from patrol_tpu.ops import delta as jdelta
    from patrol_tpu_torch.ops import delta as tdelta

    rng = np.random.default_rng(40 + zero_base)
    pn, el = base_state(rng, zero_base)
    rows = np.array([r for r, _ in EDGE_PAIRS], np.int64)
    slots = np.array([s for _, s in EDGE_PAIRS], np.int64)
    a, tk, e = _edge_values(rng, len(rows))
    if fn == "merge_scalar_batch":
        a = a * 4  # big aggregates, so attribution is often positive
    jargs = (_j32(rows), _j32(slots), jnp.asarray(a), jnp.asarray(tk), jnp.asarray(e))
    targs = (t(rows), t(slots), t(a), t(tk), t(e))
    if fn == "delta_fold":
        want = jdelta.delta_fold(jstate(pn, el), jdelta.DeltaBatch(*jargs))
        got = tdelta.delta_fold(state_from_numpy(pn, el, "cpu"), tdelta.DeltaBatch(*targs))
    else:
        want = getattr(jmerge, fn)(jstate(pn, el), jmerge.MergeBatch(*jargs))
        got = getattr(tmerge, fn)(state_from_numpy(pn, el, "cpu"), tmerge.MergeBatch(*targs))
    assert_planes(got, want)
    if zero_base and fn != "merge_scalar_batch":
        # Non-vacuous: the wrapped entries landed where the reference put
        # them (row -1 is row B - 1, slot -1 is slot N - 1).
        tpn, tel = state_to_numpy(got)
        assert tpn[B - 1, N - 1].any() and tel[B - 1] > 0


@pytest.mark.parametrize("row,slot", EDGE_PAIRS)
def test_merge_batch_folded_negative_indices(row, slot):
    # One live entry a call: the reference promises unique, sorted keys.
    rng = np.random.default_rng(50)
    pn, el = base_state(rng)
    a, tk, e = _edge_values(rng, 1)
    packed = np.array([[row, tmerge.FOLD_PAD_ROW], [slot, 1], [a[0], 0], [tk[0], 0],
                       [row, tmerge.FOLD_PAD_ROW], [e[0], 0]], np.int64)
    want = jmerge.merge_batch_folded(
        jstate(pn, el),
        jmerge.FoldedMergeBatch(
            _j32(packed[0]), _j32(packed[1]), jnp.asarray(packed[2]),
            jnp.asarray(packed[3]), _j32(packed[4]), jnp.asarray(packed[5]),
        ),
    )
    got = tmerge.merge_batch_folded(
        state_from_numpy(pn, el, "cpu"), tmerge.FoldedMergeBatch(*t(packed).unbind(0))
    )
    assert_planes(got, want)


@pytest.mark.parametrize("row", EDGE_ROWS)
def test_merge_rows_dense_negative_rows(row):
    rng = np.random.default_rng(51)
    pn, el = base_state(rng)
    upd = rng.integers(0, 2 * BIG, size=(1, N, 2), dtype=np.int64)
    e = rng.integers(0, 2 * BIG, size=1, dtype=np.int64)
    want = jmerge.merge_rows_dense(
        jstate(pn, el), jmerge.RowDenseBatch(_j32([row]), jnp.asarray(upd), jnp.asarray(e))
    )
    got = tmerge.merge_rows_dense(
        state_from_numpy(pn, el, "cpu"), tmerge.RowDenseBatch(t([row]), t(upd), t(e))
    )
    assert_planes(got, want)


def test_zero_rows_drops_and_read_rows_clamps_like_the_reference():
    rng = np.random.default_rng(52)
    pn, el = base_state(rng)
    rows = np.array(EDGE_ROWS, np.int64)
    jr = jmerge.read_rows(jstate(pn, el), _j32(rows))
    tr = tmerge.read_rows(state_from_numpy(pn, el, "cpu"), t(rows))
    np.testing.assert_array_equal(tr.pn.numpy(), np.asarray(jr.pn))
    np.testing.assert_array_equal(tr.elapsed.numpy(), np.asarray(jr.elapsed))
    # Row B clamps to B - 1 and -B - 1 to 0, as the reference's gather does.
    np.testing.assert_array_equal(tr.pn.numpy()[4], pn[B - 1])
    want = jmerge.zero_rows(jstate(pn, el), _j32(rows))
    got = tmerge.zero_rows(state_from_numpy(pn, el, "cpu"), t(rows))
    assert_planes(got, want)
    tpn, _ = state_to_numpy(got)
    assert not tpn[B - 1].any() and not tpn[0].any() and tpn[1:B - 1].any()
    # zero_rows takes host rows (ROADMAP C8): a numpy array, a list or a
    # CPU tensor, with wraps ([-B, 0)), drops (everything else out of
    # range) and duplicates, each against the reference.
    mixed = np.array([-B, -1, 3, 3, 7, B, -B - 1, tmerge.FOLD_PAD_ROW, 5, -1], np.int64)
    want = jmerge.zero_rows(jstate(pn, el), _j32(mixed))
    for host_rows in (mixed, mixed.tolist(), t(mixed), mixed.astype(np.int32)):
        got = tmerge.zero_rows(state_from_numpy(pn, el, "cpu"), host_rows)
        assert_planes(got, want)
    untouched = state_from_numpy(pn, el, "cpu")
    tmerge.zero_rows(untouched, np.array([B, -B - 1], np.int64))  # all dropped
    assert_planes(untouched, jstate(pn, el))
    with pytest.raises(ValueError):
        tmerge.zero_rows(state_from_numpy(pn, el, "cpu"), t(mixed).to("meta"))


@pytest.mark.cuda
def test_zero_rows_on_the_card_waits_for_nothing():
    """On a CUDA state zero_rows ships its host rows and fills, and never
    synchronizes: it runs clean under torch's sync detector, and equals
    the CPU result."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels do not run on the CPU")
    rng = np.random.default_rng(53)
    pn, el = base_state(rng)
    rows = np.array([-B, -1, 3, 3, B, tmerge.FOLD_PAD_ROW], np.int64)
    dev = state_from_numpy(pn, el, "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tmerge.zero_rows(dev, rows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = tmerge.zero_rows(state_from_numpy(pn, el, "cpu"), rows)
    got_pn, got_el = state_to_numpy(dev)
    np.testing.assert_array_equal(got_pn, want.pn.numpy())
    np.testing.assert_array_equal(got_el, want.elapsed.numpy())
