"""Take-n in the PyTorch port against the JAX package, bit for bit.

The same packed requests and base state, made from a numpy seed, go
through ``patrol_tpu.ops.take.take_n_batch`` (JAX on the CPU, x64, jitted
as the engine runs it) and ``patrol_tpu_torch.ops.take.take_n_batch`` on a
CPU state (the take-n kernel's plain version). Results and final state
must be equal as int64 — no tolerance. The hazard cases of the CUDA kernel
(padding rows aliasing a live row 0, floor division of negative balances,
the fp64 refill) each have a case here; the kernel itself is held to the
plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from patrol_tpu.models.limiter import LimiterState as JState
from patrol_tpu.ops import take as jtake
from patrol_tpu_torch.models.limiter import (
    NANO,
    state_from_numpy,
    state_to_numpy,
)
from patrol_tpu_torch.ops import take as ttake
from patrol_tpu_torch.ops import take_kernel

B, N = 64, 4


def run_both(pn, el, packed, node_slot):
    """→ ((jax_out, jax_pn, jax_el), (port_out, port_pn, port_el))."""
    js = JState(pn=jnp.asarray(pn), elapsed=jnp.asarray(el))
    js, jout = jtake.take_n_batch_jit(js, jnp.asarray(packed), node_slot)
    ts = state_from_numpy(pn, el, device="cpu")
    ts, tout = ttake.take_n_batch(ts, torch.from_numpy(packed.copy()), node_slot)
    tpn, tel = state_to_numpy(ts)
    return (
        (np.asarray(jout), np.asarray(js.pn), np.asarray(js.elapsed)),
        (tout.numpy(), tpn, tel),
    )


def assert_same(pn, el, packed, node_slot=1):
    """Live columns (nreq > 0) equal the reference's; a column that
    requests nothing is all zeros in the port (the reference computes it
    from the aliased row, which the engine never reads)."""
    (jo, jp, je), (to, tp, te) = run_both(pn, el, packed, node_slot)
    assert to.dtype == np.int64 and to.shape == (7, packed.shape[1])
    live = packed[5] > 0
    np.testing.assert_array_equal(to[:, live], jo[:, live])
    assert (to[:, ~live] == 0).all()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(te, je)
    return jo


def random_state(rng, lo=0, hi=10 * NANO):
    pn = rng.integers(lo, hi, size=(B, N, 2), dtype=np.int64)
    el = rng.integers(0, 50 * NANO, size=(B,), dtype=np.int64)
    return pn, el


def random_packed(rng, k, *, live=None):
    """K request rows over the small domains of test_take_coalesce.py;
    rows with nreq > 0 are unique, the rest are padding-like."""
    p = np.zeros((8, k), np.int64)
    rows = rng.permutation(B)[:k]
    p[0] = rows
    p[1] = rng.choice([0, NANO, 1000 * NANO, 1000 * NANO + NANO // 2, 10**12 + 7], k)
    p[2] = rng.choice([0, 1, 3, 10, 1000], k)
    p[3] = rng.choice([0, 1, NANO, 3 * NANO + 1, 60 * NANO], k)
    p[4] = rng.choice([-NANO, 0, NANO, 2 * NANO, 3 * NANO + 1], k)
    p[5] = rng.integers(0, 6, k) if live is None else live
    p[6] = rng.choice([0, NANO, 10 * NANO, 3 * NANO + 5], k)
    p[7] = rng.choice([0, NANO, 999 * NANO, 10**12], k)
    return p


@pytest.mark.parametrize("seed", range(6))
def test_random_small_domains(seed):
    rng = np.random.default_rng(seed)
    pn, el = random_state(rng)
    assert_same(pn, el, random_packed(rng, 32), node_slot=seed % N)


@pytest.mark.parametrize("seed", range(3))
def test_negative_balances_floor_division(seed):
    # Merges can push TAKEN past ADDED: tokens and `have` go negative, and
    # have // count must floor (C's `/` would truncate toward zero).
    rng = np.random.default_rng(100 + seed)
    pn, el = random_state(rng)
    pn[:, :, 1] += rng.integers(0, 40 * NANO, size=(B, N))
    p = random_packed(rng, 32)
    p[4] = rng.choice([NANO, 2 * NANO, 3 * NANO + 1, 7], 32)
    out = assert_same(pn, el, p)
    assert (out[0] < 0).any()  # the case is non-vacuous


def test_forfeit_clamp_over_capacity():
    # Merges push tokens above capacity: the grant is negative (cap -
    # tokens) and is booked as extra TAKEN, so both lanes stay monotone.
    pn = np.zeros((B, N, 2), np.int64)
    el = np.zeros(B, np.int64)
    pn[5, 2, 0] = 30 * NANO  # a peer's grants: 30 tokens on a 10-cap bucket
    p = np.zeros((8, 2), np.int64)
    p[:, 0] = [5, 100 * NANO, 10, NANO, NANO, 3, 10 * NANO, 0]
    p[:, 1] = [6, 100 * NANO, 10, NANO, NANO, 0, 10 * NANO, 0]
    out = assert_same(pn, el, p)
    assert out[1, 0] == 3


@pytest.mark.parametrize("freq,per", [(0, NANO), (5, 0), (10, 3), (0, 0)])
def test_zero_rates(freq, per):
    # freq == 0, per == 0 and per // freq == 0 all mean "no refill".
    rng = np.random.default_rng(7)
    pn, el = random_state(rng)
    p = random_packed(rng, 16)
    p[2], p[3] = freq, per
    assert_same(pn, el, p)


@pytest.mark.parametrize("count_nt", [0, -NANO, -1])
def test_nonpositive_count_admits_nothing(count_nt):
    rng = np.random.default_rng(8)
    pn, el = random_state(rng)
    p = random_packed(rng, 16)
    p[4] = count_nt
    out = assert_same(pn, el, p)
    assert (out[1] == 0).all()


def test_padding_rows_alias_live_row_zero():
    # The engine zeroes the request matrix: padding rows are (row 0,
    # nreq 0) and row 0 may be live in the same tick. Padding must not
    # disturb the live row's commit; it reads no state and yields zeros.
    pn = np.zeros((B, N, 2), np.int64)
    el = np.zeros(B, np.int64)
    p = np.zeros((8, 8), np.int64)
    p[:, 3] = [0, 1000 * NANO, 10, NANO, NANO, 4, 10 * NANO, 999 * NANO]
    p[:, 5] = [9, 1000 * NANO, 3, NANO, NANO, 1, 3 * NANO, 0]
    out = assert_same(pn, el, p)
    assert out[1, 3] == 4 and out[1, 5] == 1
    assert (out[1, [0, 1, 2, 4, 6, 7]] == 0).all()
    (_, jp, je), (to, tp, te) = run_both(pn, el, p, 1)
    assert (to[:, [0, 1, 2, 4, 6, 7]] == 0).all()
    assert tp[0, 1, 1] == jp[0, 1, 1] == 4 * NANO and te[0] == je[0]


def test_out_of_range_and_negative_rows():
    # Rows are cast to int32; negative rows wrap by B, the gather clamps
    # and the commit drops out-of-range rows — the reference's indexing.
    # Rows read: 62, 63 (clamped), 0 (clamped), 2, 7, 8 — no committing
    # row is read by another column.
    rng = np.random.default_rng(9)
    pn, el = random_state(rng)
    p = random_packed(rng, 6, live=np.array([2, 1, 3, 2, 1, 1]))
    p[0] = [-2, B + 3, -(B + 5), (1 << 32) + 2, 7, 8]
    p[2], p[3], p[4] = 10, NANO, NANO
    assert_same(pn, el, p)


def _fp64_corpus():
    """Adversarial (delta, interval) pairs for the fp64 refill: quotients
    within one ulp of an integer, interval 1, huge deltas and odd
    intervals that make delta / interval * 1e9 round in both directions."""
    rng = np.random.default_rng(11)
    pairs = []
    for interval in (1, 3, 7, 1_000_003, 999_999_937, 10**12 + 39, (1 << 40) + 1):
        for m in (1, 3, 10**6 + 1, 10**9 + 7):
            for eps in (-1, 0, 1):
                d = m * interval + eps
                if 0 <= d < (1 << 62):
                    pairs.append((d, interval))
    for _ in range(40):
        interval = int(rng.integers(1, 1 << 45))
        d = int(rng.integers(0, 1 << 62))
        pairs.append((d, interval))
    pairs.append(((1 << 62) - 1, 1))
    pairs.append(((1 << 62) + 12345, 3))
    return pairs


@pytest.mark.parametrize("chunk", range(4))
def test_fp64_refill_corpus(chunk):
    pairs = _fp64_corpus()[chunk::4]
    k = len(pairs)
    pn = np.zeros((B, N, 2), np.int64)
    el = np.zeros(B, np.int64)
    # A deep debit on every row keeps `missing` huge, so the raw grant
    # (not the capacity cap) shows in `have`.
    pn[:, 0, 1] = 1 << 61
    p = np.zeros((8, k), np.int64)
    p[0] = np.arange(k) % B
    p[1] = [d for d, _ in pairs]  # now = delta (created 0, elapsed 0)
    p[2] = 1  # freq 1 ⇒ interval = per
    p[3] = [i for _, i in pairs]
    p[4] = NANO
    p[5] = 1  # the deep debit admits nothing: every row reads base state
    out = assert_same(pn, el, p)
    grant = out[0] + (1 << 61)
    assert len(set(grant.tolist())) > k // 2  # non-vacuous spread


def _lane_width_cases():
    """(N, node_slot): lane widths around the kernel's 32-lane warp, the
    own lane first, last and, past 32, in the second pass of the warp."""
    cases = []
    for n in (1, 31, 32, 33, 64, 65):
        for slot in sorted({0, n - 1} | ({32} if n > 32 else set())):
            cases.append((n, slot))
    return cases


@pytest.mark.parametrize("n,node_slot", _lane_width_cases())
def test_lane_widths(n, node_slot):
    # The kernel gives each live column a warp that loads lane pairs
    # l, l + 32, ... and takes the own lane from the lane that loaded it;
    # every N and own-lane position must give the reference's results.
    rng = np.random.default_rng(1000 + 97 * n + node_slot)
    pn = rng.integers(0, 10 * NANO, size=(B, n, 2), dtype=np.int64)
    pn[::3, :, 1] += rng.integers(0, 20 * NANO, size=(len(pn[::3]), n))  # debits
    el = rng.integers(0, 50 * NANO, size=(B,), dtype=np.int64)
    p = random_packed(rng, 40)
    p[2], p[3] = 10, NANO  # a live rate, so some columns admit
    p[4] = rng.choice([NANO // 4, NANO // 2, NANO], 40)
    p[0] = rng.permutation(np.arange(1, B))[:40]  # live rows stay unique
    p[0, :5] = 0  # padding columns alias row 0, which is live beside them
    p[5, :4] = 0
    p[5, 4] = 3
    out = assert_same(pn, el, p, node_slot)
    assert (out[1] >= 1).sum() > 5 and (out[1] == 0).sum() > 3  # non-vacuous


def test_unpacked_take_batch_matches_packed():
    rng = np.random.default_rng(12)
    pn, el = random_state(rng)
    p = random_packed(rng, 16)
    ts = state_from_numpy(pn, el, device="cpu")
    req = ttake.TakeRequest(*torch.from_numpy(p.copy()).unbind(0))
    _, res = ttake.take_batch(ts, req, 2)
    _, (to, _, _) = run_both(pn, el, p, 2)
    np.testing.assert_array_equal(torch.stack(list(res)).numpy(), to)
    assert_same(pn, el, p, 2)


def test_split_grant_matches_reference():
    for have in (-NANO, 0, NANO // 2, 3 * NANO, 5 * NANO + 7):
        for count in (NANO, 2 * NANO, 3 * NANO + 1):
            for nreq in range(6):
                for admitted in range(nreq + 1):
                    assert ttake.split_grant(have, admitted, count, nreq) == (
                        jtake.split_grant(have, admitted, count, nreq)
                    )


def test_wrapper_rejects_bad_operands():
    ts = state_from_numpy(np.zeros((4, 2, 2), np.int64), np.zeros(4, np.int64), "cpu")
    with pytest.raises(TypeError):
        take_kernel.take_n(ts.pn, ts.elapsed, torch.zeros((8, 2), dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        take_kernel.take_n(ts.pn, ts.elapsed, torch.zeros((7, 2), dtype=torch.int64), 0)
    with pytest.raises(ValueError):
        take_kernel.take_n(ts.pn, ts.elapsed, torch.zeros((8, 2), dtype=torch.int64), 2)
