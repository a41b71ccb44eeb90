"""The certified families in the PyTorch port against the JAX package,
bit for bit.

Every case of ``tests/test_cert_kernels.py``'s ``TestGcra``,
``TestConcurrency`` and ``TestHierQuota`` runs through the JAX function
(``patrol_tpu.ops.gcra.gcra_take_batch`` and its siblings, JAX on the CPU)
and the port's (``patrol_tpu_torch.ops.gcra.gcra_take_batch`` on a CPU
state, which runs the plain version) on the same numpy inputs; results
and planes must be equal as int64, tolerance 0, and the case's own
assertions hold on the port. A seeded differential at B = 64 and N in
{1, 2, 33}, the own lane first and last, feeds both the hazards the CUDA
kernels are built around: repeated rows and padding columns aliasing live
ones, shared tenant and global rows (and one row at two levels),
out-of-range and negative rows, zero and negative ``nreq``, ``count`` and
``T``, releases above the held amount, lanes near 2^63 and wrapping
products; again at N in {1, 31, 33} with rows whose every TAKEN lane lies
near -2^63, and GCRA columns that repeat a row with different ``now``,
``T`` and ``nreq``. Then the engines: the port's ``DeviceEngine(device="cpu")`` and
the JAX ``DeviceEngine`` take the same ``gcra_take`` / ``conc_acquire`` /
``quota_take`` sequences (the bench's cert leg, 15 / 21 / 8, scalar
arguments broadcast across K) with equal results and planes. The kernels
themselves (``csrc/cert.cu``) are held to the plain versions on the card
by the ``cuda``-marked test here and by ``chip_smoke.py``.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from patrol_tpu.models.limiter import LimiterConfig as JConfig
from patrol_tpu.models.limiter import LimiterState as JState
from patrol_tpu.ops import concurrency as jconc
from patrol_tpu.ops import gcra as jgcra
from patrol_tpu.ops import hierquota as jquota
from patrol_tpu.runtime.engine import DeviceEngine as JEngine
from patrol_tpu_torch.models.limiter import ADDED, TAKEN, LimiterConfig, LimiterState
from patrol_tpu_torch.ops import _build, cert_kernel
from patrol_tpu_torch.ops import concurrency as tconc
from patrol_tpu_torch.ops import gcra as tgcra
from patrol_tpu_torch.ops import hierquota as tquota
from patrol_tpu_torch.runtime.engine import DeviceEngine

SLOT = 0
REMOTE = 1

# family → (JAX module, JAX batch fn, port module, port batch fn, row fields)
FAMILIES = {
    "gcra": (jgcra, jgcra.gcra_take_batch, tgcra, tgcra.gcra_take_batch, 1),
    "conc": (jconc, jconc.conc_acquire_batch, tconc, tconc.conc_acquire_batch, 1),
    "quota": (jquota, jquota.quota_take_batch, tquota, tquota.quota_take_batch, 3),
}
REQUEST = {"gcra": "GcraRequest", "conc": "ConcRequest", "quota": "QuotaRequest"}


class Twin:
    """One state in both packages; every call runs on both and must agree."""

    def __init__(self, pn):
        pn = np.asarray(pn, np.int64)
        b = pn.shape[0]
        self.j = JState(pn=jnp.asarray(pn), elapsed=jnp.zeros(b, jnp.int64))
        self.t = LimiterState(torch.from_numpy(pn.copy()), torch.zeros(b, dtype=torch.int64))

    @property
    def pn(self):
        return self.t.pn.numpy()

    def call(self, family, fields, slot=SLOT):
        """``fields``: the request's columns in field order (rows first).
        → the port's result as numpy int64 arrays."""
        jmod, jfn, tmod, tfn, nrows = FAMILIES[family]
        cols = [np.asarray(f, np.int32 if i < nrows else np.int64) for i, f in enumerate(fields)]
        jreq = getattr(jmod, REQUEST[family])(*(jnp.asarray(c) for c in cols))
        treq = getattr(tmod, REQUEST[family])(*(torch.from_numpy(c.copy()) for c in cols))
        self.j, jres = jfn(self.j, jreq, slot)
        self.t, tres = tfn(self.t, treq, slot)
        assert type(tres).__name__ == type(jres).__name__ and tres._fields == jres._fields
        for name, a, b in zip(tres._fields, jres, tres):
            assert b.dtype == torch.int64, name
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{family} {name}")
        np.testing.assert_array_equal(self.pn, np.asarray(self.j.pn), err_msg=f"{family} planes")
        return type(tres)(*(x.numpy() for x in tres))


def _zeros(buckets=32, nodes=4):
    return np.zeros((buckets, nodes, 2), np.int64)


def gcra(twin, rows, now, t=100, tol=300, nreq=10):
    k = len(rows)
    return twin.call("gcra", [rows, [now] * k, [t] * k, [tol] * k, [nreq] * k])


def conc(twin, rows, limit=5, count=1, nreq=0, releases=0):
    k = len(rows)
    return twin.call("conc", [rows, [limit] * k, [count] * k, [nreq] * k, [releases] * k])


def quota(twin, g, t, u, limits=(10, 6, 4), count=1, nreq=5):
    k = len(u)
    return twin.call("quota", [g, t, u, *([lim] * k for lim in limits), [count] * k, [nreq] * k])


class TestGcra:
    def test_burst_equals_window_capacity(self):
        tw = Twin(_zeros())
        res = gcra(tw, [3], now=0)
        assert (res.admitted[0], res.own_tat_ns[0], res.tat_ns[0], res.allow_at_ns[0]) == (
            4, 400, 400, 100)
        assert tw.pn[3, SLOT, TAKEN] == 400

    def test_sequential_replay_equivalence(self):
        def replay(tat, now, t, tol, nreq):
            k = 0
            for _ in range(nreq):
                if tat <= now + tol:
                    tat = max(tat, now) + t
                    k += 1
            return k, tat

        tw, tat = Twin(_zeros()), 0
        for now in (0, 150, 151, 700, 700, 4000):
            want_k, tat = replay(tat, now, 100, 300, 3)
            res = gcra(tw, [5], now=now, nreq=3)
            assert res.admitted[0] == want_k, now
            assert tw.pn[5, SLOT, TAKEN] == tat, now

    def test_remote_watermark_denies(self):
        pn = _zeros()
        pn[3, REMOTE, TAKEN] = 1000
        tw = Twin(pn)
        res = gcra(tw, [3], now=0)
        assert (res.admitted[0], res.tat_ns[0], tw.pn[3, SLOT, TAKEN]) == (0, 1000, 0)

    def test_padding_rows_commit_nothing(self):
        tw = Twin(_zeros())
        res = gcra(tw, [3, 3], now=0, nreq=0)  # duplicate rows, nreq=0
        assert res.admitted.tolist() == [0, 0]
        assert not tw.pn.any()

    def test_nonpositive_emission_admits_nothing(self):
        tw = Twin(_zeros())
        res = tw.call("gcra", [[1], [0], [0], [300], [5]])
        assert res.admitted[0] == 0 and not tw.pn.any()

    def test_commit_is_monotone(self):
        pn = _zeros()
        pn[7, SLOT, TAKEN] = 250
        tw = Twin(pn)
        gcra(tw, [7], now=500)
        assert (tw.pn >= pn).all()


class TestConcurrency:
    def test_acquires_saturate_at_the_limit(self):
        tw = Twin(_zeros())
        res = conc(tw, [2], nreq=8)
        assert (res.admitted[0], res.inflight_nt[0]) == (5, 5)
        assert (tw.pn[2, SLOT, TAKEN], tw.pn[2, SLOT, ADDED]) == (5, 0)

    def test_release_applies_before_acquire(self):
        tw = Twin(_zeros())
        conc(tw, [2], nreq=8)
        res = conc(tw, [2], nreq=4, releases=2)
        assert (res.released_nt[0], res.admitted[0], res.inflight_nt[0], res.clamped_nt[0]) == (
            2, 2, 5, 0)

    def test_phantom_release_is_clamped(self):
        tw = Twin(_zeros())
        res = conc(tw, [2], releases=3)
        assert (res.released_nt[0], res.clamped_nt[0]) == (0, 3)
        assert not tw.pn.any()

    def test_remote_holds_count_against_the_limit(self):
        pn = _zeros()
        pn[2, REMOTE, TAKEN] = 4
        res = conc(Twin(pn), [2], nreq=8)
        assert (res.admitted[0], res.inflight_nt[0]) == (1, 5)

    def test_remote_holds_are_not_ours_to_release(self):
        pn = _zeros()
        pn[2, REMOTE, TAKEN] = 4
        res = conc(Twin(pn), [2], releases=2)
        assert (res.released_nt[0], res.clamped_nt[0]) == (0, 2)

    def test_own_lane_pair_invariant_survives_every_tick(self):
        tw = Twin(_zeros())
        for nreq, rel in ((3, 0), (0, 5), (2, 1), (0, 9), (4, 4)):
            conc(tw, [9], nreq=nreq, releases=rel)
            assert tw.pn[9, SLOT, ADDED] <= tw.pn[9, SLOT, TAKEN]


class TestHierQuota:
    def test_leaf_binds_the_path(self):
        res = quota(Twin(_zeros()), [0], [1], [2])
        assert (res.admitted[0], res.headroom_user_nt[0], res.headroom_tenant_nt[0],
                res.headroom_global_nt[0]) == (4, 0, 2, 6)

    def test_ancestor_binds_the_path(self):
        res = quota(Twin(_zeros()), [0], [1], [2], limits=(2, 6, 8))
        assert res.admitted[0] == 2

    def test_debit_is_all_or_nothing_across_levels(self):
        tw = Twin(_zeros())
        d = quota(tw, [0], [1], [2]).admitted[0]
        assert [tw.pn[r, SLOT, TAKEN] for r in (0, 1, 2)] == [d] * 3

    def test_exhausted_leaf_starves_the_path(self):
        tw = Twin(_zeros())
        quota(tw, [0], [1], [2])
        assert quota(tw, [0], [1], [2]).admitted[0] == 0

    def test_shared_ancestor_rows_accumulate(self):
        tw = Twin(_zeros())
        res = quota(tw, [0, 0], [1, 3], [2, 4])
        assert res.admitted.tolist() == [4, 4]
        assert tw.pn[0, SLOT, TAKEN] == 8

    def test_padding_rows_commit_nothing(self):
        tw = Twin(_zeros())
        assert quota(tw, [0], [1], [2], nreq=0).admitted[0] == 0
        assert not tw.pn.any()


# -- the seeded differential over the kernels' hazards ----------------------

B = 64
BIG = 1 << 62


def hazard_state(rng, n, negative=False):
    """B x N planes, a quarter of rows each: zeros, small holds and
    spends, TAT watermarks around 10^6, raw int64 (negative values and
    values near 2^63, so sums and maxima wrap). ``negative``: a fifth
    case, every TAKEN lane near -2^63 (GCRA's max over lanes, whose
    identity must be -2^63, not 0)."""
    pn = np.zeros((B, n, 2), np.int64)
    case = rng.integers(0, 5 if negative else 4, B)
    small = case == 1
    pn[small] = rng.integers(0, 60, (int(small.sum()), n, 2))
    tat = case == 2
    pn[tat, :, TAKEN] = 10**6 + rng.integers(-1000, 1000, (int(tat.sum()), n))
    raw = case == 3
    pn[raw] = rng.integers(-(1 << 63), (1 << 63) - 1, (int(raw.sum()), n, 2), dtype=np.int64)
    pn[raw, 0, TAKEN] = (1 << 63) - 1 - rng.integers(0, 100, int(raw.sum()))
    neg = case == 4
    pn[neg, :, TAKEN] = -(1 << 63) + rng.integers(0, 100, (int(neg.sum()), n))
    return pn


def hazard_rows(rng, k, pool):
    """Rows over a small pool (repeats), with rows in [-B, 0), past B and
    below -B."""
    rows = rng.choice(rng.choice(B, pool, replace=False), k)
    at = rng.choice(k, 6, replace=False)
    rows[at[:2]] -= B
    rows[at[2:4]] = B + rng.integers(0, 5, 2)
    rows[at[4:]] = -B - 1 - rng.integers(0, 5, 2)
    return rows


def hazard_request(rng, family, k):
    nreq = rng.choice([-3, 0, 0, 1, 2, 5, 1000, BIG], k)
    if family == "gcra":
        return [hazard_rows(rng, k, 12), 10**6 + rng.integers(-2000, 2000, k),
                rng.choice([-5, 0, 1, 100, 10**5, BIG], k),
                rng.choice([-50, 0, 300, 10**6, BIG], k), nreq]
    if family == "conc":
        return [hazard_rows(rng, k, 12), rng.choice([-5, 0, 10, 1000, BIG], k),
                rng.choice([-2, 0, 1, 7, 1 << 40], k), nreq,
                rng.choice([-1, 0, 1, 3, 100, 1 << 40], k)]
    users = hazard_rows(rng, k, 16)
    tenants = hazard_rows(rng, k, 4)
    tenants[:3] = users[-3:]  # a row at two levels
    return [hazard_rows(rng, k, 2), tenants, users,
            *(rng.choice([-5, 0, 10, 1000, BIG], k) for _ in range(3)),
            rng.choice([-2, 0, 1, 7, 1 << 40], k), nreq]


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("n", [1, 2, 33])
@pytest.mark.parametrize("slot_at", ["first", "last"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hazards_match_reference(family, n, slot_at, seed):
    """Four microbatches of 48 columns on one state, each read and
    committed as the reference does; the corpus admits and commits."""
    rng = np.random.default_rng([seed, n, ord(family[0])])
    slot = 0 if slot_at == "first" else n - 1
    tw = Twin(hazard_state(rng, n))
    admitted = 0
    for _ in range(4):
        res = tw.call(family, hazard_request(rng, family, 48), slot=slot)
        admitted += int((res.admitted > 0).sum())
    assert admitted > 0


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("n", [1, 31, 33])
def test_negative_lanes_match_reference(family, n):
    """The hazard corpus with its fifth case, rows whose every TAKEN lane
    lies near -2^63, at the own lane first and last: GCRA's max over lanes
    has no floor at 0, and the sums wrap."""
    rng = np.random.default_rng([n, ord(family[0]), 5])
    tw = Twin(hazard_state(rng, n, negative=True))
    for slot in sorted({0, n - 1}):
        tw.call(family, hazard_request(rng, family, 48), slot=slot)


def test_int64_wrap_matches_reference():
    """Products and sums past 2^63: GCRA's k*T, the concurrency release
    units and in-flight sum, quota's debit and spend."""
    pn = np.zeros((8, 2, 2), np.int64)
    pn[1, 1] = [(1 << 63) - 1, (1 << 63) - 1]  # remote lanes whose sums wrap
    pn[2, 0, TAKEN] = (1 << 63) - 5
    tw = Twin(pn)
    tw.call("gcra", [[0, 3], [0, 0], [BIG, BIG], [BIG, BIG], [3, 3]])
    tw.call("conc", [[1, 2, 3], [BIG] * 3, [BIG] * 3, [4] * 3, [1 << 40] * 3])
    tw.call("quota", [[4], [5], [6], [BIG], [BIG], [BIG], [BIG], [3]])
    tw.call("quota", [[2, 4], [1, 4], [2, 4], [-5, 0], [1, 2], [BIG, 7], [1, 1], [-3, 2]])


def test_negative_nreq_debits_every_level():
    """clip(x, 0, nreq) is min(max(x, 0), nreq): a negative nreq admits and
    debits that negative count, as the reference's does."""
    tw = Twin(_zeros(8, 2))
    res = quota(tw, [0, 0], [1, 1], [2, 3], limits=(10, 10, 10), nreq=-3)
    assert res.admitted.tolist() == [-3, -3]
    assert tw.pn[1, SLOT, TAKEN] == -6


def test_out_of_range_rows_alias_as_the_reference_does():
    """Rows [-1, 7] on B = 4: both gather row 3 and admit; -1 commits to
    row 3, 7 is dropped."""
    tw = Twin(_zeros(4, 2))
    res = gcra(tw, [-1, 7], now=0, nreq=2)
    assert res.admitted.tolist() == [2, 2]
    assert tw.pn[3, SLOT, TAKEN] == 200


@pytest.mark.parametrize("slot_at", ["first", "last"])
def test_repeated_rows_match_reference(slot_at):
    """GCRA columns that repeat a row with different ``now``, ``T`` and
    ``nreq > 0``, at node slot 0 and N - 1, over remote lanes preset near
    -2^63 and near +2^63: every column reads the pre-batch row, and the
    repeats' own-lane commits combine by max, as the reference's
    gather-then-scatter-max does."""
    n = 4
    slot = 0 if slot_at == "first" else n - 1
    lo, hi = -(1 << 63), (1 << 63) - 1
    pn = np.zeros((8, n, 2), np.int64)
    pn[0, :, TAKEN] = [lo, lo + 7, lo + 3, lo + 1]  # every lane near -2^63
    pn[1, :, TAKEN] = lo + 5
    pn[1, (slot + 1) % n, TAKEN] = hi - 2  # a remote lane near +2^63 denies
    pn[2, :, TAKEN] = [lo, 900, lo + 2, 40]
    pn[2, slot, TAKEN] = lo + 9  # the own lane below the remote watermark
    pn[3, slot, TAKEN] = 1_500  # the own lane ahead of now
    pn[:, :, ADDED] = np.arange(8 * n).reshape(8, n) - 3
    tw = Twin(pn)
    rows = [0, 2, 0, 1, 3, 2, 0, 3, 2 - 8, 1]
    now = [1_000, 500, 1_300, 1_000, 900, 2_000, 700, 1_200, 950, 5_000]
    emit = [100, 7, 60, 1, 250, 1_000, BIG, 3, 9, 100]
    tol = [300, 0, 1_000, 10**6, 700, 50, BIG, 20, 400, 300]
    nreq = [5, 1, 3, 2, 4, 1000, 2, BIG, 7, 1]
    res = tw.call("gcra", [rows, now, emit, tol, nreq], slot=slot)
    assert (res.admitted[[0, 2, 4, 5, 6, 8]] > 0).all() and not res.admitted[[1, 3, 7, 9]].any()
    assert tw.pn[0, slot, TAKEN] == max(res.own_tat_ns[[0, 2, 6]])
    assert tw.pn[1, slot, TAKEN] == pn[1, slot, TAKEN]


def test_packed_layouts_match_reference():
    """The packed layouts (``*_PACK_ROWS`` / ``*_RESULT_ROWS``,
    ``QUOTA_LEVELS``) are the reference's, and the kernel wrapper's table
    agrees with them."""
    for family, (jmod, _, tmod, _, levels) in FAMILIES.items():
        prefix = {"gcra": "GCRA", "conc": "CONC", "quota": "QUOTA"}[family]
        shape = [getattr(tmod, f"{prefix}_{k}_ROWS") for k in ("PACK", "RESULT")]
        assert shape == [getattr(jmod, f"{prefix}_{k}_ROWS") for k in ("PACK", "RESULT")]
        assert list(cert_kernel.FAMILIES[family][:2]) == shape
        assert cert_kernel.FAMILIES[family][2] == (2 if family == "conc" else levels)
    assert tquota.QUOTA_LEVELS == jquota.QUOTA_LEVELS == 3


def test_kernel_wrappers_refuse_a_cpu_state():
    pn = torch.zeros((8, 2, 2), dtype=torch.int64)
    for family, (rows_in, _, _) in cert_kernel.FAMILIES.items():
        with pytest.raises(ValueError, match="CUDA"):
            cert_kernel.run(family, pn, torch.zeros((rows_in, 4), dtype=torch.int64), 0)
    with pytest.raises(ValueError, match="CUDA"):
        cert_kernel.fused("gcra", pn, torch.zeros((5, 4), dtype=torch.int64), 0)


@pytest.mark.parametrize("k,resident", [
    (1, 264), (8, 264), (32, 264), (33, 264), (8192, 264), (8192, 256), (8192, 100),
    (264 * 32 - 1, 264), (264 * 32, 264), (264 * 32 + 1, 264), (1 << 16, 264), (1 << 16, 1),
    (12345, 7),
])
def test_fused_grid_covers_every_column_once(k, resident):
    """The kernels' persistent grid: never more blocks than the card
    holds resident or than K's tiles, every block has a tile (each must
    arrive at the grid barrier), every column is taken exactly once, and
    no block walks more tiles than the spill buffer is sized for."""
    blocks, tiles = cert_kernel.grid(k, resident)
    tile = cert_kernel.TILE
    assert 1 <= blocks <= resident and blocks <= -(-k // tile)
    taken = np.zeros(k, np.int64)
    for b in range(blocks):
        # cert.cu's loop: tiles b, b + blocks, ... below ceil(K / TILE);
        # tile t is columns [t * TILE, min(K, (t + 1) * TILE)).
        walk = range(b, -(-k // tile), blocks)
        assert 1 <= len(walk) <= tiles
        for t in walk:
            taken[t * tile:min(k, (t + 1) * tile)] += 1
    assert (taken == 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_kernels_match_plain_on_the_card(family):
    """The kernels against the plain version on a CUDA state over the
    hazard corpus, bit for bit, at K = 0, 1, 8, 8,192, 2^16 and the
    grid's resident columns and one either side; a call is one launch,
    none at K = 0 (a card run; the full size is chip_smoke.py's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels do not run on the CPU")
    rng = np.random.default_rng(11)
    tmod = FAMILIES[family][2]
    batch = FAMILIES[family][3].__name__
    cols = cert_kernel.resident_blocks(family, torch.device("cuda", 0)) * cert_kernel.TILE
    ks = [0, 1, 8, 8192, 1 << 16, cols - 1, cols, cols + 1]
    launches = {f"{family}_admit": 1}
    for k, (n, slot) in zip(ks, itertools.cycle(((1, 0), (33, 32), (64, 5)))):
        pn = torch.from_numpy(hazard_state(rng, n, negative=True)).cuda()
        fields = [np.asarray(f)[:k] for f in hazard_request(rng, family, max(k, 8))]
        req = getattr(tmod, REQUEST[family])(*(torch.from_numpy(f.copy()).cuda() for f in fields))
        kstate = LimiterState(pn.clone(), torch.zeros(B, dtype=torch.int64, device="cuda"))
        pstate = LimiterState(pn.clone(), kstate.elapsed.clone())
        before = dict(_build.LAUNCHES)
        _, kres = getattr(tmod, batch)(kstate, req, slot)
        made = {name: _build.LAUNCHES[name] - before[name] for name in before}
        assert made == {name: (launches.get(name, 0) if k else 0) for name in before}, (k, made)
        _, pres = getattr(tmod, batch + "_plain")(pstate, req, slot)
        for a, b in zip(kres, pres):
            assert torch.equal(a, b), k
        assert torch.equal(kstate.pn, pstate.pn), k


# -- the engines ---------------------------------------------------------------


@pytest.fixture
def engines():
    j = JEngine(JConfig(64, 4), node_slot=0)
    t = DeviceEngine(LimiterConfig(64, 4), node_slot=0, device="cpu")
    yield j, t
    j.stop()
    t.stop()


def both(engines, method, *args, **kwargs):
    """Call one family entry point on both engines: the results (numpy
    int64 on the port) and the planes (``read_rows``) must be equal."""
    j, t = engines
    jres = getattr(j, method)(*args, **kwargs)
    tres = getattr(t, method)(*args, **kwargs)
    assert tres._fields == jres._fields
    for name, a, b in zip(tres._fields, jres, tres):
        assert isinstance(b, np.ndarray) and b.dtype == np.int64, name
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=f"{method} {name}")
    rows = np.arange(64, dtype=np.int32)
    for a, b in zip(j.read_rows(rows), t.read_rows(rows)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    return tres


def test_bench_cert_leg_admits_15_21_8(engines):
    """bench.py's cert leg, input for input, on both engines."""

    def gcra_ref(tat, now, t, tol, nreq):
        if tat > now + tol:
            return 0, tat
        base = max(tat, now)
        k = min(1 + (now + tol - base) // t, nreq)
        return k, base + k * t

    tats, want, got = [0, 0, 0], 0, 0
    for now in (1_000, 1_100):
        res = both(engines, "gcra_take", [0, 1, 2], [now] * 3, [100] * 3, [300] * 3, [5] * 3)
        got += int(np.asarray(res.admitted).sum())
        for i in range(3):
            k, tats[i] = gcra_ref(tats[i], now, 100, 300, 5)
            want += k
        assert np.asarray(res.own_tat_ns).tolist() == tats
    assert got == want == 15

    res = both(engines, "conc_acquire", [3, 4, 5], [5] * 3, [1] * 3, [8] * 3, [0] * 3)
    got = int(res.admitted.sum())
    res = both(engines, "conc_acquire", [3, 4, 5], [5] * 3, [1] * 3, [4] * 3, [2] * 3)
    assert res.released_nt.tolist() == [2] * 3 and res.inflight_nt.tolist() == [5] * 3
    assert got + int(res.admitted.sum()) == 21

    paths = dict(rows_global=[6, 7], rows_tenant=[8, 9], rows_user=[10, 11],
                 limit_global_nt=[10] * 2, limit_tenant_nt=[6] * 2, limit_user_nt=[4] * 2,
                 count_nt=[1] * 2)
    a = both(engines, "quota_take", nreq=[5] * 2, **paths)
    b = both(engines, "quota_take", nreq=[5] * 2, **paths)
    assert a.admitted.tolist() == [4, 4] and b.admitted.tolist() == [0, 0]


def test_scalar_arguments_broadcast(engines):
    """Scalars broadcast across K as the reference's jitted body does;
    duplicate and out-of-range rows and an odd K (the port pads K)."""
    both(engines, "gcra_take", [1, 2, 2, -1, 70], 5_000, 100, 300, 3)
    both(engines, "conc_acquire", np.arange(20, 31), 7, 2, 3, 0)
    both(engines, "conc_acquire", np.arange(20, 31), 7, 2, 1, np.arange(11) % 3)
    both(engines, "quota_take", [40] * 3, [41] * 3, [42, 43, 41], 9, 5, 4, 1, 3)
    both(engines, "quota_take", [40] * 3, [41, 42, 41], [42, 43, 41], 9, 5, 4, 1, -2)


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_sequences_match_reference(engines, seed):
    """Randomized microbatches of every family, interleaved, on one pair
    of engines (K from 1 to 40)."""
    rng = np.random.default_rng(seed)
    t = engines[1]
    for _ in range(12):
        family = ["gcra", "conc", "quota"][int(rng.integers(0, 3))]
        k = int(rng.integers(1, 41))
        fields = hazard_request(rng, family, max(k, 8))
        fields = [np.asarray(f)[:k] for f in fields]
        method = {"gcra": "gcra_take", "conc": "conc_acquire", "quota": "quota_take"}[family]
        gen = t._state_gen
        both(engines, method, *fields)
        assert t._state_gen == gen + 1
