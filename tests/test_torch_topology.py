"""The port's mesh topology (``patrol_tpu_torch/parallel/topology.py``)
against the JAX package's, exactly.

The JAX side runs on the 8-device virtual CPU mesh that tests/conftest.py
forces; the port side on ``cpu`` × 8 (one device repeated: every block of
the mesh on it) with the kernels' plain versions. The same numpy-seeded
inputs go through both. Tolerance 0: every plane and result is int64 and
must be equal bit for bit.

* The converge: the reference's tree and flat all-reduce on the mesh
  against the port's ``converge`` / ``tree_reduce_states`` and the
  converge kernel's plain version, over the whole int64 range (signed),
  at power-of-two R and not.
* The packed step: ``mesh_step`` (one canonical copy, replica copies of
  the take rows only) and ``cluster_step`` (R full copies) against
  ``build_cluster_step_packed`` on routed and on raw random matrices:
  deltas of take rows routed to non-home replicas, takes in non-home
  blocks, padding, out-of-range indices, and a take whose lane wraps past
  2^63 (the signed max then keeps another replica's unwrapped copy).
* ``TestMeshEquivalence``'s sequence at R = 1, 2, 4; the numpy routing;
  ``make_mesh``'s rules.

The converge kernel itself is held to its plain version on the card by
the ``cuda``-marked test here and by ``chip_smoke.py`` (phase 2).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from patrol_tpu.models.limiter import LimiterConfig as JConfig
from patrol_tpu.models.limiter import LimiterState as JState
from patrol_tpu.parallel import topology as jtopo
from patrol_tpu_torch.models.limiter import NANO, LimiterConfig, LimiterState
from patrol_tpu_torch.ops import _build, converge_kernel
from patrol_tpu_torch.parallel import topology as topo

B, N = 64, 4
CPU8 = [torch.device("cpu")] * 8
I64 = np.iinfo(np.int64)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh"
)


def full_range(rng, shape):
    """int64 values over the whole range, with lanes near ±2^63 and 0."""
    x = rng.integers(I64.min, I64.max, shape, dtype=np.int64, endpoint=True)
    edge = rng.random(shape)
    x[edge < 0.1] = I64.max - rng.integers(0, 4, shape)[edge < 0.1]
    x[(edge >= 0.1) & (edge < 0.2)] = I64.min + rng.integers(0, 4, shape)[(edge >= 0.1) & (edge < 0.2)]
    x[(edge >= 0.2) & (edge < 0.25)] = 0
    return x


# -- the converge --------------------------------------------------------------


def jax_converge(replicas, pn, el, tree: bool):
    """The reference's converge as its step runs it: each replica's block
    on its own device of the virtual mesh (tests/test_topology.py)."""
    mesh = jtopo.make_mesh(replicas=replicas, devices=jax.devices()[:replicas])

    def f(p, e):
        st = jtopo.converge(JState(pn=p[0], elapsed=e[0]), replicas if tree else None)
        return st.pn[None], st.elapsed[None]

    fn = jtopo._shard_map(
        f, mesh=mesh,
        in_specs=(P(jtopo.REPLICA_AXIS), P(jtopo.REPLICA_AXIS)),
        out_specs=(P(jtopo.REPLICA_AXIS), P(jtopo.REPLICA_AXIS)),
        **{jtopo._SM_CHECK_KW: False},
    )
    out = jax.jit(fn)(jnp.asarray(pn), jnp.asarray(el))
    return np.asarray(out[0]), np.asarray(out[1])


class TestTreeConverge:
    @pytest.mark.parametrize("replicas", [2, 3, 4, 5, 8])
    def test_converge_matches_reference(self, replicas):
        """Tree (power-of-two R) and flat schedules: every replica holds
        the reference's join, and the converge kernel's plain version
        writes the same join into the canonical rows."""
        rng = np.random.default_rng(31 + replicas)
        pn = full_range(rng, (replicas, 8, N, 2))
        el = full_range(rng, (replicas, 8))
        tree = replicas & (replicas - 1) == 0
        want_pn, want_el = jax_converge(replicas, pn, el, tree)
        if tree:  # the flat fallback gives the same bits
            flat_pn, flat_el = jax_converge(replicas, pn, el, False)
            assert np.array_equal(flat_pn, want_pn) and np.array_equal(flat_el, want_el)
        for r_arg in (replicas, None):
            got = topo.converge(torch.from_numpy(pn), torch.from_numpy(el), r_arg)
            assert np.array_equal(got.pn.numpy(), want_pn)
            assert np.array_equal(got.elapsed.numpy(), want_el)
        red = topo.tree_reduce_states(torch.from_numpy(pn), torch.from_numpy(el))
        jred = jtopo.tree_reduce_states(jnp.asarray(pn), jnp.asarray(el))
        assert np.array_equal(red.pn.numpy(), np.asarray(jred.pn))
        assert np.array_equal(red.elapsed.numpy(), np.asarray(jred.elapsed))
        assert np.array_equal(red.pn.numpy(), want_pn[0])
        # The kernel's plain version: the scratch of take rows → canonical.
        rows = torch.tensor([5, 0, 63, 17, 2, 40, 9, 33])
        cpn = torch.from_numpy(full_range(rng, (B, N, 2)))
        cel = torch.from_numpy(full_range(rng, (B,)))
        before_pn, before_el = cpn.clone(), cel.clone()
        converge_kernel.converge(cpn, cel, rows, torch.from_numpy(pn), torch.from_numpy(el))
        assert np.array_equal(cpn[rows].numpy(), want_pn[0])
        assert np.array_equal(cel[rows].numpy(), want_el[0])
        rest = torch.ones(B, dtype=torch.bool)
        rest[rows] = False
        assert torch.equal(cpn[rest], before_pn[rest]) and torch.equal(cel[rest], before_el[rest])

    def test_tree_join_states_is_the_signed_max(self):
        rng = np.random.default_rng(3)
        a = [full_range(rng, (B, N, 2)), full_range(rng, (B,))]
        b = [full_range(rng, (B, N, 2)), full_range(rng, (B,))]
        got = topo.tree_join_states(
            LimiterState(*map(torch.from_numpy, a)), LimiterState(*map(torch.from_numpy, b))
        )
        want = jtopo.tree_join_states(JState(*map(jnp.asarray, a)), JState(*map(jnp.asarray, b)))
        assert np.array_equal(got.pn.numpy(), np.asarray(want.pn))
        assert np.array_equal(got.elapsed.numpy(), np.asarray(want.elapsed))

    @pytest.mark.parametrize("replicas", [1, 2, 3, 8])
    def test_gather_fills_every_copy(self, replicas):
        rng = np.random.default_rng(replicas)
        pn = torch.from_numpy(full_range(rng, (B, N, 2)))
        el = torch.from_numpy(full_range(rng, (B,)))
        rows = torch.from_numpy(rng.permutation(B)[:11])
        spn = torch.empty((replicas, 11, N, 2), dtype=torch.int64)
        sel = torch.empty((replicas, 11), dtype=torch.int64)
        converge_kernel.gather(pn, el, rows, spn, sel)
        for r in range(replicas):
            assert torch.equal(spn[r], pn[rows]) and torch.equal(sel[r], el[rows])
        # Converging copies of equal rows writes them back unchanged.
        pn2, el2 = pn.clone(), el.clone()
        converge_kernel.converge(pn2, el2, rows, spn, sel)
        assert torch.equal(pn2, pn) and torch.equal(el2, el)

    def test_wrappers_check_their_operands(self):
        pn = torch.zeros((B, N, 2), dtype=torch.int64)
        el = torch.zeros(B, dtype=torch.int64)
        rows = torch.arange(3)
        with pytest.raises(ValueError, match="spn"):
            converge_kernel.converge(pn, el, rows, torch.zeros((2, 4, N, 2), dtype=torch.int64),
                                     torch.zeros((2, 4), dtype=torch.int64))
        with pytest.raises(TypeError):
            converge_kernel.gather(pn, el, rows.to(torch.int32),
                                   torch.zeros((2, 3, N, 2), dtype=torch.int64),
                                   torch.zeros((2, 3), dtype=torch.int64))


# -- the packed step -------------------------------------------------------------


def jax_step(replicas, pn, el, take_mat, merge_mat, node_slot):
    mesh = jtopo.make_mesh(replicas=replicas)
    st = jtopo.place_state(JState(pn=jnp.asarray(pn), elapsed=jnp.asarray(el)), mesh)
    step = jtopo.build_cluster_step_packed(mesh, node_slot)
    sh = jtopo.batch_sharding(mesh)
    st, out = step(st, jax.device_put(take_mat, sh), jax.device_put(merge_mat, sh))
    return np.asarray(st.pn), np.asarray(st.elapsed), np.asarray(out)


def port_plan(replicas, cfg=LimiterConfig(B, N)):
    return topo.plan_for(topo.make_mesh(replicas, CPU8), cfg)


def both_steps(replicas, pn, el, take_mat, merge_mat, node_slot=0):
    """The reference's step, ``mesh_step`` and ``cluster_step`` on the
    same matrices: planes equal, results equal on the live columns."""
    jpn, jel, jout = jax_step(replicas, pn, el, take_mat, merge_mat, node_slot)
    plan = port_plan(replicas)
    live = take_mat[5] > 0
    for fn in (topo.mesh_step, lambda *a: topo.cluster_step(*a)[1]):
        st = LimiterState(torch.from_numpy(pn.copy()), torch.from_numpy(el.copy()))
        out = fn(st, take_mat, merge_mat, plan, node_slot).numpy()
        assert np.array_equal(st.pn.numpy(), jpn)
        assert np.array_equal(st.elapsed.numpy(), jel)
        assert np.array_equal(out[:, live], jout[:, live])
    return jpn, jel, jout


def wrap_row(pn, el, row, node_slot, count_nt):
    """Row ``row`` set so that a take of ``count_nt`` at ``node_slot`` is
    admitted and wraps its TAKEN lane past 2^63 (ADDED equals TAKEN, so
    the balance is the capacity base)."""
    pn[row] = 0
    pn[row, node_slot] = I64.max - count_nt // 2
    el[row] = 0


def random_takes(rng, rows, now):
    return [
        (int(r), now, 10, NANO, int(rng.integers(1, 4)) * NANO, int(rng.integers(1, 3)),
         10 * NANO, 0)
        for r in rows
    ]


class TestPackedStep:
    @pytest.mark.parametrize("replicas", [1, 2, 4])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_routed_matrices_with_non_home_deltas_and_a_wrap(self, replicas, seed):
        rng = np.random.default_rng(100 * replicas + seed)
        pn = rng.integers(0, 1 << 41, (B, N, 2))
        el = rng.integers(0, 1 << 41, B)
        trows = rng.permutation(B)[:14]
        takes = random_takes(rng, trows, 5 * NANO)
        wrap = int(trows[0])
        wrap_row(pn, el, wrap, 0, 3 * NANO)
        takes[0] = (wrap, 5 * NANO, 10, NANO, 3 * NANO, 1, 10 * NANO, 0)
        # Deltas of every take row, several each: round-robin by arrival
        # puts some on replicas other than the row's home.
        d_rows = np.concatenate([np.repeat(trows, 3), rng.integers(0, B, 40)])
        deltas = [
            (int(r), int(rng.integers(N)), int(rng.integers(0, 1 << 42)),
             int(rng.integers(0, 1 << 42)), int(rng.integers(0, 1 << 42)))
            for r in rng.permutation(d_rows)
        ]
        plan = jtopo.plan_for(jtopo.make_mesh(replicas), JConfig(B, N))
        blocks = jtopo.delta_block_assignment(plan, np.array([d[0] for d in deltas]))
        if replicas > 1:
            home = np.array([d[0] % replicas for d in deltas])
            assert ((blocks // plan.shards) != home).any()
        take_mat, merge_mat, _ = jtopo.route_packed(plan, takes, deltas, 16, 32)
        jpn, _, _ = both_steps(replicas, pn, el, take_mat, merge_mat)
        wrapped = jpn[wrap, 0, 1] < 0
        assert wrapped == (replicas == 1), "the wrap case did not arise as intended"

    @pytest.mark.parametrize("replicas", [1, 2, 4])
    def test_raw_random_matrices(self, replicas):
        """Matrices not made by the router: takes in any replica's block
        of their shard (home or not), merges with random local rows and
        slots (some negative, some out of range), zero entries and
        values near 2^63."""
        rng = np.random.default_rng(7 + replicas)
        plan = port_plan(replicas)
        S, rps, blocks = plan.shards, plan.rows_per_shard, plan.blocks
        k_t, k_m = 8, 16
        pn = full_range(rng, (B, N, 2)) >> 2
        el = full_range(rng, (B,)) >> 2
        take_mat = np.zeros((8, blocks * k_t), np.int64)
        fill = np.zeros(blocks, int)
        for g in rng.permutation(B)[:20]:
            blk = int(rng.integers(replicas)) * S + int(g // rps)
            if fill[blk] == k_t:
                continue
            c = blk * k_t + fill[blk]
            fill[blk] += 1
            take_mat[:, c] = (g % rps, 7 * NANO, 10, NANO, NANO * int(rng.integers(1, 3)),
                              int(rng.integers(1, 4)), 10 * NANO, int(rng.integers(0, NANO)))
        merge_mat = np.zeros((5, blocks * k_m), np.int64)
        n_live = blocks * k_m * 3 // 4
        merge_mat[0, :n_live] = rng.integers(-rps, rps + 2, n_live)
        merge_mat[1, :n_live] = rng.integers(-N, N + 1, n_live)
        merge_mat[2:, :n_live] = rng.integers(0, 1 << 62, (3, n_live))
        merge_mat[2:, :n_live][:, rng.random(n_live) < 0.1] = 0
        merge_mat[:, :n_live] = merge_mat[:, rng.permutation(blocks * k_m)[:n_live]]
        both_steps(replicas, pn, el, take_mat, merge_mat, node_slot=N - 1)

    def test_live_takes_must_lie_in_their_shard(self):
        plan = port_plan(2)
        take_mat = np.zeros((8, plan.blocks * 8), np.int64)
        take_mat[0, 0], take_mat[5, 0] = plan.rows_per_shard, 1
        st = LimiterState(torch.zeros((B, N, 2), dtype=torch.int64),
                          torch.zeros(B, dtype=torch.int64))
        with pytest.raises(ValueError, match="shard"):
            topo.mesh_step(st, take_mat, np.zeros((5, plan.blocks * 8), np.int64), plan, 0)
        take_mat[0, 0], take_mat[0, 1], take_mat[5, 1] = 3, 3, 1
        with pytest.raises(ValueError, match="two live takes"):
            topo.mesh_step(st, take_mat, np.zeros((5, plan.blocks * 8), np.int64), plan, 0)


# -- TestMeshEquivalence, the routing, the mesh -------------------------------------


def random_ops(rng, n_takes, n_deltas, now):
    rows = rng.sample(range(B), n_takes)
    takes = [
        (row, now, 10, NANO, rng.randrange(1, 4) * NANO, rng.randrange(1, 3), 10 * NANO, 0)
        for row in rows
    ]
    deltas = [
        (rng.randrange(B), rng.randrange(N), rng.randrange(0, 5 * NANO),
         rng.randrange(0, 5 * NANO), rng.randrange(0, NANO))
        for _ in range(n_deltas)
    ]
    return takes, deltas


class TestMeshEquivalence:
    @pytest.mark.parametrize("replicas", [1, 2, 4])
    @pytest.mark.parametrize("to_home", [True, False])
    def test_sequence_matches_reference(self, replicas, to_home):
        """Four dispatches in a row through the reference's mesh and
        ``mesh_step``: results and planes equal after each."""
        rng = random.Random(11 + replicas)
        jmesh = jtopo.make_mesh(replicas)
        jplan = jtopo.plan_for(jmesh, JConfig(B, N))
        step = jtopo.build_cluster_step_packed(jmesh, 0)
        jst = jtopo.init_sharded_state(JConfig(B, N), jmesh)
        plan = port_plan(replicas)
        st = LimiterState(torch.zeros((B, N, 2), dtype=torch.int64),
                          torch.zeros(B, dtype=torch.int64))
        for it in range(4):
            takes, deltas = random_ops(rng, 12, 24, it * NANO)
            tm, mm, placed = jtopo.route_packed(jplan, takes, deltas, 16, 16,
                                                deltas_to_home=to_home)
            sh = jtopo.batch_sharding(jmesh)
            jst, jout = step(jst, jax.device_put(tm, sh), jax.device_put(mm, sh))
            out = topo.mesh_step(st, tm, mm, plan, 0).numpy()
            at = [blk * 16 + slot for blk, slot in placed]
            assert np.array_equal(out[:, at], np.asarray(jout)[:, at]), it
            assert np.array_equal(st.pn.numpy(), np.asarray(jst.pn)), it
            assert np.array_equal(st.elapsed.numpy(), np.asarray(jst.elapsed)), it

    @pytest.mark.parametrize("to_home", [True, False])
    @pytest.mark.parametrize("replicas", [1, 2, 4])
    def test_routing_matches_reference(self, replicas, to_home):
        rng = random.Random(replicas)
        takes, deltas = random_ops(rng, 20, 60, NANO)
        jplan = jtopo.plan_for(jtopo.make_mesh(replicas), JConfig(B, N))
        plan = port_plan(replicas)
        assert dataclasses_equal(plan, jplan)
        for row in range(B):
            assert plan.locate(row) == jplan.locate(row)
        rows = np.array([d[0] for d in deltas])
        assert np.array_equal(topo.delta_block_assignment(plan, rows, to_home),
                              jtopo.delta_block_assignment(jplan, rows, to_home))
        got = topo.route_packed(plan, takes, deltas, 16, 32, deltas_to_home=to_home)
        want = jtopo.route_packed(jplan, takes, deltas, 16, 32, deltas_to_home=to_home)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert got[2] == want[2]
        req, mb = jtopo.route_requests(jplan, takes, deltas, 16, 32, deltas_to_home=to_home)
        tm, mm = topo.route_requests(plan, takes, deltas, 16, 32, deltas_to_home=to_home)
        assert np.array_equal(tm, np.stack([np.asarray(f, np.int64) for f in req]))
        assert np.array_equal(mm, np.stack([np.asarray(f, np.int64) for f in mb]))

    def test_block_overflow_raises(self):
        plan = port_plan(2)
        takes = [(0, 0, 10, NANO, NANO, 1, 10 * NANO, 0)] * 3
        with pytest.raises(ValueError, match="overflow"):
            topo.route_requests(plan, takes, [], k_take=2, k_merge=2)


def dataclasses_equal(a, b) -> bool:
    return (a.replicas, a.shards, a.rows_per_shard, a.blocks) == (
        b.replicas, b.shards, b.rows_per_shard, b.blocks)


class TestMakeMesh:
    @pytest.mark.parametrize("replicas", [1, 2, 4, 8])
    def test_shape_matches_reference(self, replicas):
        mesh = topo.make_mesh(replicas, CPU8)
        jmesh = jtopo.make_mesh(replicas)
        assert mesh.shape == dict(jmesh.shape)
        assert mesh.device == torch.device("cpu") and len(mesh.devices) == 8

    def test_rules(self):
        with pytest.raises(ValueError, match="2 replicas do not divide 1 devices"):
            topo.make_mesh(2, [torch.device("cpu")])
        with pytest.raises(ValueError, match="3 replicas do not divide 8 devices"):
            topo.make_mesh(3, CPU8)
        with pytest.raises(topo.NotPortedError, match="distinct"):
            topo.make_mesh(2, [torch.device("cpu"), torch.device("cuda", 0)])
        assert topo.local_devices("cpu") == [torch.device("cpu")]
        with pytest.raises(ValueError, match="shards do not divide"):
            topo.plan_for(topo.make_mesh(1, [torch.device("cpu")] * 3), LimiterConfig(B, N))


@pytest.mark.cuda
def test_converge_kernels_match_plain_on_the_card():
    """The gather and the converge against their plain versions on a CUDA
    state, bit for bit over the whole int64 range, at several R, T and N;
    each call one launch (a card run; the full size is chip_smoke.py's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels do not run on the CPU")
    rng = np.random.default_rng(5)
    for r, t, n in ((2, 1, 1), (3, 512, 33), (4, 4096, 64), (8, 700, 64)):
        b = max(2 * t, 64)
        pn = torch.from_numpy(full_range(rng, (b, n, 2))).cuda()
        el = torch.from_numpy(full_range(rng, (b,))).cuda()
        rows = torch.from_numpy(rng.permutation(b)[:t]).cuda()
        spn = torch.from_numpy(full_range(rng, (r, t, n, 2))).cuda()
        sel = torch.from_numpy(full_range(rng, (r, t))).cuda()
        kp, ke = pn.clone(), el.clone()
        pp, pe = pn.clone(), el.clone()
        before = dict(_build.LAUNCHES)
        converge_kernel.converge(kp, ke, rows, spn, sel)
        assert _build.LAUNCHES["converge"] == before["converge"] + 1
        converge_kernel.converge_plain(pp, pe, rows, spn, sel)
        assert torch.equal(kp, pp) and torch.equal(ke, pe), (r, t, n)
        ks, kl = torch.empty_like(spn), torch.empty_like(sel)
        converge_kernel.gather(pn, el, rows, ks, kl)
        ps, pl = torch.empty_like(spn), torch.empty_like(sel)
        converge_kernel.gather_plain(pn, el, rows, ps, pl)
        assert torch.equal(ks, ps) and torch.equal(kl, pl), (r, t, n)
