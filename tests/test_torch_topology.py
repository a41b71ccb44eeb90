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

    @pytest.mark.parametrize("replicas,t,n", [(2, 8, 1), (3, 8, 33), (4, 257, 1),
                                              (2, 257, 33), (8, 97, 33)])
    def test_plain_versions_match_reference_at_odd_widths(self, replicas, t, n):
        """At N = 1 and 33 lanes and at T not a multiple of a block's
        share (257 = the kernels' 256 rows a block, plus one): the
        converge's plain version writes the reference's join into the
        canonical rows and leaves the rest; the gather's fills every
        replica copy with the rows as each block of the reference's mesh
        holds them."""
        rng = np.random.default_rng(1000 + 7 * t + n + replicas)
        b = 2 * t + 64
        spn = full_range(rng, (replicas, t, n, 2))
        sel = full_range(rng, (replicas, t))
        want_pn, want_el = jax_converge(replicas, spn, sel, replicas & (replicas - 1) == 0)
        rows_np = rng.permutation(b)[:t]
        rows = torch.from_numpy(rows_np)
        pn_np, el_np = full_range(rng, (b, n, 2)), full_range(rng, (b,))
        cpn, cel = torch.from_numpy(pn_np.copy()), torch.from_numpy(el_np.copy())
        converge_kernel.converge(cpn, cel, rows, torch.from_numpy(spn), torch.from_numpy(sel))
        assert np.array_equal(cpn[rows].numpy(), want_pn[0])
        assert np.array_equal(cel[rows].numpy(), want_el[0])
        rest = np.ones(b, dtype=bool)
        rest[rows_np] = False
        assert np.array_equal(cpn.numpy()[rest], pn_np[rest])
        assert np.array_equal(cel.numpy()[rest], el_np[rest])
        gs = torch.empty((replicas, t, n, 2), dtype=torch.int64)
        gl = torch.empty((replicas, t), dtype=torch.int64)
        converge_kernel.gather(torch.from_numpy(pn_np), torch.from_numpy(el_np), rows, gs, gl)
        jrows = jnp.asarray(rows_np)
        assert np.array_equal(gs.numpy(), np.asarray(jnp.broadcast_to(
            jnp.take(jnp.asarray(pn_np), jrows, axis=0)[None], (replicas, t, n, 2))))
        assert np.array_equal(gl.numpy(), np.asarray(jnp.broadcast_to(
            jnp.take(jnp.asarray(el_np), jrows, axis=0)[None], (replicas, t))))

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


def jax_step(replicas, pn, el, take_mat, merge_mat, node_slot, n_devices=8):
    mesh = jtopo.make_mesh(replicas=replicas, devices=jax.devices()[:n_devices])
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
        with pytest.raises(ValueError, match="one platform"):
            topo.make_mesh(2, [torch.device("cpu"), torch.device("cuda", 0)])
        mesh = topo.make_mesh(2, [torch.device("cpu", i) for i in range(8)])
        assert mesh.shape == {"r": 2, "b": 4} and mesh.cards == 1
        assert topo.local_devices("cpu") == [torch.device("cpu")]
        with pytest.raises(ValueError, match="shards do not divide"):
            topo.plan_for(topo.make_mesh(1, [torch.device("cpu")] * 3), LimiterConfig(B, N))


@pytest.mark.cuda
def test_converge_kernels_match_plain_on_the_card():
    """The gather and the converge against their plain versions on a CUDA
    state, bit for bit over the whole int64 range, at several R, T and N,
    a block's uneven share (T = 4,097) among them; then with rows -1 and B
    beside valid ones, for which neither kernel writes anything; each
    call one launch (a card run; the full size is chip_smoke.py's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels do not run on the CPU")
    rng = np.random.default_rng(5)
    for r, t, n, bad in ((2, 1, 1, False), (3, 512, 33, False), (4, 4096, 64, False),
                         (8, 700, 64, False), (2, 4097, 64, False), (3, 4097, 33, True),
                         (8, 300, 1, True)):
        b = max(2 * t, 64)
        pn = torch.from_numpy(full_range(rng, (b, n, 2))).cuda()
        el = torch.from_numpy(full_range(rng, (b,))).cuda()
        rows_np = rng.permutation(b)[:t]
        if bad:
            rows_np[rng.permutation(t)[: t // 8]] = rng.choice([-1, b], t // 8)
        ok = torch.from_numpy((rows_np >= 0) & (rows_np < b)).cuda()
        rows = torch.from_numpy(rows_np).cuda()
        spn = torch.from_numpy(full_range(rng, (r, t, n, 2))).cuda()
        sel = torch.from_numpy(full_range(rng, (r, t))).cuda()
        kp, ke = pn.clone(), el.clone()
        pp, pe = pn.clone(), el.clone()
        before = dict(_build.LAUNCHES)
        converge_kernel.converge(kp, ke, rows, spn, sel)
        assert _build.LAUNCHES["converge"] == before["converge"] + 1
        converge_kernel.converge_plain(pp, pe, rows[ok], spn[:, ok].contiguous(),
                                       sel[:, ok].contiguous())
        assert torch.equal(kp, pp) and torch.equal(ke, pe), (r, t, n, bad)
        ks = torch.from_numpy(full_range(rng, (r, t, n, 2))).cuda()
        kl = torch.from_numpy(full_range(rng, (r, t))).cuda()
        ps, pl = ks.clone(), kl.clone()
        converge_kernel.gather(pn, el, rows, ks, kl)
        assert _build.LAUNCHES["mesh_gather"] == before["mesh_gather"] + 1
        vs, vl = ps[:, ok].contiguous(), pl[:, ok].contiguous()
        converge_kernel.gather_plain(pn, el, rows[ok], vs, vl)
        ps[:, ok], pl[:, ok] = vs, vl
        assert torch.equal(ks, ps) and torch.equal(kl, pl), (r, t, n, bad)


# -- pieces: the mesh over several devices -------------------------------------------

DISTINCT8 = [torch.device("cpu", i) for i in range(8)]
MIXED8 = [torch.device("cpu", 0)] * 4 + [torch.device("cpu", 1)] * 4
# name → (device list, piece_per_block): eight distinct devices, two
# devices of four blocks each, one device with a piece a block.
LAYOUTS = {
    "distinct": (DISTINCT8, False),
    "mixed": (MIXED8, False),
    "per_block": (CPU8, True),
}
# (replicas, layout): R = 1, 2, 4 over each list, and R = 3 over six.
PIECE_CASES = [(r, name) for r in (1, 2, 4) for name in LAYOUTS] + [(3, "distinct6"),
                                                                   (3, "per_block6")]


def piece_mesh(replicas, name):
    if name.endswith("6"):
        devices, ppb = LAYOUTS[name[:-1]]
        devices = [torch.device("cpu", i) for i in range(6)] if name == "distinct6" else CPU8[:6]
    else:
        devices, ppb = LAYOUTS[name]
    return topo.make_mesh(replicas, devices, piece_per_block=ppb)


def jax_mesh_for(mesh):
    return jtopo.make_mesh(mesh.shape["r"], devices=jax.devices()[:len(mesh.devices)])


def placed_zero(mesh, cfg=LimiterConfig(B, N)):
    return topo.init_placed(cfg, mesh, topo.plan_for(mesh, cfg))


class TestPieces:
    @pytest.mark.parametrize("replicas,name", PIECE_CASES)
    def test_layout(self, replicas, name):
        """Blocks group by the device their entry names (replica-major,
        ``grid[r][s]``); each piece holds the shards its blocks cover."""
        mesh = piece_mesh(replicas, name)
        plan = topo.plan_for(mesh, LimiterConfig(B, N))
        specs = topo.piece_layout(mesh, plan)
        keys = range(len(mesh.devices)) if mesh.piece_per_block else mesh.devices
        assert len(specs) == len(dict.fromkeys(keys))
        assert sorted(b for sp in specs for b in sp.blocks) == list(range(plan.blocks))
        for sp in specs:
            assert sp.shards == tuple(sorted({b % plan.shards for b in sp.blocks}))
            assert sp.device == torch.device("cpu")
        assert specs[0].blocks[0] == 0
        placed = placed_zero(mesh)
        for s in range(plan.shards):  # every shard held, home first
            holders = [i for i, sp in enumerate(specs) if s in sp.shards]
            assert holders and placed.home[s] == holders[0]

    def test_one_device_is_one_piece(self):
        for devices in (CPU8, [torch.device("cpu", 3)] * 8):
            mesh = topo.make_mesh(2, devices)
            assert len(topo.piece_layout(mesh, topo.plan_for(mesh, LimiterConfig(B, N)))) == 1
        assert topo.make_mesh(2, CPU8).device == torch.device("cpu")

    @pytest.mark.parametrize("replicas,name", PIECE_CASES)
    def test_place_state_and_planes_round_trip(self, replicas, name):
        """The reference's placed planes (``np.asarray`` of its sharded
        state) laid onto the pieces come back whole, bit for bit; so do a
        torch state's, and a relayout onto every other layout."""
        rng = np.random.default_rng(replicas)
        pn = full_range(rng, (B, N, 2))
        el = full_range(rng, (B,))
        mesh = piece_mesh(replicas, name)
        plan = topo.plan_for(mesh, LimiterConfig(B, N))
        jst = jtopo.place_state(JState(pn=jnp.asarray(pn), elapsed=jnp.asarray(el)),
                                jax_mesh_for(mesh))
        for src in ((np.asarray(jst.pn), np.asarray(jst.elapsed)),
                    LimiterState(torch.from_numpy(pn.copy()), torch.from_numpy(el.copy()))):
            placed = topo.place_state(src, mesh, plan)
            got = placed.planes()
            assert np.array_equal(got[0], pn) and np.array_equal(got[1], el)
        for r2, other in PIECE_CASES:
            mesh2 = piece_mesh(r2, other)
            moved = topo.place_state(placed, mesh2, topo.plan_for(mesh2, LimiterConfig(B, N)))
            got = moved.planes()
            assert np.array_equal(got[0], pn) and np.array_equal(got[1], el), (r2, other)

    def test_one_piece_keeps_the_state_tensors(self):
        st = LimiterState(torch.zeros((B, N, 2), dtype=torch.int64),
                          torch.zeros(B, dtype=torch.int64))
        mesh = topo.make_mesh(2, CPU8)
        placed = topo.place_state(st, mesh, topo.plan_for(mesh, LimiterConfig(B, N)))
        assert placed.states[0].pn is st.pn and placed.states[0].elapsed is st.elapsed
        mesh4 = topo.make_mesh(4, CPU8)
        again = topo.place_state(placed, mesh4, topo.plan_for(mesh4, LimiterConfig(B, N)))
        assert again.states[0].pn is st.pn

    @pytest.mark.parametrize("replicas,name", PIECE_CASES)
    @pytest.mark.parametrize("to_home", [True, False])
    def test_sequence_matches_reference(self, replicas, name, to_home):
        """Four dispatches through the reference's mesh, ``mesh_step`` on
        the pieces and ``cluster_step`` (R full copies): results and
        planes equal after each."""
        rng = random.Random(17 + replicas)
        mesh = piece_mesh(replicas, name)
        jmesh = jax_mesh_for(mesh)
        jplan = jtopo.plan_for(jmesh, JConfig(B, N))
        step = jtopo.build_cluster_step_packed(jmesh, 0)
        jst = jtopo.init_sharded_state(JConfig(B, N), jmesh)
        plan = topo.plan_for(mesh, LimiterConfig(B, N))
        placed = placed_zero(mesh)
        ref = LimiterState(torch.zeros((B, N, 2), dtype=torch.int64),
                           torch.zeros(B, dtype=torch.int64))
        for it in range(4):
            takes, deltas = random_ops(rng, 12, 30, it * NANO)
            tm, mm, at_cols = jtopo.route_packed(jplan, takes, deltas, 16, 16,
                                                 deltas_to_home=to_home)
            sh = jtopo.batch_sharding(jmesh)
            jst, jout = step(jst, jax.device_put(tm, sh), jax.device_put(mm, sh))
            out = topo.mesh_step(placed, tm, mm, plan, 0).numpy()
            _, cout = topo.cluster_step(ref, tm, mm, plan, 0)
            at = [blk * 16 + slot for blk, slot in at_cols]
            assert np.array_equal(out[:, at], np.asarray(jout)[:, at]), it
            assert np.array_equal(cout.numpy()[:, at], out[:, at]), it
            pn, el = placed.planes()
            assert np.array_equal(pn, np.asarray(jst.pn)), it
            assert np.array_equal(el, np.asarray(jst.elapsed)), it
            assert np.array_equal(ref.pn.numpy(), pn) and np.array_equal(ref.elapsed.numpy(), el)
            # Every copy of a shard equal after the converge.
            for s in range(plan.shards):
                copies = [st.pn[sp.shards.index(s) * plan.rows_per_shard:
                                (sp.shards.index(s) + 1) * plan.rows_per_shard]
                          for sp, st in zip(placed.specs, placed.states) if s in sp.shards]
                assert all(torch.equal(c, copies[0]) for c in copies[1:]), (it, s)

    @pytest.mark.parametrize("replicas,name", PIECE_CASES)
    def test_raw_random_matrices_with_a_wrap(self, replicas, name):
        """Matrices not made by the router (takes in any replica's block,
        merges with negative and out-of-range rows and slots, zero
        entries, values near 2^63) and a take whose lane wraps past 2^63,
        over the pieces, against the reference's step."""
        rng = np.random.default_rng(70 + replicas)
        mesh = piece_mesh(replicas, name)
        plan = topo.plan_for(mesh, LimiterConfig(B, N))
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
        live = np.flatnonzero(take_mat[5] > 0)
        g0 = (live[0] // k_t % S) * rps + take_mat[0, live[0]]
        wrap_row(pn, el, g0, 0, 3 * NANO)
        take_mat[1:, live[0]] = (5 * NANO, 10, NANO, 3 * NANO, 1, 10 * NANO, 0)
        merge_mat = np.zeros((5, blocks * k_m), np.int64)
        n_live = blocks * k_m * 3 // 4
        merge_mat[0, :n_live] = rng.integers(-rps, rps + 2, n_live)
        merge_mat[1, :n_live] = rng.integers(-N, N + 1, n_live)
        merge_mat[2:, :n_live] = rng.integers(0, 1 << 62, (3, n_live))
        merge_mat[2:, :n_live][:, rng.random(n_live) < 0.1] = 0
        merge_mat[:, :n_live] = merge_mat[:, rng.permutation(blocks * k_m)[:n_live]]
        jpn, jel, jout = jax_step(replicas, pn, el, take_mat, merge_mat, 0, len(mesh.devices))
        placed = topo.place_state((pn, el), mesh, plan)
        out = topo.mesh_step(placed, take_mat, merge_mat, plan, 0).numpy()
        got_pn, got_el = placed.planes()
        assert np.array_equal(got_pn, jpn) and np.array_equal(got_el, jel)
        alive = take_mat[5] > 0
        assert np.array_equal(out[:, alive], jout[:, alive])

    def test_one_piece_prepares_as_one_card(self):
        """At one piece the split prepare is the one-card prepare, operand
        for operand, and the exchange is empty: the same launches."""
        rng = random.Random(5)
        mesh = topo.make_mesh(2, CPU8)
        plan = topo.plan_for(mesh, LimiterConfig(B, N))
        takes, deltas = random_ops(rng, 12, 40, NANO)
        tm, mm, _ = topo.route_packed(plan, takes, deltas, 16, 16)
        split = topo.prepare_pieces(tm, mm, plan, N, placed_zero(mesh))
        assert split.exchange == () and len(split.steps) == 1
        got = split.steps[0]
        live = np.flatnonzero(tm[5] > 0)
        blk = live // (tm.shape[1] // plan.blocks)
        rows = (blk % plan.shards) * plan.rows_per_shard + tm[0, live]
        trows = np.unique(rows)
        # Every live take, its global rows as the one piece's rows.
        assert np.array_equal(got.cols, live) and got.L == len(live) and got.T == len(trows)
        assert np.array_equal(got.flat[-got.T:], trows)
        takes = got.flat[:8 * got.L].reshape(8, got.L)
        assert np.array_equal(takes[0], (blk // plan.shards) * got.T
                              + np.searchsorted(trows, rows))
        assert np.array_equal(takes[1:], tm[1:, live])
        # Each merge entry lands once: in the state's rows or a scratch copy.
        assert got.Kc + got.Ks <= mm.shape[1] and got.Ks > 0 and got.Kc > 0
        assert len(got.flat) == 8 * got.L + 5 * (got.Kc + got.Ks) + got.T

    @pytest.mark.parametrize("replicas", [2, 4])
    def test_exchange_moves_each_missing_replica(self, replicas):
        """Eight distinct devices: every piece holds one shard at one
        replica and receives the other R - 1 replicas' scratch rows of
        its shard, a pn and an elapsed copy each."""
        mesh = topo.make_mesh(replicas, DISTINCT8)
        plan = topo.plan_for(mesh, LimiterConfig(B, N))
        rng = random.Random(replicas)
        takes, deltas = random_ops(rng, 16, 10, NANO)
        tm, mm, _ = topo.route_packed(plan, takes, deltas, 16, 16)
        step = topo.prepare_pieces(tm, mm, plan, N, placed_zero(mesh))
        trows = np.unique([t[0] for t in takes])
        shards_with = set((trows // plan.rows_per_shard).tolist())
        want = len(shards_with) * replicas * (replicas - 1)
        assert len(step.exchange) == want
        for x in step.exchange:
            assert x.dst != x.src and x.rows > 0
        topo.reset_exchange()
        topo.mesh_step(placed_zero(mesh), tm, mm, plan, 0)
        assert topo.EXCHANGE["copies"] == 2 * want
        assert topo.EXCHANGE["bytes"] == sum(x.rows for x in step.exchange) * (16 * N + 8)

    @pytest.mark.parametrize("name", list(LAYOUTS))
    def test_rows_view_gather_scatter_zero(self, name):
        """A launch's rows over pieces: the view's positions, a gathered
        copy equal to the rows, a write-back that reaches every copy, and
        ``zero_rows``'s wrap and drop on every copy."""
        rng = np.random.default_rng(3)
        mesh = topo.make_mesh(2, LAYOUTS[name][0], piece_per_block=LAYOUTS[name][1])
        plan = topo.plan_for(mesh, LimiterConfig(B, N))
        pn, el = full_range(rng, (B, N, 2)), full_range(rng, (B,))
        placed = topo.place_state((pn, el), mesh, plan)
        cols = np.array([[5, 63, 5, 17], [40, 2, 70, -3]], np.int64)
        rows = placed.view(cols[0], cols[1])
        assert rows.tolist() == [0, 2, 5, 17, 40, 63]  # 0: the clamp end of -3
        assert cols.tolist() == [[2, 5, 2, 3], [4, 1, 6, -1]]
        copy = placed.gather(rows)
        assert np.array_equal(copy.pn.numpy(), pn[rows]) and np.array_equal(copy.elapsed.numpy(), el[rows])
        copy.pn.add_(1)
        copy.elapsed.add_(2)
        placed.scatter(rows, copy)
        pn[rows] += 1
        el[rows] += 2
        for st_pn, st_el, sp in zip((s.pn for s in placed.states),
                                    (s.elapsed for s in placed.states), placed.specs):
            for j, s in enumerate(sp.shards):
                lo, at = s * plan.rows_per_shard, j * plan.rows_per_shard
                assert np.array_equal(st_pn[at:at + plan.rows_per_shard].numpy(),
                                      pn[lo:lo + plan.rows_per_shard])
                assert np.array_equal(st_el[at:at + plan.rows_per_shard].numpy(),
                                      el[lo:lo + plan.rows_per_shard])
        placed.zero([3, -1, 64, 200, 3])
        pn[[3, 63]] = 0
        el[[3, 63]] = 0
        got = placed.planes()
        assert np.array_equal(got[0], pn) and np.array_equal(got[1], el)


# The wrappers on a second card: each must launch on its tensors' card
# while the calling thread's current device is another.
WRAPPERS = ("pair_join", "row_join", "tick_join", "take_n", "mesh_gather", "converge",
            "lifecycle_probe", "decode_fold", "row_rmw", "gcra_admit", "conc_admit",
            "quota_admit")


def second_card_call(wrapper):
    """→ ``run(device)``: one call that reaches ``wrapper`` on small
    operands made on ``device`` (the prove stage's operands for the root
    that launches it), returning every plane and output on the host."""
    import importlib

    from patrol_tpu_torch.ops import join_kernel
    from patrol_tpu_torch.ops.obligations import PROVE_ROOTS

    if wrapper == "tick_join":
        def run(device):
            pn = torch.arange(4 * N * 2, dtype=torch.int64, device=device).view(4, N, 2) * 5
            el = torch.arange(4, dtype=torch.int64, device=device) * 7
            t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)  # noqa: E731
            dense = (t([1]), torch.full((1, N, 2), 99, dtype=torch.int64, device=device), t([3]))
            pairs = (t([2, 0]), t([1, 0]), t([40, 3]), t([9, 1]), t([2]), t([50]))
            join_kernel.tick_join(pn, el, dense, pairs)
            return [pn.cpu(), el.cpu()]
        return run
    root = next(r for r in PROVE_ROOTS if wrapper in r.launches and r.operands is not None)
    fn = getattr(importlib.import_module(root.module), root.attr)

    def run(device):
        ops = root.operands(device)
        res = fn(*ops.args)
        outs = list(ops.state_in) + list(ops.state_out(res) if ops.state_out else [])
        if ops.state_out is None and res is not None:
            outs += list(res)
        return [x.cpu() for x in outs if isinstance(x, torch.Tensor)]
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_wrapper_launches_on_its_tensors_card(wrapper):
    """A wrapper called on ``cuda:1`` tensors from a thread whose current
    device is ``cuda:0`` launches on ``cuda:1`` (its launch count moves)
    and gives what its plain version gives on the same inputs on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels do not run on the CPU")
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards to launch off the current device; this host has "
                    f"{torch.cuda.device_count()}")
    run = second_card_call(wrapper)
    torch.cuda.set_device(0)
    before = _build.LAUNCHES[wrapper]
    got = run(torch.device("cuda", 1))
    torch.cuda.synchronize(1)
    assert torch.cuda.current_device() == 0
    assert _build.LAUNCHES[wrapper] > before
    want = run(torch.device("cpu"))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b), wrapper
