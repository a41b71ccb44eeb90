"""The per-row read-modify-write probe of the port against the JAX probe.

The reference is the TPU kernel of ``scripts/probe_dma_scatter.py``
itself (``mk_kern``), run in TPU interpret mode on the CPU. That script
cannot be imported — its module body allocates the 1M-row state and
times chains — so :func:`jax_probe` parses it, executes only its imports,
literal constants and ``def``s, overrides ``B`` and ``K``, and builds the
``pallas_call`` with ``build``'s specs plus ``interpret``. Nothing under
``scripts/`` changes.

At B = 64 rows and K = 16 updates (K >= the kernel's pipeline depth
D = 8), with inputs from a numpy seed: ``row_rmw`` on a CPU tensor (its
plain version) equals the JAX kernel bit for bit for both inner
functions, over int32 state with negative values and ``w0`` of both
residues mod 4; the probe entry point's chain equals the JAX chain;
``pairmax`` equals ``pair_join_plain`` on non-negative state; and
``probe_view`` carries the probe's int32 state to the limiter's planes and
back.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from patrol_tpu_torch.models.limiter import LimiterConfig, init_state, state_from_numpy
from patrol_tpu_torch.ops import row_rmw_kernel as rk
from patrol_tpu_torch.ops.join_kernel import pair_join_plain
from patrol_tpu_torch.scripts import probe_dma_scatter as probe

jax.config.update("jax_enable_x64", True)  # as the probe script sets it

PROBE = Path(__file__).resolve().parent.parent / "scripts" / "probe_dma_scatter.py"
B, K = 64, 16
INNERS = ("bcast", "pairmax")
_CALLS = {}


def _probe_namespace():
    """The probe script's imports, literal constants and functions, with
    nothing of its module-level run."""
    tree = ast.parse(PROBE.read_text(), str(PROBE))
    keep = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef)):
            keep.append(node)
        elif isinstance(node, ast.Assign):
            try:
                ast.literal_eval(node.value)
            except ValueError:
                continue
            keep.append(node)
    ns = {"__name__": "probe_dma_scatter_reference"}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(PROBE), "exec"), ns)
    return ns


def jax_probe(inner):
    """The probe's ``pallas_call`` of ``mk_kern(inner)`` at B x 8 x 128
    and K updates, in TPU interpret mode."""
    if inner not in _CALLS:
        ns = _probe_namespace()
        assert ns["D"] <= K and (ns["S"], ns["L"]) == (rk.S, rk.L)
        ns.update(B=B, K=K)
        d, s, l = ns["D"], ns["S"], ns["L"]
        _CALLS[inner] = pl.pallas_call(
            ns["mk_kern"](inner),
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * 4
            + [pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pl.ANY),
            out_shape=jax.ShapeDtypeStruct((B, s, l), jnp.int32),
            scratch_shapes=[pltpu.VMEM((d, 1, s, l), jnp.int32),
                            pltpu.VMEM((d, 1, s, l), jnp.int32),
                            pltpu.SemaphoreType.DMA((d,)),
                            pltpu.SemaphoreType.DMA((d,))],
            input_output_aliases={4: 0},
            interpret=pltpu.InterpretParams(),
        )
    return _CALLS[inner]


def run_jax(inner, state, rows, w0, lo, hi):
    out = jax_probe(inner)(*(jnp.asarray(x) for x in (rows, w0, lo, hi, state)))
    return np.asarray(out)


def run_port(inner, state, rows, w0, lo, hi):
    t = torch.from_numpy(state.copy())
    out = rk.row_rmw(t, *(torch.from_numpy(x) for x in (rows, w0, lo, hi)), inner)
    assert out is t  # in place
    return t.numpy()


def rand_updates(rng, signed=True):
    """K unique rows, ``w0`` even in [0, 1024) with both residues mod 4,
    and int32 ``lo``/``hi`` (negative ones too when ``signed``)."""
    w0 = rng.integers(0, 512, K) * 2
    w0[:2] = [4 * int(rng.integers(0, 256)), 4 * int(rng.integers(0, 256)) + 2]
    lo_min = -(1 << 31) if signed else 0
    return (
        rng.choice(B, K, replace=False).astype(np.int32),
        w0.astype(np.int32),
        rng.integers(lo_min, 1 << 31, K).astype(np.int32),
        rng.integers(lo_min, 1 << 31, K).astype(np.int32),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("inner", INNERS)
def test_row_rmw_matches_the_jax_probe_kernel(inner, seed):
    rng = np.random.default_rng(seed)
    state = rng.integers(-(1 << 31), 1 << 31, size=(B, 8, 128)).astype(np.int32)
    upd = rand_updates(rng)
    assert {0, 2} <= set((upd[1] % 4).tolist())
    want = run_jax(inner, state, *upd)
    got = run_port(inner, state, *upd)
    assert np.array_equal(got, want)
    changed = (want != state).reshape(B, -1).any(axis=1)
    assert changed.any() and not changed[np.setdiff1d(np.arange(B), upd[0])].any()
    if inner == "pairmax":
        # Negative pairs of touched rows rise to 0 off the target pair: the
        # update is zero there.
        r = upd[0]
        off = np.ones((K, 512), bool)
        off[np.arange(K), upd[1] >> 1] = False
        pairs = state.view(np.int64).reshape(B, -1)[r]
        out = want.view(np.int64).reshape(B, -1)[r]
        assert (pairs[off] < 0).any() and (out[off] >= 0).all()


def probe_chain_state(inner, n):
    """The entry point's state and chain of ``n`` calls with ``lo + i`` at
    B x K, run on the CPU; → (initial int32 state, final, updates)."""
    state = init_state(LimiterConfig(B, probe.LANES), "cpu")
    probe.fill_state(state.pn)
    view = rk.probe_view(state.pn)
    start = view.numpy().copy()
    upd_np = probe.probe_inputs(B, K)
    upd = {k: torch.from_numpy(v) for k, v in upd_np.items()}
    for call in probe.chain_calls(state, upd, inner)[:n]:
        call()
    return start, view.numpy().copy(), upd_np


def jax_chain(inner, state, upd, n):
    for i in range(n):
        state = run_jax(inner, state, upd["rows"], upd["w0"], upd["lo"] + np.int32(i), upd["hi"])
    return state


@pytest.fixture(scope="module")
def probe_run():
    return probe.main(["--device", "cpu", "--buckets", str(B), "--k", str(K)])


@pytest.mark.parametrize("inner", INNERS)
def test_probe_chain_matches_the_jax_chain(inner, probe_run):
    n = max(probe.CHAINS)
    start, got, upd = probe_chain_state(inner, n)
    want = jax_chain(inner, start, upd, n)
    assert np.array_equal(got, want)
    assert not np.array_equal(want, start)
    # The entry point's schedule (chains of 4 and 24 calls, lo + i from
    # the same start) leaves the state that the chain of 24 leaves: each
    # update is a max, and the schedule's lo offsets are 0..23. Its
    # fingerprint is the wrapping int64 sum of that state.
    res = probe_run["inners"][inner]
    assert res["state_sum"] == int(np.sum(want.view(np.int64), dtype=np.int64))


def test_probe_entry_point_on_the_cpu(probe_run):
    out = probe_run
    assert (out["device"], out["card"], out["buckets"], out["k"]) == ("cpu", "cpu (no card)", B, K)
    assert out["state_bytes"] == B * 256 * 2 * 8
    assert out["pairmax_equals_pair_join"] is True
    calls = probe.CHAINS[0] + probe.REPEATS * sum(probe.CHAINS)
    assert out["row_rmw_calls"] == 2 * calls + 1
    assert {"bcast", "pairmax", "pair_join"} == set(out["inners"])
    for res in out["inners"].values():
        assert res["calls"] == calls and np.isfinite(res["per_row_ns"])
    # pair_join and pairmax are one function on non-negative state.
    assert out["inners"]["pair_join"]["state_sum"] == out["inners"]["pairmax"]["state_sum"]


def test_probe_inputs_are_the_jax_probes_draws():
    got = probe.probe_inputs(1_000_000, 8192)
    rng = np.random.default_rng(3)
    want = {
        "rows": rng.choice(1_000_000 - 8, 8192, replace=False),
        "w0": rng.integers(0, 256, 8192) * 4,
        "lo": rng.integers(1, 1 << 30, 8192),
        "hi": rng.integers(0, 1 << 20, 8192),
    }
    for k, v in want.items():
        assert got[k].dtype == np.int32 and np.array_equal(got[k], v.astype(np.int32)), k
    assert len(np.unique(got["rows"])) == 8192


@pytest.mark.parametrize("seed", [5, 6])
def test_pairmax_equals_pair_join_plain_on_non_negative_state(seed):
    rng = np.random.default_rng(seed)
    pn0 = rng.integers(0, 1 << 62, size=(B, 256, 2), dtype=np.int64)
    rows, w0, lo, hi = rand_updates(rng, signed=False)
    pn = torch.from_numpy(pn0.copy())
    rk.row_rmw(rk.probe_view(pn), *(torch.from_numpy(x) for x in (rows, w0, lo, hi)), "pairmax")
    ops = probe.pair_join_operands(*(torch.from_numpy(x) for x in (rows, w0, lo, hi)))
    twin = torch.from_numpy(pn0.copy())
    pair_join_plain(twin, torch.zeros(B, dtype=torch.int64), *ops)
    assert torch.equal(pn, twin)
    assert not np.array_equal(pn.numpy(), pn0)


def test_probe_view_round_trips_with_state_from_numpy():
    rng = np.random.default_rng(9)
    probe_state = rng.integers(-(1 << 31), 1 << 31, size=(B, 8, 128)).astype(np.int32)
    planes = probe_state.view(np.int64).reshape(B, 256, 2)
    state = state_from_numpy(planes, np.zeros(B, np.int64), device="cpu")
    view = rk.probe_view(state.pn)
    assert view.dtype == torch.int32 and tuple(view.shape) == (B, 8, 128)
    assert np.array_equal(view.numpy(), probe_state)
    # The view shares storage: a write through it lands in the planes.
    view[3, 1, 4] = 7
    view[3, 1, 5] = -1
    assert int(state.pn[3, (128 + 4) // 4, 0]) == (-1 << 32) | 7


@pytest.mark.parametrize("bad", ["lanes64", "int32", "strided"])
def test_probe_view_rejects_other_planes(bad):
    pn = {
        "lanes64": torch.zeros((B, 64, 2), dtype=torch.int64),
        "int32": torch.zeros((B, 256, 2), dtype=torch.int32),
        "strided": torch.zeros((B, 256, 4), dtype=torch.int64)[:, :, :2],
    }[bad]
    with pytest.raises(ValueError):
        rk.probe_view(pn)


def test_row_rmw_plain_raises_on_duplicate_rows():
    state = torch.zeros((B, 8, 128), dtype=torch.int32)
    rows = torch.tensor([1, 5, 1], dtype=torch.int32)
    z = torch.zeros(3, dtype=torch.int32)
    for inner in INNERS:
        with pytest.raises(ValueError, match="unique"):
            rk.row_rmw_plain(state, rows, z, z + 1, z, inner)


def test_row_rmw_drops_out_of_range_rows():
    rng = np.random.default_rng(4)
    state = rng.integers(-(1 << 31), 1 << 31, size=(B, 8, 128)).astype(np.int32)
    rows, w0, lo, hi = rand_updates(rng)
    bad = rows.copy()
    bad[[3, 7]] = [B, -1]
    keep = np.ones(K, bool)
    keep[[3, 7]] = False
    for inner in INNERS:
        want = run_port(inner, state, rows[keep], w0[keep], lo[keep], hi[keep])
        assert np.array_equal(run_port(inner, state, bad, w0, lo, hi), want)


def test_row_rmw_checks_its_operands():
    state = torch.zeros((B, 8, 128), dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="inner"):
        rk.row_rmw(state, z, z, z, z, "sum")
    with pytest.raises(TypeError):
        rk.row_rmw(state, z.long(), z, z, z, "bcast")
    with pytest.raises(ValueError):
        rk.row_rmw(torch.zeros((B, 256, 4), dtype=torch.int32), z, z, z, z, "bcast")
    with pytest.raises(ValueError, match="one length"):
        rk.row_rmw(state, z, z, z[:1], z, "bcast")


def test_probe_asks_for_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(["--buckets", str(B), "--k", str(K)])
