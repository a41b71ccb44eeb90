"""The port's prove stage (``patrol_tpu_torch/analysis/prove.py``, stage 4)
against the JAX package's (``patrol_tpu/analysis/prove.py``), on the CPU.

* Root by root over the reference's 24 names: both stages are clean
  everywhere except ``ops.merge.read_rows``, where the reference reports
  its two ``PTP001 'add'`` findings (the negative-index wrap inside its
  gather: index math, not plane math — its known false positive, which
  the JAX package keeps) and the port's clamped gather is clean. The
  port's three own roots (the converge and gather kernels, ``row_rmw``'s
  pairmax) are clean too.
* The six prove-stage mutations: each draws its pinned code from both
  packages.
* Torch counterparts of the reference's structural fixtures
  (``tests/test_prove.py``) fire: an add on a merged plane, an overwrite
  scatter, a float cast, a sync inside a root; index math does not; and a
  ``.cu`` join entry with ``atomicAdd`` fires the CUDA half. The CUDA
  half is clean on ``converge.cu``'s ``converge_kernel`` and draws PTP001
  from three mutants of it: its max made a sum, an ``atomicAdd`` on pn,
  and its store made a store of a sum.
* The registry and the PTP006 sweep; the driver's exit codes.

The reference's run is a module-scoped fixture (about 30 s, most of it
its interpret-mode raw ingest); the port's whole stage takes about 15 s.
"""

import dataclasses
import os
import re

import pytest
import torch

from patrol_tpu_torch.analysis import lint, prove
from patrol_tpu_torch.models.limiter import LimiterState
from patrol_tpu_torch.ops import _build
from patrol_tpu_torch.ops import obligations as ob
from patrol_tpu_torch.ops import take as take_mod
from patrol_tpu_torch.scripts import prove_repo

pytestmark = pytest.mark.prove

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOTS = {r.name: r for r in ob.PROVE_ROOTS}
PORT_OWN = {"ops.converge_kernel.converge", "ops.converge_kernel.gather",
            "ops.row_rmw_kernel.row_rmw"}
KNOWN_REF_FALSE_POSITIVE = "ops.merge.read_rows"


def codes(findings):
    return sorted({f.check for f in findings})


def scoped(name, *obligations, model="keep"):
    """A registry root narrowed to some obligations (a fixture isolates
    one code); the CUDA half is left out unless asked for."""
    base = ROOTS[name]
    return dataclasses.replace(
        base, obligations=tuple(obligations),
        model=base.model if model == "keep" else model, cuda_joins=())


@pytest.fixture(scope="module")
def reference():
    """The reference's stage over its own 24 roots, and its mutations."""
    from patrol_tpu.analysis import prove as jprove
    from patrol_tpu.ops import obligations as job

    roots = {r.name: [(f.check, f.message) for f in jprove.prove_root(r)]
             for r in job.PROVE_ROOTS}
    jroots = {r.name: r for r in job.PROVE_ROOTS}
    muts = {}
    for fam in job.KERNEL_FAMILIES:
        for m in fam.mutations:
            if m.stage == "prove":
                muts[m.name] = (m.expect, codes(jprove.prove_root(jroots[m.target], fn=m.mutant)))
    return roots, muts


@pytest.fixture(scope="module")
def port():
    stats: dict = {}
    findings = prove.prove_all(device="cpu", stats=stats)
    return findings, stats


class TestAgainstTheReference:
    def test_the_roots_are_the_reference_s_plus_three(self, reference):
        roots, _ = reference
        assert len(roots) == 24
        assert set(ROOTS) == set(roots) | PORT_OWN
        from patrol_tpu.ops.obligations import PROVE_ROOTS as JROOTS

        for jr in JROOTS:
            r = ROOTS[jr.name]
            assert (r.obligations, r.structural, r.model) == (
                jr.obligations, jr.structural, jr.model), jr.name

    def test_root_by_root(self, reference, port):
        roots, _ = reference
        findings, stats = port
        by_root = {}
        for f in findings:
            by_root.setdefault(f.message.split("]")[0].lstrip("["), []).append(f)
        for name, got in roots.items():
            if name == KNOWN_REF_FALSE_POSITIVE:
                # The reference's known false positive: its gather's
                # negative-index wrap is an 'add' on index math.
                assert [c for c, _ in got] == ["PTP001", "PTP001"], got
                assert all("primitive 'add'" in m for _, m in got), got
            else:
                assert got == [], (name, got)
            assert by_root.get(name, []) == [], (name, by_root.get(name))
        for name in PORT_OWN:
            assert by_root.get(name, []) == [], name
        assert set(stats) == set(ROOTS)

    def test_models_enumerate_the_reference_s_domains(self, port):
        _, stats = port
        # Each model ran over a non-trivial domain (the structural-only
        # roots enumerate nothing).
        for name, st in stats.items():
            r = ROOTS[name]
            if r.model is not None:
                assert st["combinations"] > 0, name
        assert stats["ops.merge.merge_dense"]["combinations"] == 243 * 243 * 2 + 243 + 32 ** 3 * 4
        assert "plain against plain on the CPU" in stats["ops.pallas_merge.merge_batch_pallas"]["notes"]

    @pytest.mark.parametrize("name", sorted(m.name for m in ob.MUTATIONS if m.stage == "prove"))
    def test_mutation_draws_the_pinned_code_in_both(self, reference, name):
        _, jmuts = reference
        m = next(x for x in ob.MUTATIONS if x.name == name)
        got = codes(prove.prove_root(ROOTS[m.target], fn=m.mutant, device="cpu"))
        jexpect, jgot = jmuts[name]
        assert m.expect == jexpect
        assert m.expect in got and jexpect in jgot, (got, jgot)

    def test_the_port_pins_all_six(self):
        names = {m.name for m in ob.MUTATIONS if m.stage == "prove"}
        assert names == {"take-n-uncapped-crowd", "take-split-lifo", "take-split-deny-drift",
                         "gcra-window-off-by-one", "conc-release-unclamped",
                         "quota-admit-leaf-only"}


# --- the structural pass: torch counterparts of the reference's fixtures ---


def add_merge_dense(a, b):
    """The classic refactor mistake: + where max belongs."""
    return LimiterState(a.pn + b.pn, torch.maximum(a.elapsed, b.elapsed))


def set_merge_batch(state, batch):
    """Last-write-wins scatter: order-dependent, non-monotone."""
    state.pn[batch.rows, batch.slots, 0] = batch.added_nt
    return state


def f32_merge_dense(a, b):
    """A float round trip on the planes."""
    return LimiterState(
        torch.maximum(a.pn.to(torch.float32), b.pn.to(torch.float32)).to(torch.int64),
        torch.maximum(a.elapsed, b.elapsed))


def sync_take(state, req, node_slot):
    """A host read of a plane inside the root."""
    out, res = take_mod.take_batch(state, req, node_slot)
    if out.pn[0, 0, 0].item() < 0:
        raise AssertionError
    return out, res


def sum_merge_batch(state, batch):
    """A scatter-add on the planes."""
    state.pn[:, :, 0].index_put_((batch.rows, batch.slots), batch.added_nt, accumulate=True)
    return state


class TestStructuralPass:
    def test_fires_on_add_on_merged_plane(self):
        f = prove.prove_root(scoped("ops.merge.merge_dense", "PTP001", model=None),
                             fn=add_merge_dense, device="cpu")
        assert codes(f) == ["PTP001"] and "'add'" in f[0].message

    def test_fires_on_overwrite_scatter(self):
        f = prove.prove_root(scoped("ops.merge.merge_batch", "PTP001", model=None),
                             fn=set_merge_batch, device="cpu")
        assert codes(f) == ["PTP001"] and "scatter" in f[0].message

    def test_fires_on_scatter_add(self):
        f = prove.prove_root(scoped("ops.merge.merge_batch", "PTP001", model=None),
                             fn=sum_merge_batch, device="cpu")
        assert codes(f) == ["PTP001"] and "scatter-add" in f[0].message

    def test_fires_on_float_cast_of_state_plane(self):
        f = prove.prove_root(scoped("ops.merge.merge_dense", "PTP001", model=None),
                             fn=f32_merge_dense, device="cpu")
        assert codes(f) == ["PTP001"] and "float cast" in f[0].message

    def test_fires_on_sync_inside_a_root(self):
        f = prove.prove_root(scoped("ops.take.take_batch", "PTP001", model=None), fn=sync_take,
                             device="cpu")
        assert codes(f) == ["PTP001"] and "host-device sync" in f[0].message
        assert f[0].path == "tests/test_torch_prove.py"

    def test_silent_on_shipped_joins(self):
        for name in ("ops.merge.merge_batch", "ops.merge.merge_batch_folded",
                     "ops.merge.merge_rows_dense", "ops.merge.merge_dense",
                     "ops.merge.read_rows", "ops.converge_kernel.converge",
                     "ops.converge_kernel.gather", "ops.row_rmw_kernel.row_rmw"):
            assert prove.prove_root(scoped(name, "PTP001", model=None), device="cpu") == [], name

    def test_take_local_adds_are_not_flagged(self):
        # The delta profile: take's scatter-add is the point; its plain
        # version's mask reads run only on the CPU (a CPU branch).
        assert prove.prove_root(scoped("ops.take.take_batch", "PTP001", model=None),
                                device="cpu") == []

    def test_index_math_is_not_tainted(self):
        # read_rows wraps and clamps its rows before the gather: index
        # math on the rows, never on a plane.
        assert prove.prove_root(scoped("ops.merge.read_rows", "PTP001", model=None),
                                device="cpu") == []

    def test_pure_read_must_not_write(self):
        def writes(state, probe, node_slot):
            state.elapsed.add_(1)
            from patrol_tpu_torch.ops.lifecycle import lifecycle_probe

            return lifecycle_probe(state, probe, node_slot)

        f = prove.prove_root(scoped("ops.lifecycle.lifecycle_probe", "PTP005", model=None),
                             fn=writes, device="cpu")
        assert codes(f) == ["PTP005"] and "pure read" in f[0].message

    def test_state_output_dtype_is_pinned(self):
        def f32_out(a, b):
            return LimiterState(torch.maximum(a.pn, b.pn).double(), a.elapsed)

        f = prove.prove_root(scoped("ops.merge.merge_dense", "PTP005", model=None), fn=f32_out,
                             device="cpu")
        assert codes(f) == ["PTP005"] and "float dtype" in f[0].message


class TestCudaHalf:
    def _join_cu(self):
        return lint.repo_cuda_sources(REPO)

    def test_shipped_join_entries_are_clean(self):
        cu = self._join_cu()
        for r in ob.PROVE_ROOTS:
            if r.cuda_joins:
                assert prove.cuda_join_findings(r, cu) == [], r.name

    def test_atomic_add_in_a_join_entry_fires(self):
        cu = self._join_cu()
        rel = "patrol_tpu_torch/csrc/join.cu"
        line = "atomicMax(a.pn + (r * a.N + s) * 2 + (t & 1), v);"
        assert cu[rel].count(line) == 1
        bad = cu[rel].replace(line, line.replace("atomicMax", "atomicAdd"))
        f = prove.cuda_join_findings(ROOTS["ops.merge.merge_batch"], {**cu, rel: bad})
        want = cu[rel][: cu[rel].index(line)].count("\n") + 1
        assert ("PTP001", rel, want) in {(x.check, x.path, x.line) for x in f}
        assert any("atomicAdd" in x.message for x in f)

    def test_a_store_of_a_sum_fires(self):
        cu = self._join_cu()
        rel = "patrol_tpu_torch/csrc/join.cu"
        line = "if (r >= 0 && r < a.B) atomicMax(a.elapsed + r, v);"
        assert cu[rel].count(line) == 1
        bad = cu[rel].replace(line, "if (r >= 0 && r < a.B) a.elapsed[r] = a.elapsed[r] + v;")
        f = prove.cuda_join_findings(ROOTS["ops.merge.merge_batch"], {**cu, rel: bad})
        assert any("store of a sum" in x.message for x in f)


# converge.cu's join: the shipped source is clean; each mutant of
# converge_kernel draws PTP001 with its message.
CONVERGE_STORE = "lanes_at(a.pn, row * a.N + v) = m;"
CONVERGE_MUTANTS = {
    "shipped": None,
    "max_as_sum": "holds no max",
    "atomic_add_on_pn": "atomicAdd() on a merged plane",
    "store_of_a_sum": "a store of a sum",
}


def converge_mutant(src: str, mutant: str) -> str:
    """converge.cu with ``converge_kernel`` mutated: every signed max a
    sum, an ``atomicAdd`` on pn in place of the store of the max, or that
    store made a store of a sum."""
    if mutant == "shipped":
        return src
    lo = src.index("converge_kernel(const ConvergeArgs a) {")
    body = src[lo:]
    if mutant == "max_as_sum":
        return src[:lo] + re.sub(r"smax\(([^,()]+(?:\[[^\]]*\])?), ([^()]+(?:\[[^\]]*\])?)\)",
                                 r"(\1 + \2)", body)
    if mutant == "atomic_add_on_pn":
        return src.replace(CONVERGE_STORE, "atomicAdd(reinterpret_cast<unsigned long long*>"
                           "(a.pn) + 2 * (row * a.N + v), (unsigned long long)m.x);")
    return src.replace(CONVERGE_STORE, "lanes_at(a.pn, row * a.N + v) = "
                       "lanes_at(a.pn, row * a.N + v) + m;")


@pytest.mark.parametrize("mutant", list(CONVERGE_MUTANTS))
def test_converge_cu_join_scan(mutant):
    """PTP001's CUDA half over the converge kernel: clean as shipped; a
    mutant whose max is a sum, that adds into pn atomically, or that
    stores a sum into pn, is caught."""
    cu = lint.repo_cuda_sources(REPO)
    rel = "patrol_tpu_torch/csrc/converge.cu"
    assert cu[rel].count(CONVERGE_STORE) == 1
    bad = converge_mutant(cu[rel], mutant)
    if mutant != "shipped":
        assert bad != cu[rel]
    f = prove.cuda_join_findings(ROOTS["ops.converge_kernel.converge"], {**cu, rel: bad})
    want = CONVERGE_MUTANTS[mutant]
    if want is None:
        assert f == []
    else:
        assert f and {x.check for x in f} == {"PTP001"}
        assert any(want in x.message and x.path == rel for x in f), [x.message for x in f]


class TestRegistration:
    def test_the_repo_registers_every_launch_and_state_call(self):
        assert prove.registration_findings(lint.repo_sources(REPO)) == []

    def test_every_launch_key_is_declared_by_a_root(self):
        declared = {k for r in ob.PROVE_ROOTS for k in r.launches}
        assert declared == set(_build.LAUNCHES)

    def test_a_root_less_launch_key_fires(self):
        f = prove.registration_findings(
            lint.repo_sources(REPO), launch_keys=(*_build.LAUNCHES, "shadow"))
        assert [(x.check, "shadow" in x.message) for x in f] == [("PTP006", True)]

    def test_an_unregistered_state_call_fires(self):
        rel = "patrol_tpu_torch/runtime/engine.py"
        src = lint.repo_sources(REPO)
        anchor = "    def read_rows(self, rows) -> tuple:\n"
        extra = ("    def shadow_zero(self, rows) -> None:\n"
                 "        merge_mod.zero_rows(self.state, rows)\n\n")
        sources = {**src, rel: src[rel].replace(anchor, extra + anchor)}
        assert prove.registration_findings(sources) == []  # zero_rows is exempt
        f = prove.registration_findings(sources, exempt=set())
        assert {x.check for x in f} == {"PTP006"}
        assert any("zero_rows" in x.message for x in f)

    def test_every_root_declares_or_justifies_every_code(self):
        for fam in ob.KERNEL_FAMILIES:
            for r in fam.prove_roots:
                for code in prove.ALL_CODES:
                    key = f"{r.name}:{code}"
                    assert (code in r.obligations) != (key in fam.absent), key

    def test_zero_rows_is_the_one_exemption(self):
        assert set(ob.PROVE_EXEMPT) == {("patrol_tpu_torch.ops.merge", "zero_rows")}


class TestDriver:
    def test_list(self, capsys):
        assert prove_repo.main(["--device", "cpu", "--list"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert sum(1 for ln in out if not ln.startswith(("exempt:", "mutation:"))) == 27

    def test_one_mutation(self, capsys):
        assert prove_repo.main(["--device", "cpu", "--mutation", "take-split-lifo"]) == 0
        assert capsys.readouterr().out.splitlines()[-1] == (
            "patrol-prove: mutation 'take-split-lifo' REJECTED by PTP002 (good)")

    def test_unknown_mutation(self):
        assert prove_repo.main(["--device", "cpu", "--mutation", "no-such"]) == 2



@pytest.mark.cuda
def test_prove_on_the_card_moves_every_launch_key():
    """Every root on the card (chip_smoke.py phase 3m runs the same):
    clean, and each of the 12 launch keys moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels do not run on the CPU")
    _build.reset_launches()
    assert prove.prove_repo(REPO, device="cuda") == []
    assert all(v > 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES
