"""A whole run of a cell on the CPU at a small size, and with the timed
path broken underneath: ``correct`` has to come out false for each fault a
delta cell can have. The card's own run is the ``cuda``-marked test."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL = {"config": {"keys": 3000, "buckets": 4096, "node_lanes": 8, "members": 4},
         "traffic": {"warm_s": 0.3}}


def small_run(traffic="deltas-fanin-zipf", seed=2**31 + 11, control=False):
    """The manifest's cell at a small size, under any traffic mix of
    ``traffic/`` (a mix that no cell runs yet included)."""
    with open(os.path.join(ROOT, "portbench", "traffic", traffic + ".json")) as f:
        mix = json.load(f)
    overrides = {"config": SMALL["config"], "traffic": {**mix, **SMALL["traffic"]}}
    cell = run.Cell("deltas-3node-zipf", seed, 1.0, False, device="cpu", control=control,
                    overrides=overrides)
    return run.run_cell(cell)


@pytest.mark.parametrize("traffic", ["deltas-fanin-uniform", "deltas-fanin-zipf"])
def test_a_sound_run_is_correct_and_the_control_is_not(traffic):
    res = small_run(traffic, control=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["metrics"]["ack_p95_ms"]["value"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0
    assert list(res)[-1] == "checks"
    assert res["control"]["lane_mismatches"] > 0
    for kind in ("state_unchanged", "half_the_batch"):
        assert any(v > 0 for v in res["faults"][kind].values()), (kind, res["faults"])


def _fault(kind):
    from patrol_tpu_torch.ops import ingest_kernel

    orig = ingest_kernel.decode_fold_plain

    def broken(pn, elapsed, planes, lengths, entry_off, rows, hosted):
        if kind == "state_unchanged":
            return orig(pn.clone(), elapsed.clone(), planes, lengths, entry_off, rows, hosted)
        if kind == "half_the_batch":
            lengths = lengths.clone()
            lengths[lengths.shape[0] // 2:] = 0
            if lengths.shape[0] == 1:
                lengths[:] = 0
            return orig(pn, elapsed, planes, lengths, entry_off, rows, hosted)
        res = orig(pn, elapsed, planes, lengths, entry_off, rows, hosted)
        live = (res[1] & ~res[2]).nonzero()
        if len(live):
            p, e = (int(x) for x in live[0])
            pn[int(rows[p, e]), int(res[3][p, e]), 1] += 1
        return res

    return ingest_kernel, orig, broken


@pytest.mark.parametrize("kind", ["state_unchanged", "half_the_batch", "value_altered"])
def test_a_broken_timed_path_is_not_correct(kind, monkeypatch):
    mod, _, broken = _fault(kind)
    monkeypatch.setattr(mod, "decode_fold_plain", broken)
    res = small_run("deltas-fanin-uniform", seed=2**31 + 12)
    assert not res["correct"], res["checks"]


def test_without_a_card_run_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "deltas-3node-zipf",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
def test_the_card_runs_a_cell_correctly():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "deltas-3node-zipf",
                          "--seed", str(2**31 + 13), "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0
