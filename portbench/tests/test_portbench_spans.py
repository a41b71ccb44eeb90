"""A traced run of a cell on the CPU at a small size yields the per-layer
metrics that read the program's own spans and queue times
(``replication.ack_hold_ms``, ``replication.rx_queue_ms``,
``ingest.rx_busy_pct``). The card's trace window is replaced by one over
the CPU's ops alone, so that ``--trace 1``'s readers run here."""

import json
import math
import os
import tempfile
import time

import torch
from torch._C._profiler import _ExperimentalConfig

from portbench import run
from portbench import trace as trace_mod
from portbench.tests.test_portbench_cell import ROOT, SMALL

NEW = ("replication.ack_hold_ms", "replication.rx_queue_ms", "ingest.rx_busy_pct")


class CpuWindow(trace_mod.Window):
    """The harness's window over every thread's CPU ops, with no card."""

    def __init__(self, torch_mod):
        self.torch = torch_mod
        self.prof = torch_mod.profiler.profile(
            activities=[torch_mod.profiler.ProfilerActivity.CPU],
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.t0 = self.t1 = None

    def stop(self):
        self.t1 = time.monotonic()
        self.prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return trace_mod.summarize(events, self.t1 - self.t0)


def test_a_traced_cpu_run_reads_the_programs_spans_and_queues(monkeypatch):
    monkeypatch.setattr(trace_mod, "Window", CpuWindow)
    with open(os.path.join(ROOT, "portbench", "traffic", "deltas-fanin-zipf.json")) as f:
        mix = json.load(f)
    overrides = {"config": SMALL["config"], "traffic": {**mix, **SMALL["traffic"]}}
    cell = run.Cell("deltas-3node-zipf", 2**31 + 21, 1.0, True, device="cpu",
                    overrides=overrides)
    res = run.run_cell(cell)
    assert res["correct"], res["checks"]
    for name in NEW:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    assert 0 < res["metrics"]["ingest.rx_busy_pct"]["value"] <= 100
    assert res["metrics"]["replication.ack_hold_ms"]["value"] > 0
