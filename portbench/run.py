"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its result.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. The cell's configuration and traffic are
the files that ``BENCHMARK.json`` names (``configs/<config>.json``,
``traffic/<traffic>.json``); the traffic's ``kind`` names the module,
``kinds/<kind>.py``, that starts the node under test (one
``patrol_tpu_torch`` ``Command`` in this process, on ``cuda:0``) and its
load, measures ``--seconds`` seconds after its set-up, and reads the
node's state back for the plain reference. Each metric is read by its own
file, ``metrics/<metric>.py``: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones, over a ``torch.profiler``
window. The last line of standard output is the result, one JSON object;
the numbers that decided ``correct`` end it (``checks``) and end standard
error, each beside its limit.

Exits 2 without a result when there is no card or fewer than the cell
asks for, and 1 when the program is missing, a run fails, or ``jax``,
``jaxlib``, ``flax`` or ``patrol_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "patrol_tpu")
# Build and kernel caches at fixed paths inside the checkout, so that only
# the first run of a cell in a checkout compiles (the port builds its own
# kernels and host library under patrol_tpu_torch/_build/ likewise).
CACHE_DIRS = {
    "TRITON_CACHE_DIR": os.path.join(HERE, ".cache", "triton"),
    "TORCH_EXTENSIONS_DIR": os.path.join(HERE, ".cache", "torch_extensions"),
}


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell of the manifest with the files it names, and one run's
    arguments. ``overrides`` replaces configuration or traffic keys; the
    benchmark's own runs give none (the CPU tests shrink a cell with it)."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool,
                 root: str = ROOT, device: str = "cuda", control: bool = False,
                 overrides: Optional[Dict[str, dict]] = None):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.manifest = json.load(f)
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        conf = next(c for c in self.manifest["configs"] if c["name"] == self.workload["config"])
        with open(os.path.join(root, conf["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(HERE, "traffic", self.workload["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        overrides = overrides or {}
        self.config.update(overrides.get("config", {}))
        self.traffic.update(overrides.get("traffic", {}))
        self.name = workload
        self.seed = int(seed) & ((1 << 63) - 1)
        self.seconds = float(seconds)
        self.trace = trace
        self.device = device
        self.control = control
        self.t_start = T_START

    def metrics(self, kind: str):
        """The manifest's metrics of one kind (``end_to_end`` or
        ``per_layer``) that this cell reports."""
        out = []
        for m in self.manifest[kind]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or self._reports(m["moves"]):
                out.append(m)
        return out

    def _reports(self, e2e: str) -> bool:
        return any(m["name"] == e2e for m in self.metrics("end_to_end"))


def read_metrics(cell: Cell, ctx: dict) -> Dict[str, dict]:
    out = {}
    for m in cell.metrics("per_layer" if cell.trace else "end_to_end"):
        reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                             "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: Cell) -> dict:
    """Run ``cell`` once → the result object (without printing it)."""
    for k, v in cell.config.get("env", {}).items():
        os.environ[k] = str(v)
    for k, v in CACHE_DIRS.items():
        os.environ.setdefault(k, v)
    kind = importlib.import_module("portbench.kinds." + cell.traffic["kind"])
    ctx = kind.run(cell)
    checks = ctx["checks"]
    return {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": ctx["attempted"],
        "failed": ctx["failed"],
        "metrics": read_metrics(cell, ctx),
        "device": ctx["device"],
        **({"breakdown": {k: ctx["trace"][k] for k in ("device_ops", "idle_gaps")}}
           if cell.trace and ctx.get("trace") else {}),
        "setup_steps": ctx["setup_steps"],
        "load": {k: ctx["peers"][k] for k in ("latency_ms", "fresh", "resent")},
        **({"control": ctx["control"], "faults": ctx["faults"]} if cell.control else {}),
        "checks": checks,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Also judge the control (the reference in a lower precision in the
    # program's place); portbench/control.py passes it, the benchmark's
    # own runs do not.
    ap.add_argument("--control", type=int, choices=(0, 1), default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cell = Cell(args.workload, args.seed, args.seconds, bool(args.trace),
                control=bool(args.control))
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(cell)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
