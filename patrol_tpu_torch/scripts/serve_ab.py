"""The single-card serving paths' host time, two trees on one card, in turns.

    python3 patrol_tpu_torch/scripts/serve_ab.py --parent DIR [--out FILE]

Runs ``chip_smoke.py``'s phase 3f residency leg (one node at the
defaults: the native front and host store, ``pt_http_blast`` over
200,000 names, cold, warm and 1 x 1 windows) and its phase 3i (the
certified families through a ``Command`` at the defaults, 192
microbatches of K = 8,192, each family's host time a call by step, held
bit for bit to a CPU replay) for this tree and for the tree at ``DIR``
(a checkout of an earlier commit, unpacked with ``git archive``), each
turn in a process of its own that imports that tree's package and its
own ``chip_smoke.py``, in the order parent, this tree, this tree,
parent. Both phases run on a 1,000,000 × 64 state with the GC window
pinned to 0, as ``chip_smoke.py`` runs them. Host-bound rates move
from one run of the script to the next; within one run the turns share
the host, so a difference between the trees larger than the spread of
each tree's two turns is the change's. Prints one JSON row per turn and then
the summary, and writes them to ``--out``. Needs a card: without one
the workers raise.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
THIS_TREE = os.path.dirname(os.path.dirname(HERE))
WINDOWS = ("cold", "warm", "warm_1x1")
FAMILIES = ("gcra", "conc", "quota")


def worker(tree: str) -> dict:
    """Run 3f's residency leg and 3i on the tree at ``tree`` (its package
    and its ``chip_smoke.py``)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("serve_ab_smoke",
                                                  os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from patrol_tpu_torch.command import Command
    from patrol_tpu_torch.models.limiter import LimiterConfig
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.runtime import engine as engine_mod

    _build.lib()
    engine_mod.GC_WINDOW_NS = 0
    engine_mod.HOST_FASTPATH = True
    res = cs.run_residency_leg(Command, LimiterConfig, engine_mod, np.random.default_rng(17))
    torch.cuda.empty_cache()
    cert = cs.run_cert_phase(Command, LimiterConfig, engine_mod, torch)
    return {
        "tree": tree,
        "card": torch.cuda.get_device_name(0),
        "3f": {w: {k: res[w][k] for k in ("rps", "p50_us", "p99_us")} for w in WINDOWS},
        "3i": {
            "call_us_p50": cert["call_us_p50"],
            "call_us_p99": cert["call_us_p99"],
            "idle_gcra_call_us_p50": cert["idle_gcra_call_us_p50"],
            "steps_us_p50": {f: {k: v["p50"] for k, v in steps.items()}
                             for f, steps in cert["call_steps_us"].items()},
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the earlier tree (a directory)")
    ap.add_argument("--out", help="also write the rows and the summary here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return {}
    if not args.parent:
        ap.error("--parent is required")
    parent = os.path.abspath(args.parent)
    rows = []
    for label, tree in (("parent", parent), ("change", THIS_TREE),
                        ("change", THIS_TREE), ("parent", parent)):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree],
            cwd=tree, capture_output=True, text=True,
        )
        if out.returncode != 0:
            raise SystemExit(f"the {label} turn failed:\n{out.stderr[-4000:]}")
        row = {"turn": label, **json.loads(out.stdout.strip().splitlines()[-1])}
        rows.append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    def both(get):
        return {label: [get(row) for row in rows if row["turn"] == label]
                for label in ("parent", "change")}

    summary = {
        "card": smi, "parent": parent, "order": [row["turn"] for row in rows],
        "3f": {w: {k: both(lambda r, w=w, k=k: r["3f"][w][k]) for k in ("rps", "p50_us", "p99_us")}
               for w in WINDOWS},
        "3i": {f: both(lambda r, f=f: r["3i"]["call_us_p50"][f]) for f in FAMILIES},
        "3i_idle_gcra": both(lambda r: r["3i"]["idle_gcra_call_us_p50"]),
    }
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
