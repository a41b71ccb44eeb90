"""The readings that a cell's limits are set from: the program's and the control's.

    python3 portbench/control.py --workload NAME --seeds N1,N2,... [--seconds S] [--out FILE]

Runs the cell once a seed, each run in a process of its own as the
benchmark runs it, with the control on: the plain reference computed in
the precision below the one the configuration states (float64 for its
int64 nanotoken counters) is put in the program's place and judged by the
same comparison. The program's numbers on every seed are the lower
readings, the control's the upper ones (``PERF.md`` gives both beside each
limit); the faults planted in the reference (``fold.faulted``) are read
beside them, the least of each over the seeds. Needs a card. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window (default: BENCHMARK.json's run_seconds)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = subprocess.run(
            [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload,
             "--seed", str(seed), "--seconds", str(seconds), "--trace", "0", "--control", "1"],
            cwd=ROOT, capture_output=True, text=True)
        if out.returncode != 0:
            rows.append({"seed": seed, "rc": out.returncode, "stderr": out.stderr[-2000:]})
        else:
            res = json.loads(out.stdout.strip().splitlines()[-1])
            rows.append({"seed": seed, "correct": res["correct"],
                         "program": {k: v["value"] for k, v in res["checks"].items()},
                         "control": res["control"], "faults": res["faults"],
                         "metrics": {k: v["value"] for k, v in res["metrics"].items()}})
        print(json.dumps(rows[-1]), flush=True)
    ok = [r for r in rows if "program" in r]
    summary = {
        "workload": args.workload, "seconds": seconds, "runs": len(rows), "ran": len(ok),
        "lower": {k: max(r["program"][k] for r in ok) for k in ok[0]["program"]} if ok else None,
        "upper": {k: min(r["control"][k] for r in ok) for k in ok[0]["control"]} if ok else None,
        "faults": {f: {k: min(r["faults"][f][k] for r in ok) for k in ok[0]["faults"][f]}
                   for f in ok[0]["faults"]} if ok else None,
        "control_failed_every_seed": all(
            any(r["control"][k] > 0 for k in r["control"]) for r in ok) if ok else None,
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0 if ok and len(ok) == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())
