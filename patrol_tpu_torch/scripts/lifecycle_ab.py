"""The lifecycle probe kernel of two trees on one card, in turns.

    python3 patrol_tpu_torch/scripts/lifecycle_ab.py --parent DIR [--out FILE]

Times ``lifecycle_probe`` of this tree and of the tree at ``DIR`` (a
checkout of an earlier commit, unpacked with ``git archive``), each in a
process of its own, in the order parent, this tree, this tree, parent,
through each tree's own wrapper (``ops/lifecycle_kernel.py::probe``), on
the same inputs (made from one seed) at the shape of ``chip_smoke.py``'s
phase 2: state 1,000,000 buckets × 64 lanes, K = 8,192 candidates
(GC_SWEEP_MAX) on distinct random rows:

* ``warm``: the same candidates every call (their 8.4 MB of lane planes
  stay in the 50 MB L2);
* ``cold``: a cycle of 16 candidate sets on fresh rows, 134 MB of planes
  together, so each call finds its rows past L2;
* ``cold_contig``: as ``cold``, each set 8,192 consecutive rows (as a
  sweep over buckets bound in order finds them);
* ``k512``: the first 512 candidates; ``floor``: the first 8 (one block
  of either design).

Each time is the median over 5 batches of the mean device time of 20
back-to-back calls queued behind a spin kernel (``chip_smoke.py``'s
``device_ms``), in ms. Prints one JSON row per turn and then the summary
(each tree's two turns), and writes them to ``--out``. Needs a card:
without one the workers raise.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
THIS_TREE = os.path.dirname(os.path.dirname(HERE))
BUCKETS, LANES, K, COLD_SETS, SEED = 1_000_000, 64, 8192, 16, 20261017
NANO = 1_000_000_000
KEYS = ("warm", "cold", "cold_contig", "k512", "floor")


def device_ms(torch, fn, reps: int = 5, n: int = 20) -> float:
    """Median over ``reps`` batches of the mean device time of ``n``
    back-to-back calls, queued behind a spin kernel so that the events
    bracket device work, not host launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / n)
    return statistics.median(means)


def worker(tree: str) -> dict:
    """Time the probe of the tree at ``tree`` (imported from there)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.ops import lifecycle_kernel as lk

    dev = torch.device("cuda", 0)
    _build.lib()
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pn = torch.empty((BUCKETS, LANES, 2), dtype=torch.int64, device=dev)
    pn.random_(0, 1 << 40, generator=gen)
    el = torch.empty(BUCKETS, dtype=torch.int64, device=dev).random_(0, 1 << 40, generator=gen)

    def probe_set(rows):
        cols = np.stack([
            rows,
            1000 * NANO + rng.integers(0, 100 * NANO, K),
            rng.choice([NANO, 3 * NANO + 1, 60 * NANO], K),
            rng.choice([1, 10, 1000], K) * NANO,
            rng.integers(0, 500 * NANO, K),
        ]).astype(np.int64)
        return [c.contiguous() for c in torch.from_numpy(cols).to(dev).unbind(0)]

    fresh = rng.choice(BUCKETS, (COLD_SETS + 1) * K, replace=False).reshape(-1, K)
    warm = probe_set(fresh[0])
    cold = [probe_set(rows) for rows in fresh[1:]]
    contig = [probe_set(np.arange(i * K, (i + 1) * K)) for i in range(COLD_SETS)]
    out = torch.empty(lk.output_bytes(K), dtype=torch.uint8, device=dev)

    def call(cols):
        lk.probe(pn, el, *cols, 0, out=out)

    cold_it, contig_it = itertools.cycle(cold), itertools.cycle(contig)
    return {
        "tree": tree,
        "card": torch.cuda.get_device_name(0),
        "warm": device_ms(torch, lambda: call(warm)),
        "cold": device_ms(torch, lambda: call(next(cold_it))),
        "cold_contig": device_ms(torch, lambda: call(next(contig_it))),
        "k512": device_ms(torch, lambda: call([c[:512] for c in warm])),
        "floor": device_ms(torch, lambda: call([c[:8] for c in warm])),
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
            cwd=tree, capture_output=True, text=True, check=True,
        ).stdout
        row = {"turn": label, **json.loads(out.strip().splitlines()[-1])}
        rows.append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    summary = {"card": smi, "parent": parent, "order": [row["turn"] for row in rows]}
    for key in KEYS:
        summary[key] = {label: [row[key] for row in rows if row["turn"] == label]
                        for label in ("parent", "change")}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
