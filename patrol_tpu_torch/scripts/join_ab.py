"""The join kernel of two trees on one card, in turns.

    python3 patrol_tpu_torch/scripts/join_ab.py --parent DIR [--out FILE]

Times the scatter-max join of this tree and of the tree at ``DIR`` (a
checkout of an earlier commit, unpacked with ``git archive``), each in a
process of its own, in the order parent, this tree, this tree, parent,
through each tree's own wrappers, on the same inputs (made from one
seed) at the shapes of ``chip_smoke.py``'s phase 2, state 1,000,000
buckets × 64 lanes:

* ``pair``: ``pair_join`` at 8,192 pairs, a quarter of them on 64 hot
  rows, 256 sentinels; ``pair_floor``: one live pair;
* ``row``: ``row_join`` at 512 dense rows; ``row_floor``: one row;
* ``tick``: the hybrid tick, 512 dense rows and 8,192 unique pairs on
  other rows — ``tick_join`` where the tree has it, else ``row_join``
  then ``pair_join``, as that tree's engine launched them;
* ``ring`` / ``ring_cold``: the J = 8 commit ring of 64,536 folded
  deltas, the same ring again, or a cycle of 16 rings on fresh rows —
  ``commit_packed`` with the fold's live counts where the tree takes
  them, else the whole ring.

Each time is the median over 5 batches of the mean device time of 20
back-to-back calls queued behind a spin kernel (``chip_smoke.py``'s
``device_ms``), in ms. Prints one JSON row per turn and then the
summary (each tree's two turns), and writes them to ``--out``. Needs a
card: without one the workers raise.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
THIS_TREE = os.path.dirname(os.path.dirname(HERE))
BUCKETS, LANES, SEED = 1_000_000, 64, 20261017


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
    """Time the joins of the tree at ``tree`` (imported from there)."""
    sys.path.insert(0, tree)
    import itertools

    import numpy as np
    import torch

    from patrol_tpu_torch.models.limiter import LimiterState
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.ops import commit as commit_mod
    from patrol_tpu_torch.ops import join_kernel as jk
    from patrol_tpu_torch.ops.merge import FOLD_PAD_ROW
    from patrol_tpu_torch.runtime import engine

    dev = torch.device("cuda", 0)
    _build.lib()
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pn = torch.empty((BUCKETS, LANES, 2), dtype=torch.int64, device=dev)
    pn.random_(0, 1 << 40, generator=gen)
    el = torch.empty(BUCKETS, dtype=torch.int64, device=dev).random_(0, 1 << 40, generator=gen)
    big = 1 << 40

    def dev64(*xs):
        return [torch.from_numpy(np.ascontiguousarray(x, np.int64)).to(dev) for x in xs]

    k, r = 8192, 512
    rows = rng.integers(0, BUCKETS, k)
    rows[: k // 4] = rng.integers(0, 64, k // 4)
    rows[-256:] = FOLD_PAD_ROW + np.arange(256)
    vals = rng.integers(0, 2 * big, size=(3, k))
    pair = dev64(rows, rng.integers(0, LANES, k), vals[0], vals[1], rows, vals[2])
    pair_one = [a[:1] for a in pair[:4]] + [pair[4][:0], pair[5][:0]]
    drows = rng.choice(BUCKETS, r, replace=False)
    drows[-8:] = FOLD_PAD_ROW + np.arange(8)
    upd = rng.integers(0, 2 * big, size=(r, LANES, 2))
    upd[:, ::3] = 0
    dense = dev64(drows, upd, rng.integers(0, 2 * big, r))
    hrows = rng.choice(BUCKETS, r + k, replace=False)
    hdense = dev64(hrows[:r], upd, rng.integers(0, 2 * big, r))
    hpairs = dev64(hrows[r:], rng.integers(0, LANES, k), *rng.integers(0, 2 * big, size=(2, k)),
                   hrows[r:], rng.integers(0, 2 * big, k))

    def fold_ring():
        n = 8 * 8192 - 1000
        d = engine.DeltaArrays(
            rng.integers(0, BUCKETS, n), rng.integers(0, LANES, n),
            rng.integers(0, 2 * big, n), rng.integers(0, 2 * big, n),
            rng.integers(0, 2 * big, n), np.zeros(n, bool),
        )
        ur, us, ua, ut, er, e = engine.fold_core(d)
        ring = commit_mod.pack_commit_blocks(ur, us, ua, ut, er, e, 8192)
        return torch.from_numpy(ring).to(dev), len(ur), len(er)

    rings = [fold_ring() for _ in range(17)]
    state = LimiterState(pn, el)
    live_counts = "n" in inspect.signature(commit_mod.commit_packed).parameters

    def commit(ring):
        packed, n, ne = ring
        if live_counts:
            return commit_mod.commit_packed(state, packed, n, ne)
        return commit_mod.commit_packed(state, packed)

    if hasattr(jk, "tick_join"):
        def tick():
            jk.tick_join(pn, el, hdense, hpairs)
    else:
        def tick():
            jk.row_join(pn, el, *hdense)
            jk.pair_join(pn, el, *hpairs)

    cold = itertools.cycle(rings[1:])
    return {
        "tree": tree,
        "card": torch.cuda.get_device_name(0),
        "live_counts": live_counts, "tick_join": hasattr(jk, "tick_join"),
        "pair": device_ms(torch, lambda: jk.pair_join(pn, el, *pair)),
        "pair_floor": device_ms(torch, lambda: jk.pair_join(pn, el, *pair_one)),
        "row": device_ms(torch, lambda: jk.row_join(pn, el, *dense)),
        "row_floor": device_ms(torch, lambda: jk.row_join(pn, el, *(a[:1] for a in dense))),
        "tick": device_ms(torch, tick),
        "ring": device_ms(torch, lambda: commit(rings[0])),
        "ring_cold": device_ms(torch, lambda: commit(next(cold))),
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
    keys = ("pair", "pair_floor", "row", "row_floor", "tick", "ring", "ring_cold")
    summary = {"card": smi, "order": [row["turn"] for row in rows]}
    for key in keys:
        summary[key] = {label: [row[key] for row in rows if row["turn"] == label]
                        for label in ("parent", "change")}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
