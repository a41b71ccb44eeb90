"""The mesh's gather and converge kernels of two trees on one card, in turns.

    python3 patrol_tpu_torch/scripts/converge_ab.py --parent DIR [--out FILE]

Times ``mesh_gather`` and ``converge`` (``csrc/converge.cu``) of this tree
and of the tree at ``DIR`` (a checkout of an earlier commit, unpacked with
``git archive``), each in a process of its own, in the order parent, this
tree, this tree, parent, through each tree's own wrappers
(``ops/converge_kernel.py::gather`` and ``::converge``), on the same
inputs (made on the card from one seed) on a state of 1,000,000 buckets
× 64 lanes, at three shapes (R replicas, T take rows, N lanes): (2, 4,096,
64), phase 2's main one; (4, 4,096, 64), 3o's R; (2, 32,768, 64), a large
tick. At each shape, for each kernel:

* ``warm``: the same rows and scratch every call (they stay in L2);
* ``cold``: a cycle of row sets and scratches of 100 MB or more, so each
  call finds its rows and scratch past the 50 MB L2;
* ``floor``: T = 1;

and ``chain``: a dispatch's order on the cold cycle, a gather then a
converge of the same rows and scratch (the time of the pair).

Each time is the median over 5 batches of the mean device time of 20
back-to-back calls queued behind a spin kernel (``chip_smoke.py``'s
``device_ms``), in ms. Every turn also runs one fixed gather and converge
and reports a digest of what they wrote: the trees must agree. Prints one
JSON row per turn and then the summary (each tree's two turns, this
tree's share of each shape's bound cold), and writes them to ``--out``.
Needs a card: without one the workers raise.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
THIS_TREE = os.path.dirname(os.path.dirname(HERE))
BUCKETS, LANES, SEED = 1_000_000, 64, 20261019
SHAPES = ((2, 4096, LANES), (4, 4096, LANES), (2, 32768, LANES))
COLD_BYTES = 100_000_000
KERNELS = ("mesh_gather", "converge")
CASES = ("warm", "cold", "floor")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


def shape_key(shape) -> str:
    return "R{}_T{}_N{}".format(*shape)


def nbytes(r: int, t: int, n: int) -> int:
    """Each pass reads or writes the R copies and the canonical rows once,
    and reads the T row indices (``chip_smoke.py``'s count)."""
    return (r + 1) * t * (16 * n + 8) + 8 * t


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
    """Time both kernels of the tree at ``tree`` (imported from there)."""
    sys.path.insert(0, tree)
    import torch

    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.ops import converge_kernel as ck

    dev = torch.device("cuda", 0)
    _build.lib()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def words(shape):
        return torch.empty(shape, dtype=torch.int64, device=dev).random_(generator=gen) - (1 << 62)

    pn, el = words((BUCKETS, LANES, 2)), words((BUCKETS,))
    kern = {"mesh_gather": ck.gather, "converge": ck.converge}
    out = {"tree": tree, "card": torch.cuda.get_device_name(0)}
    for r, t, n in SHAPES:
        def operands(tt):
            rows = torch.randperm(BUCKETS, device=dev, generator=gen)[:tt].contiguous()
            return rows, words((r, tt, n, 2)), words((r, tt))

        sets = max(2, -(-COLD_BYTES // nbytes(r, t, n)))
        warm, floor = operands(t), operands(1)
        cold = [operands(t) for _ in range(sets)]
        row = {"cold_sets": sets}
        for name in KERNELS:
            it = itertools.cycle(cold)
            row[name] = {
                "warm": device_ms(torch, lambda: kern[name](pn, el, *warm)),
                "cold": device_ms(torch, lambda: kern[name](pn, el, *next(it))),
                "floor": device_ms(torch, lambda: kern[name](pn, el, *floor)),
            }
        it = itertools.cycle(cold)

        def chain():
            ops = next(it)
            ck.gather(pn, el, *ops)
            ck.converge(pn, el, *ops)

        row["chain"] = device_ms(torch, chain)
        out[shape_key((r, t, n))] = row
        del warm, floor, cold
        torch.cuda.empty_cache()

    # One fixed gather and converge on fresh words: a digest of the
    # scratch the gather wrote and of the rows the converge wrote.
    gen.manual_seed(SEED + 1)
    r, t, n = SHAPES[0]
    rows, spn, sel = torch.randperm(BUCKETS, device=dev, generator=gen)[:t], words((r, t, n, 2)), \
        words((r, t))
    rows[:2] = torch.tensor([-1, BUCKETS], device=dev)
    gs, gl = spn.clone(), sel.clone()
    ck.gather(pn, el, rows, gs, gl)
    ck.converge(pn, el, rows, spn, sel)
    ok = (rows >= 0) & (rows < BUCKETS)
    h = hashlib.sha256()
    for x in (gs, gl, pn[rows[ok]], el[rows[ok]]):
        h.update(x.cpu().numpy().tobytes())
    torch.cuda.synchronize()
    out["digest"] = h.hexdigest()
    return out


def summarize(rows, smi: str, parent: str) -> dict:
    summary = {"card": smi, "parent": parent, "order": [row["turn"] for row in rows],
               "same_results": len({row["digest"] for row in rows}) == 1}
    for shape in SHAPES:
        key = shape_key(shape)
        bound_ms = nbytes(*shape) / HBM_BYTES_PER_S * 1e3
        s = {"bytes": nbytes(*shape), "bound_ms": bound_ms}
        for name in KERNELS:
            s[name] = {}
            for case in CASES:
                s[name][case] = {label: [row[key][name][case] for row in rows
                                         if row["turn"] == label]
                                 for label in ("parent", "change")}
            cold = s[name]["cold"]["change"]
            s[name]["share_of_bound_cold"] = [bound_ms / c for c in cold]
        s["chain"] = {label: [row[key]["chain"] for row in rows if row["turn"] == label]
                      for label in ("parent", "change")}
        summary[key] = s
    return summary


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
    summary = summarize(rows, smi, parent)
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=2)
    if not summary["same_results"]:
        raise SystemExit("the trees' gather and converge wrote different words")
    return summary


if __name__ == "__main__":
    main()
