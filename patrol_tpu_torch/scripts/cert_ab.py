"""The certified families' kernels of two trees on one card, in turns.

    python3 patrol_tpu_torch/scripts/cert_ab.py --parent DIR [--out FILE]

Times one call of each family (``gcra``, ``conc``, ``quota``) of this
tree and of the tree at ``DIR`` (a checkout of an earlier commit,
unpacked with ``git archive``), each in a process of its own, in the
order parent, this tree, this tree, parent, through each tree's own
wrapper (``ops/cert_kernel.py::run``), on the same inputs: ``chip_smoke.py``
phase 2's corpus of this tree (its hazards, rows that repeat, quota
paths under 16 global and 512 tenant rows), made from one seed, on a
state of 1,000,000 buckets × 64 lanes, K = 8,192 columns:

* ``warm``: the same request every call (its rows' planes stay in the
  50 MB L2);
* ``cold``: a cycle of 16 requests on fresh random rows (GCRA and
  concurrency 134 MB of planes together, quota three times that), so
  each call finds its rows past L2;
* ``k512``: the first 512 columns; ``floor``: the first 8.

A change to one family's kernel reads the other two as its control:
the three share only the grid barrier and the commit step. Each time is the
median over 5 batches of the mean device time of 20 back-to-back calls
queued behind a spin kernel (``chip_smoke.py``'s ``device_ms``), in ms.
Each turn also digests the result and the planes of one call from the
filled state; every turn must give the same digests. Prints one JSON row
per turn and then the summary (each tree's two turns), and writes them
to ``--out``. Needs a card: without one the workers raise.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
THIS_TREE = os.path.dirname(os.path.dirname(HERE))
BUCKETS, LANES, K, COLD_SETS, SEED = 1_000_000, 64, 8192, 16, 20261018
FAMILIES = ("gcra", "conc", "quota")
KEYS = ("warm", "cold", "k512", "floor")


def corpus():
    """This tree's ``chip_smoke.py``, for its phase-2 corpus (numpy) and
    its timer (``device_ms``)."""
    spec = importlib.util.spec_from_file_location(
        "cert_ab_corpus", os.path.join(THIS_TREE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str) -> dict:
    """Time the three families of the tree at ``tree`` (imported from
    there)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.ops import cert_kernel as ck

    cs = corpus()
    dev = torch.device("cuda", 0)
    _build.lib()
    rng = np.random.default_rng(SEED)
    pn = torch.zeros((BUCKETS, LANES, 2), dtype=torch.int64, device=dev)
    row = {"tree": tree, "card": torch.cuda.get_device_name(0)}
    for family in FAMILIES:
        levels = 3 if family == "quota" else 1
        p = cs.cert_request(rng, family, K, BUCKETS)
        pn.zero_()
        cs.cert_fill(rng, pn, p[:levels].reshape(-1), torch)
        packed = cs.cert_pack(torch, family, p, BUCKETS, dev)
        cold = []
        for _ in range(COLD_SETS):
            q = p.copy()
            q[:levels] = rng.choice(BUCKETS, levels * K, replace=False).reshape(levels, -1)
            cold.append(cs.cert_pack(torch, family, q, BUCKETS, dev))
        out = ck.run(family, pn, packed, 0)
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.cpu().numpy().tobytes())
        digest.update(pn.cpu().numpy().tobytes())
        cold_it = itertools.cycle(cold)
        p512, p8 = packed[:, :512].contiguous(), packed[:, :8].contiguous()
        row[family] = {
            "digest": digest.hexdigest()[:16],
            "warm": cs.device_ms(torch, lambda: ck.run(family, pn, packed, 0)),
            "cold": cs.device_ms(torch, lambda: ck.run(family, pn, next(cold_it), 0)),
            "k512": cs.device_ms(torch, lambda: ck.run(family, pn, p512, 0)),
            "floor": cs.device_ms(torch, lambda: ck.run(family, pn, p8, 0)),
        }
        del cold
    return row


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
    for family in FAMILIES:
        digests = {row[family]["digest"] for row in rows}
        if len(digests) != 1:
            raise SystemExit(f"{family}: the trees' results or planes differ: {digests}")
        summary[family] = {
            key: {label: [row[family][key] for row in rows if row["turn"] == label]
                  for label in ("parent", "change")}
            for key in KEYS
        }
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
