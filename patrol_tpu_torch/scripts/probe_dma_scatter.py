"""Per-row read-modify-write scatter probe on the card: the port of
``scripts/probe_dma_scatter.py``.

    python -m patrol_tpu_torch.scripts.probe_dma_scatter [--device cuda|cpu] \\
        [--buckets 1000000] [--k 8192]

The state is the limiter's ``pn int64[B, 256, 2]`` (``init_state`` at
256 node lanes, 4.1 GB at the default 1,000,000 buckets), filled with
non-negative values from a seeded ``torch.Generator`` and seen as the
probe's ``int32[B, 8, 128]`` through ``probe_view``. The K updates are
the original probe's draws (``np.random.default_rng(3)``: unique rows,
``w0`` a multiple of 4, ``lo`` and ``hi`` positive). Each inner function
of ``row_rmw`` (``bcast``, ``pairmax``) is timed as the original times
it: chains of 4 and 24 calls with ``lo + i``, differenced over 20 calls,
best of 3 (the ``lo + i`` operands are made before the clock starts).

Then the question the card raises: the same ``pairmax`` updates as
per-pair 64-bit ``atomicMax`` through ``pair_join`` — pair ``(row,
w0 // 4)`` with the update value on the plane ``w0`` names and 0 on the
other, no elapsed entries. On non-negative state that is the same
function; the probe checks that both leave equal states and times
``pair_join`` the same way.

Every printed number carries the card's name and power limit
(``nvidia-smi``). The device is CUDA unless ``--device cpu`` is given;
without a card, CUDA raises. :func:`main` returns what it printed as a
dict.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from patrol_tpu_torch.models.limiter import (
    LimiterConfig,
    LimiterState,
    init_state,
    resolve_device,
)
from patrol_tpu_torch.ops.join_kernel import pair_join
from patrol_tpu_torch.ops.row_rmw_kernel import ROW_INTS, pair_value, probe_view, row_rmw

LANES = ROW_INTS // 4  # a probe row of 8 x 128 int32 is 256 lanes x (ADDED, TAKEN)
CHAINS = (4, 24)
REPEATS = 3
SEED = 3


def probe_inputs(buckets: int, k: int) -> Dict[str, np.ndarray]:
    """The original probe's update draws: K unique rows below
    ``buckets - 8``, ``w0`` a multiple of 4, ``lo`` in [1, 2^30) and
    ``hi`` in [0, 2^20), all int32."""
    rng = np.random.default_rng(3)
    return {
        "rows": rng.choice(buckets - 8, k, replace=False).astype(np.int32),
        "w0": (rng.integers(0, 256, k) * 4).astype(np.int32),
        "lo": rng.integers(1, 1 << 30, k).astype(np.int32),
        "hi": rng.integers(0, 1 << 20, k).astype(np.int32),
    }


def fill_state(pn: torch.Tensor, seed: int = SEED) -> torch.Tensor:
    """Fill ``pn`` in place with values in [0, 2^40) from a generator on
    its device."""
    gen = torch.Generator(device=pn.device).manual_seed(seed)
    return pn.random_(0, 1 << 40, generator=gen)


def pair_join_operands(rows, w0, lo, hi):
    """The ``pair_join`` form of ``pairmax`` updates: → (rows, slots,
    added, taken, erows, evals), int64 on the operands' device."""
    i64 = torch.int64
    upd = pair_value(lo, hi)
    taken_plane = ((w0 >> 1) & 1).bool()
    zero = torch.zeros_like(upd)
    empty = torch.zeros(0, dtype=i64, device=rows.device)
    return (
        rows.to(i64), (w0 // 4).to(i64),
        torch.where(taken_plane, zero, upd), torch.where(taken_plane, upd, zero),
        empty, empty,
    )


def chain_calls(state: LimiterState, upd: Dict[str, torch.Tensor], inner: str
                ) -> List[Callable[[], object]]:
    """Call ``i`` of a chain: one update of ``state`` with ``lo + i``, for
    i < 24. ``inner`` is ``bcast`` or ``pairmax`` (``row_rmw`` on the
    probe view of ``pn``) or ``pair_join`` (on ``pn`` itself)."""
    view = probe_view(state.pn)
    calls = []
    for i in range(max(CHAINS)):
        lo = upd["lo"] + i
        if inner == "pair_join":
            ops = pair_join_operands(upd["rows"], upd["w0"], lo, upd["hi"])
            calls.append(lambda ops=ops: pair_join(state.pn, state.elapsed, *ops))
        else:
            calls.append(
                lambda lo=lo: row_rmw(view, upd["rows"], upd["w0"], lo, upd["hi"], inner)
            )
    return calls


def run_chain(calls: Sequence[Callable[[], None]], n: int, device: torch.device) -> float:
    """Seconds for the first ``n`` calls, synchronised on a card."""
    t0 = time.perf_counter()
    for call in calls[:n]:
        call()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def time_inner(calls, device: torch.device) -> Dict[str, float]:
    """The original probe's timing: a warm chain of 4, then best of 3 of
    chains of 4 and 24; per call = (best 24 - best 4) / 20."""
    short, long_ = CHAINS
    run_chain(calls, short, device)
    best = {short: float("inf"), long_: float("inf")}
    for _ in range(REPEATS):
        for n in CHAINS:
            best[n] = min(best[n], run_chain(calls, n, device))
    per_call = (best[long_] - best[short]) / (long_ - short)
    return {"per_call_s": per_call, "calls": short + REPEATS * (short + long_)}


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu (no card)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[device.index or 0]


def parse_args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m patrol_tpu_torch.scripts.probe_dma_scatter",
        description="Time the per-row RMW scatter kernel on the limiter state.",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--buckets", type=int, default=1_000_000)
    p.add_argument("--k", type=int, default=8192, help="update rows per call")
    args = p.parse_args(argv)
    if args.k < 1 or args.buckets - 8 < args.k:
        p.error("need 1 <= k <= buckets - 8")
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    card = card_line(device)
    state = init_state(LimiterConfig(buckets=args.buckets, nodes=LANES), device)
    view = probe_view(state.pn)
    upd = {k: torch.from_numpy(v).to(device) for k, v in probe_inputs(args.buckets, args.k).items()}
    out: dict = {
        "device": str(device), "card": card, "buckets": args.buckets, "k": args.k,
        "state_bytes": state.pn.numel() * 8, "inners": {}, "row_rmw_calls": 0,
    }
    print(f"card: {card}; state int32{tuple(view.shape)} = pn int64{tuple(state.pn.shape)}, "
          f"{out['state_bytes'] / 1e9:.2f} GB on {device}; K = {args.k}")
    for inner in ("bcast", "pairmax", "pair_join"):
        fill_state(state.pn)
        res = time_inner(chain_calls(state, upd, inner), device)
        res["per_row_ns"] = res["per_call_s"] / args.k * 1e9
        res["mrows_per_s"] = args.k / res["per_call_s"] / 1e6 if res["per_call_s"] > 0 else None
        # A wrapping int64 sum of the final state: a cheap fingerprint of
        # what the chains left, comparable across runs and devices.
        res["state_sum"] = int(state.pn.sum())
        out["inners"][inner] = res
        if inner != "pair_join":
            out["row_rmw_calls"] += res["calls"]
        rate = f"{res['mrows_per_s']:8.2f}" if res["mrows_per_s"] is not None else "     n/a"
        print(f"{inner:9s} per-row {res['per_row_ns']:8.2f} ns  rate {rate} M-rows/s  [{card}]")

    # pairmax through row_rmw and through pair_join on equal non-negative
    # states: the two designs must agree.
    fill_state(state.pn)
    twin = state.pn.clone()
    row_rmw(view, upd["rows"], upd["w0"], upd["lo"], upd["hi"], "pairmax")
    out["row_rmw_calls"] += 1
    pair_join(twin, state.elapsed, *pair_join_operands(upd["rows"], upd["w0"], upd["lo"], upd["hi"]))
    out["pairmax_equals_pair_join"] = bool(torch.equal(state.pn, twin))
    del twin, view, state
    print(f"pairmax through row_rmw equals pair_join: {out['pairmax_equals_pair_join']}")
    return out


if __name__ == "__main__":
    result = main()
    sys.exit(0 if result["pairmax_equals_pair_join"] else 1)
