#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``patrol_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and skipped):

1. Build every CUDA kernel from ``patrol_tpu_torch/csrc`` (nvcc, sm_90a)
   and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main path (state 1,000,000 buckets × 64 lanes): the pair
   join (8192 pairs with duplicates, FOLD_PAD_ROW sentinels and values past
   2^32, plus a commit ring of 8 blocks), the row join (512 dense rows),
   take-n (4096 rows, with padding rows aliasing a live row 0, negative
   balances, zero rates, count <= 0 and an fp64 refill corpus) and
   decode+fold (512 raw wire-v2 datagram planes of 8 KiB, about 180
   entries each, mixed with the hostile kinds — flips, truncations,
   trailing garbage, random blobs, bit-63 values with a fixed-up checksum,
   lying framing proposals — over random ``hosted`` flags, duplicate rows
   and sentinel rows; then one plane). int64 must be equal bit for bit
   (tolerance 0; decoded fields under ``entry_ok``). Each kernel is timed
   beside its plain version, its bound and, where one exists, the PyTorch
   library call that computes the same function (for decode+fold, its
   fold half). Then the per-row RMW scatter at the probe's size: state
   int32[1,000,000, 8, 128] (the 1M × 256-lane ``pn``, 4.1 GB) over the
   whole int32 range, 8192 unique rows (one out of range), ``w0`` of both
   residues mod 4, both inner functions bit for bit against the plain
   version and the library call, timed also with cold rows and, for
   ``pairmax``, beside ``pair_join`` on the same updates.
3. The main path: the port's ``Command`` serving on the asyncio front
   (ephemeral port, ``device="cuda"``, frozen clock), 100k peer deltas with
   lane trailers from lanes 1..63 through ``TPURepo.apply_delta``, 50k takes
   (uniform keys plus a Zipf(1.25) hot-key crowd) through ``submit_take``,
   and a few dozen real HTTP requests. The launch counters are zeroed just
   before and read just after; the join and take kernels must have
   launched. The same trace replays through a second engine on the CPU
   (the plain versions): per-ticket outcomes and the final planes must be
   identical.
3b. Raw wire-v2 ingest at the ring's batch: 200,000 entries over 200,000
   names in 8 KiB datagrams (one in 16 corrupted) through
   ``DeviceEngine.ingest_raw_planes`` in batches of 512 planes; replayed
   on a CPU engine, accepted counts and final planes must be equal.
3c. Two replicated nodes over loopback UDP, each a ``Command`` on the card
   at 1M × 64, wire mode ``delta``, frozen clocks: 20,000 takes over 2,000
   names split across them, then both must hold the same state for every
   name within 60 s, and ``decode_fold`` must have launched.
3d. The probe's entry point (``patrol_tpu_torch.scripts.probe_dma_scatter``,
   ``--device cuda``) at 1M × 256 lanes, K = 8192: ``row_rmw`` must have
   launched exactly once per call the probe made, and ``pairmax`` through
   ``row_rmw`` and through ``pair_join`` must leave equal states. Its
   printout goes to stderr, its numbers to the JSON detail.
4. Print the ``kernels`` JSON line, the nvidia-smi line, and as the last
   line ``{"ok": true, "device": {...}}``.

Exits nonzero without printing a result when no CUDA device is available,
or when run from a directory that holds this script without the package.
Details (build log, all numbers) go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import asyncio
import contextlib
import http.client
import itertools
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BUCKETS, LANES = 1_000_000, 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SCALAR_OPS_PER_S = 67e12  # float32 outside the tensor cores, same source
NANO = 1_000_000_000


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def bound(nbytes: float, nops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(torch, fn, reps: int = 5, n: int = 20) -> float:
    """Median over ``reps`` batches of the mean device time of ``n``
    back-to-back calls. A spin kernel queued first lets the host enqueue
    the whole batch before the device reaches it, so the events bracket
    device work, not host launch overhead (for calls that do not
    synchronise; those that do are measured as they run)."""
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


def check(cond, msg: str) -> None:
    """A smoke check that stays on under ``python -O``."""
    if not cond:
        raise AssertionError(msg)


def check_equal(torch, name: str, a, b) -> int:
    """Hold a kernel's output to its plain version's: → max |a - b| as
    measured (every value compared here is below 2^62, so the int64
    difference does not wrap); raises unless it is 0."""
    err = int((a - b).abs().max()) if a.numel() else 0
    if err != 0 or not torch.equal(a, b):
        diff = int((a != b).sum())
        raise AssertionError(f"{name}: kernel and plain version differ in {diff} elements")
    return err


# -- phase 2: each kernel against its plain version ------------------------


def join_checks(torch, jk, dev, rng):
    from patrol_tpu_torch.ops.merge import FOLD_PAD_ROW

    big = 1 << 40
    base_pn = torch.from_numpy(
        rng.integers(0, big, size=(BUCKETS, LANES, 2), dtype=np.int64)
    ).to(dev)
    base_el = torch.from_numpy(rng.integers(0, big, size=BUCKETS, dtype=np.int64)).to(dev)

    # Pair join: 8192 pairs, duplicates (a quarter on 64 hot rows), 256
    # sentinel pairs, values past 2^32.
    k = 8192
    rows = rng.integers(0, BUCKETS, k)
    rows[: k // 4] = rng.integers(0, 64, k // 4)
    rows[-256:] = FOLD_PAD_ROW + np.arange(256)
    slots = rng.integers(0, LANES, k)
    vals = rng.integers(0, 2 * big, size=(3, k))
    args = [torch.from_numpy(np.ascontiguousarray(x, np.int64)).to(dev)
            for x in (rows, slots, vals[0], vals[1], rows, vals[2])]
    pk, ek = base_pn.clone(), base_el.clone()
    pp, ep = base_pn.clone(), base_el.clone()
    jk.pair_join(pk, ek, *args)
    jk.pair_join_plain(pp, ep, *args)
    torch.cuda.synchronize()
    pair_err = max(check_equal(torch, "pair_join pn", pk, pp),
                   check_equal(torch, "pair_join elapsed", ek, ep))

    # Commit ring: 8 blocks of 8192 unique sorted pairs, flattened.
    from patrol_tpu_torch.ops import commit as commit_mod
    from patrol_tpu_torch.runtime.engine import DeltaArrays, fold_core

    n = 8 * 8192 - 1000
    d = DeltaArrays(
        rng.integers(0, BUCKETS, n), rng.integers(0, LANES, n),
        rng.integers(0, 2 * big, n), rng.integers(0, 2 * big, n),
        rng.integers(0, 2 * big, n), np.zeros(n, bool),
    )
    ring = commit_mod.pack_commit_blocks(*fold_core(d), 8192)
    check(ring.shape[1] == 8, f"commit ring has {ring.shape[1]} blocks, want 8")
    ring_t = torch.from_numpy(ring).to(dev)
    flat = [ring_t[i].reshape(-1).contiguous() for i in range(6)]
    jk.pair_join(pk, ek, *flat)
    jk.pair_join_plain(pp, ep, *flat)
    torch.cuda.synchronize()
    pair_err = max(pair_err, check_equal(torch, "commit ring pn", pk, pp),
                   check_equal(torch, "commit ring elapsed", ek, ep))

    # Row join: 512 dense rows (the fold's ceiling), 8 of them sentinels.
    r = 512
    drows = rng.choice(BUCKETS, r, replace=False)
    drows[-8:] = FOLD_PAD_ROW + np.arange(8)
    upd = rng.integers(0, 2 * big, size=(r, LANES, 2))
    upd[:, ::3] = 0  # untouched lanes carry zeros
    dargs = [torch.from_numpy(np.ascontiguousarray(x, np.int64)).to(dev)
             for x in (drows, upd, rng.integers(0, 2 * big, r))]
    jk.row_join(pk, ek, *dargs)
    jk.row_join_plain(pp, ep, *dargs)
    torch.cuda.synchronize()
    row_err = max(check_equal(torch, "row_join pn", pk, pp),
                  check_equal(torch, "row_join elapsed", ek, ep))

    # Timing at the checked shapes.
    live = rows < BUCKETS
    uniq_pairs = len(np.unique(rows[live] * LANES + slots[live]))
    uniq_rows = len(np.unique(rows[live]))
    ok_t = args[0] < BUCKETS
    lib_idx = (args[0][ok_t] * LANES + args[1][ok_t]).unsqueeze(1).expand(-1, 2).contiguous()
    lib_src = torch.stack([args[2][ok_t], args[3][ok_t]], 1).contiguous()
    lib_er, lib_ev = args[4][ok_t].contiguous(), args[5][ok_t].contiguous()
    pn2 = pk.view(-1, 2)

    def lib_pair():
        pn2.scatter_reduce_(0, lib_idx, lib_src, reduce="amax", include_self=True)
        ek.scatter_reduce_(0, lib_er, lib_ev, reduce="amax", include_self=True)

    pair_bytes = 8 * (6 * k) + 2 * 16 * uniq_pairs + 2 * 8 * uniq_rows
    pair = {
        "ms": device_ms(torch, lambda: jk.pair_join(pk, ek, *args)),
        "plain_ms": device_ms(torch, lambda: jk.pair_join_plain(pp, ep, *args)),
        "library_ms": device_ms(torch, lib_pair),
        "bytes": pair_bytes,
        "ops": 3 * k,
        "max_abs_err": pair_err,
    }
    live_r = drows < BUCKETS
    rlib_idx = dargs[0][torch.from_numpy(live_r).to(dev)].view(-1, 1, 1).expand(-1, LANES, 2).contiguous()
    rlib_src = dargs[1][torch.from_numpy(live_r).to(dev)].contiguous()

    def lib_row():
        pk.scatter_reduce_(0, rlib_idx, rlib_src, reduce="amax", include_self=True)

    nr = int(live_r.sum())
    row_bytes = 8 * (r + r * LANES * 2 + r) + 2 * (nr * LANES * 16 + nr * 8)
    row = {
        "ms": device_ms(torch, lambda: jk.row_join(pk, ek, *dargs)),
        "plain_ms": device_ms(torch, lambda: jk.row_join_plain(pp, ep, *dargs)),
        "library_ms": device_ms(torch, lib_row),
        "bytes": row_bytes,
        "ops": r * (2 * LANES + 1),
        "max_abs_err": row_err,
    }
    del base_pn, base_el, pk, ek, pp, ep, pn2
    return pair, row


def take_inputs(rng):
    """State and a packed [8, 4096] take tick with every hazard case."""
    k = 4096
    pn = np.zeros((BUCKETS, LANES, 2), np.int64)
    el = np.zeros(BUCKETS, np.int64)
    live = 3584
    rows = rng.choice(np.arange(1, BUCKETS), live, replace=False)
    rows[7] = 0  # row 0 is live; the padding tail aliases it
    pn[rows] = rng.integers(0, 4 * NANO, size=(live, LANES, 2))
    neg = rows[: live // 4]
    pn[neg, :, 1] += rng.integers(0, 8 * NANO, size=(len(neg), LANES))  # TAKEN > ADDED
    el[rows] = rng.integers(0, 50 * NANO, live)
    p = np.zeros((8, k), np.int64)
    p[0, :live] = rows
    p[1, :live] = 1000 * NANO + rng.integers(0, 100 * NANO, live)
    p[2, :live] = rng.choice([0, 1, 3, 10, 1000], live)
    p[3, :live] = rng.choice([0, 1, NANO, 3 * NANO + 1, 60 * NANO], live)
    p[4, :live] = rng.choice([-NANO, 0, NANO, 2 * NANO, 3 * NANO + 1], live)
    p[5, :live] = rng.integers(1, 6, live)
    p[6, :live] = rng.choice([0, NANO, 10 * NANO, 3 * NANO + 5], live)
    p[7, :live] = rng.integers(0, 1000 * NANO, live)
    # fp64 refill corpus on 256 rows: near-integer quotients, interval 1,
    # huge deltas; a deep debit keeps the raw grant visible in `have`.
    fp = slice(live - 256, live)
    intervals = rng.choice([1, 3, 7, 999_999_937, 10**12 + 39, (1 << 40) + 1], 256)
    mult = rng.choice([1, 3, 10**6 + 1, 10**9 + 7], 256)
    delta = np.clip(intervals * mult + rng.integers(-1, 2, 256), 0, (1 << 62) - 1)
    frows = p[0, fp]
    pn[frows] = 0
    pn[frows, 0, 1] = 1 << 61
    el[frows] = 0
    p[1, fp] = delta
    p[2, fp] = 1
    p[3, fp] = intervals
    p[4, fp] = NANO
    p[5, fp] = 1
    p[6, fp] = 0
    p[7, fp] = 0
    # Columns live..k stay zero: padding rows (row 0, nreq 0).
    return pn, el, p


def take_checks(torch, tk, dev, rng):
    pn, el, p = take_inputs(rng)
    base_pn, base_el = torch.from_numpy(pn).to(dev), torch.from_numpy(el).to(dev)
    packed = torch.from_numpy(p).to(dev)
    pk, ek = base_pn.clone(), base_el.clone()
    pp, ep = base_pn.clone(), base_el.clone()
    out_k = tk.take_n(pk, ek, packed, 0)
    out_p = tk.take_n_plain(pp, ep, packed, 0)
    torch.cuda.synchronize()
    err = max(check_equal(torch, "take_n results", out_k, out_p),
              check_equal(torch, "take_n pn", pk, pp),
              check_equal(torch, "take_n elapsed", ek, ep))
    adm = out_k[1].cpu().numpy()
    check((adm > 1).sum() > 100 and (adm == 0).sum() > 100, "take_n corpus is vacuous")
    pad = p[5] <= 0
    check(pad.sum() > 0 and not out_k[:, torch.from_numpy(pad).to(dev)].any(),
          "take_n padding columns are not zero")
    k = p.shape[1]
    live = int((~pad).sum())
    committing = int((adm >= 1).sum())
    # Bytes: the packed input and the result once each, each distinct live
    # row's lane plane and elapsed read once (padding columns read no
    # state), and the own lane and elapsed of committing rows written.
    gathered = len(np.unique(p[0][~pad])) * (LANES * 16 + 8)
    take_bytes = 8 * (8 * k) + gathered + 8 * (7 * k) + committing * 24
    # The same launch on a tick of padding columns only: no gather, no
    # commit — the kernel's fixed cost at this K.
    idle = torch.zeros_like(packed)
    res = {
        "ms": device_ms(torch, lambda: tk.take_n(pk, ek, packed, 0)),
        "plain_ms": device_ms(torch, lambda: tk.take_n_plain(pp, ep, packed, 0)),
        "padding_only_ms": device_ms(torch, lambda: tk.take_n(pk, ek, idle, 0)),
        "library_ms": None,
        "bytes": take_bytes,
        "ops": live * (2 * LANES + 40),
        "max_abs_err": err,
    }
    del base_pn, base_el, pk, ek, pp, ep
    return res


# -- phase 2: decode_fold against its plain version --------------------------

DV2_ROW = 8192


def dv2_datagrams(rng, n, nodes, name_pool):
    """``n`` wire-v2 datagrams of about 180 entries each (10-byte names
    from ``name_pool``, lanes 1..nodes-1, values below 2^50). Packet i is
    of kind i % 8, as in the JAX package's ingest corpus: 0 valid, 1 byte
    flip, 2 truncation, 3 trailing garbage, 4 random
    blob, 5 values up to 2^62 on lanes up to nodes+15, 6 a bit-63 value
    with its checksum fixed up, 7 valid bytes under a lying framing
    proposal (see ``lie_about_framing``). → (datagrams, kinds)."""
    from patrol_tpu_torch.ops import wire

    out, kind_of = [], []
    for i in range(n):
        kind = i % 8
        hi = (1 << 62) if kind == 5 else (1 << 50)
        top = nodes + 16 if kind == 5 else nodes
        names = rng.integers(0, name_pool, 200)
        vals = rng.integers(0, hi, size=(200, 4))
        lanes = rng.integers(1, top, 200)
        ents = [
            wire.DeltaEntry(f"n{int(k):09d}", int(s), *(int(x) for x in v))
            for k, s, v in zip(names, lanes, vals)
        ]
        acks = rng.integers(0, 1 << 32, int(rng.integers(0, 6))).tolist()
        data, packed = wire.encode_delta_packet(
            int(rng.integers(0, nodes)), int(rng.integers(1, 1 << 32)), acks, ents,
            max_size=DV2_ROW,
        )
        check(170 <= packed <= 190, f"datagram packed {packed} entries")
        b = bytearray(data)
        if kind == 1:
            b[int(rng.integers(0, len(b)))] ^= 0x41
        elif kind == 2:
            b = b[: int(rng.integers(1, len(b)))]
        elif kind == 3:
            b += bytes(rng.integers(0, 256, int(rng.integers(1, 6))).astype(np.uint8))
        elif kind == 4:
            b = bytearray(rng.integers(0, 256, int(rng.integers(1, 300))).astype(np.uint8))
        elif kind == 6:
            off = 32 + 8 + 4 * b[39] + 2
            off += 1 + b[off] + 2  # name_len + name + slot
            b[off] |= 0x80
            b[-1] = sum(b[32:-1]) & 0xFF
        out.append(bytes(b))
        kind_of.append(kind)
    return out, np.array(kind_of)


def to_planes(datagrams, row=DV2_ROW, stale=0xAB):
    """Datagrams → uint8[P, row] planes (stale ring bytes past each
    datagram) and int32 lengths, clipped to the row like a ring slot."""
    planes = np.full((len(datagrams), row), stale, np.uint8)
    lengths = np.zeros(len(datagrams), np.int32)
    for i, b in enumerate(datagrams):
        b = b[:row]
        planes[i, : len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return planes, lengths


def lie_about_framing(rng, eoff, count, rows_idx):
    """Perturb one proposed entry offset of each packet in ``rows_idx``:
    shifted by +1, shifted back by one entry (negative at entry 0), or
    swapped with its neighbour. Each lie must reject its packet."""
    for j, p in enumerate(rows_idx):
        c = int(count[p])
        k = int(rng.integers(1, c)) if c > 1 else 0
        mode = j % 3
        if mode == 0:
            eoff[p, k] += 1
        elif mode == 1:
            eoff[p, k] -= 35
        else:
            eoff[p, k - 1], eoff[p, k] = eoff[p, k], eoff[p, k - 1]


def decode_fold_inputs(rng, P):
    """One decode_fold batch at the ring's shape: P planes of 8 KiB, the
    host walk's framing proposal (lying on kind-7 packets), a row plan
    with duplicate rows across packets, FOLD_PAD_ROW sentinels and rows
    under dead entries, and a random ``hosted`` mask."""
    from patrol_tpu_torch.ops import ingest as ingest_ops
    from patrol_tpu_torch.ops.merge import FOLD_PAD_ROW

    datagrams, kinds = dv2_datagrams(rng, P, LANES, name_pool=1_000_000)
    planes, lengths = to_planes(datagrams)
    walk = ingest_ops.host_walk(planes, lengths)
    E = ingest_ops.MAX_RAW_ENTRIES
    # The proposal is the structure walk's, made before the verdict:
    # kind-7 packets are valid, so the walk has their full framing.
    eoff = np.maximum(walk.name_off - 1, 0).astype(np.int32)
    liars = np.flatnonzero(kinds == 7)
    lie_about_framing(rng, eoff, walk.count, liars)
    rows = rng.choice(rng.choice(BUCKETS, 20_000, replace=False), size=(P, E)).astype(np.int32)
    rows[rng.random((P, E)) < 0.05] = FOLD_PAD_ROW
    hosted = rng.random((P, E)) < 0.1
    return planes, lengths, eoff, rows, hosted, kinds, walk


def decode_fold_run(torch, ik, dev, base_pn, base_el, args_np):
    """Kernel and plain version on the same inputs; → (kernel outputs,
    plain outputs, max_abs_err, kernel-state copy, plain-state copy, the
    device operands)."""
    planes, lengths, eoff, rows, hosted = args_np
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (planes, lengths, eoff, rows, hosted)]
    pk, ek = base_pn.clone(), base_el.clone()
    pp, ep = base_pn.clone(), base_el.clone()
    out_k = ik.decode_fold(pk, ek, *args)
    out_p = ik.decode_fold_plain(pp, ep, *args)
    torch.cuda.synchronize()
    err = max(check_equal(torch, "decode_fold pn", pk, pp),
              check_equal(torch, "decode_fold elapsed", ek, ep))
    for name, a, b in zip(("ok", "entry_ok", "hosted_mask"), out_k[:3], out_p[:3]):
        check(torch.equal(a, b), f"decode_fold {name}: kernel and plain version differ")
    eok = out_p[1]
    for name, a, b in zip(("slot", "cap", "added", "taken", "elapsed"), out_k[3:], out_p[3:]):
        err = max(err, check_equal(torch, f"decode_fold {name} under entry_ok", a[eok], b[eok]))
    return out_k, out_p, err, (pk, ek), (pp, ep), args


def decode_fold_checks(torch, ik, dev, rng):
    """decode_fold at P = 512 (the ring batch) and P = 1 (the asyncio
    path) on the 1M x 64 state: bit-exact to the plain version, then
    timed beside its bound, its plain version and the library time of its
    fold half (``scatter_reduce_(amax)`` over the same pairs)."""
    big = 1 << 40
    base_pn = torch.from_numpy(
        rng.integers(0, big, size=(BUCKETS, LANES, 2), dtype=np.int64)
    ).to(dev)
    base_el = torch.from_numpy(rng.integers(0, big, size=BUCKETS, dtype=np.int64)).to(dev)
    t0 = time.perf_counter()
    planes, lengths, eoff, rows, hosted, kinds, walk = decode_fold_inputs(rng, 512)
    log(f"decode_fold corpus built in {time.perf_counter() - t0:.1f}s")
    res = {}
    for P, sel in ((512, slice(None)), (1, slice(0, 1))):
        args_np = (planes[sel], lengths[sel], eoff[sel], rows[sel], hosted[sel])
        out_k, out_p, err, (pk, ek), (pp, ep), args = decode_fold_run(
            torch, ik, dev, base_pn, base_el, args_np
        )
        ok = out_p[0].cpu().numpy()
        eok = out_p[1]
        if P == 512:
            check(ok[kinds == 0].all(), "a valid datagram was rejected")
            for bad in (4, 6, 7):
                check(not ok[kinds == bad].any(), f"a hostile datagram of kind {bad} was accepted")
            check(np.array_equal(ok, walk.ok & (kinds != 7)),
                  "verdicts differ from the host walk's")
        else:
            check(ok.all(), "the P=1 datagram was rejected")
        fold = eok & ~args[4] & (args[3] >= 0) & (args[3] < BUCKETS)
        n_fold = int(fold.sum())
        check(n_fold > (50 if P == 1 else 10_000), f"decode_fold P={P} folds only {n_fold} entries")
        frow = args[3][fold].to(torch.int64)
        fslot = out_p[3][fold]
        lib_idx = (frow * LANES + fslot).unsqueeze(1).expand(-1, 2).contiguous()
        lib_src = torch.stack([out_p[5][fold], out_p[6][fold]], 1).contiguous()
        lib_ev = out_p[7][fold].clamp(min=0).contiguous()
        pn2 = pk.view(-1, 2)

        def lib_fold():
            pn2.scatter_reduce_(0, lib_idx, lib_src, reduce="amax", include_self=True)
            ek.scatter_reduce_(0, frow, lib_ev, reduce="amax", include_self=True)

        pairs = len(np.unique((frow * LANES + fslot).cpu().numpy()))
        frows = len(np.unique(frow.cpu().numpy()))
        E = eoff.shape[1]
        nbytes = (int(lengths[sel].sum()) + 4 * P + P * E * (4 + 4 + 1)
                  + P + P * E * (1 + 1 + 5 * 8) + pairs * 32 + frows * 16)
        live = int(out_p[1].sum())
        res[P] = {
            "ms": device_ms(torch, lambda: ik.decode_fold(pk, ek, *args)),
            "plain_ms": device_ms(torch, lambda: ik.decode_fold_plain(pp, ep, *args), n=5),
            "library_ms": device_ms(torch, lib_fold),
            "bytes": nbytes,
            "ops": int(lengths[sel].sum()) + live * 40,
            "max_abs_err": err,
            "packets_ok": int(ok.sum()),
            "entries_folded": n_fold,
            "distinct_pairs": pairs,
        }
        del pk, ek, pp, ep, pn2, args, out_k, out_p
    del base_pn, base_el
    return res


# -- phase 2: row_rmw against its plain version -------------------------------

PROBE_BUCKETS, PROBE_K = 1_000_000, 8192


def row_rmw_library(torch, state, rows, w0, lo, hi, inner):
    """One ``scatter_reduce_(amax)`` computing ``row_rmw``'s function on
    in-range rows: → a call. ``bcast`` over ``state.view(B, 1024)`` with
    a ``[K, 1024]`` index; ``pairmax`` over the int64 ``view(B, 512)``
    with a ``[K, 512]`` update that is zero off the target pair. The
    index and source are built here, outside any timed call."""
    from patrol_tpu_torch.ops.row_rmw_kernel import ROW_INTS, pair_value

    b = state.shape[0]
    ok = (rows >= 0) & (rows < b)
    r = rows[ok].to(torch.int64)
    if inner == "bcast":
        flat = state.view(b, ROW_INTS)
        src = lo[ok].unsqueeze(1).expand(-1, ROW_INTS).contiguous()
    else:
        flat = state.view(b, ROW_INTS).view(torch.int64)
        src = torch.zeros((r.numel(), ROW_INTS // 2), dtype=torch.int64, device=state.device)
        src[torch.arange(r.numel(), device=state.device), w0[ok].to(torch.int64) >> 1] = (
            pair_value(lo[ok], hi[ok])
        )
    idx = r.unsqueeze(1).expand(-1, flat.shape[1]).contiguous()
    return lambda: flat.scatter_reduce_(0, idx, src, reduce="amax", include_self=True)


def row_rmw_checks(torch, rk, dev, rng):
    """``row_rmw`` at the probe's size: state int32[1,000,000, 8, 128]
    (4.1 GB) drawn over the whole int32 range, so touched rows hold
    negative pairs; K = 8192 unique rows, one of them out of range (it
    must be dropped); ``w0`` even over [0, 1024), both residues mod 4;
    ``lo`` and ``hi`` over the whole int32 range. Each inner function is
    held bit for bit (tolerance 0) to ``row_rmw_plain`` and to its library
    call, then timed beside them, beside its bound, with cold rows (a
    cycle of 8 row sets, 256 MiB, past the 50 MB L2), and — for
    ``pairmax`` — beside ``pair_join`` on the same updates."""
    from patrol_tpu_torch.ops import join_kernel as jk
    from patrol_tpu_torch.ops.row_rmw_kernel import ROW_INTS
    from patrol_tpu_torch.scripts.probe_dma_scatter import pair_join_operands

    B, K = PROBE_BUCKETS, PROBE_K
    gen = torch.Generator(device=dev).manual_seed(31)
    base = torch.empty((B, 8, 128), dtype=torch.int32, device=dev)
    base.random_(-(1 << 31), (1 << 31) - 1, generator=gen)
    rows = rng.choice(B, K, replace=False)
    rows[100] = B + 5
    w0 = rng.integers(0, 512, K) * 2
    check({0, 2} <= set((w0 % 4).tolist()), "w0 lacks a residue")
    lo, hi = rng.integers(-(1 << 31), 1 << 31, size=(2, K))
    args = [torch.from_numpy(x.astype(np.int32)).to(dev) for x in (rows, w0, lo, hi)]
    live = torch.from_numpy(rows < B).to(dev)
    live_rows = args[0][live].to(torch.int64)
    kv = int(live.sum())
    check(kv == K - 1, f"{kv} live rows")
    cold_sets = [
        [torch.from_numpy(rng.choice(B, K, replace=False).astype(np.int32)).to(dev), *args[1:]]
        for _ in range(8)
    ]
    sk, sp = base.clone(), base.clone()
    out = {}
    for inner in ("bcast", "pairmax"):
        sk.copy_(base)
        sp.copy_(base)
        rk.row_rmw(sk, *args, inner)
        rk.row_rmw_plain(sp, *args, inner)
        torch.cuda.synchronize()
        check(torch.equal(sk, sp), f"row_rmw {inner}: kernel and plain version differ")
        touched_k = sk.view(B, ROW_INTS).index_select(0, live_rows).to(torch.int64)
        touched_p = sp.view(B, ROW_INTS).index_select(0, live_rows).to(torch.int64)
        err = int((touched_k - touched_p).abs().max())
        before = base.view(B, ROW_INTS).index_select(0, live_rows)
        changed = int((touched_k != before).sum())
        check(changed > 0, f"row_rmw {inner} changed nothing")
        if inner == "pairmax":
            pairs = before.view(torch.int64)
            check(bool((pairs < 0).any()), "no negative pair in the touched rows")
        sp.copy_(base)
        lib = row_rmw_library(torch, sp, *args, inner)
        lib()
        torch.cuda.synchronize()
        check(torch.equal(sk, sp), f"row_rmw {inner}: the library call computes another function")
        sets = itertools.cycle(cold_sets)

        def cold(inner=inner):
            rk.row_rmw(sk, *next(sets), inner)

        out[inner] = {
            "ms": device_ms(torch, lambda: rk.row_rmw(sk, *args, inner)),
            "ms_cold_rows": device_ms(torch, cold),
            "plain_ms": device_ms(torch, lambda: rk.row_rmw_plain(sp, *args, inner), n=5),
            "library_ms": device_ms(torch, lib),
            "bytes": 2 * kv * ROW_INTS * 4 + 4 * K * 4,
            "ops": kv * (ROW_INTS if inner == "bcast" else ROW_INTS // 2),
            "max_abs_err": err,
            "values_changed": changed,
        }
    # pairmax as per-pair 64-bit atomicMax: the join kernel on the same
    # updates (the out-of-range row is dropped there too).
    pn = sk.view(torch.int64).view(B, ROW_INTS // 4, 2)
    elapsed = torch.zeros(B, dtype=torch.int64, device=dev)
    ops = pair_join_operands(*args)
    out["pairmax"]["pair_join_ms"] = device_ms(torch, lambda: jk.pair_join(pn, elapsed, *ops))
    out["pairmax"]["pair_join_bytes"] = 4 * 8 * K + 2 * 16 * kv
    return out


# -- phase 3: the main path -------------------------------------------------


class Clock:
    def __init__(self, now: int):
        self.now = now

    def __call__(self) -> int:
        return self.now


class Node:
    """Runs a Command on its own asyncio loop thread until closed."""

    def __init__(self, cmd):
        self.cmd = cmd
        self.loop = asyncio.new_event_loop()
        self.stop_ev = None
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        deadline = time.monotonic() + 300
        while not cmd.started.is_set():
            if self.error is not None:
                raise self.error
            if time.monotonic() > deadline:
                raise TimeoutError("the port's Command did not start serving")
            time.sleep(0.01)

    def _run(self):
        asyncio.set_event_loop(self.loop)

        async def main():
            self.stop_ev = asyncio.Event()
            await self.cmd.run(self.stop_ev)

        try:
            self.loop.run_until_complete(main())
        except BaseException as exc:
            self.error = exc
        finally:
            self.loop.close()

    def close(self):
        self.loop.call_soon_threadsafe(self.stop_ev.set)
        self.thread.join(60)
        if self.thread.is_alive():
            raise RuntimeError("the port's Command did not shut down")
        if self.error is not None:
            raise self.error


def make_trace(rng):
    """Deltas and takes of the main path, made from the seed. One
    (rate, count) key per name, so the outcome of the trace does not
    depend on how its tickets fall into ticks."""
    n_names = 200_000
    uni = rng.integers(0, n_names, 98_000)
    lanes = rng.integers(1, LANES, 98_000)
    hot_delta_names = [f"k{i}" for i in range(4)]
    deltas = []
    for i, lane in zip(uni.tolist(), lanes.tolist()):
        deltas.append((f"k{i}", lane))
    hot_burst = [(n, lane) for _ in range(8) for n in hot_delta_names for lane in range(1, LANES)]
    vals = rng.integers(0, 6 * NANO, size=(len(deltas) + len(hot_burst), 3))
    caps = np.array([10 * NANO, 100 * NANO, 5 * NANO])
    # Takes: half uniform over the name space, half a Zipf(1.25) crowd over
    # 1000 hot names, interleaved.
    ranks = np.arange(1, 1001)
    pz = ranks ** -1.25
    pz /= pz.sum()
    zipf = rng.choice(1000, 25_000, p=pz)
    uni_t = rng.integers(0, n_names, 25_000)
    takes = []
    for a, b in zip(uni_t.tolist(), zipf.tolist()):
        takes.append(f"k{a}")
        takes.append(f"k{b}")
    return deltas, hot_burst, vals, caps, takes


def rate_of(name: str):
    from patrol_tpu_torch.ops.rate import Rate

    i = int(name[1:])
    freq, per = [(10, NANO), (100, 60 * NANO), (5, NANO)][i % 3]
    return Rate(freq=freq, per_ns=per), 1 + (i % 7 == 0)


def delta_state(name: str, lane: int, v, caps):
    from patrol_tpu_torch.ops import wire

    i = int(name[1:])
    cap = int(caps[i % 3])
    a, t, e = (int(x) for x in v)
    return wire.from_nanotokens(
        name, cap + a, t, e, origin_slot=lane, cap_nt=cap,
        lane_added_nt=a, lane_taken_nt=t,
    )


HTTP_SCRIPT = [
    ("POST", "/take/http-demo?rate=5:1m&count=1"),
    ("POST", "/take/http-demo?rate=5:1m&count=1"),
    ("POST", "/take/http-demo?rate=5:1m&count=2"),
    ("POST", "/take/http-demo?rate=5:1m&count=1"),
    ("POST", "/take/http-demo?rate=5:1m&count=1"),
    ("POST", "/take/http-demo?rate=5:1m&count=1"),
    ("GET", "/tokens/http-demo"),
    ("GET", "/tokens/nobody-here"),
    ("POST", "/take_batch?" + "&".join(["t=http-hot,3:1m,1"] * 8) + "&t=k3,10:1s,1"),
    ("POST", "/take/" + "x" * 232 + "?rate=1:1s"),
    ("GET", "/take/http-demo"),
    ("GET", "/take_batch"),
    ("POST", "/take/k1?rate=100:1m&count=1"),
    *[("POST", f"/take/http-{i}?rate=2:1s") for i in range(20)],
    ("GET", "/metrics"),
]
# Answers known in advance (a fresh 5-token bucket drained at a frozen
# clock, and the reference's error routes); every take route is also held
# to the CPU replay's ticket.
HTTP_EXPECT = {
    0: (200, b"4"), 1: (200, b"3"), 2: (200, b"1"), 3: (200, b"0"),
    4: (429, b"0"), 5: (429, b"0"), 6: (200, b"0"), 7: (404, b"unknown bucket\n"),
    9: (400, b"bucket name larger than 231"), 10: (405, b"method not allowed\n"),
    11: (405, b"method not allowed\n"),
}


def drive_http(port):
    out = []
    for method, target in HTTP_SCRIPT:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request(method, target)
        resp = conn.getresponse()
        out.append((resp.status, resp.read()))
        conn.close()
    return out


def run_trace(engine, repo, trace, hold=False):
    """Drive deltas then takes through the repo facade; → (outcomes,
    seconds for deltas, seconds for takes). With ``hold`` the engine's
    state lock is held while a burst queues (the feeder parks at its next
    dispatch), so the first uniform burst drains as one multi-block commit
    ring and the hot-row burst as one fold with dense rows — what a flood
    does to a busy node."""
    deltas, hot_burst, vals, caps, takes = trace
    cut = 30_000
    phases = (
        (deltas[:cut], 0, hold),
        (deltas[cut:], cut, False),
        (hot_burst, len(deltas), hold),
    )
    t0 = time.perf_counter()
    for items, offset, held in phases:
        if held:
            engine._state_mu.acquire()
        try:
            for j, (name, lane) in enumerate(items):
                repo.apply_delta(delta_state(name, lane, vals[offset + j], caps), lane)
        finally:
            if held:
                engine._state_mu.release()
    check(engine.flush(600), "delta flush timed out")
    t_deltas = time.perf_counter() - t0
    t0 = time.perf_counter()
    tickets = []
    for name in takes:
        rate, count = rate_of(name)
        tickets.append(repo.submit_take(name, rate, count))
    check(engine.flush(600), "take flush timed out")
    t_takes = time.perf_counter() - t0
    for t in tickets:
        check(t.wait(60), "a take ticket never completed")
    return [(t.ok, t.remaining) for t in tickets], t_deltas, t_takes


def replay_http(repo):
    """The HTTP script's takes as direct repo calls, in order; → the
    (status, body) each take route must have answered."""
    from patrol_tpu_torch.ops.rate import parse_rate

    want = {}
    for i, (method, target) in enumerate(HTTP_SCRIPT):
        path, _, query = target.partition("?")
        if method != "POST":
            continue
        if path.startswith("/take/") and len(path) - len("/take/") <= 231:
            q = dict(kv.split("=") for kv in query.split("&"))
            t = repo.submit_take(path[len("/take/"):], parse_rate(q["rate"]), int(q.get("count", "1")))
            check(t.wait(60), "a take ticket never completed")
            want[i] = (200 if t.ok else 429, str(t.remaining).encode())
        elif path == "/take_batch" and query:
            entries = [part[2:].split(",") for part in query.split("&")]
            res = repo.submit_takes_batch(
                [e[0] for e in entries], [parse_rate(e[1]) for e in entries],
                [int(e[2]) for e in entries],
            )
            lines = []
            for t, _ in res:
                check(t.wait(60), "a take ticket never completed")
                lines.append(b"%d %d" % (200 if t.ok else 429, t.remaining))
            want[i] = (200, b"\n".join(lines) + b"\n")
    return want


# -- phase 3b: raw ingest at the ring's batch --------------------------------


def raw_ingest_trace(rng):
    """200,000 dv2 entries over 200,000 names, lanes 1..63, in 8 KiB
    datagrams; one datagram in 16 corrupted by a byte flip. → planes,
    lengths."""
    from patrol_tpu_torch.ops import wire

    n_entries, n_names = 200_000, 200_000
    names = rng.integers(0, n_names, n_entries)
    lanes = rng.integers(1, LANES, n_entries)
    vals = rng.integers(0, 1 << 50, size=(n_entries, 4))
    ents = [
        wire.DeltaEntry(f"r{int(k):09d}", int(s), *(int(x) for x in v))
        for k, s, v in zip(names, lanes, vals)
    ]
    datagrams = []
    at = 0
    while at < n_entries:
        data, packed = wire.encode_delta_packet(1, len(datagrams) + 1, (), ents[at:], max_size=DV2_ROW)
        at += packed
        if len(datagrams) % 16 == 15:
            b = bytearray(data)
            b[int(rng.integers(32, len(b)))] ^= 0x41
            data = bytes(b)
        datagrams.append(data)
    return to_planes(datagrams)


def run_raw_ingest(engine, planes, lengths, batch=512):
    """Feed the planes to ``ingest_raw_planes`` in ring batches, then
    flush; → (entries accepted per batch, seconds)."""
    accepted = []
    released = []
    t0 = time.perf_counter()
    for lo in range(0, len(planes), batch):
        accepted.append(engine.ingest_raw_planes(
            planes[lo:lo + batch], lengths[lo:lo + batch],
            release=lambda: released.append(1),
        ))
    check(engine.flush(600), "raw ingest flush timed out")
    dt = time.perf_counter() - t0
    check(len(released) == len(accepted), "a raw plane batch was never released")
    return accepted, dt


# -- phase 3c: two replicated nodes over loopback UDP -------------------------


def free_udp_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


TWO_NODE_NAMES, TWO_NODE_TAKES, TWO_NODE_CHUNK = 2000, 20_000, 500


def run_two_nodes(Command, LimiterConfig, rng):
    """Two port nodes on the card, each 1M x 64, peered over loopback in
    wire mode ``delta`` with frozen clocks: 20,000 takes over 2,000 names
    split across them, in chunks of 500 (the first take of each chunk over
    HTTP, the rest through ``submit_take``). Then poll (at most 60 s)
    until both nodes hold the same state for every name: ``snapshot_many``
    (one gather a node) while they differ, and ``repo.snapshot(name)`` for
    every name to confirm. → a dict of what was measured, with the
    replication counters at each poll.

    Two settings keep the delta plane out of a retransmit storm, which it
    cannot leave on its own: an interval unacked after a fixed number of
    flush ticks is resent under a new sequence number, so an ack that
    comes later than that matches nothing. Both nodes share one Python
    interpreter here, and under a take flood a receiver's acks come later
    than the default 8 ticks (160 ms). So the delta planes wait 50 ticks
    (1 s, ``PATROL_DELTA_RETX_TICKS``'s range), and the next chunk goes in
    once the last one's tickets have completed and neither node holds an
    unacked interval."""
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.ops.rate import Rate

    addrs = [f"127.0.0.1:{free_udp_port()}" for _ in range(2)]
    cfg = LimiterConfig(buckets=BUCKETS, nodes=LANES)
    nodes = [
        Node(Command(
            api_addr="127.0.0.1:0", node_addr=a, peer_addrs=addrs,
            clock=Clock(1_700_000_000 * NANO), config=cfg, handle_signals=False,
            warmup=True, device="cuda", wire_mode="delta", shutdown_timeout_s=30,
        ))
        for a in addrs
    ]
    polls = []
    try:
        cmds = [n.cmd for n in nodes]
        # The wire-v2 capability handshake first: until a peer has
        # answered it, broadcasts to it go out in the classic form.
        deadline = time.perf_counter() + 30
        while not all(len(c.replicator.delta.capable_peers()) == 1 for c in cmds):
            check(time.perf_counter() < deadline, "the dv2 capability handshake did not complete")
            time.sleep(0.05)
        for c in cmds:
            c.replicator.delta.retransmit_ticks = 50
        names = [f"c{i}" for i in range(TWO_NODE_NAMES)]
        pick = rng.integers(0, len(names), TWO_NODE_TAKES).tolist()
        rate = Rate(freq=50, per_ns=3600 * NANO)
        _build.reset_launches()
        t0 = time.perf_counter()
        admitted = http_takes = 0
        for lo in range(0, len(pick), TWO_NODE_CHUNK):
            tickets = []
            for j in range(lo, min(lo + TWO_NODE_CHUNK, len(pick))):
                cmd, name = cmds[j % 2], names[pick[j]]
                if j == lo:
                    conn = http.client.HTTPConnection("127.0.0.1", cmd.api_port, timeout=60)
                    conn.request("POST", f"/take/{name}?rate=50:1h&count=1")
                    resp = conn.getresponse()
                    check(resp.status in (200, 429), f"HTTP take answered {resp.status}")
                    admitted += resp.status == 200
                    http_takes += 1
                    resp.read()
                    conn.close()
                else:
                    tickets.append(cmd.repo.submit_take(name, rate, 1))
            for t in tickets:
                check(t.wait(60), "a take ticket never completed")
                admitted += t.ok
            drained = time.perf_counter() + 30
            while any(c.replicator.delta.stats()["wire_intervals_unacked"] for c in cmds):
                check(time.perf_counter() < drained, "the delta plane did not drain a chunk")
                time.sleep(0.005)
        t_takes = time.perf_counter() - t0
        deadline = time.perf_counter() + 60
        while True:
            for c in cmds:
                check(c.engine.flush(60), "flush timed out")
            views = [c.engine.snapshot_many(names) for c in cmds]
            bad = sum(views[0].get(n) != views[1].get(n) for n in names)
            st = [c.replicator.stats() for c in cmds]
            polls.append({
                "t": time.perf_counter() - t0, "names_differ": bad,
                "dv2_rx": [x["wire_delta_rx_packets"] for x in st],
                "dv2_tx": [x["wire_delta_packets_tx"] for x in st],
                "retransmits": [x["wire_interval_retransmits"] for x in st],
                "unacked": [x["wire_intervals_unacked"] for x in st],
            })
            if bad == 0 and len(views[0]) == len(names):
                snaps = [[c.repo.snapshot(n) for n in names] for c in cmds]
                if snaps[0] == snaps[1]:
                    break
            if time.perf_counter() > deadline:
                raise AssertionError(f"two nodes did not converge in 60 s: {bad} names differ")
            time.sleep(0.2)
        t_conv = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        stats = [c.replicator.stats() for c in cmds]
        # Frozen clocks grant no refill, so the converged taken lanes hold
        # exactly one token per admitted take, whichever node admitted it.
        taken = sum(st.lane_taken_nt for s in snaps[0] for st in s)
        check(taken == admitted * NANO,
              f"converged taken {taken / NANO} tokens, admitted {admitted} takes")
    finally:
        for n in nodes:
            n.close()
    rx = [s["wire_delta_rx_packets"] for s in stats]
    check(launches["decode_fold"] > 0, "decode_fold was not launched by the replicated nodes")
    check(all(r > 0 for r in rx), f"a node received no dv2 datagram: {rx}")
    return {
        "takes": len(pick),
        "http_takes": http_takes,
        "admitted": int(admitted),
        "takes_s": t_takes,
        "converge_s": t_conv,
        "wire_delta_rx_packets": rx,
        "wire_delta_rx_deltas": [s["wire_delta_rx_deltas"] for s in stats],
        "wire_delta_packets_tx": [s["wire_delta_packets_tx"] for s in stats],
        "wire_interval_retransmits": [s["wire_interval_retransmits"] for s in stats],
        "replication_rx_packets": [s["replication_rx_packets"] for s in stats],
        "launches": launches,
        "polls": polls,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import patrol_tpu_torch  # noqa: F401  (fails when run without the repo)
    from patrol_tpu_torch.command import Command
    from patrol_tpu_torch.models.limiter import LimiterConfig
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.ops import ingest_kernel as ik
    from patrol_tpu_torch.ops import join_kernel as jk
    from patrol_tpu_torch.ops import row_rmw_kernel as rk
    from patrol_tpu_torch.ops import take_kernel as tk
    from patrol_tpu_torch.runtime.engine import DeviceEngine
    from patrol_tpu_torch.runtime.repo import TPURepo
    from patrol_tpu_torch.utils import histogram as hist_mod

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report: dict = {}
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    report["nvidia_smi"] = smi
    report["torch"] = [torch.__version__, torch.version.cuda]
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. Build.
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    report["build_s"] = time.perf_counter() - t0
    report["build_log"] = (so.parent / "build.log").read_text() if (so.parent / "build.log").exists() else ""
    log(f"kernels built in {report['build_s']:.1f}s: {so}")

    # 2. Kernels against their plain versions.
    rng = np.random.default_rng(20261016)
    pair, row = join_checks(torch, jk, dev, rng)
    torch.cuda.empty_cache()
    take = take_checks(torch, tk, dev, rng)
    torch.cuda.empty_cache()
    dfold = decode_fold_checks(torch, ik, dev, rng)
    torch.cuda.empty_cache()
    rmw = row_rmw_checks(torch, rk, dev, rng)
    torch.cuda.empty_cache()  # the 4.1 GB probe state and its copies
    log(f"pair_join {pair['ms']:.4f} ms, row_join {row['ms']:.4f} ms, take_n {take['ms']:.4f} ms "
        f"(padding columns only {take['padding_only_ms']:.4f} ms), decode_fold "
        f"{dfold[512]['ms']:.4f} ms at P=512, {dfold[1]['ms']:.4f} ms at P=1, row_rmw "
        f"{rmw['bcast']['ms']:.4f} ms bcast, {rmw['pairmax']['ms']:.4f} ms pairmax "
        f"(pair_join on its updates {rmw['pairmax']['pair_join_ms']:.4f} ms)")
    report["kernel_detail"] = {
        "pair_join": pair, "row_join": row, "take_n": take,
        "decode_fold_p512": dfold[512], "decode_fold_p1": dfold[1],
        "row_rmw_bcast": rmw["bcast"], "row_rmw_pairmax": rmw["pairmax"],
    }

    # 3. The main path.
    trace = make_trace(np.random.default_rng(7))
    clock_now = 1_700_000_000 * NANO
    cfg = LimiterConfig(buckets=BUCKETS, nodes=LANES)
    cmd = Command(
        api_addr="127.0.0.1:0", node_addr=f"127.0.0.1:{free_udp_port()}",
        clock=Clock(clock_now), config=cfg, handle_signals=False, warmup=True,
        device="cuda",
    )
    node = Node(cmd)
    try:
        engine, repo = cmd.engine, cmd.repo
        _build.reset_launches()
        outcomes, t_deltas, t_takes = run_trace(engine, repo, trace, hold=True)
        http_out = drive_http(cmd.api_port)
        check(engine.flush(120), "flush after HTTP timed out")
        launches = dict(_build.LAUNCHES)
        # The engine's stage histograms over the main path (count, sum,
        # p50, p99 in their unit): where the host and device time went.
        stages = {
            name: h for name, h in hist_mod.HISTOGRAMS.snapshot().items()
            if isinstance(h, dict) and h.get("count")
        }
        gpu_pn, gpu_el = engine.snapshot_planes()
        ticks = engine.ticks
    finally:
        node.close()
    log(f"main path: launches {launches}, ticks {ticks}")
    for name in ("pair_join", "row_join", "take_n"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    # The same trace, then the HTTP script's takes, through a CPU engine
    # (the kernels' plain versions).
    ceng = DeviceEngine(cfg, node_slot=0, clock=Clock(clock_now), device="cpu")
    try:
        crepo = TPURepo(ceng)
        c_outcomes, _, _ = run_trace(ceng, crepo, trace)
        http_want = replay_http(crepo)
        check(ceng.flush(600), "CPU replay flush timed out")
        cpu_pn, cpu_el = ceng.snapshot_planes()
    finally:
        ceng.stop()
    if outcomes != c_outcomes:
        bad = sum(a != b for a, b in zip(outcomes, c_outcomes))
        raise AssertionError(f"{bad} take outcomes differ from the CPU replay")
    http_want.update(HTTP_EXPECT)
    for i, want in sorted(http_want.items()):
        if http_out[i] != want:
            raise AssertionError(f"HTTP {HTTP_SCRIPT[i]}: got {http_out[i]}, want {want}")
    check(http_out[-1][0] == 200 and b"engine_ticks" in http_out[-1][1], "/metrics did not answer")
    if not (np.array_equal(gpu_pn, cpu_pn) and np.array_equal(gpu_el, cpu_el)):
        raise AssertionError("final planes differ from the CPU replay")
    admitted = sum(ok for ok, _ in outcomes)
    check(1000 < admitted < len(outcomes), f"{admitted} of {len(outcomes)} takes admitted")
    del gpu_pn, gpu_el, cpu_pn, cpu_el

    n_deltas = len(trace[0]) + len(trace[1])
    main = {
        "deltas": n_deltas,
        "takes": len(outcomes),
        "admitted": admitted,
        "deltas_per_s": n_deltas / t_deltas,
        "takes_per_s": len(outcomes) / t_takes,
        "ticks": ticks,
        "launches": launches,
        "launches_per_tick": {name: n / ticks for name, n in launches.items()},
        "stages": stages,
    }
    report["main_path"] = main
    log(f"deltas/s {main['deltas_per_s']:.0f}  takes/s {main['takes_per_s']:.0f}")
    print(f"takes_per_s {main['takes_per_s']:.1f} deltas_per_s {main['deltas_per_s']:.1f}")

    # 3b. Raw wire-v2 ingest at the ring's batch, replayed on the CPU.
    t0 = time.perf_counter()
    planes, lengths = raw_ingest_trace(np.random.default_rng(11))
    log(f"raw ingest trace: {len(planes)} datagrams built in {time.perf_counter() - t0:.1f}s")
    geng = DeviceEngine(cfg, node_slot=0, clock=Clock(clock_now), device="cuda")
    try:
        geng.warmup()
        _build.reset_launches()
        acc_g, dt_g = run_raw_ingest(geng, planes, lengths)
        raw_launches = dict(_build.LAUNCHES)
        gpu_pn, gpu_el = geng.snapshot_planes()
    finally:
        geng.stop()
    del geng
    torch.cuda.empty_cache()
    ceng = DeviceEngine(cfg, node_slot=0, clock=Clock(clock_now), device="cpu")
    try:
        acc_c, _ = run_raw_ingest(ceng, planes, lengths)
        cpu_pn, cpu_el = ceng.snapshot_planes()
    finally:
        ceng.stop()
    check(acc_g == acc_c, "raw ingest accepted counts differ from the CPU replay")
    if not (np.array_equal(gpu_pn, cpu_pn) and np.array_equal(gpu_el, cpu_el)):
        raise AssertionError("raw ingest planes differ from the CPU replay")
    check(raw_launches["decode_fold"] == len(acc_g),
          f"raw ingest launched decode_fold {raw_launches['decode_fold']} times")
    accepted = sum(acc_g)
    check(180_000 < accepted < 200_000, f"raw ingest accepted {accepted} entries")
    del gpu_pn, gpu_el, cpu_pn, cpu_el
    raw = {
        "datagrams": len(planes),
        "batches": len(acc_g),
        "accepted": accepted,
        "seconds": dt_g,
        "raw_deltas_per_s": accepted / dt_g,
        "launches": raw_launches,
    }
    report["raw_ingest"] = raw
    log(f"raw ingest: {accepted} entries in {dt_g:.2f}s")
    print(f"raw_deltas_per_s {raw['raw_deltas_per_s']:.1f}")

    # 3c. Two replicated nodes over loopback UDP.
    two = run_two_nodes(Command, LimiterConfig, np.random.default_rng(13))
    report["two_nodes"] = two
    log(f"two nodes: converged in {two['converge_s']:.2f}s, dv2 rx {two['wire_delta_rx_packets']}, "
        f"launches {two['launches']}")
    print(f"two_nodes_converge_s {two['converge_s']:.3f}")

    # 3d. The probe's entry point on the card: 1M x 256 lanes, K = 8192.
    from patrol_tpu_torch.scripts import probe_dma_scatter as probe_mod

    _build.reset_launches()
    with contextlib.redirect_stdout(sys.stderr):
        probe = probe_mod.main(["--device", "cuda"])
    probe_launches = dict(_build.LAUNCHES)
    torch.cuda.empty_cache()
    check(probe["pairmax_equals_pair_join"], "pairmax through row_rmw and pair_join differ")
    check(probe_launches["row_rmw"] == probe["row_rmw_calls"],
          f"the probe launched row_rmw {probe_launches['row_rmw']} times, "
          f"made {probe['row_rmw_calls']} calls")
    check(probe_launches["pair_join"] == probe["inners"]["pair_join"]["calls"] + 1,
          f"the probe launched pair_join {probe_launches['pair_join']} times")
    probe["launches"] = probe_launches
    report["probe"] = probe
    per_row = {k: v["per_row_ns"] for k, v in probe["inners"].items()}
    log(f"probe: per-row ns {per_row}, launches {probe_launches}")
    print("probe_per_row_ns " + " ".join(f"{k} {v:.3f}" for k, v in per_row.items()))

    # 4. The kernels line, the card, the contract line.
    kernels = []
    for name, src, replaces, m, n in (
        ("pair_join", "patrol_tpu_torch/csrc/join.cu", "patrol_tpu/ops/pallas_merge.py:86",
         pair, launches["pair_join"]),
        ("row_join", "patrol_tpu_torch/csrc/join.cu", "patrol_tpu/ops/pallas_merge.py:86",
         row, launches["row_join"]),
        ("take_n", "patrol_tpu_torch/csrc/take.cu", "patrol_tpu/ops/take.py:171",
         take, launches["take_n"]),
        # Timed at the ring batch (P = 512); launches are those of the two
        # replicated nodes (phase 3c, P = 1 each). The P = 1 numbers ride
        # along under *_p1.
        ("decode_fold", "patrol_tpu_torch/csrc/decode_fold.cu", "patrol_tpu/ops/ingest.py:589",
         dfold[512], two["launches"]["decode_fold"]),
        # Timed as pairmax (the join); bcast rides along under *_bcast.
        # Launches are those of the probe's entry point (phase 3d).
        ("row_rmw", "patrol_tpu_torch/csrc/row_rmw.cu", "scripts/probe_dma_scatter.py:86",
         rmw["pairmax"], probe_launches["row_rmw"]),
    ):
        b_ms, b_by = bound(m["bytes"], m["ops"])
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": n, "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": m["library_ms"],
        }
        if name == "row_rmw":
            mb = rmw["bcast"]
            bb, byb = bound(mb["bytes"], mb["ops"])
            bj, _ = bound(m["pair_join_bytes"], 3 * PROBE_K)
            entry.update({
                "max_abs_err": max(m["max_abs_err"], mb["max_abs_err"]),
                "ms_cold_rows": m["ms_cold_rows"], "pair_join_ms": m["pair_join_ms"],
                "pair_join_bound_ms": bj,
                "ms_bcast": mb["ms"], "ms_cold_rows_bcast": mb["ms_cold_rows"],
                "plain_ms_bcast": mb["plain_ms"], "bound_ms_bcast": bb, "bound_by_bcast": byb,
                "library_ms_bcast": mb["library_ms"],
            })
        if name == "decode_fold":
            m1 = dfold[1]
            b1, by1 = bound(m1["bytes"], m1["ops"])
            entry.update({
                "max_abs_err": max(m["max_abs_err"], m1["max_abs_err"]),
                "ms_p1": m1["ms"], "plain_ms_p1": m1["plain_ms"], "bound_ms_p1": b1,
                "bound_by_p1": by1, "library_ms_p1": m1["library_ms"],
            })
        kernels.append(entry)
    report["kernels"] = kernels
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
