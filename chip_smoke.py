#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``patrol_tpu_torch``) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --fresh-trace-legs N [--unprepared]

(the second form only repeats phase 3k(d)'s fresh-process trace leg:
see :func:`trace_soak`).

Phases (any failure exits nonzero; nothing is caught and skipped):

1. Build every CUDA kernel from ``patrol_tpu_torch/csrc`` (nvcc, sm_90a)
   and the native host library from ``patrol_tpu_torch/native`` (g++),
   and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main path (state 1,000,000 buckets × 64 lanes): the join
   kernel through each wrapper — ``pair_join`` (8192 pairs with
   duplicates, FOLD_PAD_ROW sentinels and values past 2^32), the J = 8
   commit ring (64,536 folded deltas) whole and cut at its live counts,
   ``row_join`` (512 dense rows), ``tick_join`` (512 dense rows and 8192
   pairs in one launch, and as ``row_join`` then ``pair_join``), the ring
   warm and cold beside a
   byte and a sector-granular bound, and each wrapper's floor (one live
   entry); ``cuobjdump -sass`` must show the reduction body as
   ``RED.E.MAX.S64`` and no returning ``ATOM``. Then take-n (4096 rows, with padding rows aliasing a live row 0, negative
   balances, zero rates, count <= 0 and an fp64 refill corpus) and
   decode+fold (512 raw wire-v2 datagram planes of 8 KiB, about 180
   entries each, mixed with the hostile kinds — flips, truncations,
   trailing garbage, random blobs, bit-63 values with a fixed-up checksum,
   lying framing proposals — over random ``hosted`` flags, duplicate rows
   and sentinel rows; then one plane). int64 must be equal bit for bit
   (tolerance 0; decoded fields under ``entry_ok``). Each kernel is timed
   beside its plain version, its bound and, where one exists, the PyTorch
   library call that computes the same function (for decode+fold, its
   fold half); take-n also on padding columns only, decode+fold also on
   one plane rejected at its length (each kernel's own floor). On a small
   state beside it, the two kernels' edge shapes: take-n at N = 1, 31,
   32, 33, 64 and 65 lanes with the own lane first, last and at 32;
   decode+fold over datagrams ending at every residue mod 16, with names
   of every length 0..17, count 0 and the row's maximum count, at P = 16
   and P = 1 (random stale bytes past each datagram); and a CUDA call on
   planes one byte past a 16-byte boundary must raise in the wrapper.
   ``-Xptxas -v``'s lines for these and the join kernel go to the JSON
   detail. Then
   the per-row RMW scatter at the probe's size: state
   int32[1,000,000, 8, 128] (the 1M × 256-lane ``pn``, 4.1 GB) over the
   whole int32 range, 8192 unique rows (one out of range), ``w0`` of both
   residues mod 4, both inner functions bit for bit against the plain
   version and the library call, timed also with cold rows and, for
   ``pairmax``, beside ``pair_join`` on the same updates. Last, the
   lifecycle probe at K = 8,192 (GC_SWEEP_MAX) candidates on the 1M × 64
   state, over every verdict case (full, spent, over capacity, zero rate,
   capacity-0 padding, ``now`` before ``created + elapsed``, int64-wrapping
   sums, an fp64 corpus on the edge of the verdict, wrapped and clamped
   rows) at ``node_slot`` 0, 31, 32 and 63, at K = 0 (no launch), 1, 8,
   512 and 2^20, and at N = 1, 31, 33, 256 and 512 lanes on a small state
   with the own lane first and last; all four outputs bit for bit, timed
   warm (the same candidates each call), cold (a cycle of fresh random
   row sets past L2, and of consecutive ones), at K = 512 and at its floor
   (K = 8, one block), beside its plain version and its bound; its
   ``-Xptxas -v`` line (registers, shared memory) is printed. Then the
   certified families (``csrc/cert.cu``: GCRA's, concurrency's and
   quota's one cooperative launch each)
   at K = 8,192 on the 1M x 64 state (quota over 24,576 row gathers),
   each held bit for bit (results and final planes) to its plain version
   at ``node_slot`` 0 and 63, over its hazards: remote lanes preset
   (holds, spends, TAT watermarks, raw int64 near 2^63, every TAKEN lane
   near -2^63), repeated rows and
   padding columns aliasing live ones, rows in ``[-B, 0)``, past ``B`` and
   below ``-B``, shared tenant and global rows and a row at two levels,
   ``nreq``, ``count`` and ``T`` <= 0, negative ``nreq``, releases above
   the held amount, wrapping products; again at K = 0 (no launch), 1, 8
   and 2^16, at the resident grid's columns and one either side (the
   persistent loop's wrap) and at 2^16 with every column committing (the
   spill buffer), each call one launch; and at N = 1, 31, 33 and 256
   lanes on a small state. Each family is timed warm, cold (16 requests
   on fresh random rows), at K = 512 and at K = 8 (its floor), beside its
   plain version, the library calls (``index_select``, ``amax`` or
   ``sum``, ``scatter_reduce_``) and its bound; the ``-Xptxas -v`` lines
   and each kernel's grid (blocks an SM from the occupancy call, resident
   blocks) print. Last, the mesh converge (``csrc/converge.cu``): the
   scratch gather and the converge, each against its plain version bit
   for bit over the whole int64 range (words near +2^63 and -2^63) at
   R = 2, 3, 4, 8 replicas, T = 1, 512, 4,096, 32,768 take rows and N = 1,
   33, 64 lanes on a 1,000,000-row state, each call one launch; both timed
   at R = 2, T = 4,096, N = 64 warm, cold (8 row sets, past L2) and at
   T = 1, beside the plain versions, the library calls (``amax`` +
   ``index_copy_``; ``index_select`` + ``copy_``) and their bound.
3. The main path: the port's ``Command`` serving on the asyncio front
   (host fast path off, see 3f)
   (ephemeral port, ``device="cuda"``, frozen clock), 100k peer deltas with
   lane trailers from lanes 1..63 through ``TPURepo.apply_delta``, 50k takes
   (uniform keys plus a Zipf(1.25) hot-key crowd) through ``submit_take``,
   and a few dozen real HTTP requests. The launch counters are zeroed just
   before and read just after; the join kernel (through any of its
   wrappers) and take-n must have launched. The deltas run under
   ``torch.profiler``: the join kernel's count and device time, the
   device's busy share, and how the merge ticks committed (single-block,
   hybrid, commit rings by J) go to the JSON detail, with the ticks that
   folded in C++ (``fold_native_ticks``, the hot-row burst's when it
   falls into a tick of 1,024 deltas or more); the tick fold is also
   timed on one clustered batch of 131,072 deltas over 64 rows, numpy
   against native (host ns, outputs equal). The same trace replays
   through a second engine on the CPU (the plain versions): per-ticket
   outcomes and the final planes must be identical.
3b. Raw wire-v2 ingest at the ring's batch: 200,000 entries over 200,000
   names in 8 KiB datagrams (one in 16 corrupted) through
   ``DeviceEngine.ingest_raw_planes`` in batches of 512 planes; replayed
   on a CPU engine, accepted counts and final planes must be equal.
3c. Two replicated nodes over loopback UDP on the asyncio backend, each a
   ``Command`` on the card at 1M × 64, wire mode ``delta``, frozen clocks:
   20,000 takes over 2,000
   names split across them in paced chunks of 500 (each chunk's delta
   intervals all acked within 30 s), then both must hold the same state
   for every name within 60 s, and ``decode_fold`` must have launched.
   The delta planes run their default, adaptive retransmit timer; the
   smoothed ack round trip and the timeout it set go to the JSON detail.
   Chunks 4..9
   of the paced takes run under ``torch.profiler``: the count and device
   time of ``take_n_kernel`` and ``decode_fold_kernel`` and the device's
   busy share of that window go to the JSON detail.
3e. Phase 3c again, same traffic, on the native UDP backend: recvmmsg
   batches of up to 512 datagrams into the rx ring, each batch of dv2
   datagrams shipped from its ring plane to one ``decode_fold`` launch.
   Each node's replicator must be a ``NativeReplicator`` whose ring planes
   report ``is_pinned()``; once the nodes stop, each ring's leases and
   commits must be equal and above zero; ``decode_fold`` must have run at
   a mean P above 1, some batch straight from a pinned plane, and the
   nodes must converge as in 3c. The P histogram, launches, retransmits,
   ack srtt and the profiled window go beside 3c's.
3f. One node at the defaults (``Command()`` as the CLI makes it: the
   native C++ front, the native host-lane store, the host fast path on),
   1M x 64 on the card. Phases 3, 3b, 3c and 3e run the asyncio front
   with ``engine.HOST_FASTPATH = False``, as before host lanes became the
   default, so their numbers stay comparable. A residency leg drives
   ``pt_http_blast`` (h1 keep-alive, 16 x 8 in flight) over 200,000
   names (half uniform, half Zipf(1.25) over 1,000 hot names) for
   windows of 3 s: cold (each bucket's first take crosses the Python
   pump), warm (the buckets the cold window bound; every take is
   answered in C++ in the front), and warm again over one connection
   with one request in flight (unloaded latency). Per window: rps,
   p50/p99 latency, the
   200/429 split, in-front, Python-host and device takes, promotions and
   launches. A promotion leg lowers ``HOST_PROMOTE_TAKES`` and
   ``NATIVE_PROMOTE_TAKES`` to 32 and steps the clock: 64 hot names are
   bound, burst in front (the C++ take path at an explicit clock) past
   the threshold, promoted (the drain must launch the join), taken on the
   device (take-n must launch), idle a demote window and are demoted
   (gather, zero) by the take that ends it, then served in front again.
   Each row must be promoted and demoted exactly once, and every take
   outcome and final per-name state (``snapshot``, host lanes) must equal
   a replay on a CPU engine with the fast path off.
3g. Two nodes at the defaults on the native UDP backend: every one of
   phase 3c's 2,000 names taken on both nodes first (so both host it),
   then 6,000 paced takes as in 3c. Hosted rows' dv2 entries reach
   ``decode_fold`` marked hosted; the kernel's ``hosted_mask`` and fields
   come back in one copy and are absorbed into host lanes. At least one
   launch must carry a hosted entry, the nodes must converge as in 3c,
   and every admitted take must be in a lane; the launches with and
   without a hosted entry and the entries absorbed are printed.
3h. The bucket lifecycle: one engine at 1M x 64 on the card at the
   defaults (host lanes in the native store, GC at its default knobs),
   at a stepped clock. (a) 200,000 device rows bound by raw dv2 ingest,
   4,000 host-resident rows by takes (a quarter also spent through the
   C++ take path), 64 rows promoted with own-lane spend; (b) the clock
   past the refill and GC_IDLE, four sweeps at the feeder's cadence, then
   forced sweeps until no candidate is left: every bucket must be
   reclaimed, the probe kernel launched once for each sweep with device
   candidates; (c) 1,000 reclaimed names taken again (each own lane must
   resume at its tombstone) and 512 ingested again; (d) a bucket budget
   just above the bound count, then 2,000 new names: sheds counted; (e)
   the node saved to a temp directory and restored into a fresh engine on
   the card (planes, directory and tombstones equal). (a)-(d) replay on a
   CPU engine: outcomes, each sweep's reclaims, the bound set, tombstones
   and final planes must be equal. Phases 3-3g pin the GC window to 0.
3i. The certified families through the engine's entry points: a
   ``Command`` at the defaults on the card (1M x 64, GC window pinned to
   0). The bench's cert leg input for input on rows 0..11 (bound first to
   names of their own) must admit 15 / 21 / 8 with ``own_tat_ns`` on its
   sequential replay; then 64 rounds of one microbatch of each family at
   K = 8,192 over random rows in ``[B/2, B)``, each round followed by 16
   host-served takes and 16 peer deltas on other names, under the
   profiler; a microbatch of each family on rows 0..11 must show in the
   next scrape. Each family's kernel must have launched once a call, and
   no other kernel. Each call's host time is split into its
   steps (packing, staging lease, ship, launch, readback; p50 and p99 per
   family). Then 1,000 scrapes of unchanged state must be mirror hits
   with no device gather. The sequence replays on a CPU engine: every
   result, serving outcome and the final planes equal.
3j. The mesh: ``MeshEngine`` over ``cuda:0`` x 8 at 1M x 64 (host fast
   path and GC off, as phase 3), phase 3's trace through a ``TPURepo``
   with its held bursts. R = 2 (2 x 4 blocks) over the whole trace, then
   6,000 takes submitted from one thread while the mesh resizes 2 -> 4 ->
   2; R = 4 (4 x 2) and R = 1 (1 x 8) over its first 30,000 deltas (and
   the hot burst) and 10,000 takes. Each leg replays on a CPU MeshEngine
   at the same R: take outcomes and the planes (after the trace and at
   the end) must be equal. Each leg must split a tick past
   ``MESH_WARM_MAX`` (``mesh_split_ticks`` > 0); take-n must launch once
   for each dispatch with takes, and the gather and the converge as often
   at R > 1 and never at R = 1; the join must launch; every take across
   the resize must be answered. Per leg: deltas/s, takes/s, a dispatch's
   host time by step (route, prepare, ship, launch, other; p50 and p99),
   the tick fold's, and the device busy share under ``torch.profiler``.
3d. The probe's entry point (``patrol_tpu_torch.scripts.probe_dma_scatter``,
   ``--device cuda``) at 1M × 256 lanes, K = 8192: ``row_rmw`` must have
   launched exactly once per call the probe made, and ``pairmax`` through
   ``row_rmw`` and through ``pair_join`` must leave equal states. Its
   printout goes to stderr, its numbers to the JSON detail.
3k. The port's check stages on the card, and a device trace of a live
   node. (a) Every ABI obligation (``analysis/abi.py``) against the
   port's ``libpatrolhost.so``, the fold's kernel twins on ``cuda``: no
   finding, and the join kernel must have launched (counts zeroed just
   before). (b) The lin pins (``analysis/lin_pins.py``): the sequential
   take spec against ``take_n``, the GC gate against ``lifecycle_probe``,
   ``SequentialGcra``/``Conc``/``Quota`` against the cert kernels, 2,048
   histories x 24 steps each from a seed, bit for bit, one launch a call.
   (c) ``protocol_repo`` and ``lin_repo`` as subprocesses: both exit 0
   and print every registered seeded mutation as rejected with its code.
   (d) A ``Command`` at the defaults on the card with a peer socket in its
   member list: the peer's dv2 deltas bind 2,000 names (device rows), a
   first capture under load pays the profiler's start-up, then
   ``pt_http_blast`` windows over those names (with the peer sending 16
   deltas every 50 ms) without a capture, under ``GET
   /debug/cuda/trace?seconds=2`` (an overlapping ``/debug/pprof/trace``
   must answer 409), and without again. The trace must hold
   ``take_n_kernel`` (or ``join_kernel``), and ``decode_fold_kernel`` when
   ``decode_fold`` launched inside it; printed: the captures' wall time,
   the file's size, the device busy share, how far into the window the
   first host op, launch call and device event lie, launch calls without
   a device record, and takes/s with and without the capture.
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
import types

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
    """The join kernel through each of its wrappers on the 1M x 64 state,
    bit for bit (tolerance 0) against the plain versions, then timed:

    * ``pair_join`` at 8192 pairs with duplicates (a quarter on 64 hot
      rows), 256 sentinel pairs and values past 2^32;
    * ``row_join`` at 512 dense rows (the fold's ceiling), 8 sentinels;
    * ``tick_join``, the hybrid tick: 512 dense rows and 8192 unique pairs
      on other rows, as one launch and as ``row_join`` then ``pair_join``;
    * the J = 8 commit ring of 64,536 folded deltas through
      ``commit_packed``, whole (sentinel tail included) and cut at the
      fold's live counts, warm (the same ring again) and cold (a cycle of
      16 rings on fresh random rows, ~10 MB of touched sectors each, past
      the 50 MB L2), beside two bounds: the table's rule (live inputs
      once, each touched 16-byte pair and 8-byte elapsed word read and
      written once) and a sector-granular one (each touched 32-byte
      sector read and written once);
    * each wrapper's floor: the same launch with one live pair, one live
      row, or one of each.

    → {"pair": ..., "row": ..., "tick": ..., "ring": ...}, each with the
    keys the kernels line reads."""
    from patrol_tpu_torch.models.limiter import LimiterState
    from patrol_tpu_torch.ops import commit as commit_mod
    from patrol_tpu_torch.ops.merge import FOLD_PAD_ROW
    from patrol_tpu_torch.runtime.engine import DeltaArrays, fold_core

    big = 1 << 40
    base_pn = torch.from_numpy(
        rng.integers(0, big, size=(BUCKETS, LANES, 2), dtype=np.int64)
    ).to(dev)
    base_el = torch.from_numpy(rng.integers(0, big, size=BUCKETS, dtype=np.int64)).to(dev)

    def dev64(*xs):
        return [torch.from_numpy(np.ascontiguousarray(x, np.int64)).to(dev) for x in xs]

    pk, ek = base_pn.clone(), base_el.clone()
    pp, ep = base_pn.clone(), base_el.clone()
    errs = {}

    def same(name, kernel, plain):
        kernel(pk, ek)
        plain(pp, ep)
        torch.cuda.synchronize()
        errs[name] = max(check_equal(torch, f"{name} pn", pk, pp),
                         check_equal(torch, f"{name} elapsed", ek, ep))

    # Pair join: 8192 pairs, duplicates (a quarter on 64 hot rows), 256
    # sentinel pairs, values past 2^32.
    k = 8192
    rows = rng.integers(0, BUCKETS, k)
    rows[: k // 4] = rng.integers(0, 64, k // 4)
    rows[-256:] = FOLD_PAD_ROW + np.arange(256)
    slots = rng.integers(0, LANES, k)
    vals = rng.integers(0, 2 * big, size=(3, k))
    args = dev64(rows, slots, vals[0], vals[1], rows, vals[2])
    same("pair_join", lambda p, e: jk.pair_join(p, e, *args),
         lambda p, e: jk.pair_join_plain(p, e, *args))

    # Commit ring: 8 blocks of 8192, 64,536 deltas folded (and, for the
    # cold cycle, 16 more rings on fresh random rows).
    def fold_ring(n):
        d = DeltaArrays(
            rng.integers(0, BUCKETS, n), rng.integers(0, LANES, n),
            rng.integers(0, 2 * big, n), rng.integers(0, 2 * big, n),
            rng.integers(0, 2 * big, n), np.zeros(n, bool),
        )
        ur, us, ua, ut, er, e = fold_core(d)
        ring = commit_mod.pack_commit_blocks(ur, us, ua, ut, er, e, 8192)
        check(ring.shape[1] == 8, f"commit ring has {ring.shape[1]} blocks, want 8")
        return torch.from_numpy(ring).to(dev), len(ur), len(er)

    n_ring = 8 * 8192 - 1000
    ring_t, n, ne = fold_ring(n_ring)
    flat = [ring_t[i].reshape(-1).contiguous() for i in range(6)]
    live = commit_mod.live_pairs(ring_t, n, ne, BUCKETS)
    same("ring whole", lambda p, e: jk.pair_join(p, e, *flat),
         lambda p, e: jk.pair_join_plain(p, e, *flat))
    same("ring live", lambda p, e: commit_mod.commit_packed(LimiterState(p, e), ring_t, n, ne),
         lambda p, e: jk.pair_join_plain(p, e, *flat))

    # Row join: 512 dense rows (the fold's ceiling), 8 of them sentinels.
    r = 512
    drows = rng.choice(BUCKETS, r, replace=False)
    drows[-8:] = FOLD_PAD_ROW + np.arange(8)
    upd = rng.integers(0, 2 * big, size=(r, LANES, 2))
    upd[:, ::3] = 0  # untouched lanes carry zeros
    dargs = dev64(drows, upd, rng.integers(0, 2 * big, r))
    same("row_join", lambda p, e: jk.row_join(p, e, *dargs),
         lambda p, e: jk.row_join_plain(p, e, *dargs))

    # The hybrid tick: 512 dense rows and 8192 unique pairs (one a row) on
    # other rows, every entry live.
    hrows = rng.choice(BUCKETS, r + k, replace=False)
    hdense = dev64(hrows[:r], upd, rng.integers(0, 2 * big, r))
    hpairs = dev64(hrows[r:], rng.integers(0, LANES, k), *rng.integers(0, 2 * big, size=(2, k)),
                   hrows[r:], rng.integers(0, 2 * big, k))
    same("tick_join", lambda p, e: jk.tick_join(p, e, hdense, hpairs),
         lambda p, e: jk.tick_join_plain(p, e, hdense, hpairs))
    same("tick as row_join then pair_join",
         lambda p, e: (jk.row_join(p, e, *hdense), jk.pair_join(p, e, *hpairs)),
         lambda p, e: jk.tick_join_plain(p, e, hdense, hpairs))

    # Timing at the checked shapes.
    def t(fn, **kw):
        return device_ms(torch, fn, **kw)

    def lib_pairs(idx, src, er, ev):
        pk.view(-1, 2).scatter_reduce_(0, idx, src, reduce="amax", include_self=True)
        ek.scatter_reduce_(0, er, ev, reduce="amax", include_self=True)

    def lib_operands(rows_t, slots_t, added, taken, erows, evals):
        """The library call's operands for a pair half (in-range only)."""
        ok = (rows_t < BUCKETS) & (slots_t < LANES)
        eok = erows < BUCKETS
        return ((rows_t[ok] * LANES + slots_t[ok]).unsqueeze(1).expand(-1, 2).contiguous(),
                torch.stack([added[ok], taken[ok]], 1).contiguous(),
                erows[eok].contiguous(), evals[eok].contiguous())

    ok = rows < BUCKETS
    uniq_pairs = len(np.unique(rows[ok] * LANES + slots[ok]))
    uniq_rows = len(np.unique(rows[ok]))
    lib = lib_operands(*args)
    one = [a[:1].contiguous() for a in args[:4]] + [args[4][:0], args[5][:0]]
    pair = {
        "ms": t(lambda: jk.pair_join(pk, ek, *args)),
        "floor_ms": t(lambda: jk.pair_join(pk, ek, *one)),
        "plain_ms": t(lambda: jk.pair_join_plain(pp, ep, *args)),
        "library_ms": t(lambda: lib_pairs(*lib)),
        "bytes": 8 * (6 * k) + 2 * 16 * uniq_pairs + 2 * 8 * uniq_rows,
        "ops": 3 * k,
        "max_abs_err": errs["pair_join"],
    }

    live_r = torch.from_numpy(drows < BUCKETS).to(dev)
    rlib_idx = dargs[0][live_r].view(-1, 1, 1).expand(-1, LANES, 2).contiguous()
    rlib_src = dargs[1][live_r].contiguous()
    nr = int(live_r.sum())
    row = {
        "ms": t(lambda: jk.row_join(pk, ek, *dargs)),
        "floor_ms": t(lambda: jk.row_join(pk, ek, *(a[:1] for a in dargs))),
        "plain_ms": t(lambda: jk.row_join_plain(pp, ep, *dargs)),
        "library_ms": t(lambda: pk.scatter_reduce_(0, rlib_idx, rlib_src, reduce="amax",
                                                   include_self=True)),
        "bytes": 8 * (r + r * LANES * 2 + r) + 2 * (nr * LANES * 16 + nr * 8),
        "ops": r * (2 * LANES + 1),
        "max_abs_err": errs["row_join"],
    }

    hlib_rows = hdense[0].view(-1, 1, 1).expand(-1, LANES, 2).contiguous()
    hlib = lib_operands(*hpairs[:4], torch.cat([hdense[0], hpairs[4]]),
                        torch.cat([hdense[2], hpairs[5]]))

    def lib_tick():
        pk.scatter_reduce_(0, hlib_rows, hdense[1], reduce="amax", include_self=True)
        lib_pairs(*hlib)

    tick = {
        "ms": t(lambda: jk.tick_join(pk, ek, hdense, hpairs)),
        "two_launches_ms": t(lambda: (jk.row_join(pk, ek, *hdense),
                                      jk.pair_join(pk, ek, *hpairs))),
        "floor_ms": t(lambda: jk.tick_join(pk, ek, [a[:1] for a in hdense],
                                           [a[:1] for a in hpairs])),
        "plain_ms": t(lambda: jk.tick_join_plain(pp, ep, hdense, hpairs)),
        "library_ms": t(lib_tick),
        "bytes": 8 * (r * (2 * LANES + 2) + 6 * k) + 2 * (r * (LANES * 16 + 8) + k * (16 + 8)),
        "ops": r * (2 * LANES + 1) + 3 * k,
        "max_abs_err": max(v for name, v in errs.items() if name.startswith("tick")),
    }

    # The ring, warm and cold, whole and live-only, both bodies.
    def ring_bytes(ring_dev, cn, cne):
        """(table-rule bytes, sector-granular bytes) of one ring's live
        entries: inputs once, then each touched 16-byte pair and 8-byte
        elapsed word, or each touched 32-byte sector, read and written."""
        rnp = ring_dev.reshape(6, -1).cpu().numpy()
        inputs = cn * 32 + cne * 16
        sec = (len(np.unique((rnp[0, :cn] * LANES + rnp[1, :cn]) // 2))
               + len(np.unique(rnp[4, :cne] // 4)))
        return inputs + 2 * (cn * 16 + cne * 8), inputs + 2 * 32 * sec

    b_table, b_sector = ring_bytes(ring_t, n, ne)
    ring = {
        "n": n, "ne": ne, "slots": int(ring_t[0].numel()),
        "bytes": b_table, "bytes_sectors": b_sector, "ops": 3 * n + ne,
    }
    cold = [fold_ring(n_ring) for _ in range(16)]
    cold_live = [commit_mod.live_pairs(c, cn, cne, BUCKETS) for c, cn, cne in cold]
    cold_flat = [[c[i].reshape(-1).contiguous() for i in range(6)] for c, _, _ in cold]
    cold_bytes = [ring_bytes(*c) for c in cold]
    ring["bytes_cold"] = statistics.mean(b for b, _ in cold_bytes)
    ring["bytes_sectors_cold"] = statistics.mean(b for _, b in cold_bytes)
    # Live prefix and whole ring in turns (live, whole, whole, live); each
    # time is the mean of its two turns.
    for key, ops in (("", live), ("_whole", flat), ("_whole", flat), ("", live)):
        cyc = itertools.cycle(cold_live if ops is live else cold_flat)
        ring.setdefault("ms" + key + "_turns", []).append(
            t(lambda: jk.pair_join(pk, ek, *ops)))
        ring.setdefault("ms_cold" + key + "_turns", []).append(
            t(lambda: jk.pair_join(pk, ek, *next(cyc))))
    for key in ("", "_whole"):
        for warm in ("ms", "ms_cold"):
            ring[warm + key] = statistics.mean(ring.pop(warm + key + "_turns"))
    ring["plain_ms"] = t(lambda: jk.pair_join_plain(pp, ep, *live), n=5)
    rlib = lib_operands(*live)
    ring["library_ms"] = t(lambda: lib_pairs(*rlib))
    ring["max_abs_err"] = max(v for name, v in errs.items() if name.startswith("ring"))
    del base_pn, base_el, pk, ek, pp, ep, cold, cold_live, cold_flat
    return {"pair": pair, "row": row, "tick": tick, "ring": ring}


def take_inputs(rng, buckets=BUCKETS, lanes=LANES, k=4096):
    """State and a packed [8, k] take tick with every hazard case: 7/8 of
    the columns live, the rest padding (row 0, nreq 0) aliasing a live
    row 0, and k / 16 columns of fp64 refill corpus."""
    pn = np.zeros((buckets, lanes, 2), np.int64)
    el = np.zeros(buckets, np.int64)
    live = k * 7 // 8
    rows = rng.choice(np.arange(1, buckets), live, replace=False)
    rows[7] = 0  # row 0 is live; the padding tail aliases it
    pn[rows] = rng.integers(0, 4 * NANO, size=(live, lanes, 2))
    neg = rows[: live // 4]
    pn[neg, :, 1] += rng.integers(0, 8 * NANO, size=(len(neg), lanes))  # TAKEN > ADDED
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
    # fp64 refill corpus on k / 16 rows: near-integer quotients, interval
    # 1, huge deltas; a deep debit keeps the raw grant visible in `have`.
    nf = k // 16
    fp = slice(live - nf, live)
    intervals = rng.choice([1, 3, 7, 999_999_937, 10**12 + 39, (1 << 40) + 1], nf)
    mult = rng.choice([1, 3, 10**6 + 1, 10**9 + 7], nf)
    delta = np.clip(intervals * mult + rng.integers(-1, 2, nf), 0, (1 << 62) - 1)
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


EDGE_BUCKETS = 4096


def take_lane_cases():
    """(N, node_slot) around the kernel's 32-lane warp: the own lane
    first, last and, past 32 lanes, in the warp's second pass."""
    return [(n, slot) for n in (1, 31, 32, 33, 64, 65)
            for slot in sorted({0, n - 1} | ({32} if n > 32 else set()))]


def take_edge_checks(torch, tk, dev, rng):
    """take_n at every lane width of :func:`take_lane_cases` on a small
    state (4096 buckets, K = 512 with every hazard case), bit for bit
    against its plain version; → the number of cases and max_abs_err."""
    err = 0
    cases = take_lane_cases()
    for n, slot in cases:
        pn, el, p = take_inputs(rng, EDGE_BUCKETS, n, 512)
        pk, ek = torch.from_numpy(pn).to(dev), torch.from_numpy(el).to(dev)
        pp, ep = pk.clone(), ek.clone()
        packed = torch.from_numpy(p).to(dev)
        out_k = tk.take_n(pk, ek, packed, slot)
        out_p = tk.take_n_plain(pp, ep, packed, slot)
        torch.cuda.synchronize()
        tag = f"take_n N={n} node_slot={slot}"
        err = max(err, check_equal(torch, f"{tag} results", out_k, out_p),
                  check_equal(torch, f"{tag} pn", pk, pp),
                  check_equal(torch, f"{tag} elapsed", ek, ep))
        check(int((out_k[1] >= 1).sum()) > 50, f"{tag}: the corpus admits too little")
    return {"cases": len(cases), "max_abs_err": err}


# -- phase 2: the lifecycle probe against its plain version -------------------

GC_K = 8192  # GC_SWEEP_MAX: the candidates one sweep probes


def lifecycle_inputs(rng, buckets=BUCKETS, lanes=LANES, k=GC_K):
    """State and K probe candidates over every verdict case, in equal
    parts: full (spend refilled), spent (refill short), over capacity
    (merged grants past it), zero rate (per 0, or a capacity under one
    token), capacity-0 padding, ``now`` before ``created + elapsed``,
    int64-wrapping lane sums, and an fp64 refill corpus whose grant lands
    within a nanotoken of the distance to capacity. Rows are distinct and
    a few lie in ``[-B, 0)`` (wrapped) or past ``B`` (clamped).
    → (pn, el, cols int64[5, K]: rows, now, per, cap, created)."""
    pn = np.zeros((buckets, lanes, 2), np.int64)
    el = np.zeros(buckets, np.int64)
    rows = rng.choice(np.arange(1, buckets), k, replace=False)
    now = 1000 * NANO + rng.integers(0, 100 * NANO, k)
    per = rng.choice([NANO, 3 * NANO + 1, 60 * NANO], k)
    cap = rng.choice([1, 10, 1000], k) * NANO
    created = rng.integers(0, 500 * NANO, k)
    cases = np.arange(k) % 8
    spend = rng.integers(1, 4 * NANO, (k, lanes))
    pn[rows, :, 1] = np.where(cases[:, None] < 3, spend // lanes, 0)
    el[rows] = rng.integers(0, 400 * NANO, k)
    # 0 full: a whole period since the last refill covers the spend.
    c = cases == 0
    el[rows[c]] = 0
    created[c] = now[c] - per[c] * 2
    # 1 spent: no time since the last refill.
    c = cases == 1
    created[c] = now[c] - el[rows[c]]
    # 2 over capacity: merged grants past the capacity.
    c = cases == 2
    pn[rows[c], :, 0] = rng.integers(NANO, 2 * NANO, (int(c.sum()), lanes))
    # 3 zero rate: per 0, or a capacity under one token.
    c = cases == 3
    per[c] = np.where(rng.random(int(c.sum())) < 0.5, 0, per[c])
    cap[c] = np.where(per[c] == 0, cap[c], rng.integers(1, NANO, int(c.sum())))
    pn[rows[c], 0, 1] = 5
    # 4 capacity-0 padding (the row's own values are still gathered).
    c = cases == 4
    cap[c] = 0
    pn[rows[c]] = rng.integers(0, 4 * NANO, (int(c.sum()), lanes, 2))
    # 5 now before created + elapsed: no refill at all.
    c = cases == 5
    created[c] = now[c] + rng.integers(1, 10 * NANO, int(c.sum()))
    pn[rows[c], :, 1] = rng.integers(0, NANO // lanes, (int(c.sum()), lanes))
    # 6 int64-wrapping sums.
    c = cases == 6
    pn[rows[c]] = rng.integers(1 << 60, 1 << 62, (int(c.sum()), lanes, 2))
    # 7 fp64 corpus: grant = floor(delta / interval * 1e9) near missing.
    c = np.flatnonzero(cases == 7)
    intervals = rng.choice([1, 3, 7, 999_999_937, 10**12 + 39], c.size)
    cap[c] = NANO  # freq 1, interval = per
    per[c] = intervals
    el[rows[c]] = 0
    created[c] = 0
    mult = rng.choice([1, 3, 10**6 + 1], c.size)
    now[c] = np.clip(intervals * mult + rng.integers(-1, 2, c.size), 0, (1 << 62) - 1)
    grant = np.floor(np.clip(now[c].astype(np.float64) / intervals.astype(np.float64)
                             * float(NANO), 0, 2.0**62)).astype(np.int64)
    missing = grant + rng.integers(-1, 2, c.size)  # taken = missing: verdict on the edge
    pn[rows[c]] = 0
    pn[rows[c], 0, 1] = missing
    # A few rows by index semantics: wrapped negatives and clamped ones.
    rows = rows.copy()
    rows[1:33:8] = rows[1:33:8] - buckets
    rows[2:34:8] = buckets + rng.integers(0, 5, 4)
    return pn, el, np.stack([rows, now, per, cap, created]).astype(np.int64)


def lifecycle_compare(torch, lops, pn_t, el_t, cols_t, slot, tag):
    """Kernel against plain on one probe; → max_abs_err over the four
    outputs, and the kernel's verdicts."""
    state = lops.LimiterState(pn_t, el_t)
    probe = lops.LifecycleProbe(*cols_t.unbind(0))
    kv = lops.lifecycle_probe(state, probe, slot)
    pv = lops.lifecycle_probe_plain(state, probe, slot)
    torch.cuda.synchronize()
    err = 0
    for name, a, b in zip(kv._fields, kv, pv):
        err = max(err, check_equal(torch, f"{tag} {name}", a.to(torch.int64), b.to(torch.int64)))
    return err, kv.full


def lifecycle_checks(torch, lk, lops, dev, rng):
    """The probe at K = 8,192 on the 1M x 64 state against its plain
    version at four ``node_slot`` values, then at K = 0, 1, 8, 512 and
    2^20 (the corpus repeated); timed warm (the same candidates every
    call), cold (a cycle of 16 candidate sets on fresh random rows, 134 MB
    of planes together, past the 50 MB L2), cold on consecutive rows, and
    at K = 512 and K = 8 (the floor: one block)."""
    from patrol_tpu_torch.ops import _build

    pn, el, cols = lifecycle_inputs(rng)
    pn_t, el_t = torch.from_numpy(pn).to(dev), torch.from_numpy(el).to(dev)
    del pn
    cols_t = torch.from_numpy(cols).to(dev)
    err = 0
    for slot in (0, 31, 32, 63):
        e, full = lifecycle_compare(torch, lops, pn_t, el_t, cols_t, slot,
                                    f"lifecycle_probe node_slot={slot}")
        err = max(err, e)
    nfull = int(full.sum())
    check(GC_K // 8 < nfull < GC_K * 7 // 8, f"lifecycle corpus is one-sided: {nfull} full")
    for k in (1, 8, 512):
        e, _ = lifecycle_compare(torch, lops, pn_t, el_t, cols_t[:, :k], 63,
                                 f"lifecycle_probe K={k}")
        err = max(err, e)
    e, _ = lifecycle_compare(torch, lops, pn_t, el_t, cols_t.repeat(1, 128), 31,
                             "lifecycle_probe K=2^20")
    err = max(err, e)
    launches = _build.LAUNCHES["lifecycle_probe"]
    empty = lops.lifecycle_probe(lops.LimiterState(pn_t, el_t),
                                 lops.LifecycleProbe(*cols_t[:, :0].unbind(0)), 0)
    check(all(x.numel() == 0 for x in empty) and _build.LAUNCHES["lifecycle_probe"] == launches,
          "lifecycle_probe at K = 0 launched or returned values")

    k = cols.shape[1]
    out = torch.empty(lk.output_bytes(k), dtype=torch.uint8, device=dev)
    args = (pn_t, el_t, *cols_t.unbind(0))
    state = lops.LimiterState(pn_t, el_t)
    probe = lops.LifecycleProbe(*cols_t.unbind(0))
    fresh = rng.choice(BUCKETS, (16, k), replace=False)
    cold = []
    for rows in (fresh, np.arange(16 * k).reshape(16, k)):
        sets = []
        for r in rows:
            c = cols.copy()
            c[0] = r
            sets.append([x.contiguous() for x in torch.from_numpy(c).to(dev).unbind(0)])
        cold.append(itertools.cycle(sets))

    def call(cs, kk=k):
        lk.probe(pn_t, el_t, *(x[:kk] for x in cs), 0, out=out)

    # Bytes: each distinct gathered row's lane plane and elapsed once, the
    # probe's five columns and the 25-byte verdicts once.
    g = cols[0].astype(np.int32).astype(np.int64)
    g = np.clip(np.where(g < 0, g + BUCKETS, g), 0, BUCKETS - 1)
    nbytes = len(np.unique(g)) * (LANES * 16 + 8) + k * 40 + k * 25
    res = {
        "ms": device_ms(torch, lambda: lk.probe(*args, 0, out=out)),
        "ms_cold": device_ms(torch, lambda: call(next(cold[0]))),
        "ms_cold_contig": device_ms(torch, lambda: call(next(cold[1]))),
        "ms_k512": device_ms(torch, lambda: call(cols_t.unbind(0), 512)),
        "floor_ms": device_ms(torch, lambda: call(cols_t.unbind(0), 8)),
        "plain_ms": device_ms(torch, lambda: lops.lifecycle_probe_plain(state, probe, 0)),
        "library_ms": None,
        "bytes": nbytes,
        "ops": k * (2 * LANES + 40),
        "max_abs_err": err,
        "full": nfull,
        "k": k,
    }
    del pn_t, el_t, cols_t, out, cold
    return res


def lifecycle_edge_checks(torch, lk, lops, dev, rng):
    """The probe at N = 1, 31, 33, 256 and 512 lanes (a lane group's
    ragged edge, and planes of several passes) with the own lane first and
    last, on a small state (4096 buckets, K = 512), bit for bit against
    its plain version."""
    err = 0
    cases = [(n, slot) for n in (1, 31, 33, 256, 512) for slot in sorted({0, n - 1})]
    for n, slot in cases:
        pn, el, cols = lifecycle_inputs(rng, EDGE_BUCKETS, n, 512)
        e, _ = lifecycle_compare(
            torch, lops, torch.from_numpy(pn).to(dev), torch.from_numpy(el).to(dev),
            torch.from_numpy(cols).to(dev), slot, f"lifecycle_probe N={n} node_slot={slot}",
        )
        err = max(err, e)
    return {"cases": len(cases), "max_abs_err": err}


# -- phase 2: the certified families' kernels against their plain versions ----

CERT_K = 8192  # columns a family call takes in phase 2 (quota: 3 x 8,192 row gathers)
CERT_NOW = 1_700_000_000 * NANO
CERT_FAMILIES = ("gcra", "conc", "quota")
_I64_MAX = (1 << 63) - 1


def cert_rows(rng, k, buckets, pool):
    """K raw rows over ``pool`` distinct rows (so rows repeat): 1/64 each in
    ``[-B, 0)`` (wrapped), past ``B`` (clamped to B - 1, commit dropped) and
    below ``-B`` (clamped to 0, commit dropped)."""
    rows = rng.choice(rng.choice(buckets, min(pool, buckets), replace=False), k)
    n = max(k // 64, 1)
    if k >= 3 * n:
        at = rng.choice(k, 3 * n, replace=False)
        rows[at[:n]] -= buckets
        rows[at[n:2 * n]] = buckets + rng.integers(0, 1000, n)
        rows[at[2 * n:]] = -buckets - 1 - rng.integers(0, 1000, n)
    return rows.astype(np.int64)


def cert_fill(rng, pn_t, rows, torch):
    """Preset the lanes of every row the columns gather (remote lanes
    included), a fifth each: zeros, small holds and spends (sparse), TAT
    watermarks around ``CERT_NOW``, raw int64 (values near 2^63, negative
    ones, wrapping sums), and every TAKEN lane near -2^63 (GCRA's max over
    lanes, whose identity must be -2^63, not 0)."""
    b, n, _ = pn_t.shape
    r = rows.astype(np.int32).astype(np.int64)
    r = np.unique(np.clip(np.where(r < 0, r + b, r), 0, b - 1))
    case = rng.integers(0, 5, len(r))
    vals = np.zeros((len(r), n, 2), np.int64)
    small = case == 1
    mask = rng.random((int(small.sum()), n, 1)) < 0.3
    vals[small] = rng.integers(0, 200, (int(small.sum()), n, 2)) * mask
    vals[small, :, 1] += rng.integers(0, 50, (int(small.sum()), n))  # TAKEN >= ADDED mostly
    tat = case == 2
    vals[tat, :, 1] = CERT_NOW + rng.integers(-10**6, 10**6, (int(tat.sum()), n))
    raw = case == 3
    vals[raw] = rng.integers(-(1 << 63), _I64_MAX, (int(raw.sum()), n, 2), dtype=np.int64)
    vals[raw, 0, 1] = _I64_MAX - rng.integers(0, 1000, int(raw.sum()))
    neg = case == 4
    vals[neg, :, 1] = -_I64_MAX - 1 + rng.integers(0, 1000, (int(neg.sum()), n))
    pn_t[torch.from_numpy(r).to(pn_t.device)] = torch.from_numpy(vals).to(pn_t.device)


def cert_request(rng, family, k, buckets):
    """One family's packed request (rows raw, as a caller passes them)
    over its hazards: repeated rows with padding columns (``nreq`` 0)
    aliasing live ones, out-of-range rows, ``nreq``, ``count`` and ``T``
    <= 0 and negative ``nreq``, releases above the held amount, operands
    near 2^62 whose products and sums wrap; quota paths under 16 global and
    512 tenant rows, a tenth of the tenant rows a user row of another path."""
    big = 1 << 62
    nreq = rng.choice([-3, 0, 0, 1, 5, 1000, big], k)
    if family == "gcra":
        return np.stack([
            cert_rows(rng, k, buckets, max(k // 2, 1)),
            CERT_NOW + rng.integers(-10**6, 10**6, k),
            rng.choice([-5, 0, 1, 100, 10**5, big], k),
            rng.choice([-50, 0, 300, 10**6, big], k),
            nreq,
        ])
    if family == "conc":
        return np.stack([
            cert_rows(rng, k, buckets, max(k // 2, 1)),
            rng.choice([-5, 0, 10, 1000, 10**6, big], k),
            rng.choice([-2, 0, 1, 7, 1 << 40], k),
            nreq,
            rng.choice([-1, 0, 1, 3, 100, 1 << 40], k),
        ])
    users = cert_rows(rng, k, buckets, max(k // 2, 1))
    tenants = cert_rows(rng, k, buckets, min(512, k))
    swap = rng.random(k) < 0.1
    tenants[swap] = rng.choice(users, int(swap.sum()))  # a row at two levels
    limits = [rng.choice([-5, 0, 10, 1000, 10**6, big, big], k) for _ in range(3)]
    return np.stack([
        cert_rows(rng, k, buckets, min(16, k)), tenants, users, *limits,
        rng.choice([-2, 0, 1, 1, 7, 1 << 40], k), nreq,
    ])


def cert_modules():
    from patrol_tpu_torch.ops import cert_kernel, concurrency, gcra, hierquota

    return cert_kernel, {"gcra": gcra, "conc": concurrency, "quota": hierquota}


def cert_pack(torch, family, p, b, dev):
    """A raw request → the packed device matrix (rows cast and wrapped,
    as the engine packs)."""
    from patrol_tpu_torch.ops import cert_kernel

    p = p.copy()
    levels = 3 if family == "quota" else 1
    p[:levels] = cert_kernel.wrap_rows_np(p[:levels], b)
    return torch.from_numpy(p).to(dev)


def cert_compare(torch, family, base, packed, slot, tag):
    """Kernel (one launch) against the plain version from the same
    base planes: results and final planes bit for bit. → (max_abs_err,
    kernel result, kernel planes)."""
    ck, mods = cert_modules()
    pk, pp = base.clone(), base.clone()
    out_k = ck.run(family, pk, packed, slot)
    out_p = mods[family].packed_plain(pp, *packed, slot)
    torch.cuda.synchronize()
    err = max(check_equal(torch, f"{tag} results", out_k, out_p),
              check_equal(torch, f"{tag} pn", pk, pp))
    del pp
    return err, out_k, pk


def cert_library(torch, family, pn, g):
    """The function's data movement as PyTorch library calls (timed only):
    ``index_select`` of the rows, ``amax`` or ``sum`` over lanes, and one
    ``scatter_reduce_`` into the own lane (slot 0)."""
    rows = pn.index_select(0, g)
    if family == "gcra":
        pn[:, 0, 1].scatter_reduce_(0, g, rows[:, :, 1].amax(-1), reduce="amax")
    elif family == "conc":
        pn[:, 0].scatter_reduce_(0, g[:, None].expand(-1, 2), rows.sum(1), reduce="sum")
    else:
        pn[:, 0, 1].scatter_reduce_(0, g, rows[:, :, 1].sum(-1), reduce="sum")


def cert_saturating(rng, family, k, buckets):
    """A request in which every column admits (and, for concurrency,
    releases nothing): the most commit entries a call can make, so a
    block's entries overflow its shared memory into the spill buffer."""
    p = cert_request(rng, family, k, buckets)
    if family == "gcra":
        p[2:5] = np.array([1 << 40, 0, 1])[:, None]  # one emission a column, no burst
    elif family == "conc":
        p[1:5] = np.array([1 << 40, 1, 1, 0])[:, None]
    elif family == "quota":
        p[3:8] = np.array([1 << 40, 1 << 40, 1 << 40, 1, 1])[:, None]
    return p


def cert_checks(torch, dev, rng):
    """Each family at K = 8,192 on the 1M x 64 state against its plain
    version at ``node_slot`` 0 and 63, then at K = 0 (no launch), 1, 8
    and 2^16, at the resident grid's columns and one either side (a
    block's second tile), and at 2^16 with every column committing (the
    spill buffer), each call one launch. Timed warm (the same request
    each call), cold (a cycle of 16 requests on fresh random rows, 134 MB
    of planes for GCRA, past the 50 MB L2), at K = 512 and at its floor
    (K = 8), beside its plain version, the library calls and its bound.
    → {family: numbers, "grid": each kernel's residency}."""
    from patrol_tpu_torch.ops import _build

    ck, mods = cert_modules()
    base = torch.zeros((BUCKETS, LANES, 2), dtype=torch.int64, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {"grid": {}}
    for family in CERT_FAMILIES:
        mod = mods[family]
        p = cert_request(rng, family, CERT_K, BUCKETS)
        levels = 3 if family == "quota" else 1
        base.zero_()
        cert_fill(rng, base, p[:levels].reshape(-1), torch)
        packed = cert_pack(torch, family, p, BUCKETS, dev)
        err = 0
        for slot in (0, LANES - 1):
            e, out_k, pk = cert_compare(torch, family, base, packed, slot,
                                        f"{family} node_slot={slot}")
            err = max(err, e)
            if slot == 0:
                adm = out_k[0].cpu().numpy()
                check((adm >= 1).sum() > CERT_K // 32 and (adm == 0).sum() > CERT_K // 32,
                      f"{family}: the corpus admits {int((adm >= 1).sum())} of {CERT_K}")
                changed = int((pk != base).any(-1).any(-1).sum())
                check(changed > CERT_K // 32, f"{family}: {changed} rows committed")
            del pk
        for kk in (1, 8):
            e, _, pk = cert_compare(torch, family, base, packed[:, :kk].contiguous(), LANES // 2,
                                    f"{family} K={kk}")
            err = max(err, e)
            del pk
        resident = ck.resident_blocks(family, dev)
        cols = resident * ck.TILE
        res["grid"][family] = {"blocks_per_sm": resident // sms, "sms": sms,
                               "resident_blocks": resident, "resident_columns": cols,
                               "blocks_at_k": ck.grid(CERT_K, resident)[0]}
        sizes = [(1 << 16, cert_request), (cols - 1, cert_request), (cols, cert_request),
                 (cols + 1, cert_request), (1 << 16, cert_saturating)]
        for kk, make in sizes:
            q = make(rng, family, kk, BUCKETS)
            base.zero_()
            if make is cert_request:  # a saturating request admits on empty rows
                cert_fill(rng, base, q[:levels].reshape(-1), torch)
            launches = dict(_build.LAUNCHES)
            packed_q = cert_pack(torch, family, q, BUCKETS, dev)
            e, out_k, pk = cert_compare(torch, family, base, packed_q, 7,
                                        f"{family} K={kk} ({make.__name__})")
            err = max(err, e)
            made = {name: _build.LAUNCHES[name] - launches[name] for name in launches}
            check(made == {name: int(name == f"{family}_admit") for name in launches},
                  f"{family} K={kk}: not one launch: {made}")
            if make is cert_saturating:
                check(bool((out_k[0] == 1).all()), f"{family}: a saturating column did not admit")
            del pk
        base.zero_()
        cert_fill(rng, base, p[:levels].reshape(-1), torch)
        launches = dict(_build.LAUNCHES)
        empty = ck.run(family, base, packed[:, :0].contiguous(), 0)
        check(empty.numel() == 0 and _build.LAUNCHES == launches,
              f"{family} at K = 0 launched or returned values")

        # Bytes: the request and result matrices once, each distinct
        # gathered row's lane plane once, 8 B written per updated lane.
        g = p[:levels].astype(np.int32).astype(np.int64)
        g = np.clip(np.where(g < 0, g + BUCKETS, g), 0, BUCKETS - 1).reshape(-1)
        rows_in, rows_out, _ = ck.FAMILIES[family]
        ca, cb = base.clone(), base.clone()
        ck.run(family, cb, packed, 0)
        torch.cuda.synchronize()
        n_updated = int((ca != cb).sum())
        del cb
        nbytes = (len(np.unique(g)) * LANES * 16 + 8 * rows_in * CERT_K
                  + 8 * rows_out * CERT_K + 8 * n_updated)
        cold = []
        for _ in range(16):
            q = p.copy()
            q[:levels] = rng.choice(BUCKETS, levels * CERT_K, replace=False).reshape(levels, -1)
            cold.append(cert_pack(torch, family, q, BUCKETS, dev))
        cold = itertools.cycle(cold)
        g_t = torch.from_numpy(g).to(dev)
        pp = ca.clone()
        packed8 = packed[:, :8].contiguous()
        packed512 = packed[:, :512].contiguous()
        res[family] = {
            "ms": device_ms(torch, lambda: ck.run(family, ca, packed, 0)),
            "ms_cold": device_ms(torch, lambda: ck.run(family, ca, next(cold), 0)),
            "ms_k512": device_ms(torch, lambda: ck.run(family, ca, packed512, 0)),
            "floor_ms": device_ms(torch, lambda: ck.run(family, ca, packed8, 0)),
            "plain_ms": device_ms(torch, lambda: mod.packed_plain(pp, *packed, 0)),
            "library_ms": device_ms(torch, lambda: cert_library(torch, family, ca, g_t)),
            "bytes": nbytes,
            "ops": len(g) * 2 * LANES + 40 * CERT_K,
            "max_abs_err": err,
            "admitted_columns": int((adm >= 1).sum()),
            "updated_lanes": n_updated,
            "k": CERT_K,
        }
        del ca, pp, cold
        torch.cuda.empty_cache()
    del base
    return res


def cert_edge_checks(torch, dev, rng):
    """Each family at N = 1, 31, 33 and 256 lanes with the own lane first
    and last, on a small state (4096 buckets, K = 512), bit for bit."""
    err, cases = 0, 0
    _, mods = cert_modules()
    for family in CERT_FAMILIES:
        levels = 3 if family == "quota" else 1
        for n in (1, 31, 33, 256):
            for slot in sorted({0, n - 1}):
                base = torch.zeros((EDGE_BUCKETS, n, 2), dtype=torch.int64, device=dev)
                p = cert_request(rng, family, 512, EDGE_BUCKETS)
                cert_fill(rng, base, p[:levels].reshape(-1), torch)
                packed = cert_pack(torch, family, p, EDGE_BUCKETS, dev)
                e, _, _ = cert_compare(torch, family, base, packed, slot,
                                       f"{family} N={n} node_slot={slot}")
                err, cases = max(err, e), cases + 1
    return {"cases": cases, "max_abs_err": err}


# -- phase 2: the mesh converge against its plain versions --------------------

CONVERGE_R = (2, 3, 4, 8)
CONVERGE_T = (1, 512, 4096, 32768)
CONVERGE_N = (1, 33, 64)
CONVERGE_MAIN = (2, 4096, LANES)  # (R, T, N) timed: a 3j take tick's rows at R = 2


def full_range_t(torch, shape, dev, gen):
    """int64 words over the whole range, made on the device from two
    32-bit halves: a tenth near +2^63, a tenth near -2^63, a twentieth 0."""
    hi = torch.randint(-(2**31), 2**31, shape, dtype=torch.int64, device=dev, generator=gen)
    lo = torch.randint(0, 2**32, shape, dtype=torch.int64, device=dev, generator=gen)
    x = (hi << 32) | lo
    u = torch.rand(shape, device=dev, generator=gen)
    off = torch.randint(0, 4, shape, dtype=torch.int64, device=dev, generator=gen)
    x = torch.where(u < 0.1, (2**63 - 1) - off, x)
    x = torch.where((u >= 0.1) & (u < 0.2), -(2**63) + off, x)
    return torch.where((u >= 0.2) & (u < 0.25), torch.zeros_like(x), x)


def exact_err(torch, name: str, a, b) -> float:
    """Hold a kernel's output to its plain version's over the whole int64
    range: → max |a - b| (in float64, so nothing wraps); raises unless 0."""
    if not torch.equal(a, b):
        diff = int((a != b).sum())
        raise AssertionError(f"{name}: kernel and plain version differ in {diff} elements")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def converge_checks(torch, ck, _build, dev):
    """The gather and the converge (``csrc/converge.cu``) against their
    plain versions at every (R, T, N) of CONVERGE_R x CONVERGE_T x
    CONVERGE_N on a 1,000,000-row state, over the whole int64 range; each
    call must be one launch. Then both are timed at CONVERGE_MAIN, warm (the
    same rows and scratch), cold (a cycle of 8 row sets and scratches, 100
    MB, past the 50 MB L2) and at T = 1 (the floor), beside the plain
    versions and the library calls."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261019)
    err = 0.0
    shapes = 0
    for n in CONVERGE_N:
        kp = full_range_t(torch, (BUCKETS, n, 2), dev, gen)
        ke = full_range_t(torch, (BUCKETS,), dev, gen)
        pp, pe = kp.clone(), ke.clone()
        for r in CONVERGE_R:
            for t in CONVERGE_T:
                rows = torch.randperm(BUCKETS, device=dev, generator=gen)[:t].contiguous()
                spn = full_range_t(torch, (r, t, n, 2), dev, gen)
                sel = full_range_t(torch, (r, t), dev, gen)
                before = dict(_build.LAUNCHES)
                ck.converge(kp, ke, rows, spn, sel)
                ck.converge_plain(pp, pe, rows, spn, sel)
                gs, gl = torch.empty_like(spn), torch.empty_like(sel)
                ck.gather(kp, ke, rows, gs, gl)
                ps, pl = torch.empty_like(spn), torch.empty_like(sel)
                ck.gather_plain(pp, pe, rows, ps, pl)
                torch.cuda.synchronize()
                made = {k: _build.LAUNCHES[k] - before[k] for k in before}
                check(made == {**{k: 0 for k in before}, "converge": 1, "mesh_gather": 1},
                      f"converge R={r} T={t} N={n}: launches {made}")
                tag = f"R={r} T={t} N={n}"
                err = max(err, exact_err(torch, f"converge pn {tag}", kp, pp),
                          exact_err(torch, f"converge elapsed {tag}", ke, pe),
                          exact_err(torch, f"gather spn {tag}", gs, ps),
                          exact_err(torch, f"gather sel {tag}", gl, pl))
                shapes += 1
        del kp, ke, pp, pe, spn, sel, gs, gl, ps, pl
        torch.cuda.empty_cache()

    r, t, n = CONVERGE_MAIN
    pn = full_range_t(torch, (BUCKETS, n, 2), dev, gen)
    el = full_range_t(torch, (BUCKETS,), dev, gen)

    def operands(tt):
        rows = torch.randperm(BUCKETS, device=dev, generator=gen)[:tt].contiguous()
        return (rows, full_range_t(torch, (r, tt, n, 2), dev, gen),
                full_range_t(torch, (r, tt), dev, gen))

    warm = operands(t)
    cold = itertools.cycle([operands(t) for _ in range(8)])
    floor = operands(1)

    def library_converge(rows, spn, sel):
        pn.index_copy_(0, rows, spn.amax(dim=0))
        el.index_copy_(0, rows, sel.amax(dim=0))

    def library_gather(rows, spn, sel):
        spn.copy_(pn.index_select(0, rows).unsqueeze(0).expand_as(spn))
        sel.copy_(el.index_select(0, rows).unsqueeze(0).expand_as(sel))

    nbytes = (r + 1) * t * (16 * n + 8) + 8 * t
    res = {}
    for name, kern, plain, lib in (("converge", ck.converge, ck.converge_plain, library_converge),
                                   ("mesh_gather", ck.gather, ck.gather_plain, library_gather)):
        res[name] = {
            "ms": device_ms(torch, lambda: kern(pn, el, *warm)),
            "ms_cold": device_ms(torch, lambda: kern(pn, el, *next(cold))),
            "floor_ms": device_ms(torch, lambda: kern(pn, el, *floor)),
            "plain_ms": device_ms(torch, lambda: plain(pn, el, *warm)),
            "library_ms": device_ms(torch, lambda: lib(*warm)),
            "bytes": nbytes,
            # One signed max per word and copy for the converge; the gather
            # only moves words.
            "ops": (r - 1) * t * (2 * n + 1) if name == "converge" else 0,
            "max_abs_err": err,
            "shape": {"R": r, "T": t, "N": n},
            "shapes_checked": shapes,
        }
    del pn, el, warm, cold, floor
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


def residue_datagrams(rng, row=DV2_ROW):
    """Valid datagrams at the kernel's alignment edges (it stages a plane
    in 16-byte vectors and decodes entry tails from 4-byte words): one
    entry with a name of every length 0..17 under 0..3 acks (lengths end
    at every residue mod 16); 24 packets of 2..6 entries with names of
    mixed lengths 0..17 (tails start at every residue mod 4); count = 0
    under 0..3 acks; the row's maximum entry count (empty names) under
    0..2 acks. Every third packet is followed by a copy with one payload
    byte flipped. → datagrams."""
    from patrol_tpu_torch.ops import ingest as ingest_ops
    from patrol_tpu_torch.ops import wire

    E = ingest_ops.max_entries(row)
    specs = [([L], a) for L in range(18) for a in range(4)]
    specs += [(list(rng.integers(0, 18, int(rng.integers(2, 7)))), int(rng.integers(0, 4)))
              for _ in range(24)]
    specs += [([], a) for a in range(4)] + [([0] * E, a) for a in range(3)]
    out = []
    for i, (name_lens, n_acks) in enumerate(specs):
        ents = [
            wire.DeltaEntry(
                "".join(chr(97 + int(c)) for c in rng.integers(0, 26, int(L))),
                int(rng.integers(0, LANES)), *(int(x) for x in rng.integers(0, 1 << 50, 4)),
            )
            for L in name_lens
        ]
        acks = [int(x) for x in rng.integers(0, 1 << 32, n_acks)]
        data, n = wire.encode_delta_packet(2, i + 1, acks, ents, max_size=row)
        check(n == len(ents), f"residue packet {i} packed {n} of {len(ents)} entries")
        out.append(data)
        if i % 3 == 0:
            b = bytearray(data)
            b[int(rng.integers(32, len(b) - 1))] ^= 0x10
            out.append(bytes(b))
    return out


def decode_fold_edge_checks(torch, ik, dev, rng):
    """decode_fold over :func:`residue_datagrams` (random stale bytes past
    every datagram) on a small state, in batches of P = 16 and one plane
    at a time (P = 1), bit for bit against its plain version, verdicts
    equal to ``wire.decode_delta_packet``'s. Then a CUDA call on planes
    that start one byte past a 16-byte boundary must raise in the wrapper
    and launch nothing. → a dict of what was checked."""
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.ops import ingest as ingest_ops
    from patrol_tpu_torch.ops import wire
    from patrol_tpu_torch.ops.merge import FOLD_PAD_ROW

    raw = residue_datagrams(rng)
    planes = rng.integers(0, 256, (len(raw), DV2_ROW)).astype(np.uint8)
    lengths = np.array([len(b) for b in raw], np.int32)
    for i, b in enumerate(raw):
        planes[i, : len(b)] = np.frombuffer(b, np.uint8)
    walk = ingest_ops.host_walk(planes, lengths)
    eoff = np.maximum(walk.name_off - 1, 0).astype(np.int32)
    rows = rng.integers(0, EDGE_BUCKETS, eoff.shape).astype(np.int32)
    rows[rng.random(rows.shape) < 0.05] = FOLD_PAD_ROW
    hosted = rng.random(rows.shape) < 0.1
    want = np.array([wire.decode_delta_packet(b) is not None for b in raw])
    check(set((lengths[want] % 16).tolist()) == set(range(16)), "residue corpus misses a residue")
    base_pn = torch.from_numpy(
        rng.integers(0, 1 << 40, size=(EDGE_BUCKETS, LANES, 2), dtype=np.int64)
    ).to(dev)
    base_el = torch.from_numpy(rng.integers(0, 1 << 40, EDGE_BUCKETS, dtype=np.int64)).to(dev)
    err = 0
    for P in (16, 1):
        for lo in range(0, len(raw), P):
            sel = slice(lo, lo + P)
            out_k, _, e, *_ = decode_fold_run(
                torch, ik, dev, base_pn, base_el,
                (planes[sel], lengths[sel], eoff[sel], rows[sel], hosted[sel]),
            )
            err = max(err, e)
            check(np.array_equal(out_k[0].cpu().numpy(), want[sel]),
                  f"decode_fold P={P} at {lo}: verdicts differ from the decoder's")
    # A plane view one byte past an aligned base: the bulk copy cannot take
    # it, so the wrapper raises before any launch.
    P = 2
    buf = torch.zeros(P * DV2_ROW + 16, dtype=torch.uint8, device=dev)
    mis = buf[1 : 1 + P * DV2_ROW].view(P, DV2_ROW)
    args = [torch.from_numpy(np.ascontiguousarray(x[:P])).to(dev)
            for x in (lengths, eoff, rows, hosted)]
    before = _build.LAUNCHES["decode_fold"]
    try:
        ik.decode_fold(base_pn, base_el, mis, *args)
    except ValueError:
        raised = True
    else:
        raised = False
    check(raised, "decode_fold took a plane at byte offset 1")
    check(_build.LAUNCHES["decode_fold"] == before, "decode_fold launched on a misaligned plane")
    return {
        "datagrams": len(raw), "accepted": int(want.sum()),
        "max_abs_err": err, "misaligned_plane_raises": raised,
    }


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
        if P == 1:
            # The kernel's own floor: one plane rejected at its length,
            # before any byte is copied.
            rej = [args[0], torch.zeros_like(args[1]), *args[2:]]
            res[P]["rejected_only_ms"] = device_ms(torch, lambda: ik.decode_fold(pk, ek, *rej))
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


def join_sass(so) -> dict:
    """The 64-bit max updates in the join kernel's machine code: →
    {"red_max_s64": n, "atom": n} from ``cuobjdump -sass`` of the built
    library (None where the toolkit has no cuobjdump). They must compile
    to ``RED.E.MAX.S64`` (no return trip), never to a returning ``ATOM``."""
    from patrol_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out, inside = {"red_max_s64": 0, "atom": 0}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "join_kernel" in line
        elif inside and "*/" in line:
            words = [w for w in line.split("*/")[1].split() if not w.startswith("@")]
            op = words[0] if words else ""
            out["red_max_s64"] += op.startswith("RED") and "MAX.S64" in op
            out["atom"] += op.startswith("ATOM")
    return out


def commit_split(hist_mod, profiling, before=None) -> dict:
    """How the engine's merge ticks committed: the count of each
    device-commit label (``device_kernel_<label>_ns``: ``merge_folded``
    single-block ticks, ``merge_hybrid`` ticks with a dense half,
    ``commit_blocks`` rings) and the ``commit_*`` counters (rings by J,
    blocks coalesced), less ``before``."""
    out = {
        name[len("device_kernel_"):-len("_ns")]: h["count"]
        for name, h in hist_mod.HISTOGRAMS.snapshot().items()
        if name.startswith("device_kernel_") and isinstance(h, dict)
    }
    out.update({k: v for k, v in profiling.COUNTERS.snapshot().items() if k.startswith("commit_")})
    before = before or {}
    return {k: v - before.get(k, 0) for k, v in out.items() if v - before.get(k, 0)}


def ptxas_lines(build_log: str, names) -> dict:
    """``-Xptxas -v`` lines (registers, shared memory, spills) of each
    source in ``names`` from the build log: → {name: [lines]}."""
    out, cur = {}, None
    for line in build_log.splitlines():
        if line.startswith("== "):
            cur = line.split()[1] if line.split()[1] in names else None
            if cur:
                out[cur] = []
        elif cur and ("ptxas" in line or "bytes stack frame" in line):
            out[cur].append(line.strip())
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


def run_trace(engine, repo, trace, hold=False, profile=False):
    """Drive deltas then takes through the repo facade; → (outcomes,
    seconds for deltas, seconds for takes, profile). With ``hold`` the
    engine's state lock is held while a burst queues (the feeder parks at
    its next dispatch), so the first uniform burst drains as one
    multi-block commit ring and the hot-row burst as one fold with dense
    rows — what a flood does to a busy node. With ``profile`` the deltas
    (every burst, until flushed) run under a :class:`ProfileWindow` of
    the join kernel; else the profile is None."""
    deltas, hot_burst, vals, caps, takes = trace
    cut = 30_000
    phases = (
        (deltas[:cut], 0, hold),
        (deltas[cut:], cut, False),
        (hot_burst, len(deltas), hold),
    )
    window = ProfileWindow(JOIN_PROFILE_KERNELS) if profile else None
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
    prof = window.close(deltas=len(deltas) + len(hot_burst)) if window else None
    t0 = time.perf_counter()
    tickets = []
    for name in takes:
        rate, count = rate_of(name)
        tickets.append(repo.submit_take(name, rate, count))
    check(engine.flush(600), "take flush timed out")
    t_takes = time.perf_counter() - t0
    for t in tickets:
        check(t.wait(60), "a take ticket never completed")
    return [(t.ok, t.remaining) for t in tickets], t_deltas, t_takes, prof


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
DEFAULTS_TAKES = 6_000  # phase 3g's paced takes (after 2 x 2,000 priming takes)
PROFILE_CHUNKS = range(4, 10)  # the paced takes' chunks traced by the profiler
PROFILE_KERNELS = ("take_n_kernel", "decode_fold_kernel")
JOIN_PROFILE_KERNELS = ("join_kernel",)  # phase 3's deltas
PROFILE_LEAD_IN_S = 0.25  # a profiler window's lead-in before its baseline


class ProfileWindow:
    """``torch.profiler`` (CPU and CUDA activities) over a window of a
    phase. :meth:`close` ends it and reads, from ``key_averages()``, the
    count and summed device time of each kernel whose name holds one of
    ``kernels``, and from the trace's device events the device busy share
    of the window (the union of their intervals over the window's wall
    time), beside the launch counters' view of the same window."""

    def __init__(self, kernels=PROFILE_KERNELS, lead_in_s: float = 0.0):
        import torch
        from patrol_tpu_torch.ops import _build

        self.torch = torch
        self.kernels = kernels
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        # The tracer now and then drops every device record of a window's
        # first milliseconds: 3h's window lost its first sweep's (the probe
        # and its copies, 6 ms in) while the launch counter counted the
        # launch, and a warm-up launch did not prevent it. A window whose
        # profiled count is read against its launches (3h) waits out a
        # lead-in before its baseline, so that its first launch is well
        # past the trace's start.
        torch.cuda.synchronize()
        time.sleep(lead_in_s)
        self.launches0 = dict(_build.LAUNCHES)
        self.t0 = time.perf_counter()

    def close(self, **meta) -> dict:
        from patrol_tpu_torch.ops import _build

        self.torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        launches = {k: v - self.launches0[k] for k, v in _build.LAUNCHES.items()}
        self.prof.__exit__(None, None, None)
        kernels = {}
        for name in self.kernels:
            rows = [e for e in self.prof.key_averages() if name in e.key]
            kernels[name] = {
                "count": sum(e.count for e in rows),
                "device_us": sum(e.device_time_total for e in rows),
            }
            starts = sorted(e.time_range.start for e in self.prof.events()
                            if name in e.name and str(e.device_type).endswith("CUDA"))
            if len(starts) <= 64:  # each launch's start, in us from the trace's
                kernels[name]["starts_us"] = starts
        spans = [
            (e.time_range.start, e.time_range.end) for e in self.prof.events()
            if str(e.device_type).endswith("CUDA") and e.time_range.end > e.time_range.start
        ]
        busy = union_length(spans)
        measured = bool(spans)
        return {
            **meta, "wall_s": wall, "kernels": kernels, "device_events": len(spans),
            "device_busy_us": busy if measured else None,
            "device_busy_share": busy / (wall * 1e6) if measured else None,
            "launches": launches,
        }


def union_length(spans) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def plane_counts(hist_mod) -> tuple:
    """(count per log2 bucket, sum) of the ``ingest_raw_planes`` histogram:
    the planes P of every raw ``decode_fold`` launch in this process."""
    lat = hist_mod.RAW_PLANES.to_lattice()
    counts = [sum(lane[b] for lane in lat["counts"]) for b in range(len(lat["counts"][0]))]
    return counts, sum(lat["sums"])


def plane_histogram(before, after) -> dict:
    """The P histogram of the launches between two :func:`plane_counts`:
    launches per range of P, their count and mean P."""
    counts = [b - a for a, b in zip(before[0], after[0])]
    launches = sum(counts)
    hist = {}
    for b, c in enumerate(counts):
        if c:
            lo, hi = (0, 0) if b == 0 else (1 << (b - 1), (1 << b) - 1)
            hist[str(lo) if lo == hi else f"{lo}-{hi}"] = c
    planes = after[1] - before[1]
    return {"launches": launches, "planes": planes,
            "mean_p": planes / launches if launches else None, "by_p": hist}


def run_two_nodes(Command, LimiterConfig, rng, udp_backend, defaults=False):
    """Two port nodes on the card, each 1M x 64, on the UDP backend named,
    peered over loopback in wire mode ``delta`` with frozen clocks: 20,000
    takes over 2,000 names split across them, in chunks of 500 (the first
    take of each chunk over HTTP, the rest through ``submit_take``). Then
    poll (at most 60 s) until both nodes hold the same state for every
    name: ``snapshot_many`` (one gather a node) while they differ, and
    ``repo.snapshot(name)`` for every name to confirm. → a dict of what
    was measured, with the replication counters at each poll.

    Both nodes share one Python interpreter here. On the asyncio backend a
    receiver's acks come back in hundreds of milliseconds to seconds (each
    P = 1 datagram costs milliseconds of host time on its loop); the
    native backend receives up to 512 datagrams a syscall into its rx
    ring and ships each batch to one ``decode_fold`` launch. The delta
    planes run their default timer, which adapts to the ack round trip
    (``net/delta.py``); a fixed timeout under it resends every interval
    before its ack lands and never drains (``scripts/delta_timer.py``
    shows both). The next chunk goes in once the last one's tickets have
    completed and neither node holds an unacked interval; a chunk's drain
    is held to 30 s.

    Without ``defaults`` the nodes run the asyncio front with the host
    fast path off (phases 3c, 3e). With it (phase 3g) they run at the
    defaults — native front, native host store, fast path on — every
    name is first taken on both nodes, so each node hosts it and its
    peer's dv2 entries for it reach ``decode_fold`` marked hosted, and
    the paced takes are 6,000 instead of 20,000."""
    import torch
    from patrol_tpu_torch.net.native_replication import NativeReplicator
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.ops.rate import Rate
    from patrol_tpu_torch.utils import histogram as hist_mod
    from patrol_tpu_torch.utils import profiling

    addrs = [f"127.0.0.1:{free_udp_port()}" for _ in range(2)]
    cfg = LimiterConfig(buckets=BUCKETS, nodes=LANES)
    nodes = []
    for a in addrs:
        nodes.append(Node(Command(
            api_addr="127.0.0.1:0", node_addr=a, peer_addrs=addrs,
            clock=Clock(1_700_000_000 * NANO), config=cfg, handle_signals=False,
            warmup=True, device="cuda", wire_mode="delta", shutdown_timeout_s=30,
            udp_backend=udp_backend, http_front="native" if defaults else "python",
        )))
    polls = []
    native = udp_backend == "native"
    try:
        cmds = [n.cmd for n in nodes]
        reps = [c.replicator for c in cmds]
        pinned = None
        if native:
            check(all(isinstance(r, NativeReplicator) for r in reps),
                  f"the native backend was not taken: {[type(r).__name__ for r in reps]}")
            pinned = [[torch.from_numpy(r._rx_ring.plane(i)).is_pinned()
                       for i in range(r._rx_ring.n_planes)] for r in reps]
            log(f"rx ring planes pinned: {pinned}")
            check(all(all(p) for p in pinned), f"rx ring planes are not all pinned: {pinned}")
        # The wire-v2 capability handshake first: until a peer has
        # answered it, broadcasts to it go out in the classic form.
        deadline = time.perf_counter() + 30
        while not all(len(c.replicator.delta.capable_peers()) == 1 for c in cmds):
            check(time.perf_counter() < deadline, "the dv2 capability handshake did not complete")
            time.sleep(0.05)
        names = [f"c{i}" for i in range(TWO_NODE_NAMES)]
        # At the defaults a take is served in Python on the calling thread,
        # and every state it emits rides the delta plane: the phase is
        # host-bound, so it runs fewer paced takes over the same names.
        pick = rng.integers(0, len(names), DEFAULTS_TAKES if defaults else TWO_NODE_TAKES).tolist()
        rate = Rate(freq=50, per_ns=3600 * NANO)
        counters0 = profiling.COUNTERS.snapshot()
        planes0 = plane_counts(hist_mod)
        _build.reset_launches()
        t0 = time.perf_counter()
        admitted = http_takes = 0
        if defaults:
            check(all(c.native_front is not None and c.engine._native_store is not None
                      for c in cmds), "the native front and host store were not taken")
            # Every name taken on both nodes, a few names at a time, one
            # node right after the other: each binds them fresh, so hosts
            # them, unless its peer's delta for one lands in between (the
            # delta plane ships every 20 ms).
            for lo in range(0, len(names), 8):
                chunk = names[lo:lo + 8]
                for c in cmds:
                    for t, _ in c.repo.submit_takes_batch(chunk, [rate] * len(chunk),
                                                          [1] * len(chunk)):
                        check(t.wait(60), "a take ticket never completed")
                        admitted += t.ok
            hosted0 = [c.engine.hosted_buckets for c in cmds]
            prime_s = time.perf_counter() - t0
        drains = []
        window = None
        for ci, lo in enumerate(range(0, len(pick), TWO_NODE_CHUNK)):
            if ci == PROFILE_CHUNKS.start:
                window = ProfileWindow()
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
            t_drain = time.perf_counter()
            while any(c.replicator.delta.stats()["wire_intervals_unacked"] for c in cmds):
                check(time.perf_counter() < t_drain + 30, f"the delta plane did not drain chunk {ci}")
                time.sleep(0.005)
            drains.append(time.perf_counter() - t_drain)
            if ci == PROFILE_CHUNKS.stop - 1:
                profile = window.close(
                    chunks=[PROFILE_CHUNKS.start, PROFILE_CHUNKS.stop],
                    takes=len(PROFILE_CHUNKS) * TWO_NODE_CHUNK,
                )
        t_takes = time.perf_counter() - t0
        timers = [next(iter(c.replicator.delta.lag_stats().values())) for c in cmds]
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
        planes = plane_histogram(planes0, plane_counts(hist_mod))
        counters = {k: v - counters0.get(k, 0) for k, v in profiling.COUNTERS.snapshot().items()
                    if k in ("fold_native_ticks", "ingest_raw_pinned_ships",
                             "ingest_raw_device_dispatches", "ingest_raw_hosted_dispatches",
                             "ingest_raw_hosted_absorbed")}
        stats = [c.replicator.stats() for c in cmds]
        hosting = None
        if defaults:
            hosting = {
                "priming_s": prime_s,
                "hosted_after_priming": hosted0,
                "hosted_buckets": [c.engine.hosted_buckets for c in cmds],
                "in_front_takes": [c.engine._native_store.native_takes for c in cmds],
                "host_takes": [c.engine.host_takes for c in cmds],
                "promotions": [c.engine.promotions for c in cmds],
                "demotions": [c.engine.demotions for c in cmds],
            }
        # The converged taken lanes hold exactly one token per admitted
        # take, whichever node admitted it: frozen clocks grant no refill
        # (an in-front take reads the wall clock, so its refill lands in
        # the added lanes only).
        taken = sum(st.lane_taken_nt for s in snaps[0] for st in s)
        check(taken == admitted * NANO,
              f"converged taken {taken / NANO} tokens, admitted {admitted} takes")
    finally:
        for n in nodes:
            n.close()
    rx = [s["wire_delta_rx_packets"] for s in stats]
    check(launches["decode_fold"] > 0, "decode_fold was not launched by the replicated nodes")
    check(all(r > 0 for r in rx), f"a node received no dv2 datagram: {rx}")
    check(planes["launches"] == launches["decode_fold"],
          f"P histogram holds {planes['launches']} launches, decode_fold made "
          f"{launches['decode_fold']}")
    ring = None
    if native:
        # Read once the nodes have stopped: each rx loop held a lease
        # across every receive wait, and each batch shipped to the card
        # held one until its copy finished; all must have come back.
        ring = [r._rx_ring.stats() for r in reps]
        for st in ring:
            check(st["rx_ring_leases"] == st["rx_ring_commits"] > 0,
                  f"rx ring leases and commits differ or are zero: {ring}")
        check(planes["mean_p"] > 1,
              f"decode_fold ran at a mean P of {planes['mean_p']} on the native backend")
        check(counters["ingest_raw_pinned_ships"] > 0,
              "no raw batch shipped straight from a pinned ring plane")
    if defaults:
        check(counters.get("ingest_raw_hosted_dispatches", 0) > 0,
              "no decode_fold launch carried a hosted entry")
    return {
        "udp_backend": udp_backend,
        "defaults": defaults,
        "hosting": hosting,
        "rx_ring_pinned": pinned,
        "rx_ring": ring,
        "decode_fold_planes": planes,
        "counters": counters,
        "takes": len(pick),
        "http_takes": http_takes,
        "admitted": int(admitted),
        "takes_s": t_takes,
        "converge_s": t_conv,
        "wire_delta_rx_packets": rx,
        "wire_delta_rx_deltas": [s["wire_delta_rx_deltas"] for s in stats],
        "wire_delta_packets_tx": [s["wire_delta_packets_tx"] for s in stats],
        "wire_interval_retransmits": [s["wire_interval_retransmits"] for s in stats],
        # Interval logs dropped for a peer that fell 64 intervals behind on
        # acks (the plane then repairs through anti-entropy).
        "wire_fullstate_fallbacks": [s["wire_fullstate_fallbacks"] for s in stats],
        "ae_fetches_tx": [s["ae_fetches_tx"] for s in stats],
        "srtt_ticks": [t["srtt_ticks"] for t in timers],
        "retransmit_timeout_ticks": [t["retransmit_timeout_ticks"] for t in timers],
        "drain_s_max": max(drains),
        "drain_s_sum": sum(drains),
        "replication_rx_packets": [s["replication_rx_packets"] for s in stats],
        "launches": launches,
        "profile": profile,
        "polls": polls,
    }


def log_two_nodes(label: str, two: dict) -> None:
    prof = two["profile"]
    log(f"{label}: converged in {two['converge_s']:.2f}s, paced takes {two['takes_s']:.2f}s, "
        f"longest drain {two['drain_s_max']:.2f}s, dv2 rx {two['wire_delta_rx_packets']}, "
        f"retransmits {two['wire_interval_retransmits']}, fallbacks "
        f"{two['wire_fullstate_fallbacks']}, srtt ticks {two['srtt_ticks']}, "
        f"launches decode_fold {two['launches']['decode_fold']} tick_join "
        f"{two['launches']['tick_join']} take_n {two['launches']['take_n']}, "
        f"P {json.dumps(two['decode_fold_planes'])}, counters {two['counters']}, "
        f"rx ring {two['rx_ring']}, device busy share (chunks 4..9) "
        f"{prof['device_busy_share']}")
    log(f"{label} profiled window: {json.dumps(prof)}")


# -- phase 3f: one node at the defaults (native front, host lanes) ----------

RESIDENCY_NAMES, RESIDENCY_S = 200_000, 3.0
PROMO_NAMES, PROMO_BURST, PROMO_THRESHOLD = 64, 48, 32
PROMO_RATE = (40, NANO)  # 40 tokens a second: the burst ends in 429s


def residency_paths(rng) -> list:
    """200,000 ``/take`` paths for ``pt_http_blast`` (which cycles through
    them in order): half uniform over 200,000 names, half a Zipf(1.25)
    crowd over 1,000 hot names, interleaved, as phase 3's takes."""
    ranks = np.arange(1, 1001)
    pz = ranks ** -1.25
    pz /= pz.sum()
    half = RESIDENCY_NAMES // 2
    uni = rng.integers(0, RESIDENCY_NAMES, half).tolist()
    hot = rng.choice(1000, half, p=pz).tolist()
    paths = []
    for a, b in zip(uni, hot):
        paths.append(f"/take/f{a}?rate=1000:1s")
        paths.append(f"/take/f{b}?rate=1000:1s")
    return paths


def run_residency_leg(Command, LimiterConfig, engine_mod, rng) -> dict:
    """3f, first leg: one node at the defaults — native front, native host
    store, host fast path on, 1M x 64 on the card — driven by
    ``pt_http_blast`` (h1 keep-alive, 16 connections x 8 in flight) over
    :func:`residency_paths`, in two windows of about 3 s:

    * ``cold``: the paths from the first. A bucket's first take crosses the
      Python pump (and is served from fresh host lanes); a hosted bucket's
      takes are answered in C++ on the front's epoll thread; only promoted
      rows would reach take-n.
    * ``warm``: the paths the cold window answered, again from the first:
      every bucket is hosted, so this is the front's steady state.
    * ``warm_1x1``: the same paths over one connection with one request
      in flight: the latency of an unloaded take (the closed loop's
      latency above is mostly queueing behind 128 requests in flight).

    → per window: rps, p50/p99 latency, statuses, the take split by path,
    promotions and launches."""
    from patrol_tpu_torch import native
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.utils import profiling

    lib = native.load(required=True)
    paths = residency_paths(rng)
    node = Node(Command(
        api_addr="127.0.0.1:0", node_addr=f"127.0.0.1:{free_udp_port()}",
        config=LimiterConfig(buckets=BUCKETS, nodes=LANES), handle_signals=False,
        warmup=True, device="cuda",
    ))
    out = {}
    try:
        cmd = node.cmd
        eng = cmd.engine
        check(cmd.native_front is not None, "the native front was not taken by default")
        check(eng._native_store is not None, "the native host store was not taken by default")
        check(engine_mod.HOST_FASTPATH, "the host fast path is off")
        warm = np.zeros(5, np.uint64)
        lib.pt_http_blast(b"127.0.0.1", cmd.api_port, b"/take/warm?rate=5:1s", 2, 1, 200, warm)
        targets = "\n".join(paths).encode()
        for window, conns, depth in (("cold", 16, 8), ("warm", 16, 8), ("warm_1x1", 1, 1)):
            native0, host0, prom0 = eng._native_store.native_takes, eng._host_takes, eng.promotions
            dev0 = profiling.COUNTERS.get("take_device_tickets")
            _build.reset_launches()
            res5 = np.zeros(5, np.uint64)
            t0 = time.perf_counter()
            rc = lib.pt_http_blast(b"127.0.0.1", cmd.api_port, targets, conns, depth,
                                   int(RESIDENCY_S * 1000), res5)
            wall = time.perf_counter() - t0
            check(rc == 0, f"pt_http_blast failed: {rc}")
            check(eng.flush(60), "flush after the blast timed out")
            done = int(res5[0])
            out[window] = {
                "paths": len(targets.split(b"\n")), "connections": conns, "in_flight": depth,
                "seconds": wall, "requests": done,
                "rps": done / wall, "p50_us": int(res5[1]) / 1e3, "p99_us": int(res5[2]) / 1e3,
                "ok_200": int(res5[3]), "limited_429": int(res5[4]),
                # The takes the node served, by path (the blast counts only
                # the answers that came back inside its window).
                "in_front_takes": eng._native_store.native_takes - native0,
                "python_host_takes": eng._host_takes - host0,
                "device_takes": profiling.COUNTERS.get("take_device_tickets") - dev0,
                "promotions": eng.promotions - prom0, "hosted_buckets": eng.hosted_buckets,
                "launches": dict(_build.LAUNCHES),
            }
            check(done > 0 and out[window]["ok_200"] + out[window]["limited_429"] == done,
                  f"the blast's answers are not all 200 or 429: {out[window]}")
            if window == "cold":
                # The warm windows cycle over the paths the cold one
                # answered: each was issued, and its bucket bound, in order.
                targets = "\n".join(paths[:done]).encode()
        out["front"] = cmd.native_front.stats()
        out["h2_mode"] = cmd.native_front.h2_mode
    finally:
        node.close()
    check(out["warm"]["in_front_takes"] > 0, "no take was answered in the front")
    return out


def probe_take(eng, name: str, rate, count: int, now: int):
    """The C++ in-front take path (resolve, residency, ``hls_take_locked``)
    at an explicit clock; → (remaining, ok), or None when the bucket is not
    served in front."""
    import ctypes

    st = eng._native_store
    raw = name.encode()
    buf = np.zeros(256, np.uint8)
    buf[:len(raw)] = np.frombuffer(raw, np.uint8)
    rem = ctypes.c_int64(0)
    rc = st.lib.pt_hls_take_probe(st.h, eng.directory._ptdir, buf, len(raw), rate.freq,
                                  rate.per_ns, count, now, ctypes.byref(rem))
    return None if rc < 0 else (rem.value, bool(rc))


def promotion_sequence(eng, clock, names, rate, record, demote_window_ns):
    """The promotion/demotion leg's takes, phase by phase at one stepped
    clock value each (so a replay may batch a phase): bind and host, an
    in-front burst that crosses the native promote threshold, device takes,
    an idle window, the take that ends it, then in-front takes again.
    ``record(phase, name, outcome, path)`` sees every take. → the clock
    value of each phase."""
    from patrol_tpu_torch.utils import profiling

    def batch(phase, now):
        res = eng.submit_takes_batch(names, [rate] * len(names), [1] * len(names), now_ns=now)
        check(res is not None, "the pool is spent")
        for name, (t, _) in zip(names, res):
            check(t.wait(60), "a take ticket never completed")
            record(phase, name, (t.remaining, t.ok), "pump")

    t0 = clock.now
    batch("bind", t0)  # fresh rows: served from new host lanes
    for name in names:
        for _ in range(PROMO_BURST):
            got = probe_take(eng, name, rate, 1, t0)
            path = "front"
            if got is None:  # promoted mid-burst: the take rides the device
                t = eng.submit_take(name, rate, 1, now_ns=t0)[0]
                check(t.wait(60), "a take ticket never completed")
                got, path = (t.remaining, t.ok), "engine"
            record("burst", name, got, path)
    eng.drain_native_promotions()  # the pump does this too; either is fine
    check(eng.flush(60), "the promotion drain did not finish")
    t1 = t0 + NANO // 1000
    clock.now = t1
    batch("device", t1)  # promoted rows: take-n
    t2 = t1 + demote_window_ns + 1
    clock.now = t2
    batch("wake", t2)  # the feeder demotes first, then serves from the lanes
    check(eng.flush(60), "flush after the demotion timed out")
    t3 = t2 + NANO // 1000
    clock.now = t3
    for name in names:
        got = probe_take(eng, name, rate, 1, t3)
        check(got is not None, f"{name} is not served in front after its demotion")
        record("front-again", name, got, "front")
    return [t0, t1, t2, t3]


def run_promotion_leg(Command, LimiterConfig, engine_mod) -> dict:
    """3f, second leg: one node at the defaults but with the promote knobs
    lowered to a few dozen (``HOST_PROMOTE_TAKES`` on the engine module,
    ``NATIVE_PROMOTE_TAKES`` on the store, both read when used or made),
    a stepped clock, and 64 hot names (:func:`promotion_sequence`). Each
    row must be promoted once (the drain launches the join), take device
    takes through take-n, be demoted once by the idle window (gather and
    zero) and be served in front again; the take outcomes and final
    per-name states (``snapshot``, which reads host lanes) must equal a
    replay of the same takes on a CPU engine with the fast path off."""
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.ops.rate import Rate
    from patrol_tpu_torch.runtime import hoststore
    from patrol_tpu_torch.runtime.engine import DeviceEngine

    names = [f"promo{i}" for i in range(PROMO_NAMES)]
    rate = Rate(freq=PROMO_RATE[0], per_ns=PROMO_RATE[1])
    saved = engine_mod.HOST_PROMOTE_TAKES, hoststore.NATIVE_PROMOTE_TAKES
    engine_mod.HOST_PROMOTE_TAKES = hoststore.NATIVE_PROMOTE_TAKES = PROMO_THRESHOLD
    clock = Clock(1_700_000_000 * NANO)
    outcomes = []
    paths = {}
    try:
        node = Node(Command(
            api_addr="127.0.0.1:0", node_addr=f"127.0.0.1:{free_udp_port()}",
            config=LimiterConfig(buckets=BUCKETS, nodes=LANES), clock=clock,
            handle_signals=False, warmup=True, device="cuda",
        ))
        try:
            eng = node.cmd.engine
            check(eng._native_store is not None, "the native host store was not taken")
            _build.reset_launches()

            def record(phase, name, got, path):
                outcomes.append((phase, name, got))
                paths[path] = paths.get(path, 0) + 1

            steps = promotion_sequence(eng, clock, names, rate, record,
                                       engine_mod.HOST_DEMOTE_WINDOW_NS)
            launches = dict(_build.LAUNCHES)
            counts = {"promotions": eng.promotions, "demotions": eng.demotions,
                      "promoted_rows_left": len(eng._promoted_rows),
                      "hosted_buckets": eng.hosted_buckets}
            gpu_states = [eng.snapshot(n) for n in names]
        finally:
            node.close()
    finally:
        engine_mod.HOST_PROMOTE_TAKES, hoststore.NATIVE_PROMOTE_TAKES = saved
    join = launches["pair_join"] + launches["row_join"] + launches["tick_join"]
    check(counts["promotions"] == PROMO_NAMES,
          f"{counts['promotions']} promotions for {PROMO_NAMES} hot rows")
    check(counts["demotions"] == PROMO_NAMES,
          f"{counts['demotions']} demotions for {PROMO_NAMES} hot rows")
    check(counts["promoted_rows_left"] == 0, "a promoted row was never demoted")
    check(join > 0, "the promotion drain launched no join")
    check(launches["take_n"] > 0, "no take on a promoted row launched take-n")
    # The replay: the same takes, phase by phase, on a CPU engine with the
    # host fast path off (every take through take-n's plain version).
    engine_mod.HOST_FASTPATH = False
    ceng = DeviceEngine(LimiterConfig(buckets=BUCKETS, nodes=LANES), node_slot=0,
                        clock=Clock(steps[0]), device="cpu")
    try:
        want = []
        for phase in ("bind", "burst", "device", "wake", "front-again"):
            now = steps[{"bind": 0, "burst": 0, "device": 1, "wake": 2, "front-again": 3}[phase]]
            ceng.clock.now = now
            items = [(n, got) for ph, n, got in outcomes if ph == phase]
            tickets = [ceng.submit_take(n, rate, 1, now_ns=now)[0] for n, _ in items]
            for (n, _), t in zip(items, tickets):
                check(t.wait(60), "a replay ticket never completed")
                want.append((phase, n, (t.remaining, t.ok)))
        check(ceng.flush(60), "the replay's flush timed out")
        cpu_states = [ceng.snapshot(n) for n in names]
    finally:
        ceng.stop()
        engine_mod.HOST_FASTPATH = True
    bad = sum(a != b for a, b in zip(outcomes, want))
    check(len(outcomes) == len(want) and bad == 0,
          f"{bad} of {len(outcomes)} take outcomes differ from the CPU replay")
    check(gpu_states == cpu_states, "final per-name states differ from the CPU replay")
    return {"names": PROMO_NAMES, "threshold": PROMO_THRESHOLD, "takes": len(outcomes),
            "admitted": sum(ok for _, _, (_, ok) in outcomes), "paths": paths,
            "launches": launches, **counts}


# -- phase 3h: the bucket lifecycle on the card ---------------------------------

GC_RAW_NAMES = 200_000  # device rows bound by raw ingest
GC_HOST_NAMES = 4_000  # host-resident rows bound by takes
GC_RATE = (10, NANO)  # 10 tokens a second
GC_RETAKES = 1_000  # reclaimed names taken again
GC_REINGEST = 512  # reclaimed raw names ingested again
GC_SHED_OFFER = 2_000  # new names offered at the hard watermark


def lifecycle_raw_trace(rng, names, seq0=1):
    """One dv2 entry for each name (lanes 1..63, capacity 10 tokens), each
    with added >= taken: wire deltas carry no rate period, so such a row is
    reclaimable by its standing balance alone. → planes, lengths."""
    from patrol_tpu_torch.ops import wire

    n = len(names)
    lanes = rng.integers(1, LANES, n)
    taken = rng.integers(0, 1 << 40, n)
    added = taken + rng.integers(0, NANO, n)
    elapsed = rng.integers(1, 1 << 40, n)
    ents = [
        wire.DeltaEntry(name, int(s), GC_RATE[0] * NANO, int(a), int(t), int(e))
        for name, s, a, t, e in zip(names, lanes, added, taken, elapsed)
    ]
    datagrams = []
    at = 0
    while at < n:
        data, packed = wire.encode_delta_packet(1, seq0 + len(datagrams), (), ents[at:],
                                                max_size=DV2_ROW)
        at += packed
        datagrams.append(data)
    return to_planes(datagrams)


def wait_sweep(eng, sweeps_before: int, clock, window_ns: int) -> int:
    """Step the clock past the GC window and wake the feeder through the
    host-served paths' seam until its cadence has run a sweep; → the
    engine's sweep count."""
    deadline = time.monotonic() + 60
    while True:
        clock.now += window_ns + 1
        eng._kick_gc_if_due(clock.now)
        t_end = time.monotonic() + 5
        while time.monotonic() < t_end:
            n = eng.lifecycle_stats()["engine_gc_sweeps"]
            if n > sweeps_before:
                check(eng.flush(60), "flush after a cadence sweep timed out")
                return n
            time.sleep(0.001)
        check(time.monotonic() < deadline, "the feeder's GC cadence never swept")


def lifecycle_sequence(eng, clock, traces, profile=False) -> dict:
    """Phase 3h's steps (a)-(d) on one engine at the defaults (host lanes
    in the native store, the GC knobs at their defaults, the promote knobs
    lowered to PROMO_THRESHOLD), at a stepped clock. → every take outcome,
    the reclaimed count of each sweep, and the phase's counts."""
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.ops.rate import Rate
    from patrol_tpu_torch.utils import histogram as hist_mod

    planes, lengths, re_planes, re_lengths = traces
    rate = Rate(freq=GC_RATE[0], per_ns=GC_RATE[1])
    prate = Rate(freq=PROMO_RATE[0], per_ns=PROMO_RATE[1])
    window = eng._gc_window_ns
    out: dict = {"outcomes": [], "sweep_reclaims": []}

    def takes(names, r, counts, phase):
        for lo in range(0, len(names), 512):
            part = names[lo:lo + 512]
            res = eng.submit_takes_batch(part, [r] * len(part), counts[lo:lo + 512],
                                         now_ns=clock.now)
            check(res is not None, "the pool is spent")
            for name, (t, created) in zip(part, res):
                check(t.wait(60), "a take ticket never completed")
                out["outcomes"].append((phase, name, t.remaining, t.ok, created, t.shed))

    # (a) Bind: 200,000 device rows by raw ingest, 4,000 host-resident rows
    # by takes (a quarter also spent in front), 64 promoted rows.
    accepted, _ = run_raw_ingest(eng, planes, lengths)
    out["raw_accepted"] = sum(accepted)
    host = [f"gh{i:05d}" for i in range(GC_HOST_NAMES)]
    takes(host, rate, [1 + i % 3 for i in range(len(host))], "bind")
    for name in host[:GC_HOST_NAMES // 4]:
        got = probe_take(eng, name, rate, 2, clock.now)
        out["outcomes"].append(("front", name, got))
    promo = [f"gp{i:02d}" for i in range(PROMO_NAMES)]
    takes(promo, prate, [1] * len(promo), "bind")
    for name in promo:
        for _ in range(PROMO_BURST):
            got = probe_take(eng, name, prate, 1, clock.now)
            if got is None:  # promoted mid-burst: the take rides the device
                t = eng.submit_take(name, prate, 1, now_ns=clock.now)[0]
                check(t.wait(60), "a take ticket never completed")
                got = (t.remaining, t.ok)
            out["outcomes"].append(("burst", name, got))
    eng.drain_native_promotions()
    check(eng.flush(60), "the promotion drain did not finish")
    out["promotions"] = eng.promotions
    out["bound"] = len(eng.directory)
    hosted_names = {eng.directory.name_of(r) for r in list(eng._hosted)}

    # (b) Sweep: past the refill and GC_IDLE, the feeder's cadence, then
    # forced sweeps until no candidate is left.
    clock.now += 10 * NANO
    probe_calls = [0]
    probe_at = []  # host seconds of each probe call
    orig_probe = eng._probe_device_rows

    def counted_probe(*args):
        probe_calls[0] += 1
        probe_at.append(time.perf_counter())
        return orig_probe(*args)

    eng._probe_device_rows = counted_probe
    launches0 = _build.LAUNCHES["lifecycle_probe"]
    hist0 = hist_mod.GC_SWEEP.count
    t_sweep = time.perf_counter()
    sweeps = eng.lifecycle_stats()["engine_gc_sweeps"]
    reclaimed0 = 0
    for _ in range(4):
        sweeps = wait_sweep(eng, sweeps, clock, window)
        now_reclaimed = eng.lifecycle_stats()["engine_gc_reclaimed"]
        out["sweep_reclaims"].append(("cadence", now_reclaimed - reclaimed0))
        reclaimed0 = now_reclaimed
    out["cadence_sweeps"] = sweeps
    window_prof = (ProfileWindow(kernels=("lifecycle_probe_kernel",),
                                 lead_in_s=PROFILE_LEAD_IN_S) if profile else None)
    forced = 0
    while forced < 80:
        n = eng.gc_sweep(force=True)
        forced += 1
        out["sweep_reclaims"].append(("forced", n))
        if n == 0 and eng.directory.gc_candidates(clock.now, 0, 1)[0].size == 0:
            break
    if window_prof is not None:
        out["profile"] = window_prof.close(sweeps=forced)
        # When each probe of the window was called (ms after it opened),
        # to match against the profiled kernels' starts.
        out["profile"]["probe_calls_ms"] = [
            (t - window_prof.t0) * 1e3 for t in probe_at if t >= window_prof.t0]
    out["sweep_wall_s"] = time.perf_counter() - t_sweep
    eng._probe_device_rows = orig_probe
    out["forced_sweeps"] = forced
    out["probe_calls"] = probe_calls[0]
    out["probe_launches"] = _build.LAUNCHES["lifecycle_probe"] - launches0
    st = eng.lifecycle_stats()
    out["reclaimed"] = st["engine_gc_reclaimed"]
    out["reclaimed_host"] = sum(eng.directory.lookup(n) is None for n in hosted_names)
    out["reclaimed_device"] = out["reclaimed"] - out["reclaimed_host"]
    out["tombstones"] = st["engine_gc_tombstones"]
    out["bound_after_sweeps"] = len(eng.directory)
    # The process's histogram: no sweep ran before this phase's first run.
    out["gc_sweep_ns"] = hist_mod.GC_SWEEP.summary()
    out["gc_sweep_count"] = hist_mod.GC_SWEEP.count - hist0

    # (c) Re-create: take 1,000 reclaimed names again (the promoted ones and
    # host ones, whose tombstones hold own-lane spend), and ingest 512
    # reclaimed raw names again.
    clock.now += NANO
    tombs = eng.directory.export_tombstones()
    again = promo + host[:GC_RETAKES - len(promo)]
    takes(again, rate, [1] * len(again), "retake")
    re_acc = eng.ingest_raw_planes(re_planes, re_lengths)
    check(eng.flush(60), "flush after the re-creation timed out")
    out["reingest_accepted"] = re_acc
    own = []
    for name in again:
        states = {s.origin_slot: s for s in eng.snapshot(name)}
        own.append(states[0].lane_taken_nt if 0 in states else 0)
    out["retake_own_taken"] = own
    out["retake_tomb_taken"] = [int(tombs[n][1]) for n in again]
    out["tombstones_after_recreate"] = eng.lifecycle_stats()["engine_gc_tombstones"]

    # (d) Shed: a hard watermark just above the bound count, then new names.
    sweeps = eng.lifecycle_stats()["engine_gc_sweeps"]
    eng.configure_lifecycle(max_buckets=len(eng.directory) + 8)
    fresh = [f"gn{i:05d}" for i in range(GC_SHED_OFFER)]
    takes(fresh, rate, [1] * len(fresh), "shed")
    sweeps = wait_sweep(eng, sweeps, clock, window)  # a sweep under pressure
    st = eng.lifecycle_stats()
    out["shed_tickets"] = sum(1 for o in out["outcomes"] if o[0] == "shed" and o[5])
    out["gc_shed"] = st["engine_gc_shed"]
    out["pressure_sweeps"] = st["engine_gc_sweeps"] - out["cadence_sweeps"] - forced
    eng.configure_lifecycle(max_buckets=0)
    check(eng.flush(60), "the final flush timed out")
    return out


# -- phase 3i: the certified families through the engine's entry points -----

CERT_BATCHES = 64  # microbatches of each family, K = CERT_K each
CERT_LEG_NAMES = [f"cert-leg-{i}" for i in range(12)]  # bind rows 0..11
CERT_SERVE_TAKES, CERT_SERVE_DELTAS = 16, 16  # serving traffic a round
CERT_SCRAPES = 1_000
CERT_PROFILE_KERNELS = ("gcra_admit_kernel", "conc_admit_kernel", "quota_admit_kernel")
CERT_METHODS = {"gcra": "gcra_take", "conc": "conc_acquire", "quota": "quota_take"}
CERT_LAUNCHES = ("gcra_admit", "conc_admit", "quota_admit")


def cert_engine_batches(rng) -> list:
    """(family, raw request int64[P, K]) for 64 rounds of the three
    families: :func:`cert_request`'s operands, rows in ``[B/2, B)`` (the
    serving names bind rows from 0), repeated within a call (quota paths
    under 16 global and 512 tenant rows)."""
    half = BUCKETS // 2
    out = []
    for _ in range(CERT_BATCHES):
        for family in CERT_FAMILIES:
            p = cert_request(rng, family, CERT_K, BUCKETS)
            pools = (16, 512, CERT_K // 2) if family == "quota" else (CERT_K // 2,)
            for level, pool in enumerate(pools):
                p[level] = rng.choice(half + rng.choice(half, pool, replace=False), CERT_K)
            out.append((family, p))
    return out


def cert_leg(eng) -> dict:
    """bench.py's cert leg (``bench.py:1529-1608``), input for input, on
    rows 0..11: → admitted counts; each result is held to the leg's
    sequential replay."""
    def gcra_ref(tat, now, t, tol, nreq):
        if tat > now + tol:
            return 0, tat
        base = max(tat, now)
        k = min(1 + (now + tol - base) // t, nreq)
        return k, base + k * t

    rows3, tats, want, got = [0, 1, 2], [0, 0, 0], 0, 0
    for now in (1_000, 1_100):
        res = eng.gcra_take(rows3, [now] * 3, [100] * 3, [300] * 3, [5] * 3)
        got += int(np.asarray(res.admitted).sum())
        for i in range(3):
            k, tats[i] = gcra_ref(tats[i], now, 100, 300, 5)
            want += k
        check(np.asarray(res.own_tat_ns).tolist() == tats,
              "3i: gcra TAT diverged from the sequential replay")
    check(got == want, f"3i: gcra admitted {got}, the sequential replay {want}")
    rows3 = [3, 4, 5]
    res = eng.conc_acquire(rows3, [5] * 3, [1] * 3, [8] * 3, [0] * 3)
    check(np.asarray(res.admitted).tolist() == [5] * 3, "3i: conc first acquire")
    conc = int(np.asarray(res.admitted).sum())
    res = eng.conc_acquire(rows3, [5] * 3, [1] * 3, [4] * 3, [2] * 3)
    check(np.asarray(res.released_nt).tolist() == [2] * 3
          and np.asarray(res.admitted).tolist() == [2] * 3
          and np.asarray(res.inflight_nt).tolist() == [5] * 3, "3i: conc re-acquire")
    conc += int(np.asarray(res.admitted).sum())
    paths = dict(rows_global=[6, 7], rows_tenant=[8, 9], rows_user=[10, 11],
                 limit_global_nt=[10] * 2, limit_tenant_nt=[6] * 2, limit_user_nt=[4] * 2,
                 count_nt=[1] * 2)
    res = eng.quota_take(nreq=[5] * 2, **paths)
    check(np.asarray(res.admitted).tolist() == [4] * 2, "3i: quota path-minimum admission")
    quota = int(np.asarray(res.admitted).sum())
    res = eng.quota_take(nreq=[5] * 2, **paths)
    check(np.asarray(res.admitted).tolist() == [0] * 2, "3i: quota second tick must starve")
    return {"gcra": got, "conc": conc, "quota": quota}


def cert_sequence(eng, clock, batches, wire_mod, rate_cls, profile=False) -> dict:
    """3i's sequence on one engine at a frozen, stepped clock: the cert
    leg (its rows bound first to names of their own, so the serving names
    land on other rows), then each round's three family microbatches
    followed by 16 takes (host lanes) and 16 peer deltas (device rows) on
    other names and a flush; then one microbatch of each family on the
    leg's rows, which a scrape must show. → digests of every result,
    serving outcomes, host time per call and (``profile``) the profiled
    window."""
    import hashlib

    for name in CERT_LEG_NAMES:
        eng.assign_row(name, clock.now)
    out = {"leg": cert_leg(eng), "digests": [], "serve": [], "call_us": {f: [] for f in CERT_FAMILIES}}
    rng = np.random.default_rng(29)
    rate = rate_cls(freq=100, per_ns=NANO)
    window = ProfileWindow(CERT_PROFILE_KERNELS) if profile else None
    for i, (family, p) in enumerate(batches):
        levels = 3 if family == "quota" else 1
        t0 = time.perf_counter()
        res = getattr(eng, CERT_METHODS[family])(*p[:levels], *p[levels:])
        out["call_us"][family].append((time.perf_counter() - t0) * 1e6)
        out["digests"].append(hashlib.sha256(np.stack(res).tobytes()).hexdigest())
        if i % 3 == 2:
            clock.now += 1_000_000
            for name in rng.integers(0, 2_000, CERT_SERVE_TAKES):
                out["serve"].append(tuple(eng.take(f"svc{name}", rate, 1)))
            for name, slot in zip(rng.integers(0, 2_000, CERT_SERVE_DELTAS),
                                  rng.integers(1, LANES, CERT_SERVE_DELTAS)):
                t = int(rng.integers(0, 50)) * NANO
                out["serve"].append(eng.ingest_delta(wire_mod.from_nanotokens(
                    f"peer{name}", 0, t, 0, origin_slot=int(slot), cap_nt=100 * NANO,
                    lane_added_nt=0, lane_taken_nt=t), slot=int(slot)))
            check(eng.flush(120), "3i: flush after a round timed out")
    out["profile"] = window.close(calls=len(batches)) if window else None
    # A scrape after a family's microbatch shows it: GCRA on rows 0..2,
    # concurrency on 3..5, quota on paths 6/8/10 and 7/9/11.
    clock.now += 1_000_000
    shown = []
    g = eng.gcra_take([0, 1, 2], [5_000] * 3, [100] * 3, [300] * 3, [2] * 3)
    shown.append([int(eng.row_view(r)[0][0, 1]) for r in (0, 1, 2)] == np.asarray(g.own_tat_ns).tolist())
    c = eng.conc_acquire([3, 4, 5], [9] * 3, [1] * 3, [3] * 3, [1] * 3)
    views = [eng.row_view(r)[0][0] for r in (3, 4, 5)]
    shown.append([[int(v[0]), int(v[1])] for v in views]
                 == [[int(a), int(t)] for a, t in zip(c.own_released_nt, c.own_acquired_nt)])
    q = eng.quota_take([6, 7], [8, 9], [10, 11], [100] * 2, [100] * 2, [100] * 2, [1] * 2, [3] * 2)
    shown.append([int(eng.row_view(r)[0][0, 1]) for r in (10, 11)]
                 == np.asarray(q.own_taken_user_nt).tolist())
    direct, _ = eng.read_rows(np.arange(12))
    shown.append(all(np.array_equal(eng.row_view(r)[0], direct[r]) for r in range(12)))
    out["scrape_shows_microbatch"] = shown
    out["digests"].append(hashlib.sha256(np.concatenate([*g, *c, *q]).tobytes()).hexdigest())
    return out


class CertCallSteps:
    """Where a family call's host time goes: times the steps of the
    engine's ``_cert_call`` from outside, by wrapping the callables it
    calls, on the thread that calls the families only (the feeder leases
    staging too). Steps: ``pack`` (rows and fields into the staging
    buffer, before and after its lease), ``lease`` (the staging leases),
    ``ship`` (the pinned host-to-device copy), ``launch`` (the family's
    ``*_packed`` function: operand checks, allocations, the ctypes calls),
    ``readback`` (the synchronous result copy and its numpy slice) and
    ``other`` (the state lock, the result tuple, the wrappers themselves).
    → per family, each step's host µs, p50 and p99."""

    STEPS = ("pack", "lease", "ship", "launch", "readback", "other")

    def __init__(self, eng):
        from patrol_tpu_torch.ops import concurrency, gcra, hierquota

        self.eng = eng
        self.events = None
        self.tid = threading.get_ident()
        self.us = {f: {k: [] for k in self.STEPS} for f in CERT_FAMILIES}
        self._undo = []
        # The pool's class has __slots__: the engine gets a stand-in that
        # times its two methods.
        pool = eng._staging
        eng._staging = types.SimpleNamespace(lease=self._timed("lease", pool.lease),
                                             release=self._timed("release", pool.release))
        self._undo.append((eng, "_staging", pool))
        self._wrap(eng, "_ship", "ship")
        for mod, attr in ((gcra, "gcra_take_packed"), (concurrency, "conc_acquire_packed"),
                          (hierquota, "quota_take_packed")):
            self._wrap(mod, attr, "launch")
        for family, method in CERT_METHODS.items():
            self._wrap_call(family, method)

    def _timed(self, tag, fn):
        def timed(*args, **kwargs):
            events = self.events
            if events is None or threading.get_ident() != self.tid:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                events.append((tag, t0, time.perf_counter()))

        return timed

    def _wrap(self, obj, attr, tag):
        orig = getattr(obj, attr)
        self._undo.append((obj, attr, orig if attr in vars(obj) else None))
        setattr(obj, attr, self._timed(tag, orig))

    def _wrap_call(self, family, method):
        orig = getattr(self.eng, method)

        def call(*args, **kwargs):
            self.events = events = []
            t0 = time.perf_counter()
            try:
                res = orig(*args, **kwargs)
            finally:
                self.events = None
            self._book(family, events, t0, time.perf_counter())
            return res

        self._undo.append((self.eng, method, None))
        setattr(self.eng, method, call)

    def _book(self, family, events, t0, t1):
        by = {tag: [e for e in events if e[0] == tag]
              for tag in ("lease", "release", "ship", "launch")}
        lease, ship, launch = by["lease"], by["ship"][0], by["launch"][0]
        steps = {
            "pack": (lease[0][1] - t0) + (ship[1] - lease[0][2]),
            "lease": sum(e[2] - e[1] for e in lease),
            "ship": ship[2] - ship[1],
            "launch": launch[2] - launch[1],
            "readback": by["release"][-1][1] - lease[-1][2],
        }
        steps["other"] = (t1 - t0) - sum(steps.values())
        for k, v in steps.items():
            self.us[family][k].append(v * 1e6)

    def close(self) -> dict:
        for obj, attr, orig in reversed(self._undo):
            if orig is None:
                delattr(obj, attr)  # the class's method shows again
            else:
                setattr(obj, attr, orig)
        return {f: {k: {"p50": statistics.median(v), "p99": float(np.percentile(v, 99))}
                    for k, v in steps.items()} for f, steps in self.us.items()}


def run_cert_phase(Command, LimiterConfig, engine_mod, torch) -> dict:
    """3i: a ``Command`` at the defaults on the card (1M x 64, GC window
    pinned to 0 as in phases 3-3g) drives :func:`cert_sequence` with the
    launch counters zeroed just before; then 1,000 scrapes of unchanged
    state must all be mirror hits with no device gather. The sequence
    replays on a CPU engine: every family result, every serving outcome
    and the final planes must be equal."""
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.ops import wire as wire_mod
    from patrol_tpu_torch.ops.rate import Rate
    from patrol_tpu_torch.runtime.engine import DeviceEngine
    from patrol_tpu_torch.utils import profiling

    t = time.perf_counter()
    batches = cert_engine_batches(np.random.default_rng(23))
    built_s = time.perf_counter() - t
    cfg = LimiterConfig(buckets=BUCKETS, nodes=LANES)
    t0 = 1_700_000_000 * NANO
    clock = Clock(t0)
    node = Node(Command(
        api_addr="127.0.0.1:0", node_addr=f"127.0.0.1:{free_udp_port()}", config=cfg,
        clock=clock, handle_signals=False, warmup=True, device="cuda",
    ))
    try:
        eng = node.cmd.engine
        check(eng._native_store is not None, "3i: the native host store was not taken")
        check(engine_mod.SCRAPE_MIRROR and eng._mirror_window == engine_mod.SCRAPE_MIRROR_ROWS,
              "3i: the scrape mirror is not on at the defaults")
        steps = CertCallSteps(eng)
        try:
            _build.reset_launches()
            t = time.perf_counter()
            gpu = cert_sequence(eng, clock, batches, wire_mod, Rate, profile=True)
            gpu["seconds"] = time.perf_counter() - t
            gpu["launches"] = dict(_build.LAUNCHES)
        finally:
            gpu_steps = steps.close()
        gpu["call_steps_us"] = gpu_steps
        check(eng.flush(120), "3i: final flush timed out")
        # 1,000 scrapes of unchanged state: the leg's rows and the peer
        # names' device rows, all inside the mirror window.
        peers = [f"peer{i}" for i in range(2_000) if eng.directory.lookup(f"peer{i}") is not None]
        c0 = {k: profiling.COUNTERS.get(k) for k in
              ("scrape_mirror_hits", "scrape_device_gathers", "scrape_mirror_refreshes")}
        t = time.perf_counter()
        for i in range(CERT_SCRAPES):
            if i % 2:
                eng.row_view(i % 12)
            else:
                eng.tokens_if_known(peers[i % len(peers)])
        scrape_s = time.perf_counter() - t
        scrapes = {k: profiling.COUNTERS.get(k) - v for k, v in c0.items()}
        scrapes["per_scrape_us"] = scrape_s / CERT_SCRAPES * 1e6
        gpu["scrapes"] = scrapes
        gpu_planes = eng.snapshot_planes()
        # The entry point's own host time: 64 GCRA calls at K = 8192 on an
        # idle engine, after the planes were read (their writes are not
        # replayed).
        p = next(q for f, q in batches if f == "gcra")
        idle = []
        for _ in range(64):
            t = time.perf_counter()
            eng.gcra_take(*p)
            idle.append((time.perf_counter() - t) * 1e6)
        gpu["idle_gcra_call_us_p50"] = statistics.median(idle)
    finally:
        node.close()
    del node
    torch.cuda.empty_cache()
    cclock = Clock(t0)
    ceng = DeviceEngine(cfg, node_slot=0, clock=cclock, device="cpu", native_host=True)
    try:
        t = time.perf_counter()
        cpu = cert_sequence(ceng, cclock, batches, wire_mod, Rate)
        cpu_s = time.perf_counter() - t
        check(ceng.flush(600), "3i: CPU replay flush timed out")
        cpu_planes = ceng.snapshot_planes()
    finally:
        ceng.stop()
    check(gpu["leg"] == {"gcra": 15, "conc": 21, "quota": 8}, f"3i: cert leg {gpu['leg']}")
    check(gpu["leg"] == cpu["leg"], "3i: the cert leg differs from the CPU replay")
    bad = [i for i, (a, b) in enumerate(zip(gpu["digests"], cpu["digests"])) if a != b]
    check(not bad and len(gpu["digests"]) == len(cpu["digests"]),
          f"3i: family results differ from the CPU replay at calls {bad[:8]}")
    check(gpu["serve"] == cpu["serve"], "3i: serving outcomes differ from the CPU replay")
    check(all(gpu["scrape_shows_microbatch"]) and all(cpu["scrape_shows_microbatch"]),
          f"3i: a scrape did not show a family's microbatch: {gpu['scrape_shows_microbatch']}")
    check(np.array_equal(gpu_planes[0], cpu_planes[0]) and np.array_equal(gpu_planes[1], cpu_planes[1]),
          "3i: the final planes differ from the CPU replay")
    check(scrapes["scrape_device_gathers"] == 0
          and scrapes["scrape_mirror_hits"] >= CERT_SCRAPES // 2,
          f"3i: scrapes of unchanged state gathered: {scrapes}")
    # Each family: two calls of the leg, the rounds, one on the leg's rows;
    # one launch a call, which commits inside it: no other cert launch.
    calls_each = 2 + CERT_BATCHES + 1
    for name in CERT_LAUNCHES:
        check(gpu["launches"][name] == calls_each,
              f"3i: {name} launched {gpu['launches'][name]} times, not {calls_each}")
    check(not [k for k, v in gpu["launches"].items() if "commit" in k and v],
          f"3i: a commit kernel launched: {gpu['launches']}")
    del gpu_planes, cpu_planes
    calls = {f: statistics.median(v) for f, v in gpu["call_us"].items()}
    p99 = {f: float(np.percentile(v, 99)) for f, v in gpu["call_us"].items()}
    gpu.pop("digests")
    gpu.pop("serve")
    gpu.pop("call_us")
    gpu.update({"batches_built_s": built_s, "cpu_replay_s": cpu_s, "call_us_p50": calls,
                "call_us_p99": p99})
    return gpu


def run_lifecycle_phase(engine_mod, torch) -> dict:
    """3h: one node at 1,000,000 x 64 on the card at the defaults (host
    lanes in the native store, GC on at its default knobs), at a stepped
    clock, through :func:`lifecycle_sequence`; then (e) a checkpoint saved
    and restored into a fresh engine on the card. (a)-(d) replay on a CPU
    engine with the same clock steps: outcomes, each sweep's reclaims, the
    bound set, tombstones and final planes must be equal."""
    import shutil
    import tempfile

    from patrol_tpu_torch.models.limiter import LimiterConfig
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.runtime import checkpoint as ckpt
    from patrol_tpu_torch.runtime import hoststore
    from patrol_tpu_torch.runtime.engine import DeviceEngine

    rng = np.random.default_rng(19)
    raw_names = [f"g{i:09d}" for i in range(GC_RAW_NAMES)]
    planes, lengths = lifecycle_raw_trace(rng, raw_names)
    re_planes, re_lengths = lifecycle_raw_trace(rng, raw_names[:GC_REINGEST], seq0=10_000)
    traces = (planes, lengths, re_planes, re_lengths)
    cfg = LimiterConfig(buckets=BUCKETS, nodes=LANES)
    saved = engine_mod.HOST_PROMOTE_TAKES, hoststore.NATIVE_PROMOTE_TAKES
    engine_mod.HOST_PROMOTE_TAKES = hoststore.NATIVE_PROMOTE_TAKES = PROMO_THRESHOLD
    t0 = 1_700_000_000 * NANO
    try:
        clock = Clock(t0)
        eng = DeviceEngine(cfg, node_slot=0, clock=clock, device="cuda", native_host=True)
        try:
            check(eng._native_store is not None, "the native host store was not taken")
            check(eng._gc_window_ns > 0, "GC is not on at the defaults")
            eng.warmup()
            _build.reset_launches()
            t = time.perf_counter()
            gpu = lifecycle_sequence(eng, clock, traces, profile=True)
            gpu["seconds"] = time.perf_counter() - t
            gpu["launches"] = dict(_build.LAUNCHES)
            gpu_state = (dict(eng.directory._rows), eng.directory.export_tombstones(),
                         *eng.snapshot_planes())
            # (e) The checkpoint round trip, on the card.
            tmp = tempfile.mkdtemp(prefix="patrol-ckpt-")
            try:
                t = time.perf_counter()
                ckpt.save(tmp, eng, membership={"self_slot": 0, "epoch": 0})
                gpu["save_s"] = time.perf_counter() - t
                gpu["checkpoint_bytes"] = sum(
                    os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
                eng2 = DeviceEngine(cfg, node_slot=0, clock=Clock(clock.now), device="cuda",
                                    native_host=True)
                try:
                    t = time.perf_counter()
                    gpu["restored_buckets"] = ckpt.restore(tmp, eng2)
                    gpu["restore_s"] = time.perf_counter() - t
                    pn2, el2 = eng2.snapshot_planes()
                    check(np.array_equal(pn2, gpu_state[2]) and np.array_equal(el2, gpu_state[3]),
                          "the restored planes differ from the saved node's")
                    check(eng2.directory.export_tombstones() == gpu_state[1],
                          "the restored tombstones differ from the saved node's")
                    check(dict(eng2.directory._rows) == gpu_state[0],
                          "the restored directory differs from the saved node's")
                    del pn2, el2
                finally:
                    eng2.stop()
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        finally:
            eng.stop()
        del eng
        torch.cuda.empty_cache()
        cclock = Clock(t0)
        ceng = DeviceEngine(cfg, node_slot=0, clock=cclock, device="cpu", native_host=True)
        try:
            cpu = lifecycle_sequence(ceng, cclock, traces)
            cpu_state = (dict(ceng.directory._rows), ceng.directory.export_tombstones(),
                         *ceng.snapshot_planes())
        finally:
            ceng.stop()
    finally:
        engine_mod.HOST_PROMOTE_TAKES, hoststore.NATIVE_PROMOTE_TAKES = saved

    for key in ("outcomes", "sweep_reclaims", "reclaimed", "reclaimed_host", "tombstones",
                "retake_own_taken", "shed_tickets", "gc_shed", "raw_accepted",
                "reingest_accepted", "promotions"):
        check(gpu[key] == cpu[key], f"3h: {key} differs from the CPU replay")
    check(gpu_state[0] == cpu_state[0], "3h: the bound set differs from the CPU replay")
    check(gpu_state[1] == cpu_state[1], "3h: the tombstones differ from the CPU replay")
    check(np.array_equal(gpu_state[2], cpu_state[2]) and np.array_equal(gpu_state[3], cpu_state[3]),
          "3h: the final planes differ from the CPU replay")
    check(gpu["promotions"] == PROMO_NAMES, f"3h: {gpu['promotions']} promotions")
    check(gpu["reclaimed"] >= GC_RAW_NAMES, f"3h: only {gpu['reclaimed']} reclaimed")
    check(gpu["reclaimed_host"] > 0 and gpu["reclaimed_device"] >= GC_RAW_NAMES,
          f"3h: reclaimed {gpu['reclaimed_host']} host, {gpu['reclaimed_device']} device rows")
    check(gpu["bound_after_sweeps"] == 0, f"3h: {gpu['bound_after_sweeps']} rows survived the sweeps")
    check(gpu["probe_launches"] > 0 and gpu["probe_launches"] == gpu["probe_calls"],
          f"3h: {gpu['probe_launches']} probe launches for {gpu['probe_calls']} sweeps "
          "with device candidates")
    # The re-seed: a re-taken bucket's own lane resumes at its tombstone.
    check(all(o == t + NANO for o, t in zip(gpu["retake_own_taken"], gpu["retake_tomb_taken"])),
          "3h: a re-taken bucket's own lane did not resume at its tombstone")
    check(sum(t > 0 for t in gpu["retake_tomb_taken"]) >= GC_RETAKES // 2,
          "3h: too few re-taken buckets had own-lane spend")
    check(gpu["tombstones_after_recreate"] == gpu["tombstones"] - GC_RETAKES - GC_REINGEST,
          "3h: re-creation did not consume the tombstones")
    check(gpu["shed_tickets"] > 0 and gpu["gc_shed"] >= gpu["shed_tickets"],
          f"3h: {gpu['shed_tickets']} sheds")
    gpu.pop("outcomes")
    for key in ("retake_own_taken", "retake_tomb_taken"):
        gpu.pop(key)
    return gpu


# -- phase 3j: the mesh ----------------------------------------------------------

MESH_DEVICES = 8  # cuda:0 x 8: R x (8 / R) blocks on the one card
MESH_SHORT = (30_000, 10_000)  # the R = 4 and R = 1 legs: the trace's first deltas, takes
MESH_RESIZE_TAKES = 6_000
MESH_PROFILE_KERNELS = ("join_kernel", "take_n_kernel", "gather_kernel", "converge_kernel")


class MeshSteps:
    """Times a MeshEngine's dispatches on its feeder, by step: ``route``
    (``route_packed`` into the leased matrices), ``prepare`` (the host
    classification, ``prepare_step``), ``ship`` (one staging copy),
    ``launch`` (``run_step`` under the state lock: the gather, joins,
    take-n and converge launches, with any wait for the lock) and
    ``other`` (the rest of ``_dispatch_fused``: packing the takes, the
    result readback's enqueue, the completion hand-off); and the tick fold
    apart. It counts the dispatches that carried takes (and so, at R > 1,
    a gather and a converge)."""

    def __init__(self, eng, topo):
        self.eng, self.topo = eng, topo
        self.cur = None
        self.rows, self.folds = [], []
        self._undo = []
        for name, step in (("route_packed", "route"), ("prepare_step", "prepare")):
            self._patch(topo, name, self._timed(step, getattr(topo, name)))
        self._patch(topo, "run_step", self._timed("launch", topo.run_step, note=True))
        self._patch(eng, "_ship_flat", self._timed("ship", eng._ship_flat))
        dispatch, fold = eng._dispatch_fused, eng._fold_core

        def dispatch_timed(*a, **kw):
            self.cur = cur = {}
            t0 = time.perf_counter()
            try:
                return dispatch(*a, **kw)
            finally:
                self.cur = None
                cur["total"] = time.perf_counter() - t0
                self.rows.append(cur)

        def fold_timed(deltas):
            t0 = time.perf_counter()
            try:
                return fold(deltas)
            finally:
                self.folds.append(time.perf_counter() - t0)

        self._patch(eng, "_dispatch_fused", dispatch_timed)
        self._patch(eng, "_fold_core", fold_timed)

    def _patch(self, obj, attr, fn):
        self._undo.append((obj, attr, getattr(obj, attr), attr in vars(obj)))
        setattr(obj, attr, fn)

    def _timed(self, step, fn, note=False):
        def timed(*args, **kwargs):
            cur = self.cur
            if cur is None:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                cur[step] = cur.get(step, 0.0) + time.perf_counter() - t0
                if note:
                    cur["takes"], cur["T"] = args[1].L, args[1].T

        return timed

    def close(self) -> dict:
        for obj, attr, orig, own in reversed(self._undo):
            if own:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
        steps = ("route", "prepare", "ship", "launch")
        us = {k: [r.get(k, 0.0) * 1e6 for r in self.rows] for k in steps + ("total",)}
        us["other"] = [r["total"] * 1e6 - sum(r.get(k, 0.0) * 1e6 for k in steps)
                       for r in self.rows]

        def pct(v):
            return {"p50": statistics.median(v), "p99": float(np.percentile(v, 99))} if v else None

        return {
            "dispatches": len(self.rows),
            "with_takes": sum(1 for r in self.rows if r.get("takes")),
            "scratch_rows_p50": statistics.median([r["T"] for r in self.rows if r.get("T")] or [0]),
            "dispatch_us": {k: pct(v) for k, v in us.items()},
            "fold_us": pct([f * 1e6 for f in self.folds]),
        }


def mesh_trace(trace, short):
    """The trace cut to its first ``short`` = (deltas, takes), hot burst whole."""
    deltas, hot_burst, vals, caps, takes = trace
    return deltas[:short[0]], hot_burst, vals, caps, takes[:short[1]]


def resize_takes(repo, trace, eng=None, at=1_000):
    """MESH_RESIZE_TAKES of the trace's takes submitted from one thread in
    order; with ``eng``, the mesh is resized 2 -> 4 once ``at`` are
    submitted and back 4 -> 2 once twice that are. → (outcomes, receipts)."""
    names = trace[4][-MESH_RESIZE_TAKES:]
    tickets, receipts = [], []
    submitted = threading.Semaphore(0)

    def submit():
        for i, name in enumerate(names):
            rate, count = rate_of(name)
            tickets.append(repo.submit_take(name, rate, count))
            if i in (at, 2 * at):
                submitted.release()

    th = threading.Thread(target=submit)
    th.start()
    if eng is not None:
        for replicas in (4, 2):
            check(submitted.acquire(timeout=120), "3j: the take stream stalled")
            receipts.append(eng.resize(replicas=replicas, devices=[eng.device] * MESH_DEVICES))
    th.join(300)
    check(not th.is_alive(), "3j: the take stream did not finish")
    for t in tickets:
        check(t.wait(120), "3j: a take across the resize was never answered")
    return [(t.ok, t.remaining) for t in tickets], receipts


def mesh_leg(torch, topo, MeshEngine, TPURepo, cfg, replicas, trace, clock_now, device,
             resize=False):
    """One meshed engine over ``device`` x MESH_DEVICES at ``replicas``:
    the trace through a TPURepo (held bursts, as phase 3), timed by step
    and, on the card, under the profiler, with the launch counters zeroed
    just before; with
    ``resize``, then the take stream across 2 -> 4 -> 2. → (result, final
    planes, planes after the trace)."""
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.utils import profiling

    eng = MeshEngine(cfg, replicas=replicas, node_slot=0, clock=Clock(clock_now),
                     devices=[torch.device(device)] * MESH_DEVICES)
    try:
        eng.warmup()
        repo = TPURepo(eng)
        steps = MeshSteps(eng, topo)
        _build.reset_launches()
        window = ProfileWindow(MESH_PROFILE_KERNELS) if device == "cuda" else None
        outcomes, t_d, t_t, _ = run_trace(eng, repo, trace, hold=True)
        res = {"outcomes": outcomes, "deltas_per_s": (len(trace[0]) + len(trace[1])) / t_d,
               "takes_per_s": len(trace[4]) / t_t, "stats": eng.stats()}
        res["profile"] = window.close() if window else None
        res["launches"] = dict(_build.LAUNCHES)
        res["steps"] = steps.close()
        trace_planes = eng.snapshot_planes()
        if resize:
            resizes0 = profiling.COUNTERS.get("mesh_resizes")
            _build.reset_launches()
            t0 = time.perf_counter()
            res["resize_outcomes"], res["receipts"] = resize_takes(repo, trace, eng)
            res["resize_s"] = time.perf_counter() - t0
            check(eng.flush(120), "3j: flush after the resize timed out")
            res["resize_launches"] = dict(_build.LAUNCHES)
            check(profiling.COUNTERS.get("mesh_resizes") == resizes0 + 2, "3j: two resizes")
            check((eng.plan.replicas, eng.plan.shards) == (2, MESH_DEVICES // 2),
                  f"3j: the mesh did not resize back ({eng.plan})")
        planes = eng.snapshot_planes()
    finally:
        eng.stop()
    return res, planes, trace_planes


def mesh_replay(torch, MeshEngine, TPURepo, cfg, replicas, trace, clock_now, resize=False):
    """The same calls on a CPU MeshEngine (the plain versions), no resize:
    with no merges in flight the take results do not depend on the mesh's
    shape. → (outcomes, resize outcomes, final planes, planes after the
    trace)."""
    ceng = MeshEngine(cfg, replicas=replicas, node_slot=0, clock=Clock(clock_now),
                      devices=[torch.device("cpu")] * MESH_DEVICES)
    try:
        crepo = TPURepo(ceng)
        outcomes, _, _, _ = run_trace(ceng, crepo, trace)
        trace_planes = ceng.snapshot_planes()
        more = resize_takes(crepo, trace)[0] if resize else None
        check(ceng.flush(600), "3j: CPU replay flush timed out")
        planes = ceng.snapshot_planes()
    finally:
        ceng.stop()
    return outcomes, more, planes, trace_planes


def run_mesh_phase(torch, device="cuda", buckets=BUCKETS, lanes=LANES, trace=None,
                   short=MESH_SHORT) -> dict:
    """3j: the mesh engine on ``device`` x 8 at 1,000,000 x 64 (GC off and
    the host fast path off, as in phase 3): R = 2 (2 x 4 blocks) over
    phase 3's whole trace, then the take stream across a resize 2 -> 4 ->
    2; R = 4 (4 x 2) and R = 1 (1 x 8) over the trace's first
    ``short`` deltas and takes. Every leg replays on a CPU MeshEngine at
    the same R: outcomes and planes equal. Each leg's held first burst
    splits (mesh_split_ticks > 0); take-n launches once for each dispatch
    with takes, and at R > 1 the gather and the converge too (none at
    R = 1); the join launches. (On ``device="cpu"``, a rehearsal at a
    small size, the launch counts are not held.)"""
    from patrol_tpu_torch.models.limiter import LimiterConfig
    from patrol_tpu_torch.parallel import topology as topo
    from patrol_tpu_torch.runtime.mesh_engine import MeshEngine
    from patrol_tpu_torch.runtime.repo import TPURepo

    cfg = LimiterConfig(buckets=buckets, nodes=lanes)
    trace = trace if trace is not None else make_trace(np.random.default_rng(7))
    clock_now = 1_700_000_000 * NANO
    out = {}
    for key, replicas, leg_trace, resize in (
        ("r2", 2, trace, True),
        ("r4", 4, mesh_trace(trace, short), False),
        ("r1", 1, mesh_trace(trace, short), False),
    ):
        t0 = time.perf_counter()
        res, planes, trace_planes = mesh_leg(torch, topo, MeshEngine, TPURepo, cfg, replicas,
                                             leg_trace, clock_now, device, resize)
        res["device_s"] = time.perf_counter() - t0
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        c_out, c_more, c_planes, c_trace_planes = mesh_replay(
            torch, MeshEngine, TPURepo, cfg, replicas, leg_trace, clock_now, resize)
        res["replay_s"] = time.perf_counter() - t0
        check(res.pop("outcomes") == c_out, f"3j R={replicas}: take outcomes differ from the CPU replay")
        for mine, theirs, what in ((trace_planes, c_trace_planes, "after the trace"),
                                   (planes, c_planes, "at the end")):
            check(all(np.array_equal(x, y) for x, y in zip(mine, theirs)),
                  f"3j R={replicas}: planes {what} differ from the CPU replay")
        del planes, trace_planes, c_planes, c_trace_planes
        if resize:
            check(res.pop("resize_outcomes") == c_more,
                  "3j: take outcomes across the resize differ from the CPU replay")
        st = res["stats"]
        check(st["mesh_split_ticks"] > 0, f"3j R={replicas}: no tick split ({st})")
        check(st["mesh_replicas"] == replicas, f"3j: {st['mesh_replicas']} replicas")
        if device == "cuda":
            la, n_takes = res["launches"], res["steps"]["with_takes"]
            check(n_takes > 0 and la["take_n"] == n_takes,
                  f"3j R={replicas}: take_n {la['take_n']} for {n_takes} dispatches with takes")
            want = n_takes if replicas > 1 else 0
            check(la["converge"] == want and la["mesh_gather"] == want,
                  f"3j R={replicas}: converge {la['converge']}, gather {la['mesh_gather']}, "
                  f"want {want}")
            check(la["pair_join"] > 0, f"3j R={replicas}: the join was not launched")
            if resize:
                rl = res["resize_launches"]
                check(rl["take_n"] > 0 and rl["converge"] == rl["mesh_gather"] > 0,
                      f"3j: launches across the resize {rl}")
        out[key] = res
    return out


# -- phase 3k: the check stages and a device trace, on the card ----------------

JOIN_LAUNCHES = ("pair_join", "row_join", "tick_join")
# Each lin pin's kernel: the launch counter a pin's calls must move once each.
LIN_PIN_KERNELS = {"take": "take_n", "lifecycle": "lifecycle_probe", "gcra": "gcra_admit",
                   "conc": "conc_admit", "quota": "quota_admit"}
LIN_PIN_K = 2048  # histories (columns) a pin runs at once
TRACE_NAMES = 2000  # names the peer socket binds on the traced node
TRACE_S, TRACE_BLAST_S, TRACE_LEAD_S = 2.0, 1.4, 0.3  # capture, blast, blast's start in it
TRACE_DELTAS = 16  # dv2 entries a datagram during a blast window
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def run_abi_stage(device: str) -> dict:
    """3k(a): every ABI obligation, one pass at a time, against the port's
    library, the fold's kernel twins on ``device``. → each pass's seconds
    and findings (as strings)."""
    from patrol_tpu_torch.analysis import abi
    from patrol_tpu_torch.ops.obligations import ABI_OBLIGATIONS

    out = {}
    for ob in ABI_OBLIGATIONS:
        t = time.perf_counter()
        findings = abi.abi_all(only=[ob.name], device=device)
        out[ob.name] = {"seconds": time.perf_counter() - t,
                        "findings": [str(f) for f in findings]}
    return out


def run_lin_pins(_build, device: str, k: int = LIN_PIN_K) -> dict:
    """3k(b): each sequential spec against its kernel on ``device``
    (``analysis/lin_pins.py``), K histories at once from a seed; → per
    pin its calls, columns, mismatches, seconds and the launches of its
    kernel (counted from 0 around the pin)."""
    from patrol_tpu_torch.analysis import lin_pins

    out = {}
    for name, pin in lin_pins.PINS.items():
        _build.reset_launches()
        t = time.perf_counter()
        res = pin(device, np.random.default_rng(20261019), k=k)
        res["seconds"] = time.perf_counter() - t
        res["launches"] = _build.LAUNCHES[LIN_PIN_KERNELS[name]]
        out[name] = res
    return out


def start_check_stages() -> dict:
    """3k(c): ``protocol_repo`` and ``lin_repo`` as subprocesses, started
    together (pure Python: they run on the host's cores beside the card
    work of 3k). → the running processes, by stage."""
    t0 = time.perf_counter()
    return {
        stage: (t0, subprocess.Popen(
            [sys.executable, "-m", f"patrol_tpu_torch.scripts.{stage}_repo"], cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
        for stage in ("protocol", "lin")
    }


def finish_check_stages(procs: dict) -> dict:
    """Wait for :func:`start_check_stages`' processes (each is killed if
    it outlives its limit). → per stage its exit code, seconds from its
    start to when it was found done, and stdout lines."""
    out = {}
    try:
        for stage, (t0, p) in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            out[stage] = {"rc": p.returncode, "seconds": time.perf_counter() - t0,
                          "stdout": stdout.splitlines(), "stderr": stderr[-2000:]}
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(30)
    return out


def trace_datagrams(names, slot: int, taken: int, seq0: int, per: int):
    """dv2 datagrams from the peer in lane ``slot``: one entry a name
    (capacity 1,000 tokens, the sender's own lane at ``taken``
    nanotokens), ``per`` entries a datagram. → (datagrams, next seq)."""
    from patrol_tpu_torch.ops import wire

    ents = [wire.DeltaEntry(n, slot, 1000 * NANO, 0, taken, 1) for n in names]
    out = []
    for at in range(0, len(ents), per):
        data, packed = wire.encode_delta_packet(slot, seq0 + len(out), (),
                                                ents[at:at + per], max_size=DV2_ROW)
        check(packed == len(ents[at:at + per]), f"a trace datagram packed {packed} entries")
        out.append(data)
    return out, seq0 + len(out)


def http_get(port: int, target: str, timeout: float = 120) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", target, headers={"Connection": "close"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def kernel_name(signature: str) -> str:
    """A kernel event's demangled signature → its function's name
    (``(anonymous namespace)::take_n_kernel(long long*, ...)`` →
    ``take_n_kernel``); a templated library kernel keeps its first 80
    characters."""
    import re

    m = re.match(r"(?:\(anonymous namespace\)::)?(\w+)\(", signature)
    return m.group(1) if m else signature[:80]


def trace_summary(path: str) -> dict:
    """A Chrome-trace JSON of ``cuda_trace`` → its window (the profiler's
    own span), kernel events by name, the device busy share (union of
    kernel, copy and memset intervals over the window), host ops by
    thread, and the lead-in: how far into the window the first host op,
    the first launch call and the first device event lie, and which
    launch calls have no device record (their correlation ids match no
    kernel), with their offsets."""
    import collections

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = next(e for e in events if e.get("cat") == "Trace"
                and str(e.get("name", "")).startswith("PyTorch Profiler"))
    w0, wdur = float(span["ts"]), float(span["dur"])
    xs = [e for e in events if e.get("ph") == "X" and e is not span]
    dev = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0)), w0 + wdur))
           for e in xs if e.get("cat") in DEVICE_CATS]
    busy = union_length([(a, b) for a, b in dev if b > a])
    kernels = [e for e in xs if e.get("cat") == "kernel"]
    by_name = collections.Counter(kernel_name(e["name"]) for e in kernels)
    launch_calls = [e for e in xs if e.get("cat") == "cuda_runtime"
                    and "Launch" in str(e.get("name", ""))]
    device_corr = {e.get("args", {}).get("correlation") for e in xs if e.get("cat") in DEVICE_CATS}
    unmatched = [round((float(e["ts"]) - w0) / 1e3, 3) for e in launch_calls
                 if e.get("args", {}).get("correlation") not in device_corr]
    cpu_ops = [e for e in xs if e.get("cat") == "cpu_op"]

    def first_ms(evs):
        return round((min(float(e["ts"]) for e in evs) - w0) / 1e3, 3) if evs else None

    return {
        "window_ms": wdur / 1e3, "events": len(events), "kernels": dict(by_name),
        "device_events": len(dev), "device_busy_share": busy / wdur if wdur else None,
        "cpu_ops": len(cpu_ops), "cpu_threads": len({e.get("tid") for e in cpu_ops}),
        "first_cpu_op_ms": first_ms(cpu_ops), "first_launch_call_ms": first_ms(launch_calls),
        "first_device_event_ms": first_ms([e for e in xs if e.get("cat") in DEVICE_CATS]),
        "launch_calls": len(launch_calls), "unmatched_launch_calls": len(unmatched),
        "unmatched_at_ms": unmatched[:32],
    }


def run_trace_leg(Command, LimiterConfig, _build, device: str = "cuda",
                  buckets: int = BUCKETS, lanes: int = LANES, names: int = TRACE_NAMES,
                  windows: bool = True) -> dict:
    """3k(d): one ``Command`` at the defaults (native front, native UDP
    backend, host lanes) on ``device``, with a peer socket in its member
    list. The peer's dv2 deltas bind ``names`` buckets (so their takes
    ride the device path: a bucket replication created first is not
    hosted). The Command prepares the profiler as it starts (its seconds
    are reported); a first capture of 0.5 s follows under load (its wall
    time is reported). Then three windows, each ``pt_http_blast``
    over those names for TRACE_BLAST_S while the peer sends a datagram
    of TRACE_DELTAS deltas every 50 ms: without a capture, under ``GET
    /debug/cuda/trace?seconds=2`` (the blast starts TRACE_LEAD_S into it,
    and an overlapping ``GET /debug/pprof/trace`` is sent 0.2 s after
    that), and without again. → takes/s of each window, the captures'
    statuses and wall times, the file and its size, the overlap's
    status, the launch counts (all, and ``decode_fold``'s while the peer
    sent inside the capture), and :func:`trace_summary` of the file.
    With ``windows`` false the leg ends after the first capture."""
    import socket

    from patrol_tpu_torch import native
    from patrol_tpu_torch.utils import profiling

    lib = native.load(required=True)
    peer = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    peer.bind(("127.0.0.1", 0))
    node_addr = f"127.0.0.1:{free_udp_port()}"
    peer_addr = f"127.0.0.1:{peer.getsockname()[1]}"
    members = sorted([node_addr, peer_addr])
    sender_slot = members.index(peer_addr)
    host, port = node_addr.rsplit(":", 1)
    dest = (host, int(port))
    tnames = [f"tr{i:06d}" for i in range(names)]
    out: dict = {}
    try:
        node = Node(Command(
            api_addr="127.0.0.1:0", node_addr=node_addr, peer_addrs=[node_addr, peer_addr],
            config=LimiterConfig(buckets=buckets, nodes=lanes), handle_signals=False,
            warmup=True, device=device,
        ))
    except BaseException:
        peer.close()
        raise
    try:
        cmd = node.cmd
        eng = cmd.engine
        out["trace_prepare_s"] = cmd.trace_prepare_s
        check(cmd.native_front is not None, "the native front was not taken by default")
        check(type(cmd.replicator).__name__ == "NativeReplicator",
              f"the native UDP backend was not taken by default: {type(cmd.replicator)}")
        # Half the capacity spent by the peer, and takes at 1,000 an hour:
        # no bucket refills to full during the run, so the GC's sweeps at
        # their defaults reclaim none of them (a reclaimed name would come
        # back hosted, and its takes would leave the device path).
        seq = 1
        taken = 500 * NANO
        binding, seq = trace_datagrams(tnames, sender_slot, taken, seq, 150)
        for d in binding:
            peer.sendto(d, dest)
        deadline = time.monotonic() + 60
        while any(eng.tokens_if_known(n) is None for n in (tnames[0], tnames[-1])):
            check(time.monotonic() < deadline, "the peer's deltas did not bind the trace names")
            time.sleep(0.05)
        check(eng.flush(60), "flush after binding timed out")
        out["hosted_after_binding"] = eng.hosted_buckets
        targets = "\n".join(f"/take/{n}?rate=1000:1h" for n in tnames).encode()
        rng = np.random.default_rng(20261020)

        def window(label: str, blast_s: float, may_stall: bool = False) -> dict:
            nonlocal seq, taken
            stop = threading.Event()
            sent = []

            def send():
                nonlocal seq, taken
                while not stop.wait(0.05):
                    taken += NANO
                    pick = [tnames[i] for i in rng.integers(0, len(tnames), TRACE_DELTAS)]
                    grams, seq = trace_datagrams(pick, sender_slot, taken, seq, TRACE_DELTAS)
                    peer.sendto(grams[0], dest)
                    sent.append(len(pick))

            res5 = np.zeros(5, np.uint64)
            sender = threading.Thread(target=send)
            df0 = _build.LAUNCHES["decode_fold"]
            sender.start()
            t = time.perf_counter()
            rc = lib.pt_http_blast(b"127.0.0.1", cmd.api_port, targets, 16, 8,
                                   int(blast_s * 1000), res5)
            wall = time.perf_counter() - t
            stop.set()
            sender.join(30)
            check(rc == 0, f"pt_http_blast failed: {rc}")
            done = int(res5[0])
            w = {"window": label, "seconds": wall, "requests": done, "takes_per_s": done / wall,
                 "p50_us": int(res5[1]) / 1e3, "p99_us": int(res5[2]) / 1e3,
                 "ok_200": int(res5[3]), "limited_429": int(res5[4]),
                 "deltas_sent": sum(sent), "decode_fold_launches": _build.LAUNCHES["decode_fold"] - df0}
            check((done > 0 or may_stall) and w["ok_200"] + w["limited_429"] == done,
                  f"the blast's answers are not all 200 or 429: {w}")
            return w

        window("warm-up", 0.5)
        check(eng.flush(60), "flush after the warm-up timed out")
        # The process's first capture, under the same load (blasts of 0.5 s
        # back to back until it answers): its wall time is what the route's
        # first caller waits, its trace shows whether a first capture loses
        # the window's first device records, and the blasts' counts show
        # how the node serves meanwhile (a blast may get no answer at all).
        first: dict = {"blasts": []}

        def first_capture():
            t = time.perf_counter()
            first["status"], first["body"] = http_get(cmd.api_port, "/debug/cuda/trace?seconds=0.5")
            first["wall_s"] = time.perf_counter() - t

        capturer = threading.Thread(target=first_capture)
        capturer.start()
        while capturer.is_alive():
            w = window("first capture", 0.5, may_stall=True)
            first["blasts"].append([w["requests"], round(w["takes_per_s"], 1)])
        capturer.join()
        check(first.get("status") == 200, f"the first /debug/cuda/trace answered {first}")
        first["trace"] = trace_summary(first["body"].strip().split(" ")[-1])
        out["first_capture"] = first
        out["counters"] = {k: profiling.COUNTERS.get(k)
                           for k in ("trace_captures", "trace_captures_busy")}
        if not windows:
            return out
        _build.reset_launches()
        out["without_1"] = window("without", TRACE_BLAST_S)
        cap: dict = {}
        overlap: dict = {}

        def capture():
            t = time.perf_counter()
            cap["status"], cap["body"] = http_get(cmd.api_port, f"/debug/cuda/trace?seconds={TRACE_S:g}")
            cap["wall_s"] = time.perf_counter() - t

        def overlapping():
            time.sleep(0.2)
            t = time.perf_counter()
            overlap["status"], overlap["body"] = http_get(cmd.api_port, "/debug/pprof/trace?seconds=1")
            overlap["wall_s"] = time.perf_counter() - t

        capturer = threading.Thread(target=capture)
        capturer.start()
        time.sleep(TRACE_LEAD_S)
        overlapper = threading.Thread(target=overlapping)
        overlapper.start()
        out["with"] = window("with", TRACE_BLAST_S)
        capturer.join(120)
        overlapper.join(120)
        check(not capturer.is_alive() and not overlapper.is_alive(), "a trace request hung")
        out["without_2"] = window("without", TRACE_BLAST_S)
        check(eng.flush(60), "flush after the trace leg timed out")
        out["launches"] = dict(_build.LAUNCHES)
        out["capture"] = cap
        out["overlap"] = overlap
        check(cap.get("status") == 200, f"/debug/cuda/trace answered {cap}")
        path = cap["body"].strip().split(" ")[-1]
        out["trace_path"] = path
        out["trace_bytes"] = os.path.getsize(path)
        out["trace"] = trace_summary(path)
        out["counters"] = {k: profiling.COUNTERS.get(k)
                           for k in ("trace_captures", "trace_captures_busy")}
    finally:
        try:
            node.close()
        finally:
            peer.close()
    return out


def trace_leg_child(prepare: bool = True) -> dict:
    """:func:`run_trace_leg` at full size on the card, for a fresh process
    (:func:`fresh_trace_leg_argv` starts it): a node whose process has
    never started the profiler, as a deployed one. With ``prepare``
    false (the soak's control) the node skips its start-up
    ``prepare_cuda_trace``, so the first capture does the profiler's
    set-up under load. Prints the leg's result as one JSON line and
    returns it."""
    sys.path.insert(0, HERE)
    from patrol_tpu_torch import native
    from patrol_tpu_torch.command import Command
    from patrol_tpu_torch.models.limiter import LimiterConfig
    from patrol_tpu_torch.ops import _build
    from patrol_tpu_torch.utils import profiling

    if not prepare:
        profiling.prepare_cuda_trace = lambda: 0.0
    native.load(required=True)
    _build.lib()
    out = run_trace_leg(Command, LimiterConfig, _build)
    print(json.dumps(out, default=str))
    return out


def fresh_trace_leg_argv(prepare: bool = True) -> list:
    """The command of a fresh-process trace leg (:func:`trace_leg_child`),
    with ``faulthandler`` on, so that a crash names every Python
    thread's frame."""
    return [sys.executable, "-X", "faulthandler", "-c",
            f"import chip_smoke; chip_smoke.trace_leg_child(prepare={prepare})"]


def run_fresh_trace_leg() -> dict:
    """3k(d) in a fresh process (:func:`trace_leg_child`), the kernels
    and the host library already built. → its result."""
    res = subprocess.run(fresh_trace_leg_argv(), cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    check(res.returncode == 0, f"the fresh trace leg exited {res.returncode}: {res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def trace_soak(argv: list) -> int:
    """``python3 chip_smoke.py --fresh-trace-legs N [--unprepared]``: N
    fresh-process trace legs, two at a time, after the kernels and the
    host library are built. ``--unprepared`` is the
    control: each node leaves the profiler's set-up to its first capture,
    under load. Prints one JSON line a leg (its exit code, whether it
    printed its result before it ended, the set-up's and the captures'
    seconds) and a summary line; every leg's standard error goes to
    ``chiprun_out/trace_soak/``. → 0 when every leg exited 0."""
    import argparse
    import concurrent.futures

    import torch

    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--fresh-trace-legs", type=int, required=True)
    ap.add_argument("--unprepared", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from patrol_tpu_torch import native
    from patrol_tpu_torch.ops import _build

    _build.build()
    _build.lib()
    native.load(required=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    out_dir = os.path.join(HERE, "chiprun_out", "trace_soak")
    os.makedirs(out_dir, exist_ok=True)
    argv_leg = fresh_trace_leg_argv(prepare=not args.unprepared)

    def leg(i: int) -> dict:
        t = time.perf_counter()
        try:
            res = subprocess.run(argv_leg, cwd=HERE, capture_output=True, text=True, timeout=600)
            rc, stdout, stderr = res.returncode, res.stdout, res.stderr
        except subprocess.TimeoutExpired as exc:
            rc, stdout, stderr = "timeout", "", str(exc.stderr)
        with open(os.path.join(out_dir, f"leg{i}.err"), "w") as f:
            f.write(stderr)
        lines = stdout.strip().splitlines()
        out = {"leg": i, "rc": rc, "wall_s": time.perf_counter() - t, "printed_result": bool(lines)}
        if lines:
            r = json.loads(lines[-1])
            out.update(prepare_s=r["trace_prepare_s"], first_capture_s=r["first_capture"]["wall_s"],
                       capture_s=r["capture"]["wall_s"], overlap=r["overlap"].get("status"))
        print(json.dumps(out), flush=True)
        return out

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        legs = list(pool.map(leg, range(args.fresh_trace_legs)))
    failed = [x["leg"] for x in legs if x["rc"] != 0]
    print(json.dumps({"trace_soak": {"legs": len(legs), "parallel": 2,
                                     "prepared": not args.unprepared, "failed": failed,
                                     "card": smi}}))
    return 1 if failed else 0


def run_check_stage_phase(torch, Command, LimiterConfig, _build) -> dict:
    """Phase 3k on the card: (c) the protocol and lin stages start as
    subprocesses, and beside them (a) the ABI stage with the fold's twins
    on ``join.cu``, (b) the lin pins on ``take.cu``, ``lifecycle.cu`` and
    ``cert.cu`` and (d) the trace leg's first capture in this process
    (which has opened profiler windows in earlier phases); once the
    stages are done, (d) the whole leg in a fresh process. Any failed
    check raises. → the phase's numbers."""
    t0 = time.perf_counter()
    from patrol_tpu_torch.ops.obligations import MUTATIONS as REGISTERED

    running = start_check_stages()
    try:
        _build.reset_launches()
        abi_stage = run_abi_stage("cuda")
        abi_launches = dict(_build.LAUNCHES)
        for name, res in abi_stage.items():
            check(res["findings"] == [], f"patrol-abi on the card, {name}: {res['findings'][:5]}")
        check(sum(abi_launches[k] for k in JOIN_LAUNCHES) > 0,
              f"the ABI stage's fold twins did not launch the join kernel: {abi_launches}")
        pins = run_lin_pins(_build, "cuda")
        for name, res in pins.items():
            check(res["mismatch_count"] == 0, f"lin pin {name} on the card: {res['mismatches']}")
            check(res["launches"] == res["calls"] > 0,
                  f"lin pin {name}: {res['launches']} launches of {LIN_PIN_KERNELS[name]} "
                  f"for {res['calls']} calls")
        torch.cuda.empty_cache()
        inproc = run_trace_leg(Command, LimiterConfig, _build, windows=False)
    finally:
        stages = finish_check_stages(running)
    # After the stages: their Python would compete with the profiler's
    # start-up in the fresh process.
    torch.cuda.empty_cache()
    tleg = run_fresh_trace_leg()
    for stage, res in stages.items():
        check(res["rc"] == 0, f"{stage}_repo exited {res['rc']}: {res['stdout'][-5:]} {res['stderr']}")
        for m in REGISTERED:
            if m.stage == stage:
                line = f"patrol-{stage}: mutation '{m.name}' REJECTED by {m.expect} (good)"
                check(line in res["stdout"], f"{stage}_repo printed no '{line}'")
    tsum = tleg["trace"]
    check(tleg["trace_prepare_s"] > 0,
          "the fresh node did not prepare the profiler as it started (ROADMAP C6)")
    check(tleg["overlap"].get("status") == 409,
          f"an overlapping /debug/pprof/trace answered {tleg['overlap']}")
    for label, summary in (("in-process first capture", inproc["first_capture"]["trace"]),
                           ("fresh first capture", tleg["first_capture"]["trace"]),
                           ("fresh capture", tsum)):
        names = summary["kernels"]
        check(names.get("take_n_kernel", 0) + names.get("join_kernel", 0) > 0,
              f"the {label} holds neither take_n_kernel nor join_kernel: {names}")
    if tleg["with"]["decode_fold_launches"] > 0:
        check(tsum["kernels"].get("decode_fold_kernel", 0) > 0,
              f"decode_fold launched {tleg['with']['decode_fold_launches']} times in the "
              f"capture, but the trace holds no decode_fold_kernel: {tsum['kernels']}")
    check(tleg["launches"]["take_n"] > 0, "the traced node's takes did not launch take_n")
    phase = {
        "abi": {"seconds": {k: v["seconds"] for k, v in abi_stage.items()},
                "launches": abi_launches},
        "lin_pins": {k: {kk: v[kk] for kk in ("calls", "columns", "seconds", "launches")}
                     for k, v in pins.items()},
        "stages": {k: {"seconds": v["seconds"], "summary": v["stdout"][-1]}
                   for k, v in stages.items()},
        "trace_in_process": inproc,
        "trace": tleg,
        "phase_s": time.perf_counter() - t0,
    }
    log(f"3k: {json.dumps(phase, default=str)}")
    print("3k abi on the card: clean; seconds a pass "
          f"{json.dumps({k: round(v, 3) for k, v in phase['abi']['seconds'].items()})}, "
          f"launches {json.dumps({k: v for k, v in abi_launches.items() if v})}")
    print("3k lin pins on the card, bit for bit: " + json.dumps(phase["lin_pins"]))
    print("3k stages (beside 3k(a), (b) and the in-process capture): " + json.dumps(
        {k: [round(v["seconds"], 2), v["summary"]] for k, v in phase["stages"].items()}))

    def lead(summary) -> str:
        return (f"first host op {summary['first_cpu_op_ms']} ms, launch call "
                f"{summary['first_launch_call_ms']} ms, device event "
                f"{summary['first_device_event_ms']} ms in; {summary['launch_calls']} launch "
                f"calls, {summary['unmatched_launch_calls']} without a device record at "
                f"{summary['unmatched_at_ms']} ms")

    for label, leg in (("in this process", inproc), ("fresh process", tleg)):
        first = leg["first_capture"]
        print(f"3k trace, {label}, profiler prepared at the node's start-up in "
              f"{leg['trace_prepare_s']:.3f} s, first capture of 0.5 s: {first['wall_s']:.3f} s wall "
              f"(blasts of 0.5 s meanwhile, [answers, takes/s]: {first['blasts']}); "
              + lead(first["trace"]))
    print(f"3k trace, fresh process, capture of 2 s: {tleg['capture']['wall_s']:.3f} s wall, "
          f"{tleg['trace_bytes']} B, overlap {tleg['overlap']['status']} in "
          f"{tleg['overlap']['wall_s']:.3f} s; kernels {json.dumps(tsum['kernels'])}; device busy "
          f"{tsum['device_busy_share']}; " + lead(tsum) + f"; host ops {tsum['cpu_ops']} on "
          f"{tsum['cpu_threads']} threads; takes/s without "
          f"{tleg['without_1']['takes_per_s']:.1f}, with {tleg['with']['takes_per_s']:.1f}, "
          f"without {tleg['without_2']['takes_per_s']:.1f}; phase {phase['phase_s']:.1f} s")
    return phase


def fold_timing(engine_mod, reps: int = 5) -> dict:
    """The tick fold on one clustered batch, 131,072 deltas over 64 rows
    and 64 lanes (the reference's motivating shape): host ns of the numpy
    fold and of the native one (median of ``reps``), whose outputs must
    be equal."""
    rng = np.random.default_rng(17)
    n = 131_072
    rows = rng.choice(rng.choice(BUCKETS, 64, replace=False), n).astype(np.int64)
    deltas = engine_mod.DeltaArrays(
        rows, rng.integers(0, LANES, n).astype(np.int64),
        *(rng.integers(0, 1 << 50, n).astype(np.int64) for _ in range(3)),
        np.zeros(n, bool),
    )
    dense_min = max(4, LANES // 3)
    times = {"numpy": [], "native": []}
    outs = {}
    for _ in range(reps):
        for name, fn in (("numpy", engine_mod.fold_hybrid_numpy),
                         ("native", engine_mod._fold_hybrid_native)):
            t0 = time.perf_counter_ns()
            outs[name] = fn(deltas, LANES, dense_min)
            times[name].append(time.perf_counter_ns() - t0)
    check(outs["native"] is not None, "the native fold refused the clustered batch")
    def same(a, b):
        if a is None or b is None:
            return a is None and b is None
        if isinstance(a, tuple):
            return all(np.array_equal(x, y) for x, y in zip(a, b))
        return np.array_equal(a, b)

    check(all(same(x, y) for x, y in zip(outs["numpy"], outs["native"])),
          "the native fold differs from the numpy fold")
    med = {k: statistics.median(v) for k, v in times.items()}
    return {"deltas": n, "rows": 64, "numpy_ns": med["numpy"], "native_ns": med["native"],
            "speedup": med["numpy"] / med["native"], "cpus": os.cpu_count()}


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
    from patrol_tpu_torch.ops import converge_kernel as ck
    from patrol_tpu_torch.ops import ingest_kernel as ik
    from patrol_tpu_torch.ops import join_kernel as jk
    from patrol_tpu_torch.ops import lifecycle as lops
    from patrol_tpu_torch.ops import lifecycle_kernel as lk
    from patrol_tpu_torch.ops import row_rmw_kernel as rk
    from patrol_tpu_torch.ops import take_kernel as tk
    from patrol_tpu_torch.runtime import engine as engine_mod
    from patrol_tpu_torch.runtime.engine import DeviceEngine
    from patrol_tpu_torch.runtime.repo import TPURepo
    from patrol_tpu_torch.utils import histogram as hist_mod
    from patrol_tpu_torch.utils import profiling

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

    # 1. Build: the native host library (C++ receive path, directory,
    # tick fold; g++) beside the CUDA kernels (nvcc), both from the
    # checkout's sources. A failed build raises.
    from patrol_tpu_torch import native

    host: dict = {}

    def build_host() -> None:
        t = time.perf_counter()
        try:
            native.load(required=True)
        except BaseException as exc:  # re-raised on the main thread
            host["error"] = exc
        host["s"] = time.perf_counter() - t

    host_thread = threading.Thread(target=build_host)
    host_thread.start()
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    report["build_s"] = time.perf_counter() - t0
    report["build_log"] = (so.parent / "build.log").read_text() if (so.parent / "build.log").exists() else ""
    report["ptxas"] = ptxas_lines(report["build_log"],
                                  ("take.cu", "decode_fold.cu", "join.cu", "lifecycle.cu",
                                   "cert.cu", "converge.cu"))
    report["join_sass"] = join_sass(so)
    sass = report["join_sass"]
    if sass is not None:
        check(sass["atom"] == 0 and sass["red_max_s64"] > 0,
              f"join_kernel's 64-bit max updates are not all reductions: {sass}")
    log(f"kernels built in {report['build_s']:.1f}s: {so}")
    host_thread.join()
    if "error" in host:
        raise host["error"]
    report["host_build_s"] = host["s"]
    log(f"host library built in {host['s']:.1f}s: {native.lib_path()}")

    # 2. Kernels against their plain versions.
    rng = np.random.default_rng(20261016)
    joins = join_checks(torch, jk, dev, rng)
    pair, row, tick, ring = joins["pair"], joins["row"], joins["tick"], joins["ring"]
    torch.cuda.empty_cache()
    take = take_checks(torch, tk, dev, rng)
    take["edges"] = take_edge_checks(torch, tk, dev, rng)
    torch.cuda.empty_cache()
    dfold = decode_fold_checks(torch, ik, dev, rng)
    dfold["edges"] = decode_fold_edge_checks(torch, ik, dev, rng)
    torch.cuda.empty_cache()
    rmw = row_rmw_checks(torch, rk, dev, rng)
    torch.cuda.empty_cache()  # the 4.1 GB probe state and its copies
    lrng = np.random.default_rng(20261017)
    life = lifecycle_checks(torch, lk, lops, dev, lrng)
    life["edges"] = lifecycle_edge_checks(torch, lk, lops, dev, lrng)
    torch.cuda.empty_cache()
    crng = np.random.default_rng(20261018)
    cert = cert_checks(torch, dev, crng)
    cert["edges"] = cert_edge_checks(torch, dev, crng)
    torch.cuda.empty_cache()
    conv = converge_checks(torch, ck, _build, dev)
    torch.cuda.empty_cache()
    log(f"joins: {json.dumps(joins)}")
    log(f"pair_join {pair['ms']:.4f} ms, row_join {row['ms']:.4f} ms, tick_join "
        f"{tick['ms']:.4f} ms (two launches {tick['two_launches_ms']:.4f} ms), ring warm "
        f"{ring['ms']:.4f} ms cold {ring['ms_cold']:.4f} ms, take_n {take['ms']:.4f} ms "
        f"(padding columns only {take['padding_only_ms']:.4f} ms), decode_fold "
        f"{dfold[512]['ms']:.4f} ms at P=512, {dfold[1]['ms']:.4f} ms at P=1 "
        f"(rejected at its length {dfold[1]['rejected_only_ms']:.4f} ms), row_rmw "
        f"{rmw['bcast']['ms']:.4f} ms bcast, {rmw['pairmax']['ms']:.4f} ms pairmax "
        f"(pair_join on its updates {rmw['pairmax']['pair_join_ms']:.4f} ms), lifecycle_probe "
        f"{life['ms']:.4f} ms at K={life['k']} (floor {life['floor_ms']:.4f} ms)")
    # The probe's launch shape: registers and shared memory from -Xptxas -v.
    life["ptxas"] = [ln for ln in report["ptxas"].get("lifecycle.cu", []) if "Used" in ln]
    print(f"lifecycle_probe K={life['k']}: warm {life['ms']:.6f} ms, cold {life['ms_cold']:.6f} "
          f"ms (consecutive rows {life['ms_cold_contig']:.6f}), K=512 {life['ms_k512']:.6f} ms, "
          f"K=8 {life['floor_ms']:.6f} ms, plain {life['plain_ms']:.6f} ms, bound "
          f"{bound(life['bytes'], life['ops'])[0]:.6f} ms, max_abs_err "
          f"{max(life['max_abs_err'], life['edges']['max_abs_err'])}; ptxas: "
          f"{' '.join(life['ptxas'])}")
    # The cert kernels' launch shapes, and each family beside its bounds.
    cert["ptxas"] = [ln for ln in report["ptxas"].get("cert.cu", [])
                     if "Used" in ln or "entry function" in ln]
    for family in CERT_FAMILIES:
        m = cert[family]
        print(f"{family}_admit (one launch) K={m['k']}: warm {m['ms']:.6f} ms, cold "
              f"{m['ms_cold']:.6f} ms, "
              f"K=512 {m['ms_k512']:.6f} ms, K=8 {m['floor_ms']:.6f} ms, plain "
              f"{m['plain_ms']:.6f} ms, library {m['library_ms']:.6f} ms, bound "
              f"{bound(m['bytes'], m['ops'])[0]:.6f} ms, max_abs_err "
              f"{max(m['max_abs_err'], cert['edges']['max_abs_err'])}")
    print("cert.cu ptxas: " + " | ".join(cert["ptxas"]))
    conv_ptxas = [ln for ln in report["ptxas"].get("converge.cu", []) if "Used" in ln]
    for name in ("converge", "mesh_gather"):
        m = conv[name]
        print(f"{name} R={m['shape']['R']} T={m['shape']['T']} N={m['shape']['N']}: warm "
              f"{m['ms']:.6f} ms, cold {m['ms_cold']:.6f} ms, T=1 {m['floor_ms']:.6f} ms, plain "
              f"{m['plain_ms']:.6f} ms, library {m['library_ms']:.6f} ms, bound "
              f"{bound(m['bytes'], m['ops'])[0]:.6f} ms, max_abs_err {m['max_abs_err']} over "
              f"{m['shapes_checked']} shapes")
    print("converge.cu ptxas: " + " | ".join(conv_ptxas))
    print("cert grid: " + json.dumps(cert["grid"]))
    report["kernel_detail"] = {
        "pair_join": pair, "row_join": row, "tick_join": tick, "commit_ring": ring,
        "take_n": take,
        "decode_fold_p512": dfold[512], "decode_fold_p1": dfold[1],
        "decode_fold_edges": dfold["edges"],
        "row_rmw_bcast": rmw["bcast"], "row_rmw_pairmax": rmw["pairmax"],
        "lifecycle_probe": life,
        "cert": cert,
        "converge": conv,
    }

    # 3. The main path. Phases 3, 3b, 3c and 3e run the asyncio front with
    # the host fast path off (the engine module's switch, as the tests set
    # it), as they did before host lanes and the native front became the
    # defaults, so their numbers stay comparable; 3f and 3g run the
    # defaults. Phases 3-3g also pin the GC window to 0 (the feeder never
    # sweeps), so their windows stay comparable with the runs before GC
    # was on by default; 3h runs GC at its defaults.
    engine_mod.HOST_FASTPATH = False
    gc_window = engine_mod.GC_WINDOW_NS
    engine_mod.GC_WINDOW_NS = 0
    trace = make_trace(np.random.default_rng(7))
    clock_now = 1_700_000_000 * NANO
    cfg = LimiterConfig(buckets=BUCKETS, nodes=LANES)
    cmd = Command(
        api_addr="127.0.0.1:0", node_addr=f"127.0.0.1:{free_udp_port()}",
        clock=Clock(clock_now), config=cfg, handle_signals=False, warmup=True,
        device="cuda", http_front="python",
    )
    node = Node(cmd)
    try:
        engine, repo = cmd.engine, cmd.repo
        split0 = commit_split(hist_mod, profiling)
        native_folds0 = profiling.COUNTERS.get("fold_native_ticks")
        _build.reset_launches()
        outcomes, t_deltas, t_takes, join_profile = run_trace(
            engine, repo, trace, hold=True, profile=True
        )
        native_folds = profiling.COUNTERS.get("fold_native_ticks") - native_folds0
        http_out = drive_http(cmd.api_port)
        check(engine.flush(120), "flush after HTTP timed out")
        launches = dict(_build.LAUNCHES)
        split = commit_split(hist_mod, profiling, split0)
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
    # How many ticks fold in C++ depends on how the hot-row burst falls
    # into ticks (a tick of 1,024 deltas or more on few rows): printed,
    # not held to a count. The fold itself is held to numpy below.
    log(f"main path: launches {launches}, ticks {ticks}, commits {split}, "
        f"fold_native_ticks {native_folds}")
    log(f"phase 3 deltas under the profiler: {json.dumps(join_profile)}")
    join_launches = launches["pair_join"] + launches["row_join"] + launches["tick_join"]
    check(join_launches > 0, "the join kernel was not launched on the main path")
    check(launches["take_n"] > 0, "kernel take_n was not launched on the main path")

    # The same trace, then the HTTP script's takes, through a CPU engine
    # (the kernels' plain versions).
    ceng = DeviceEngine(cfg, node_slot=0, clock=Clock(clock_now), device="cpu")
    try:
        crepo = TPURepo(ceng)
        c_outcomes, _, _, _ = run_trace(ceng, crepo, trace)
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
        "commits": split,
        "fold_native_ticks": native_folds,
        "join_profile": join_profile,
        "stages": stages,
    }
    report["main_path"] = main
    main["fold_timing"] = fold_timing(engine_mod)
    log(f"tick fold, 131,072 deltas over 64 rows: {json.dumps(main['fold_timing'])}")
    print(f"fold_native_ticks {native_folds} fold_hybrid_ns numpy "
          f"{main['fold_timing']['numpy_ns']:.0f} native {main['fold_timing']['native_ns']:.0f}")
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

    # 3c. Two replicated nodes over loopback UDP, asyncio backend; 3e. the
    # same traffic on the native backend.
    two = run_two_nodes(Command, LimiterConfig, np.random.default_rng(13), "asyncio")
    report["two_nodes"] = two
    log_two_nodes("3c asyncio", two)
    torch.cuda.empty_cache()
    two_n = run_two_nodes(Command, LimiterConfig, np.random.default_rng(13), "native")
    report["two_nodes_native"] = two_n
    log_two_nodes("3e native", two_n)
    print(f"two_nodes_converge_s {two['converge_s']:.3f} (asyncio) "
          f"{two_n['converge_s']:.3f} (native)")
    print(f"native decode_fold launches {two_n['decode_fold_planes']['launches']} "
          f"mean P {two_n['decode_fold_planes']['mean_p']:.3f} "
          f"P histogram {json.dumps(two_n['decode_fold_planes']['by_p'])}")
    torch.cuda.empty_cache()

    # 3f. One node at the defaults: the native front, the native host
    # store, the host fast path on.
    engine_mod.HOST_FASTPATH = True
    res_leg = run_residency_leg(Command, LimiterConfig, engine_mod, np.random.default_rng(17))
    report["residency"] = res_leg
    log(f"3f residency: {json.dumps(res_leg)}")
    for window in ("cold", "warm", "warm_1x1"):
        w = res_leg[window]
        print(f"native_front {window} rps {w['rps']:.1f} p50_us {w['p50_us']:.1f} p99_us "
              f"{w['p99_us']:.1f} 200 {w['ok_200']} 429 {w['limited_429']} in_front "
              f"{w['in_front_takes']} python_host {w['python_host_takes']} device "
              f"{w['device_takes']} promotions {w['promotions']} take_n "
              f"{w['launches']['take_n']} join "
              f"{w['launches']['pair_join'] + w['launches']['row_join'] + w['launches']['tick_join']}")
    torch.cuda.empty_cache()
    promo = run_promotion_leg(Command, LimiterConfig, engine_mod)
    report["promotion"] = promo
    log(f"3f promotion/demotion: {json.dumps(promo)}")
    print(f"promotion leg: {promo['promotions']} promoted, {promo['demotions']} demoted, "
          f"launches {json.dumps(promo['launches'])}, paths {json.dumps(promo['paths'])}, "
          f"outcomes and states equal the CPU replay")
    torch.cuda.empty_cache()

    # 3g. Two nodes at the defaults: phase 3c's traffic with every name
    # hosted on both nodes, on the native UDP backend.
    two_d = run_two_nodes(Command, LimiterConfig, np.random.default_rng(13), "native",
                          defaults=True)
    report["two_nodes_defaults"] = two_d
    log_two_nodes("3g defaults", two_d)
    log(f"3g hosting: {json.dumps(two_d['hosting'])}")
    hosted_launches = two_d["counters"].get("ingest_raw_hosted_dispatches", 0)
    print(f"defaults two_nodes_converge_s {two_d['converge_s']:.3f} decode_fold launches "
          f"{two_d['launches']['decode_fold']} ({hosted_launches} with a hosted entry, "
          f"{two_d['launches']['decode_fold'] - hosted_launches} without), entries absorbed "
          f"through hosted_mask {two_d['counters'].get('ingest_raw_hosted_absorbed', 0)}")
    torch.cuda.empty_cache()

    # 3i. The certified families through the engine's entry points, at the
    # defaults (GC window still pinned to 0); replayed on the CPU.
    t0 = time.perf_counter()
    cphase = run_cert_phase(Command, LimiterConfig, engine_mod, torch)
    cphase["phase_s"] = time.perf_counter() - t0
    report["cert_phase"] = cphase
    log(f"3i cert families: {json.dumps(cphase, default=str)}")
    cprof = cphase["profile"]
    print(f"cert 3i: leg {json.dumps(cphase['leg'])}, {3 * CERT_BATCHES} microbatches of "
          f"K={CERT_K} in {cphase['seconds']:.2f} s, host us a call p50 "
          f"{json.dumps(cphase['call_us_p50'])} p99 {json.dumps(cphase['call_us_p99'])} (idle "
          f"engine, gcra: {cphase['idle_gcra_call_us_p50']:.1f}), launches "
          f"{json.dumps({k: cphase['launches'][k] for k in CERT_LAUNCHES})}, "
          f"profiled {json.dumps({k: v['count'] for k, v in cprof['kernels'].items()})} device us "
          f"{json.dumps({k: round(v['device_us'], 3) for k, v in cprof['kernels'].items()})}, "
          f"device busy {cprof['device_busy_share']}, scrapes {json.dumps(cphase['scrapes'])}; "
          f"equal to the CPU replay; phase {cphase['phase_s']:.1f} s")
    print("cert 3i host us a call by step, p50 / p99: " + json.dumps({
        f: {k: [round(v["p50"], 1), round(v["p99"], 1)] for k, v in steps.items()}
        for f, steps in cphase["call_steps_us"].items()}))
    torch.cuda.empty_cache()

    # 3j. The mesh: MeshEngine over cuda:0 x 8 at R = 2, 4 and 1 and a
    # resize, the device path as phase 3 runs it (host fast path and GC
    # off); each leg replayed on a CPU MeshEngine.
    engine_mod.HOST_FASTPATH = False
    t0 = time.perf_counter()
    mesh = run_mesh_phase(torch)
    mesh["phase_s"] = time.perf_counter() - t0
    engine_mod.HOST_FASTPATH = True
    report["mesh"] = mesh
    log(f"3j mesh: {json.dumps(mesh, default=str)}")
    for key in ("r2", "r4", "r1"):
        m = mesh[key]
        st, prof = m["stats"], m["profile"]
        print(f"mesh 3j {key}: deltas/s {m['deltas_per_s']:.1f} takes/s {m['takes_per_s']:.1f} "
              f"dispatches {m['steps']['dispatches']} ({m['steps']['with_takes']} with takes, "
              f"{st['mesh_split_ticks']} split ticks), launches "
              f"{json.dumps({k: m['launches'][k] for k in ('pair_join', 'take_n', 'mesh_gather', 'converge')})}, "
              f"device busy {prof['device_busy_share']}, profiled "
              f"{json.dumps({k: [v['count'], round(v['device_us'], 3)] for k, v in prof['kernels'].items()})}; "
              f"host us a dispatch p50 "
              f"{json.dumps({k: round(v['p50'], 1) for k, v in m['steps']['dispatch_us'].items() if v})}, "
              f"fold p50 {m['steps']['fold_us']['p50']:.1f}; equal to the CPU replay")
    print(f"mesh 3j resize 2 -> 4 -> 2 under {MESH_RESIZE_TAKES} takes in "
          f"{mesh['r2']['resize_s']:.3f} s, launches "
          f"{json.dumps({k: v for k, v in mesh['r2']['resize_launches'].items() if v})}, every take "
          f"answered and equal to the CPU replay; phase {mesh['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 3h. The bucket lifecycle at the defaults: bind, sweep, re-create,
    # shed, checkpoint; replayed on a CPU engine.
    engine_mod.GC_WINDOW_NS = gc_window
    t0 = time.perf_counter()
    lc = run_lifecycle_phase(engine_mod, torch)
    lc["phase_s"] = time.perf_counter() - t0
    report["lifecycle"] = lc
    log(f"3h lifecycle: {json.dumps(lc, default=str)}")
    prof = lc.get("profile", {}).get("kernels", {}).get("lifecycle_probe_kernel", {})
    window_launches = lc.get("profile", {}).get("launches", {}).get("lifecycle_probe")
    print(f"lifecycle 3h: bound {lc['bound']} reclaimed {lc['reclaimed']} (device "
          f"{lc['reclaimed_device']}, host {lc['reclaimed_host']}) in {lc['cadence_sweeps']} "
          f"cadence + {lc['forced_sweeps']} forced sweeps, probe launches "
          f"{lc['probe_launches']} (device time {prof.get('device_us')} us over "
          f"{prof.get('count')} profiled of the window's {window_launches}), sweep p50 "
          f"{lc['gc_sweep_ns']['p50']} ns p99 "
          f"{lc['gc_sweep_ns']['p99']} ns, tombstones {lc['tombstones']}, sheds "
          f"{lc['shed_tickets']}, pressure sweeps {lc['pressure_sweeps']}, checkpoint "
          f"{lc['checkpoint_bytes']} B save {lc['save_s']:.3f} s restore {lc['restore_s']:.3f} s; "
          f"equal to the CPU replay; phase {lc['phase_s']:.1f} s")
    torch.cuda.empty_cache()

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

    # 3k. The check stages on the card (ABI with the fold's twins on
    # join.cu, the lin pins on take.cu, lifecycle.cu and cert.cu, the
    # protocol and lin stages as subprocesses), then a device trace of a
    # live node through /debug/cuda/trace.
    k3 = run_check_stage_phase(torch, Command, LimiterConfig, _build)
    report["check_stages"] = k3
    abi_launches, tleg = k3["abi"]["launches"], k3["trace"]
    torch.cuda.empty_cache()

    # 4. The kernels line, the card, the contract line.
    kernels = []
    for name, src, replaces, m, n in (
        # One join kernel behind three wrappers: each entry's launches are
        # the kernel's on the main path, through any wrapper (its own
        # wrapper's count rides along as wrapper_launches).
        ("pair_join", "patrol_tpu_torch/csrc/join.cu", "patrol_tpu/ops/pallas_merge.py:86",
         pair, join_launches),
        ("row_join", "patrol_tpu_torch/csrc/join.cu", "patrol_tpu/ops/pallas_merge.py:86",
         row, join_launches),
        ("tick_join", "patrol_tpu_torch/csrc/join.cu", "patrol_tpu/ops/pallas_merge.py:86",
         tick, join_launches),
        ("take_n", "patrol_tpu_torch/csrc/take.cu", "patrol_tpu/ops/take.py:171",
         take, launches["take_n"]),
        # Timed at the ring batch (P = 512); launches are those of the two
        # replicated nodes on the native backend (phase 3e, the rx ring's
        # batches); phase 3c's asyncio launches (P = 1 each) and the P = 1
        # numbers ride along.
        ("decode_fold", "patrol_tpu_torch/csrc/decode_fold.cu", "patrol_tpu/ops/ingest.py:589",
         dfold[512], two_n["launches"]["decode_fold"]),
        # Timed as pairmax (the join); bcast rides along under *_bcast.
        # Launches are those of the probe's entry point (phase 3d).
        ("row_rmw", "patrol_tpu_torch/csrc/row_rmw.cu", "scripts/probe_dma_scatter.py:86",
         rmw["pairmax"], probe_launches["row_rmw"]),
        # Timed at K = 8192 (GC_SWEEP_MAX) on the 1M x 64 state; launches
        # are those of phase 3h's sweeps.
        ("lifecycle_probe", "patrol_tpu_torch/csrc/lifecycle.cu",
         "patrol_tpu/ops/lifecycle.py:69", life, lc["launches"]["lifecycle_probe"]),
        # Each family timed as one call (its one launch) at K = 8192 on the
        # 1M x 64 state; launches are phase 3i's.
        ("gcra_admit", "patrol_tpu_torch/csrc/cert.cu", "patrol_tpu/ops/gcra.py:69",
         cert["gcra"], cphase["launches"]["gcra_admit"]),
        ("conc_admit", "patrol_tpu_torch/csrc/cert.cu", "patrol_tpu/ops/concurrency.py:73",
         cert["conc"], cphase["launches"]["conc_admit"]),
        ("quota_admit", "patrol_tpu_torch/csrc/cert.cu", "patrol_tpu/ops/hierquota.py:79",
         cert["quota"], cphase["launches"]["quota_admit"]),
        # Timed at R = 2, T = 4,096 take rows on the 1M x 64 state;
        # launches are phase 3j's R = 2 leg (once a dispatch with takes).
        ("converge", "patrol_tpu_torch/csrc/converge.cu", "patrol_tpu/parallel/topology.py:182",
         conv["converge"], mesh["r2"]["launches"]["converge"]),
        # The scratch gather beside it: inside the reference's jitted
        # cluster_step (topology.py:199), not a kernel of its own there.
        ("mesh_gather", "patrol_tpu_torch/csrc/converge.cu", "patrol_tpu/parallel/topology.py:199",
         conv["mesh_gather"], mesh["r2"]["launches"]["mesh_gather"]),
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
                "max_abs_err": max(m["max_abs_err"], m1["max_abs_err"],
                                   dfold["edges"]["max_abs_err"]),
                "ms_p1": m1["ms"], "plain_ms_p1": m1["plain_ms"], "bound_ms_p1": b1,
                "bound_by_p1": by1, "library_ms_p1": m1["library_ms"],
                "rejected_only_ms": m1["rejected_only_ms"],
                "mean_p": two_n["decode_fold_planes"]["mean_p"],
                "p_histogram": two_n["decode_fold_planes"]["by_p"],
                "launches_asyncio": two["launches"]["decode_fold"],
            })
        # This slice's paths, each counted from zero around its own run:
        # the residency leg (3f, defaults), the promotion leg (3f) and the
        # two nodes at the defaults (3g).
        for path, counts in (("3f_cold", res_leg["cold"]["launches"]),
                             ("3f_warm", res_leg["warm"]["launches"]),
                             ("3f_warm_1x1", res_leg["warm_1x1"]["launches"]),
                             ("3f_promotion", promo["launches"]),
                             ("3g", two_d["launches"]),
                             ("3i", cphase["launches"]),
                             ("3h", lc["launches"]),
                             ("3j_r2", mesh["r2"]["launches"]),
                             ("3j_r4", mesh["r4"]["launches"]),
                             ("3j_r1", mesh["r1"]["launches"]),
                             ("3j_resize", mesh["r2"]["resize_launches"]),
                             ("3k_abi", abi_launches),
                             ("3k_lin", {LIN_PIN_KERNELS[k]: v["launches"]
                                         for k, v in k3["lin_pins"].items()}),
                             ("3k_trace", tleg["launches"])):
            if name in ("pair_join", "row_join", "tick_join"):
                entry[f"launches_{path}"] = sum(counts.get(k, 0) for k in JOIN_LAUNCHES)
            elif name != "row_rmw":
                entry[f"launches_{path}"] = counts.get(name, 0)
        if name == "decode_fold":
            entry["hosted_launches_3g"] = two_d["counters"].get("ingest_raw_hosted_dispatches", 0)
        if name in ("pair_join", "row_join", "tick_join"):
            entry["wrapper_launches"] = launches[name]
            entry.update({key: m[key] for key in m if key.startswith(("floor_ms", "ms_", "two_"))})
        if name == "pair_join":
            entry["max_abs_err"] = max(m["max_abs_err"], ring["max_abs_err"])
            # The J = 8 commit ring, through commit_packed's live prefix.
            entry["ring"] = {
                **{key: ring[key] for key in ring if "bytes" not in key and key != "ops"},
                "bound_ms": bound(ring["bytes"], ring["ops"])[0],
                "bound_ms_sectors": bound(ring["bytes_sectors"], ring["ops"])[0],
                "bound_ms_cold": bound(ring["bytes_cold"], ring["ops"])[0],
                "bound_ms_sectors_cold": bound(ring["bytes_sectors_cold"], ring["ops"])[0],
            }
        if name == "take_n":
            entry["max_abs_err"] = max(m["max_abs_err"], m["edges"]["max_abs_err"])
            entry["padding_only_ms"] = m["padding_only_ms"]
        if name in CERT_LAUNCHES:
            entry["max_abs_err"] = max(m["max_abs_err"], cert["edges"]["max_abs_err"])
            entry.update({key: m[key] for key in ("floor_ms", "ms_cold", "ms_k512", "k")})
            entry["grid"] = cert["grid"][name.split("_")[0]]
        if name in ("converge", "mesh_gather"):
            entry.update({key: m[key] for key in ("floor_ms", "ms_cold", "shape",
                                                   "shapes_checked")})
        if name == "lifecycle_probe":
            entry["max_abs_err"] = max(m["max_abs_err"], m["edges"]["max_abs_err"])
            entry.update({key: m[key] for key in ("floor_ms", "ms_cold", "ms_cold_contig",
                                                   "ms_k512")})
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
    sys.exit(trace_soak(sys.argv[1:]) if sys.argv[1:] else main())
