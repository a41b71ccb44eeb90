"""Mesh serving on one card: the counterpart of
``patrol_tpu/parallel/topology.py``.

The reference lays ``pn[B, N, 2]`` / ``elapsed[B]`` over a 2-D
``jax.sharding.Mesh``: the bucket axis ``"b"`` splits the rows into
shards, and the replica axis ``"r"`` holds R full copies of each shard.
Every dispatch routes each take to its row's home block (replica
``row % R``, the row's shard), spreads merges over the replicas
round-robin, runs merge → take → converge in every block, and the
converge (a signed int64 max over the R copies) leaves every replica
with the join.

Between dispatches all R replicas of a shard hold identical planes: every
fused step ends in a converge, and every other writer (promotion drain,
scalar merges, GC's ``zero_rows``, checkpoint restore, ``place_state``)
writes all replicas alike. So on one card the port keeps ONE canonical
copy of the state, exactly as the single-device engine does, and makes
per-replica copies only of what one dispatch can make differ: the rows
its takes touch. :func:`mesh_step` is that dispatch:

1. gather the T distinct take rows into a scratch of R copies
   (``int64[R, T, N, 2]``, ``int64[R, T]``; ``ops/converge_kernel.py``);
2. join each block's merges: those of a take row into its replica's
   copy in the scratch, all others straight into the canonical rows
   (every replica would end with them anyway);
3. run take-n on the copy of each take's block;
4. converge: the signed max over the R copies, written back to the
   canonical rows.

That is bit for bit the reference's step, including a take whose lane
wraps past 2^63 (the max then picks another replica's unwrapped copy). At
R = 1 the canonical rows are the only copy: merges, then take-n on them.
:func:`cluster_step` is the plain R-copy transcription that it is held to
in the tests.

The host routing (:class:`MeshPlan`, :func:`plan_for`,
:func:`delta_block_assignment`, :func:`route_packed`,
:func:`route_requests`) is the reference's numpy, copied. A mesh here is
a list of torch devices that may repeat: ``cuda:0`` × 8 is a 2 × 4 mesh
on one card, ``cpu`` × 8 the same in the tests. A list that names more
than one distinct device raises :class:`NotPortedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from patrol_tpu_torch.models.limiter import LimiterConfig, LimiterState, resolve_device
from patrol_tpu_torch.ops import converge_kernel
from patrol_tpu_torch.ops.join_kernel import pair_join
from patrol_tpu_torch.ops.merge import MergeBatch, merge_batch
from patrol_tpu_torch.ops.take import TAKE_RESULT_ROWS, take_n_batch

REPLICA_AXIS = "r"
BUCKET_AXIS = "b"

# Packed-matrix layouts of one dispatch (the reference's staged transfer
# shape): ONE int64[8, B·k_t] take matrix and ONE int64[5, B·k_m] merge
# matrix, each block's columns contiguous, blocks replica-major.
TAKE_MAT_ROWS = 8  # rows, now_ns, freq, per_ns, count_nt, nreq, cap, created
MERGE_MAT_ROWS = 5  # rows, slots, added_nt, taken_nt, elapsed_ns


class NotPortedError(ValueError):
    """A configuration that needs a part of the system not ported yet."""


def local_devices(device="cuda") -> list:
    """Every local device of ``device``'s platform: each CUDA card, or the
    one CPU. Asking for CUDA without a card raises (no fallback)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def _canonical(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (replicas × shards) grid of devices, replica-major; ``shape`` is
    keyed by axis name as a ``jax.sharding.Mesh``'s is. Every entry is
    the same device (:func:`make_mesh`)."""

    devices: Tuple[torch.device, ...]
    shape: Dict[str, int]

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def check_one_device(devices) -> None:
    """Raise :class:`NotPortedError` unless ``devices`` name at most one
    distinct device (a layout over several cards is not ported)."""
    distinct = {_canonical(d) for d in devices}
    if len(distinct) > 1:
        raise NotPortedError(
            f"a mesh over {len(distinct)} distinct devices is not yet ported "
            "(its blocks must share one device)"
        )


def make_mesh(replicas: int = 1, devices=None) -> Mesh:
    """A (replicas × shards) mesh over ``devices`` (default: every local
    CUDA card). ``replicas`` must divide the device count; the remainder
    becomes the bucket axis. The entries may repeat one device; more than
    one distinct device raises :class:`NotPortedError`."""
    devices = [_canonical(d) for d in (devices if devices is not None else local_devices())]
    n = len(devices)
    if replicas < 1 or n % replicas:
        raise ValueError(f"{replicas} replicas do not divide {n} devices")
    check_one_device(devices)
    return Mesh(tuple(devices), {REPLICA_AXIS: replicas, BUCKET_AXIS: n // replicas})


# -- the join over replica stacks (plain) --------------------------------------


def tree_join_states(a: LimiterState, b: LimiterState) -> LimiterState:
    """One interior node of the converge tree: elementwise signed max of
    both planes."""
    return LimiterState(pn=torch.maximum(a.pn, b.pn), elapsed=torch.maximum(a.elapsed, b.elapsed))


def _butterfly(pn: torch.Tensor, elapsed: torch.Tensor) -> LimiterState:
    """log2(R) rounds of recursive doubling over a power-of-two stack:
    round k joins index i with index i XOR 2^k, so every index ends
    with the join (the reference's ``ppermute`` schedule)."""
    r = pn.shape[0]
    step = 1
    while step < r:
        idx = torch.arange(r, device=pn.device) ^ step
        pn = torch.maximum(pn, pn[idx])
        elapsed = torch.maximum(elapsed, elapsed[idx])
        step <<= 1
    return LimiterState(pn=pn, elapsed=elapsed)


def tree_reduce_states(pn: torch.Tensor, elapsed: torch.Tensor) -> LimiterState:
    """Reduce R stacked replica states (``pn[R, B, N, 2]``,
    ``elapsed[R, B]``) to their join: the butterfly for a power-of-two
    R, a flat max otherwise. Max is associative, commutative and
    idempotent, so both schedules give the same bits."""
    r = pn.shape[0]
    if r > 1 and r & (r - 1) == 0:
        st = _butterfly(pn, elapsed)
        return LimiterState(pn=st.pn[0], elapsed=st.elapsed[0])
    return LimiterState(pn=pn.amax(dim=0), elapsed=elapsed.amax(dim=0))


def converge(
    pn: torch.Tensor, elapsed: torch.Tensor, replicas: Optional[int] = None
) -> LimiterState:
    """The cross-replica join over ``[R, ...]`` stacks, returned as
    stacks in which every replica holds the join: the butterfly with a
    power-of-two ``replicas``, else the flat max. On one card both are
    the one converge kernel (:mod:`patrol_tpu_torch.ops.converge_kernel`);
    this is their plain form."""
    if replicas is not None and replicas > 1 and replicas & (replicas - 1) == 0:
        return _butterfly(pn, elapsed)
    return LimiterState(
        pn=pn.amax(dim=0, keepdim=True).expand_as(pn).clone(),
        elapsed=elapsed.amax(dim=0, keepdim=True).expand_as(elapsed).clone(),
    )


# -- host routing (the reference's numpy) ---------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Host-side routing geometry for a mesh deployment."""

    replicas: int
    shards: int
    rows_per_shard: int

    @property
    def blocks(self) -> int:
        return self.replicas * self.shards

    def locate(self, global_row: int) -> Tuple[int, int, int]:
        """→ (home_replica, shard, local_row) for a bucket row."""
        shard, local_row = divmod(global_row, self.rows_per_shard)
        return global_row % self.replicas, shard, local_row

    def block_index(self, replica: int, shard: int) -> int:
        return replica * self.shards + shard


def plan_for(mesh: Mesh, config: LimiterConfig) -> MeshPlan:
    shards = mesh.shape[BUCKET_AXIS]
    if config.buckets % shards:
        raise ValueError(f"{shards} shards do not divide {config.buckets} buckets")
    return MeshPlan(
        replicas=mesh.shape[REPLICA_AXIS],
        shards=shards,
        rows_per_shard=config.buckets // shards,
    )


def route_requests(
    plan: MeshPlan,
    takes,  # sequence of (global_row, now_ns, freq, per_ns, count_nt, nreq, cap_base_nt, created_ns)
    deltas,  # sequence of (global_row, slot, added_nt, taken_nt, elapsed_ns)
    k_take: int,
    k_merge: int,
    deltas_to_home: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack host requests into the (replica-major, shard-minor) block
    layout: → ``(take_mat, merge_mat)``. Each take lands in its home
    block; deltas spread round-robin over replicas unless
    ``deltas_to_home``. Overflowing a block raises."""
    take_mat, merge_mat, _placed = route_packed(
        plan, takes, deltas, k_take, k_merge, deltas_to_home=deltas_to_home
    )
    return take_mat, merge_mat


def delta_block_assignment(
    plan: MeshPlan, rows_a: np.ndarray, deltas_to_home: bool = False
) -> np.ndarray:
    """The delta → block rule: shard from the row, replica round-robin by
    arrival index (or the row's home replica with ``deltas_to_home``)."""
    K = len(rows_a)
    shard = rows_a // plan.rows_per_shard
    replica = (
        rows_a % plan.replicas
        if deltas_to_home
        else np.arange(K, dtype=np.int64) % plan.replicas
    )
    return replica * plan.shards + shard


def route_packed(
    plan: MeshPlan,
    takes,
    deltas,
    k_take: int,
    k_merge: int,
    take_out: Optional[np.ndarray] = None,
    merge_out: Optional[np.ndarray] = None,
    deltas_to_home: bool = False,
    delta_blocks: Optional[np.ndarray] = None,
):
    """Fill (or allocate) the int64 ``[TAKE_MAT_ROWS, B·k_take]`` and
    ``[MERGE_MAT_ROWS, B·k_merge]`` matrices in block layout; → ``(take_mat,
    merge_mat, placed)`` with ``placed`` the ``(block, slot-in-block)`` of
    each take in input order. Caller-leased ``*_out`` buffers are zeroed
    first: padding entries read as (row 0, slot 0, zeros)."""
    B = plan.blocks
    if take_out is None:
        take_mat = np.zeros((TAKE_MAT_ROWS, B * k_take), dtype=np.int64)
    else:
        take_mat = take_out
        take_mat[:] = 0
    if merge_out is None:
        merge_mat = np.zeros((MERGE_MAT_ROWS, B * k_merge), dtype=np.int64)
    else:
        merge_mat = merge_out
        merge_mat[:] = 0

    placed: list = []
    fill_t = [0] * B
    for row, now_ns, freq, per_ns, count_nt, nreq, cap_base_nt, created_ns in takes:
        replica, shard, local = plan.locate(row)
        blk = plan.block_index(replica, shard)
        i = fill_t[blk]
        if i >= k_take:
            raise ValueError(f"take block {blk} overflow (k_take={k_take})")
        at = blk * k_take + i
        take_mat[0, at] = local
        take_mat[1, at] = now_ns
        take_mat[2, at] = freq
        take_mat[3, at] = per_ns
        take_mat[4, at] = count_nt
        take_mat[5, at] = nreq
        take_mat[6, at] = cap_base_nt
        take_mat[7, at] = created_ns
        fill_t[blk] += 1
        placed.append((blk, i))

    # Deltas pack vectorized: a 5-tuple of int64 arrays (rows, slots,
    # added_nt, taken_nt, elapsed_ns) or a sequence of 5-tuples (tests).
    if deltas is not None and len(deltas):
        if isinstance(deltas, tuple) and isinstance(deltas[0], np.ndarray):
            rows_a, slots_a, added_a, taken_a, elapsed_a = (
                np.asarray(x, dtype=np.int64) for x in deltas
            )
        else:
            arr = np.asarray(list(deltas), dtype=np.int64).T
            rows_a, slots_a, added_a, taken_a, elapsed_a = arr
        K = len(rows_a)
        local = rows_a % plan.rows_per_shard
        blk = (
            delta_blocks
            if delta_blocks is not None
            else delta_block_assignment(plan, rows_a, deltas_to_home)
        )
        counts = np.bincount(blk, minlength=B)
        if counts.max(initial=0) > k_merge:
            raise ValueError(
                f"merge block {int(counts.argmax())} overflow (k_merge={k_merge})"
            )
        order = np.argsort(blk, kind="stable")
        sblk = blk[order]
        run_start = np.concatenate(([0], np.cumsum(counts)))[sblk]
        at = sblk * k_merge + (np.arange(K, dtype=np.int64) - run_start)
        merge_mat[0, at] = local[order]
        merge_mat[1, at] = slots_a[order]
        merge_mat[2, at] = np.maximum(added_a[order], 0)
        merge_mat[3, at] = np.maximum(taken_a[order], 0)
        merge_mat[4, at] = np.maximum(elapsed_a[order], 0)

    return take_mat, merge_mat, placed


# -- one dispatch ------------------------------------------------------------------


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _wrap(idx: np.ndarray, n: int) -> np.ndarray:
    """The reference's index rule: an int32 cast, then ``[-n, 0)`` wraps."""
    idx = idx.astype(np.int32).astype(np.int64)
    return np.where(idx < 0, idx + n, idx)


class PreparedStep(NamedTuple):
    """The host half of one dispatch (:func:`prepare_step`). ``flat`` is
    every device operand in one int64 array, shipped with one copy: the
    live take columns ``[8, L]`` (row field rewritten to the row they
    run on), the merges into canonical rows ``[5, Kc]``, the merges into
    scratch copies ``[5, Ks]`` and the ``T`` distinct take rows."""

    replicas: int
    cols: np.ndarray  # int64[L]: the live take columns, ascending
    L: int
    Kc: int
    Ks: int
    T: int
    flat: np.ndarray


def _dedupe_zero(entries: np.ndarray) -> np.ndarray:
    """Drop repeats of all-zero merge entries (the matrices' padding): an
    entry of zeros clamps its lane pair and elapsed at 0 under the
    signed max, once or many times alike, and its repeats would only
    contend for one word's atomics."""
    zero = ~entries[2:5].any(axis=0)
    if np.count_nonzero(zero) < 2:
        return entries
    z = np.flatnonzero(zero)
    key = (entries[0, z] << 32) | (entries[1, z] & 0xFFFFFFFF)
    _, first = np.unique(key, return_index=True)
    keep = np.ones(entries.shape[1], bool)
    keep[z] = False
    keep[z[first]] = True
    return entries[:, keep]


def prepare_step(take_mat, merge_mat, plan: MeshPlan, nodes: int) -> PreparedStep:
    """Classify one dispatch's packed matrices on the host. Every column
    of ``merge_mat`` is an entry, as the reference's scatter sees it
    (padding included); a take column is live where ``nreq > 0``. Local
    indices follow the reference's shard-local rule (int32 cast, wrap of
    ``[-n, 0)``); a merge whose row stays outside its shard is dropped,
    one whose slot stays outside ``[0, N)`` keeps only its elapsed. Live
    take rows must lie in their shard and be distinct within a replica,
    as the router keeps them; else this raises."""
    take_mat = _host(take_mat).astype(np.int64, copy=False)
    merge_mat = _host(merge_mat).astype(np.int64, copy=False)
    B, S, rps, R = plan.blocks, plan.shards, plan.rows_per_shard, plan.replicas
    if take_mat.shape[0] != TAKE_MAT_ROWS or take_mat.shape[1] % B:
        raise ValueError(f"take matrix must be [{TAKE_MAT_ROWS}, {B}·k], got {take_mat.shape}")
    if merge_mat.shape[0] != MERGE_MAT_ROWS or merge_mat.shape[1] % B:
        raise ValueError(f"merge matrix must be [{MERGE_MAT_ROWS}, {B}·k], got {merge_mat.shape}")
    k_t = take_mat.shape[1] // B
    k_m = merge_mat.shape[1] // B

    cols = np.flatnonzero(take_mat[5] > 0)
    t_blk = cols // max(k_t, 1)
    local = _wrap(take_mat[0, cols], rps)
    if ((local < 0) | (local >= rps)).any():
        raise ValueError("a live take row lies outside its block's shard")
    g = (t_blk % S) * rps + local
    if R > 1 and len(cols):
        trows = np.unique(g)
        target = (t_blk // S) * len(trows) + np.searchsorted(trows, g)
    else:
        trows = np.zeros(0, np.int64)
        target = g
    if len(np.unique(target)) != len(target):
        raise ValueError("a replica holds two live takes of one row")
    takes = take_mat[:, cols]
    takes[0] = target
    T = len(trows)

    m_blk = np.arange(merge_mat.shape[1], dtype=np.int64) // max(k_m, 1)
    mlocal = _wrap(merge_mat[0], rps)
    ok = (mlocal >= 0) & (mlocal < rps)
    entries = np.empty((MERGE_MAT_ROWS, merge_mat.shape[1]), np.int64)
    entries[0] = (m_blk % S) * rps + mlocal
    entries[1] = _wrap(merge_mat[1], nodes)
    entries[2:] = merge_mat[2:]
    if T:
        pos = np.searchsorted(trows, entries[0])
        hit = ok & (pos < T)
        hit[hit] = trows[pos[hit]] == entries[0, hit]
        scratch = entries[:, hit]
        scratch[0] = (m_blk[hit] // S) * T + pos[hit]
        canon = entries[:, ok & ~hit]
    else:
        scratch = entries[:, :0]
        canon = entries[:, ok]
    canon = _dedupe_zero(canon)
    scratch = _dedupe_zero(scratch)
    flat = np.concatenate([takes.ravel(), canon.ravel(), scratch.ravel(), trows])
    return PreparedStep(R, cols, len(cols), canon.shape[1], scratch.shape[1], T, flat)


def run_step(
    state: LimiterState, step: PreparedStep, dev: torch.Tensor, node_slot: int
) -> torch.Tensor:
    """The device half of one dispatch, in place on ``state``: ``dev`` is
    ``step.flat`` on the state's device. → ``int64[7, L]``, take-n's
    result rows for the live take columns in ``step.cols`` order. The
    launches: the scratch gather (R > 1 with takes), the join into the
    canonical rows and into the scratch (where each has entries), take-n
    (with takes), the converge (R > 1 with takes)."""
    pn, el = state.pn, state.elapsed
    n = pn.shape[1]
    L, Kc, Ks, T, R = step.L, step.Kc, step.Ks, step.T, step.replicas
    at = 0
    takes = dev[at:at + 8 * L].view(8, L)
    at += 8 * L
    canon = dev[at:at + 5 * Kc].view(5, Kc)
    at += 5 * Kc
    scratch = dev[at:at + 5 * Ks].view(5, Ks)
    at += 5 * Ks
    trows = dev[at:at + T]

    def join(p, e, m):
        pair_join(p, e, m[0], m[1], m[2], m[3], m[0], m[4])

    if T == 0:
        if Kc:
            join(pn, el, canon)
        if L == 0:
            return torch.zeros((TAKE_RESULT_ROWS, 0), dtype=torch.int64, device=pn.device)
        return take_n_batch(state, takes, node_slot)[1]
    spn = torch.empty((R, T, n, 2), dtype=torch.int64, device=pn.device)
    sel = torch.empty((R, T), dtype=torch.int64, device=pn.device)
    converge_kernel.gather(pn, el, trows, spn, sel)
    if Kc:
        join(pn, el, canon)
    flat = LimiterState(spn.view(R * T, n, 2), sel.view(R * T))
    if Ks:
        join(flat.pn, flat.elapsed, scratch)
    out = take_n_batch(flat, takes, node_slot)[1]
    converge_kernel.converge(pn, el, trows, spn, sel)
    return out


def mesh_step(
    state: LimiterState, take_mat, merge_mat, plan: MeshPlan, node_slot: int
) -> torch.Tensor:
    """One fused dispatch on one card: merge, take, converge, bit for
    bit the reference's ``build_cluster_step_packed`` step over its
    canonical state. → ``int64[7, B·k_t]`` in the take matrix's column
    order (all-zero columns where ``nreq <= 0``: padding is never read)."""
    step = prepare_step(take_mat, merge_mat, plan, state.pn.shape[1])
    dev = torch.from_numpy(step.flat).to(state.pn.device)
    live = run_step(state, step, dev, node_slot)
    out = torch.zeros(
        (TAKE_RESULT_ROWS, _host(take_mat).shape[1]), dtype=torch.int64, device=state.pn.device
    )
    out[:, torch.from_numpy(step.cols).to(out.device)] = live
    return out


def cluster_step(
    state: LimiterState, take_mat, merge_mat, plan: MeshPlan, node_slot: int
) -> Tuple[LimiterState, torch.Tensor]:
    """The plain R-copy semantics of one dispatch, block by block as the
    reference runs it: R full copies of the state; in each (replica,
    shard) block, merge its merges, then take its takes, on its copy's
    shard (shard-local rows); then converge the copies into ``state``.
    → ``(state, out[7, B·k_t])``. Memory: R copies of the state; for
    tests and checks, not the serving path."""
    take_mat = torch.as_tensor(_host(take_mat), dtype=torch.int64).to(state.pn.device)
    merge_mat = torch.as_tensor(_host(merge_mat), dtype=torch.int64).to(state.pn.device)
    R, S, rps = plan.replicas, plan.shards, plan.rows_per_shard
    k_t = take_mat.shape[1] // plan.blocks
    k_m = merge_mat.shape[1] // plan.blocks
    pn = state.pn.unsqueeze(0).repeat(R, 1, 1, 1)
    el = state.elapsed.unsqueeze(0).repeat(R, 1)
    out = torch.zeros((TAKE_RESULT_ROWS, take_mat.shape[1]), dtype=torch.int64, device=pn.device)
    for r in range(R):
        for s in range(S):
            blk = plan.block_index(r, s)
            shard = LimiterState(pn[r, s * rps:(s + 1) * rps], el[r, s * rps:(s + 1) * rps])
            m = merge_mat[:, blk * k_m:(blk + 1) * k_m]
            merge_batch(shard, MergeBatch(m[0].to(torch.int32), m[1].to(torch.int32), m[2], m[3], m[4]))
            t = take_mat[:, blk * k_t:(blk + 1) * k_t].clone()
            out[:, blk * k_t:(blk + 1) * k_t] = take_n_batch(shard, t, node_slot)[1]
    joined = tree_reduce_states(pn, el)
    state.pn.copy_(joined.pn)
    state.elapsed.copy_(joined.elapsed)
    return state, out
