"""Mesh serving: the counterpart of ``patrol_tpu/parallel/topology.py``.

The reference lays ``pn[B, N, 2]`` / ``elapsed[B]`` over a 2-D
``jax.sharding.Mesh``: the bucket axis ``"b"`` splits the rows into
shards, and the replica axis ``"r"`` holds R full copies of each shard.
Every dispatch routes each take to its row's home block (replica
``row % R``, the row's shard), spreads merges over the replicas
round-robin, runs merge → take → converge in every block, and the
converge (a signed int64 max over the R copies) leaves every replica
with the join.

A mesh here is a list of torch devices, replica-major (block
``r * S + s`` is ``grid[r][s]``), that may repeat: ``cuda:0`` × 8 is a
2 × 4 mesh on one card, ``[cuda:0 .. cuda:7]`` one block a card. The
blocks group by the device their entry names into **pieces**
(:func:`piece_layout`): each piece holds one copy of every shard its
blocks cover, stacked in shard order. Between dispatches all R replicas
of a shard hold identical planes (every fused step ends in a converge,
and every other writer writes every copy alike), so the replicas of a
shard that share a device share that device's copy. ``cuda:0`` × 8 is
therefore one piece holding the whole state, as the single-device
engine keeps it; eight distinct cards at R = 2 are eight pieces of one
shard each. :func:`place_state` lays planes onto the pieces
(:class:`PlacedState`); a read takes each shard from one piece, a write
goes to every piece that holds the row's shard.

One dispatch (:func:`mesh_step`) makes per-replica copies only of what
it can make differ: the rows its takes touch. On each piece:

1. gather the piece's take rows into a scratch of R copies
   (``int64[R, T, N, 2]``, ``int64[R, T]``; ``ops/converge_kernel.py``);
2. join the merges: those of a take row into the scratch copy of the
   replica they were routed to (on the piece that hosts that block), all
   others into the piece's own rows (every piece that holds the shard
   gets them: every replica would end with them anyway);
3. run take-n on the copy of each take's block;
4. the exchange (several pieces only): each piece receives the other
   replicas' scratch rows of its shards from the pieces that host them,
   a device-to-device copy on its own stream behind an event recorded
   on the sender's stream after its take-n;
5. converge: the signed max over the R copies, into the piece's rows.

That is bit for bit the reference's step, including a take whose lane
wraps past 2^63 (the max then picks another replica's unwrapped copy). At
R = 1 each shard has one copy: merges, then take-n on it. At one piece
the exchange is empty and the launches are those of one card's step.
:func:`cluster_step` is the plain R-copy transcription that the rest is
held to in the tests.

The host routing (:class:`MeshPlan`, :func:`plan_for`,
:func:`delta_block_assignment`, :func:`route_packed`,
:func:`route_requests`) is the reference's numpy, copied. A list that
mixes platforms raises ``ValueError``, as a JAX mesh cannot mix them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from patrol_tpu_torch.models.limiter import LimiterConfig, LimiterState, resolve_device
from patrol_tpu_torch.ops import _build, converge_kernel
from patrol_tpu_torch.ops.join_kernel import pair_join
from patrol_tpu_torch.ops.merge import MergeBatch, merge_batch, zero_rows
from patrol_tpu_torch.ops.take import TAKE_RESULT_ROWS, take_n_batch

REPLICA_AXIS = "r"
BUCKET_AXIS = "b"

# Packed-matrix layouts of one dispatch (the reference's staged transfer
# shape): ONE int64[8, B·k_t] take matrix and ONE int64[5, B·k_m] merge
# matrix, each block's columns contiguous, blocks replica-major.
TAKE_MAT_ROWS = 8  # rows, now_ns, freq, per_ns, count_nt, nreq, cap, created
MERGE_MAT_ROWS = 5  # rows, slots, added_nt, taken_nt, elapsed_ns

# The exchange's device-to-device copies and the bytes they moved (the
# scratch rows of pn and elapsed), counted where they are issued.
EXCHANGE: Dict[str, int] = {"copies": 0, "bytes": 0}


def reset_exchange() -> None:
    for k in EXCHANGE:
        EXCHANGE[k] = 0


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


def tensor_device(device) -> torch.device:
    """Where a mesh entry's tensors live: the card it names, or ``cpu``
    (``cpu:3`` names a distinct mesh entry, but every CPU tensor lies on
    ``cpu``)."""
    dev = torch.device(device)
    return torch.device("cpu") if dev.type == "cpu" else dev


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (replicas × shards) grid of devices, replica-major; ``shape`` is
    keyed by axis name as a ``jax.sharding.Mesh``'s is. Entries may repeat
    a device; ``piece_per_block`` is :func:`make_mesh`'s keyword."""

    devices: Tuple[torch.device, ...]
    shape: Dict[str, int]
    piece_per_block: bool = False

    @property
    def device(self) -> torch.device:
        """The first block's device: where a gathered copy of rows goes."""
        return tensor_device(self.devices[0])

    @property
    def cards(self) -> int:
        """Distinct devices the tensors lie on (1 for any CPU mesh)."""
        return len({tensor_device(d) for d in self.devices})


def make_mesh(replicas: int = 1, devices=None, *, piece_per_block: bool = False) -> Mesh:
    """A (replicas × shards) mesh over ``devices`` (default: every local
    CUDA card). ``replicas`` must divide the device count; the remainder
    becomes the bucket axis. The entries may repeat a device and may name
    distinct devices of one platform; two platforms raise ``ValueError``.

    ``piece_per_block`` lays every block on a piece of its own even where
    the entries repeat a device. It exists so that the multi-piece path
    (per-piece operands, the exchange between pieces, writes to every
    copy of a shard) runs on the CPU and on one card; a served mesh
    groups its blocks by device."""
    devices = list(devices) if devices is not None else local_devices()
    kinds = sorted({torch.device(d).type for d in devices})
    if len(kinds) > 1:
        raise ValueError(f"a mesh's devices must share one platform, got {', '.join(kinds)}")
    devices = [_canonical(d) for d in devices]
    n = len(devices)
    if replicas < 1 or n % replicas:
        raise ValueError(f"{replicas} replicas do not divide {n} devices")
    return Mesh(tuple(devices), {REPLICA_AXIS: replicas, BUCKET_AXIS: n // replicas},
                piece_per_block)
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
# -- pieces: the state laid over the mesh's devices ---------------------------------


@dataclasses.dataclass(frozen=True)
class PieceSpec:
    """One piece of a mesh: the blocks whose entries name one device (or
    one block, with ``piece_per_block``), and the shards they cover in
    ascending order, which is the order the piece stacks them in."""

    device: torch.device  # where the piece's tensors lie
    blocks: Tuple[int, ...]
    shards: Tuple[int, ...]


def piece_layout(mesh: Mesh, plan: "MeshPlan") -> Tuple[PieceSpec, ...]:
    """The mesh's pieces in the order of their first block: piece 0
    holds block 0, on the mesh's first device. Keyed by the mesh's
    entries (``cpu:0`` and ``cpu:1`` are two pieces though both keep
    their tensors on ``cpu``), or by block with ``piece_per_block``."""
    index: Dict[object, int] = {}
    groups: List[Tuple[torch.device, List[int]]] = []
    for blk, dev in enumerate(mesh.devices):
        key = blk if mesh.piece_per_block else dev
        if key not in index:
            index[key] = len(groups)
            groups.append((dev, []))
        groups[index[key]][1].append(blk)
    return tuple(
        PieceSpec(tensor_device(dev), tuple(blks), tuple(sorted({b % plan.shards for b in blks})))
        for dev, blks in groups
    )


def _host_index(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host rows → an int64 index on ``device``, pinned first on a card (a
    copy from pageable memory may make the host wait while CUDA stages
    it)."""
    idx = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64))
    if device.type == "cuda":
        idx = idx.pin_memory()
    return idx.to(device, non_blocking=True)


class PlacedState:
    """A state laid over a mesh's pieces (:func:`place_state`). Piece
    ``i`` holds ``states[i]``: one copy of each shard of
    ``specs[i].shards``, stacked in that order. Every copy of a shard is
    equal between dispatches, so reads take a shard from its ``home``
    (its first holder) and writes go to every holder."""

    def __init__(self, specs: Sequence[PieceSpec], states: Sequence[LimiterState],
                 plan: "MeshPlan"):
        self.specs = tuple(specs)
        self.states = list(states)
        self.plan = plan
        rps = plan.rows_per_shard
        self.buckets = rps * plan.shards
        # _slot[i, s]: where shard s sits in piece i's stack (-1: absent).
        self._slot = np.full((len(self.specs), plan.shards), -1, np.int64)
        for i, sp in enumerate(self.specs):
            self._slot[i, list(sp.shards)] = np.arange(len(sp.shards))
        self.home = np.argmax(self._slot >= 0, axis=0)
        self.block_piece = np.empty(plan.blocks, np.int64)
        for i, sp in enumerate(self.specs):
            self.block_piece[list(sp.blocks)] = i

    @property
    def device(self) -> torch.device:
        return self.specs[0].device

    def holds(self, i: int, rows: np.ndarray) -> np.ndarray:
        """Which of the global ``rows`` (in ``[0, B)``) piece ``i`` holds."""
        return self.has_shard(i, rows // self.plan.rows_per_shard)

    def has_shard(self, i: int, shards: np.ndarray) -> np.ndarray:
        """Which of ``shards`` piece ``i`` holds a copy of."""
        return self._slot[i, shards] >= 0

    def local(self, i: int, rows: np.ndarray) -> np.ndarray:
        """Piece ``i``'s rows of global ``rows`` (all in its shards)."""
        s, off = np.divmod(rows, self.plan.rows_per_shard)
        return self._slot[i, s] * self.plan.rows_per_shard + off

    def shard_rows(self, s: int) -> Tuple[int, LimiterState, int]:
        """(home piece, its state, the offset of shard ``s`` in it)."""
        i = int(self.home[s])
        return i, self.states[i], int(self._slot[i, s]) * self.plan.rows_per_shard

    def planes(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of both whole planes, each shard from its home."""
        rps = self.plan.rows_per_shard
        st0 = self.states[0]
        pn = np.empty((self.buckets,) + tuple(st0.pn.shape[1:]), np.int64)
        el = np.empty(self.buckets, np.int64)
        for s in range(self.plan.shards):
            _i, st, off = self.shard_rows(s)
            pn[s * rps:(s + 1) * rps] = st.pn[off:off + rps].cpu().numpy()
            el[s * rps:(s + 1) * rps] = st.elapsed[off:off + rps].cpu().numpy()
        return pn, el

    # -- rows of a launch on one device

    def view(self, *cols: np.ndarray) -> np.ndarray:
        """Rewrite the global rows in ``cols`` (host int64 arrays, in
        place) to positions in a compact copy of those rows; → the global
        rows of that copy, ascending (for :meth:`gather` and
        :meth:`scatter`; the order does not depend on the layout). A row
        outside ``[0, B)`` keeps the family kernels' reading of it (the
        gather clamps into ``[0, B)`` and commits nothing): it becomes -1
        or the copy's length, and the copy holds row 0 or row B-1 at its
        ends to clamp to."""
        b = self.buckets
        every = np.concatenate([np.asarray(c).reshape(-1) for c in cols])
        inside = every[(every >= 0) & (every < b)]
        ends = [0] * bool((every < 0).any()) + [b - 1] * bool((every >= b).any())
        rows = np.unique(np.concatenate([inside, np.asarray(ends, np.int64)]))
        for c in cols:
            c[...] = np.where(c < 0, -1, np.where(c >= b, len(rows), np.searchsorted(rows, c)))
        return rows

    def gather(self, rows: np.ndarray) -> LimiterState:
        """A copy of global ``rows`` on the first piece's device, in their
        order: each home piece's rows are selected on its card, moved in
        one copy a plane and placed."""
        hp = self.home[rows // self.plan.rows_per_shard]
        homes = np.unique(hp)
        if len(homes) == 1:
            i = int(homes[0])
            st = self.states[i]
            idx = _host_index(self.local(i, rows), st.pn.device)
            return LimiterState(st.pn.index_select(0, idx).to(self.device, non_blocking=True),
                                st.elapsed.index_select(0, idx).to(self.device, non_blocking=True))
        st0 = self.states[0]
        pn = torch.empty((len(rows),) + tuple(st0.pn.shape[1:]), dtype=torch.int64,
                         device=self.device)
        el = torch.empty(len(rows), dtype=torch.int64, device=self.device)
        for i in homes:
            i = int(i)
            at = np.flatnonzero(hp == i)
            st = self.states[i]
            idx = _host_index(self.local(i, rows[at]), st.pn.device)
            dst = _host_index(at, self.device)
            pn.index_copy_(0, dst, st.pn.index_select(0, idx).to(self.device, non_blocking=True))
            el.index_copy_(0, dst, st.elapsed.index_select(0, idx).to(self.device,
                                                                       non_blocking=True))
        return LimiterState(pn, el)

    def scatter(self, rows: np.ndarray, copy: LimiterState) -> None:
        """Write a copy of ``rows`` back into every piece that holds them."""
        for i, st in enumerate(self.states):
            mine = np.flatnonzero(self.holds(i, rows))
            if not mine.size:
                continue
            dev = st.pn.device
            pn, el = copy.pn, copy.elapsed
            if mine.size != len(rows):
                at = _host_index(mine, pn.device)
                pn, el = pn.index_select(0, at), el.index_select(0, at)
            idx = _host_index(self.local(i, rows[mine]), dev)
            st.pn.index_copy_(0, idx, pn.to(dev, non_blocking=True))
            st.elapsed.index_copy_(0, idx, el.to(dev, non_blocking=True))

    def zero(self, rows) -> None:
        """``zero_rows`` on every copy: the same wrap and drop."""
        r = np.asarray(rows, dtype=np.int64).reshape(-1)
        r = np.where(r < 0, r + self.buckets, r)
        r = r[(r >= 0) & (r < self.buckets)]
        for i, st in enumerate(self.states):
            mine = r[self.holds(i, r)]
            if mine.size:
                zero_rows(st, self.local(i, mine))

    def join_planes(self, pn: np.ndarray, elapsed: np.ndarray) -> None:
        """Join whole host planes into every copy (signed max, in place)."""
        rps = self.plan.rows_per_shard
        for i, st in enumerate(self.states):
            dev = st.pn.device
            for j, s in enumerate(self.specs[i].shards):
                lo, at = s * rps, j * rps
                dst_pn, dst_el = st.pn[at:at + rps], st.elapsed[at:at + rps]
                torch.maximum(dst_pn, torch.from_numpy(pn[lo:lo + rps]).to(dev), out=dst_pn)
                torch.maximum(dst_el, torch.from_numpy(elapsed[lo:lo + rps]).to(dev), out=dst_el)


def init_placed(config: LimiterConfig, mesh: Mesh, plan: "MeshPlan") -> PlacedState:
    """Zero planes laid over ``mesh``'s pieces: each piece allocates its
    own shards on its device, and no device holds more than its piece."""
    specs = piece_layout(mesh, plan)
    rows = [len(sp.shards) * plan.rows_per_shard for sp in specs]
    return PlacedState(specs, [
        LimiterState(
            torch.zeros((r, config.nodes, 2), dtype=torch.int64, device=sp.device),
            torch.zeros(r, dtype=torch.int64, device=sp.device),
        )
        for sp, r in zip(specs, rows)
    ], plan)


def one_piece(state: LimiterState, plan: "MeshPlan") -> PlacedState:
    """``state`` as one piece that holds every shard and hosts every
    block, on the state's own tensors."""
    spec = PieceSpec(state.pn.device, tuple(range(plan.blocks)), tuple(range(plan.shards)))
    return PlacedState((spec,), [state], plan)


def _copy_rows(dst: LimiterState, at: int, src, lo: int, hi: int) -> None:
    """Fill ``dst`` rows ``[at, at + hi - lo)`` with global rows
    ``[lo, hi)`` of ``src``: a LimiterState, host (pn, elapsed) arrays, or
    a PlacedState (each shard from its home)."""
    dev = dst.pn.device
    if isinstance(src, PlacedState):
        rps = src.plan.rows_per_shard
        g = lo
        while g < hi:
            s = g // rps
            end = min(hi, (s + 1) * rps)
            _i, st, off = src.shard_rows(s)
            a = at + g - lo
            dst.pn[a:a + end - g].copy_(st.pn[off + g - s * rps:off + end - s * rps], non_blocking=True)
            dst.elapsed[a:a + end - g].copy_(
                st.elapsed[off + g - s * rps:off + end - s * rps], non_blocking=True)
            g = end
        return
    if isinstance(src, LimiterState):
        pn, el = src.pn[lo:hi], src.elapsed[lo:hi]
    else:
        pn = torch.from_numpy(np.array(src[0][lo:hi], dtype=np.int64))
        el = torch.from_numpy(np.array(src[1][lo:hi], dtype=np.int64))
    dst.pn[at:at + hi - lo].copy_(pn.to(dev), non_blocking=True)
    dst.elapsed[at:at + hi - lo].copy_(el.to(dev), non_blocking=True)


def place_state(state, mesh: Mesh, plan: "MeshPlan") -> PlacedState:
    """Lay a state onto ``mesh``'s pieces, bit for bit: ``state`` is a
    LimiterState on any device, a ``(pn, elapsed)`` pair of host arrays
    (``np.asarray`` of the JAX package's planes), or a PlacedState (the
    resize's relayout, each shard read from its home; no host round
    trip). A piece that holds the same rows on the same device as the
    source keeps the source's tensors: one piece over the state's own
    device takes the state as it is."""
    specs = piece_layout(mesh, plan)
    rps = plan.rows_per_shard
    if isinstance(state, PlacedState):
        pn0 = state.states[0].pn
        old = {(sp.device, tuple(sp.shards), state.plan.rows_per_shard): st
               for sp, st in zip(state.specs, state.states)}
    elif isinstance(state, LimiterState):
        pn0 = state.pn
        old = {(pn0.device, tuple(range(plan.shards)), rps): state}
    else:
        pn0 = np.asarray(state[0])
        old = {}
    if isinstance(state, PlacedState) and len(state.specs) == 1:
        # One old piece holds every row in order, whatever its shards.
        old = {(state.specs[0].device, tuple(range(plan.shards)), rps): state.states[0]}
    n = pn0.shape[1]
    states = []
    for sp in specs:
        keep = old.pop((sp.device, sp.shards, rps), None)  # a copy serves one piece
        if keep is None:
            with _build.on_device(sp.device):
                keep = LimiterState(
                    torch.empty((len(sp.shards) * rps, n, 2), dtype=torch.int64, device=sp.device),
                    torch.empty(len(sp.shards) * rps, dtype=torch.int64, device=sp.device),
                )
                for j, s in enumerate(sp.shards):
                    _copy_rows(keep, j * rps, state, s * rps, (s + 1) * rps)
        states.append(keep)
    return PlacedState(specs, states, plan)
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
    """The host half of one dispatch on one piece (:func:`prepare_pieces`).
    ``flat`` is every device operand in one int64 array, shipped with one
    copy: the live take columns ``[8, L]`` (row field rewritten to the row
    they run on), the merges into the piece's rows ``[5, Kc]``, the
    merges into scratch copies ``[5, Ks]`` and the ``T`` distinct take
    rows (the piece's rows)."""

    replicas: int
    cols: np.ndarray  # int64[L]: the live take columns, ascending
    L: int
    Kc: int
    Ks: int
    T: int
    flat: np.ndarray


class Exchange(NamedTuple):
    """One copy of the exchange: replica ``replica``'s scratch rows
    ``[src_at, src_at + rows)`` on piece ``src`` → rows ``[dst_at, ...)``
    of the same replica's scratch on piece ``dst``."""

    dst: int
    src: int
    replica: int
    dst_at: int
    src_at: int
    rows: int


class PiecesStep(NamedTuple):
    """The host half of one dispatch (:func:`prepare_pieces`): a
    :class:`PreparedStep` a piece, and the exchange's copies."""

    steps: Tuple[PreparedStep, ...]
    exchange: Tuple[Exchange, ...]


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


class _Classified(NamedTuple):
    cols: np.ndarray  # live take columns
    t_blk: np.ndarray  # their blocks
    g: np.ndarray  # their global rows
    takes: np.ndarray  # int64[8, L]
    trows: np.ndarray  # distinct take rows (R > 1), ascending
    entries: np.ndarray  # int64[5, M]: global row, wrapped slot, values
    m_blk: np.ndarray  # each entry's block
    ok: np.ndarray  # entry's row inside its shard
    hit: np.ndarray  # ok and a take row
    pos: np.ndarray  # index into trows where hit


def _classify(take_mat, merge_mat, plan: MeshPlan, nodes: int) -> _Classified:
    """The host classification of one dispatch, before its split by piece
    (see :func:`prepare_pieces`)."""
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
    if len(np.unique((t_blk // S) * (S * rps) + g)) != len(g):
        raise ValueError("a replica holds two live takes of one row")
    trows = np.unique(g) if R > 1 else np.zeros(0, np.int64)

    m_blk = np.arange(merge_mat.shape[1], dtype=np.int64) // max(k_m, 1)
    mlocal = _wrap(merge_mat[0], rps)
    ok = (mlocal >= 0) & (mlocal < rps)
    entries = np.empty((MERGE_MAT_ROWS, merge_mat.shape[1]), np.int64)
    entries[0] = (m_blk % S) * rps + mlocal
    entries[1] = _wrap(merge_mat[1], nodes)
    entries[2:] = merge_mat[2:]
    pos = np.searchsorted(trows, entries[0])
    hit = ok & (pos < len(trows))
    hit[hit] = trows[pos[hit]] == entries[0, hit]
    return _Classified(cols, t_blk, g, take_mat[:, cols], trows, entries, m_blk, ok, hit, pos)


def _piece_step(c: _Classified, plan: MeshPlan, placed: PlacedState, i: int) -> PreparedStep:
    """Piece ``i``'s operands (see :func:`prepare_pieces`)."""
    S, R = plan.shards, plan.replicas
    blocks = list(placed.specs[i].blocks)
    mine_t = np.isin(c.t_blk, blocks)
    trows = c.trows[placed.holds(i, c.trows)]
    held = c.ok & placed.has_shard(i, c.m_blk % S)
    mine_m = np.isin(c.m_blk, blocks)
    T = len(trows)
    takes = c.takes[:, mine_t]
    g = c.g[mine_t]
    if T:
        takes[0] = (c.t_blk[mine_t] // S) * T + np.searchsorted(trows, g)
    else:
        takes[0] = placed.local(i, g)
    sc = c.hit & mine_m
    scratch = c.entries[:, sc]
    if T:
        scratch[0] = (c.m_blk[sc] // S) * T + np.searchsorted(trows, scratch[0])
    canon = c.entries[:, held & ~c.hit]
    canon[0] = placed.local(i, canon[0])
    canon = _dedupe_zero(canon)
    scratch = _dedupe_zero(scratch)
    flat = np.concatenate([takes.ravel(), canon.ravel(), scratch.ravel(), placed.local(i, trows)])
    return PreparedStep(R, c.cols[mine_t], int(mine_t.sum()), canon.shape[1],
                        scratch.shape[1], T, flat)


def prepare_pieces(take_mat, merge_mat, plan: MeshPlan, nodes: int,
                   placed: PlacedState) -> PiecesStep:
    """Classify one dispatch's packed matrices on the host and split them
    over ``placed``'s pieces. Every column of ``merge_mat`` is an entry,
    as the reference's scatter sees it (padding included); a take column
    is live where ``nreq > 0``. Local indices follow the reference's
    shard-local rule (int32 cast, wrap of ``[-n, 0)``); a merge whose row
    stays outside its shard is dropped, one whose slot stays outside
    ``[0, N)`` keeps only its elapsed. Live take rows must lie in their
    shard and be distinct within a replica, as the router keeps them;
    else this raises.

    A piece gets the live take columns of the blocks it hosts, the merges
    into the non-take rows of every shard it holds (whichever replica
    they were routed to), the merges into take rows routed to the blocks
    it hosts, and its shards' distinct take rows. The exchange: for each
    shard with takes, each piece that holds it receives every other
    replica's scratch rows of it from the piece hosting that replica's
    block. One piece holds every row where it lies and hosts every
    block: its operands are the whole dispatch's and the exchange is
    empty."""
    c = _classify(take_mat, merge_mat, plan, nodes)
    steps = tuple(_piece_step(c, plan, placed, i) for i in range(len(placed.specs)))
    exchange = []
    if len(c.trows):
        rps, S = plan.rows_per_shard, plan.shards
        t_shard = c.trows // rps
        firsts = {}
        for i in range(len(placed.specs)):
            mine = t_shard[placed.holds(i, c.trows)]
            firsts[i] = {int(s): int(np.searchsorted(mine, s)) for s in np.unique(mine)}
        for s in np.unique(t_shard):
            s = int(s)
            n = int(np.count_nonzero(t_shard == s))
            for i, at in ((i, f[s]) for i, f in firsts.items() if s in f):
                for r in range(plan.replicas):
                    src = int(placed.block_piece[r * S + s])
                    if src != i:
                        exchange.append(Exchange(i, src, r, at, firsts[src][s], n))
    return PiecesStep(steps, tuple(exchange))


class _Front(NamedTuple):
    out: torch.Tensor  # take-n's result rows, int64[7, L]
    spn: Optional[torch.Tensor]  # the scratch, int64[R, T, N, 2] (None: no take rows)
    sel: Optional[torch.Tensor]
    trows: Optional[torch.Tensor]


def _step_front(state: LimiterState, step: PreparedStep, dev: torch.Tensor,
                node_slot: int) -> _Front:
    """One piece's launches up to take-n: the scratch gather (with take
    rows), the join into the piece's rows and into the scratch (where
    each has entries), take-n (with takes)."""
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
            out = torch.zeros((TAKE_RESULT_ROWS, 0), dtype=torch.int64, device=pn.device)
        else:
            out = take_n_batch(state, takes, node_slot)[1]
        return _Front(out, None, None, None)
    spn = torch.empty((R, T, n, 2), dtype=torch.int64, device=pn.device)
    sel = torch.empty((R, T), dtype=torch.int64, device=pn.device)
    converge_kernel.gather(pn, el, trows, spn, sel)
    if Kc:
        join(pn, el, canon)
    flat = LimiterState(spn.view(R * T, n, 2), sel.view(R * T))
    if Ks:
        join(flat.pn, flat.elapsed, scratch)
    if L:
        out = take_n_batch(flat, takes, node_slot)[1]
    else:
        out = torch.zeros((TAKE_RESULT_ROWS, 0), dtype=torch.int64, device=pn.device)
    return _Front(out, spn, sel, trows)


def _step_converge(state: LimiterState, front: _Front) -> None:
    """The converge of one piece's scratch into its rows (with take rows)."""
    if front.spn is not None:
        converge_kernel.converge(state.pn, state.elapsed, front.trows, front.spn, front.sel)


def run_pieces(placed: PlacedState, step: PiecesStep, devs: Sequence[torch.Tensor],
               node_slot: int) -> List[torch.Tensor]:
    """The device half of one dispatch, in place: ``devs[i]`` is
    ``step.steps[i].flat`` on piece ``i``'s device. Each piece's launches
    go to its card's current stream: the scratch gather (R > 1 with take
    rows), the join into its rows and into the scratch (where each has
    entries), take-n (with takes). With an exchange, an event is recorded
    on each card behind them and each exchange copy runs on the receiving
    card's stream after it waits on the sender's event. Then each piece
    converges (R > 1 with take rows). → take-n's result rows a piece
    (``int64[7, L]`` in its ``cols`` order), each on its piece's
    device."""
    fronts = []
    for i, (st, piece_step, dev) in enumerate(zip(placed.states, step.steps, devs)):
        with _build.on_device(placed.specs[i].device):
            fronts.append(_step_front(st, piece_step, dev, node_slot))
    if step.exchange:
        cuda = placed.device.type == "cuda"
        events = []
        for i, sp in enumerate(placed.specs):
            ev = None
            if cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(sp.device))
            events.append(ev)
        for x in step.exchange:
            dst, src = fronts[x.dst], fronts[x.src]
            device = placed.specs[x.dst].device
            with _build.on_device(device):
                if cuda:
                    torch.cuda.current_stream(device).wait_event(events[x.src])
                d, s = slice(x.dst_at, x.dst_at + x.rows), slice(x.src_at, x.src_at + x.rows)
                dst.spn[x.replica, d].copy_(src.spn[x.replica, s], non_blocking=True)
                dst.sel[x.replica, d].copy_(src.sel[x.replica, s], non_blocking=True)
            EXCHANGE["copies"] += 2
            EXCHANGE["bytes"] += x.rows * (dst.spn.shape[2] * 16 + 8)
    for i, (st, front) in enumerate(zip(placed.states, fronts)):
        with _build.on_device(placed.specs[i].device):
            _step_converge(st, front)
    return [f.out for f in fronts]


def mesh_step(state, take_mat, merge_mat, plan: MeshPlan, node_slot: int) -> torch.Tensor:
    """One fused dispatch: merge, take, converge, bit for bit the
    reference's ``build_cluster_step_packed`` step. ``state`` is a
    :class:`PlacedState`, or a LimiterState taken as one piece. →
    ``int64[7, B·k_t]`` in the take matrix's column order, on the first
    piece's device (all-zero columns where ``nreq <= 0``: padding is never
    read)."""
    if isinstance(state, LimiterState):
        state = one_piece(state, plan)
    width = _host(take_mat).shape[1]
    pstep = prepare_pieces(take_mat, merge_mat, plan, state.states[0].pn.shape[1], state)
    devs = [torch.from_numpy(s.flat).to(st.pn.device) for s, st in zip(pstep.steps, state.states)]
    lives = run_pieces(state, pstep, devs, node_slot)
    cols = np.concatenate([s.cols for s in pstep.steps])
    live = torch.cat([x.to(state.device) for x in lives], dim=1)
    out = torch.zeros((TAKE_RESULT_ROWS, width), dtype=torch.int64, device=state.device)
    out[:, torch.from_numpy(cols).to(state.device)] = live
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
