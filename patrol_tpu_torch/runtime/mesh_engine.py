"""MeshEngine: the device engine over a (replicas × shards) mesh
(counterpart of ``patrol_tpu/runtime/mesh_engine.py``).

Same public surface and host protocol behaviour as
:class:`~patrol_tpu_torch.runtime.engine.DeviceEngine`. The reference
shards the planes over the bucket axis ``"b"`` of a ``jax.sharding.Mesh``
and keeps R full replicas along ``"r"``, which ingest disjoint slices of
each tick's work and converge with a max all-reduce. Here the mesh's
blocks group by device into pieces (``parallel/topology.py``): each
piece holds one copy of every shard its blocks cover, and replicas of a
shard on one device share that copy, since between dispatches all
replicas of the reference hold identical planes. With one piece (every
block on one device: ``cuda:0`` × 8, ``cpu`` × 8) the state is
``self.state``, ``pn[B, N, 2]``, exactly as the single-device engine
keeps it, and only a dispatch's take rows get replica copies, inside the
dispatch. With several pieces (distinct cards, or ``piece_per_block``)
``self.state`` is None and the planes are ``self._placed``, a
:class:`~patrol_tpu_torch.parallel.topology.PlacedState`.

Each tick is the reference's fused tick, verbatim: the feeder drains up
to ``_commit_blocks`` × MAX_MERGE_ROWS deltas and folds the whole drain
once (``DeviceEngine._fold_core``); the folded deltas spread round-robin
over the replicas in the fold's order, each take goes to its row's home
block; a drain whose densest block passes ``MESH_WARM_MAX`` splits into
sub-dispatches (all merge chunks first, the last one sharing a dispatch
with take chunk 0), each ending in a converge. The split exists for the
reference's JIT warm shapes, which this package does not have; it still
decides which merges a take sees, so it stays bit for bit. Each dispatch
routes into leased staging, classifies on the host, ships each piece's
operands in one copy to its card and launches under ``_state_mu``: on
each piece the scratch gather, the join (``pair_join``, into its rows and
into the scratch) and take-n; with several pieces the exchange of scratch
rows between them (device-to-device copies behind per-card events); then
the converge kernel (``ops/converge_kernel.py``) on each piece. Its
completion waits on one event a card. With a card present these are the
hand-written kernels; a launch that fails fails the tick's undispatched
tickets (the partial-failure discipline below), it never falls back to
the CPU.

The inherited paths (GC's probe and reclaim, eviction, the promotion
drain, the certified families, ``read_rows`` and the scrape mirror,
``snapshot_planes``, ``release_bucket``, checkpoints, scalar merges) go
through the pieces however many there are. A path that addresses rows
gathers them from each shard's home piece into one copy on the first
piece's card (at one piece, an ``index_select`` of the state),
launches there, and writes the rows back to every piece that holds
their shard (``_row_view`` / ``_viewed``); ``zero_rows`` zeroes every
copy, a snapshot reads each shard from its home, a restore joins into
every copy. As in the reference, idle demotion, raw ingest and the
rx-thread interval fold stay off.

The reference's ``_HostSyncStateLock`` (one in-flight XLA collective on
host device pools) has no counterpart: the port has no collective, and
every launch goes to its card's current stream under the state mutex.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from patrol_tpu_torch.models.limiter import NANO, LimiterConfig, LimiterState
from patrol_tpu_torch.ops import converge_kernel
from patrol_tpu_torch.ops.take import TAKE_RESULT_ROWS
from patrol_tpu_torch.parallel import topology as topo
from patrol_tpu_torch.runtime import engine as engine_mod
from patrol_tpu_torch.runtime.bucket import ClockFn, system_clock
from patrol_tpu_torch.runtime.engine import (
    BroadcastFn,
    DeltaArrays,
    DeviceEngine,
    TakeTicket,
    _obs_stage,
    _pad_size,
)
from patrol_tpu_torch.utils import histogram as hist
from patrol_tpu_torch.utils import profiling
from patrol_tpu_torch.utils import trace as trace_mod

log = logging.getLogger("patrol.mesh")

# The densest (replica, shard) block one dispatch carries; a tick past it
# splits into sub-dispatches (see the module docstring).
MESH_WARM_MAX = 1 << 12


def _pow2(n: int) -> int:
    k = 8
    while k < n:
        k <<= 1
    return k


class MeshEngine(DeviceEngine):
    # Idle demotion stays off, as in the reference (whose per-row gather
    # and zero would reshard across the mesh): stats() says
    # ``mesh_demotion: unsupported``.
    _demotion_capable = False
    # The reference pins the static commit-block default here.
    _commit_blocks_auto = False
    # Raw-plane ingest and the rx-thread interval fold opt out, as in the
    # reference: deltas queue for the fused tick, so decode_fold stays off
    # this path and every merge rides the mesh's routing.
    _raw_ingest_capable = False
    _interval_fold_capable = False

    def __init__(
        self,
        config: LimiterConfig,
        replicas: int = 1,
        node_slot: int = 0,
        clock: ClockFn = system_clock,
        on_broadcast: Optional[BroadcastFn] = None,
        devices=None,
        piece_per_block: bool = False,
    ):
        """``devices``: the mesh's device list, which may repeat a device
        (``[cuda:0] * 8`` is a 2 × 4 mesh on one card at ``replicas=2``,
        ``[cpu] * 8`` the same on the host) and may name distinct devices
        of one platform (``[cuda:0 .. cuda:7]``); default: every local
        card. ``piece_per_block`` is :func:`topology.make_mesh`'s: each
        block a piece of its own, so that the multi-piece path runs on the
        CPU and on one card."""
        self.mesh = topo.make_mesh(replicas=replicas, devices=devices,
                                   piece_per_block=piece_per_block)
        self.plan = topo.plan_for(self.mesh, config)  # the shards must divide the buckets
        # The planes over the mesh's pieces (set by _init_planes, swapped
        # by resize under _state_mu); self.state is its one piece, or None.
        self._placed: Optional[topo.PlacedState] = None
        # Tick accounting, read by stats() from API threads while the
        # feeder writes it (a leaf lock).
        self._mesh_mu = threading.Lock()
        # Serializes resize() calls: _resize_mu → _cond → _state_mu.
        self._resize_mu = threading.Lock()
        self._mesh_metrics: Dict[str, int] = {
            "mesh_fused_dispatches": 0,
            "mesh_split_ticks": 0,
            "mesh_sub_dispatches": 0,
            "mesh_routed_takes": 0,
            "mesh_routed_deltas": 0,
            "mesh_folded_dupes": 0,
        }
        super().__init__(
            config, node_slot=node_slot, clock=clock, on_broadcast=on_broadcast,
            device=self.mesh.device,
        )

    # -- the planes over pieces -----------------------------------------------

    def _init_planes(self) -> Optional[LimiterState]:
        self._set_placed(topo.init_placed(self.config, self.mesh, self.plan))
        return self.state

    def _set_placed(self, placed: topo.PlacedState) -> None:
        """Take ``placed`` as the planes: ``self.state`` is its one piece,
        or None over several; the engine's device is its first piece's.
        The caller holds ``_state_mu`` (or is the constructor)."""
        self._placed = placed
        self.state = placed.states[0] if len(placed.states) == 1 else None
        self.device = placed.device
        self._cards = list(dict.fromkeys(sp.device for sp in placed.specs))

    # -- elasticity ---------------------------------------------------------

    def resize(self, replicas: int = 1, devices=None, timeout: float = 30.0,
               piece_per_block: bool = False) -> dict:
        """Re-lay the mesh live: quiesce, swap, resume. The feeder pauses
        between ticks (queues keep absorbing work), the in-flight tick
        drains, the planes are laid onto the new mesh's pieces under
        ``_state_mu`` (bit for bit, each shard copied from its home piece
        card to card; a piece with the same rows on the same device keeps
        its tensors, so a one-piece mesh on one device stays in place;
        ``_state_gen`` moves), and the feeder resumes on the new plan. An
        invalid target (shards that do not divide the buckets, another
        platform) is refused before anything pauses. → a receipt dict."""
        new_mesh = topo.make_mesh(
            replicas=replicas,
            devices=devices if devices is not None else topo.local_devices(self.device.type),
            piece_per_block=piece_per_block,
        )
        if new_mesh.device.type != self.device.type:
            raise ValueError(f"resize onto {new_mesh.device}: the engine runs on {self.device.type}")
        plan = topo.plan_for(new_mesh, self.config)
        with self._resize_mu:
            old_shape = (self.plan.replicas, self.plan.shards)
            with self._cond:
                self._tick_paused = True
            try:
                deadline = time.monotonic() + timeout
                while True:
                    with self._cond:
                        if not self._busy:
                            break
                    if time.monotonic() >= deadline:
                        raise TimeoutError("resize quiesce timed out waiting for the in-flight tick")
                    time.sleep(0.0005)
                with self._state_mu:
                    self._set_placed(topo.place_state(self._placed, new_mesh, plan))
                    self._state_gen += 1  # scrape-mirror epoch: a new placement
                    self.mesh = new_mesh
                    self.plan = plan
            finally:
                with self._cond:
                    self._tick_paused = False
                    self._cond.notify_all()
        profiling.COUNTERS.inc("mesh_resizes")
        receipt = {
            "from": {"replicas": old_shape[0], "shards": old_shape[1]},
            "to": {"replicas": plan.replicas, "shards": plan.shards},
            "devices": len(new_mesh.devices),
        }
        log.info("mesh resized", extra=receipt)
        return receipt

    # -- tick ---------------------------------------------------------------

    def _apply(self, deltas: Optional[DeltaArrays], tickets: Sequence[TakeTicket]) -> None:
        # Scalar-semantics (reference-peer) deltas need deficit attribution
        # against the whole row: peeled into the inherited kernel and
        # applied AFTER the fused step, so lane merges land first.
        scalar_subset = None
        if deltas is not None and deltas.scalar.any():
            sc = deltas.scalar
            scalar_subset = DeltaArrays(*(a[sc] for a in deltas))
            deltas = DeltaArrays(*(a[~sc] for a in deltas)) if not sc.all() else None

        keys, groups = self._group_tickets(tickets) if tickets else ([], {})
        if keys:
            self._note_take_coalesce(keys, groups)
        try:
            self._apply_fused(deltas, keys, groups)
        finally:
            if scalar_subset is not None:
                self._apply_scalar_merges(scalar_subset)

    def _apply_fused(self, deltas: Optional[DeltaArrays], keys: List, groups: Dict) -> None:
        """The fused mesh tick: fold the whole drain once, route per
        (replica, shard) block, dispatch the fewest sub-dispatches of at
        most MESH_WARM_MAX a block that cover it, merge chunks strictly
        before take chunks (sharing the boundary dispatch)."""
        plan = self.plan
        W = MESH_WARM_MAX

        # Fold: cross-block duplicate (row, slot) keys max-join on the
        # host; the per-row elapsed fold rides the row's FIRST pair.
        folded = None
        blk_m = msub = None
        m = 0
        raw_n = len(deltas) if deltas is not None else 0
        if raw_n:
            t0 = time.perf_counter_ns()
            ur, us, ua, ut, er, e = self._fold_core(deltas)
            first = np.flatnonzero(np.concatenate(([True], ur[1:] != ur[:-1])))
            el = np.zeros(len(ur), np.int64)
            el[first] = e
            folded = (ur, us, ua, ut, el)
            _obs_stage(hist.STAGE_FOLD, t0, trace_mod.EV_FOLD, raw_n)
            # Block assignment + within-block rank → sub-dispatch index.
            blk_m = topo.delta_block_assignment(plan, ur)
            counts = np.bincount(blk_m, minlength=plan.blocks)
            order = np.argsort(blk_m, kind="stable")
            run_start = np.concatenate(([0], np.cumsum(counts)))[blk_m[order]]
            rank = np.empty(len(ur), np.int64)
            rank[order] = np.arange(len(ur), dtype=np.int64) - run_start
            msub = rank // W
            m = int(msub.max()) + 1

        # Take placement: per-block arrival rank → (chunk, slot).
        key_sub: List[int] = []
        fill_t = [0] * plan.blocks
        for key in keys:
            replica, shard, _local = plan.locate(key[0])
            blk = plan.block_index(replica, shard)
            key_sub.append(fill_t[blk] // W)
            fill_t[blk] += 1
        t = (max(key_sub) + 1) if keys else 0

        n_dispatch = m + t - (1 if m and t else 0)
        if n_dispatch == 0:
            return
        if n_dispatch > 1:
            log.debug(
                "mesh tick split into %d sub-dispatches (%d merge chunks, %d take chunks)",
                n_dispatch, m, t,
            )

        take_base = (m - 1) if m else 0  # dispatch index of take chunk 0
        failed = False
        for d in range(n_dispatch):
            mi = d if d < m else None
            ti = d - take_base if (t and d >= take_base) else None
            keys_d = (
                [k for j, k in enumerate(keys) if key_sub[j] == ti] if ti is not None else []
            )
            try:
                self._dispatch_fused(folded, blk_m, msub, mi, keys_d, groups)
            except Exception:
                # Partial failure: earlier sub-dispatches admitted takes and
                # debited tokens on the device, and their queued
                # completions must stand. Fail ONLY the tickets of this and
                # later chunks, and swallow (re-raising would make the tick
                # loop's catch-all race those completions).
                log.exception(
                    "mesh sub-dispatch %d/%d failed; failing undispatched takes only",
                    d + 1, n_dispatch,
                )
                later = [
                    tk
                    for j, key in enumerate(keys)
                    if ti is None or key_sub[j] >= ti
                    for tk in groups[key]
                ]
                self._fail_tickets(later)
                failed = True
                break

        n_pairs = len(folded[0]) if folded is not None else 0
        with self._mesh_mu:
            mm = self._mesh_metrics
            mm["mesh_fused_dispatches"] += n_dispatch
            if n_dispatch > 1 and not failed:
                mm["mesh_split_ticks"] += 1
                mm["mesh_sub_dispatches"] += n_dispatch
            mm["mesh_routed_takes"] += len(keys)
            mm["mesh_routed_deltas"] += n_pairs
            mm["mesh_folded_dupes"] += raw_n - n_pairs

    def _ship_flat(self, arr: np.ndarray, device=None) -> torch.Tensor:
        """Ship a flat int64 operand through a staging lease padded to a
        power of two (so the pool holds few shapes) to ``device`` (default
        the engine's); → its device prefix."""
        buf = self._staging.lease((_pow2(arr.size),))
        buf.numpy()[:arr.size] = arr
        return self._ship(buf, device=device)[:arr.size]

    def _dispatch_fused(
        self,
        folded,
        blk_m: Optional[np.ndarray],
        msub: Optional[np.ndarray],
        mi: Optional[int],
        keys_d: List,
        groups: Dict,
    ) -> None:
        """One fused dispatch: the selected merge chunk and take chunk,
        routed into leased staging with the reference's square padding
        (its zero entries are merges too, clamping at 0 under the signed
        max), classified on the host, shipped in one copy, launched under
        the state lock."""
        plan = self.plan

        deltas_d = None
        blk_d = None
        max_fill_m = 0
        if mi is not None:
            sel = msub == mi
            deltas_d = tuple(a[sel] for a in folded)
            blk_d = blk_m[sel]
            max_fill_m = int(np.bincount(blk_d, minlength=plan.blocks).max(initial=0))

        takes_d = []
        max_fill_t = 0
        if keys_d:
            fill = [0] * plan.blocks
            for key in keys_d:
                ts = groups[key]
                first = ts[0]
                replica, shard, _local = plan.locate(first.row)
                fill[plan.block_index(replica, shard)] += 1
                takes_d.append(
                    (
                        first.row,
                        min(tk.now_ns for tk in ts),
                        first.rate.freq,
                        first.rate.per_ns,
                        first.count * NANO,
                        len(ts),
                        int(self.directory.cap_base_nt[first.row]),
                        int(self.directory.created_ns[first.row]),
                    )
                )
            max_fill_t = max(fill)

        k = _pad_size(max(max_fill_m, max_fill_t, 1), lo=8, hi=MESH_WARM_MAX)
        take_buf = self._staging.lease((topo.TAKE_MAT_ROWS, plan.blocks * k))
        merge_buf = self._staging.lease((topo.MERGE_MAT_ROWS, plan.blocks * k))
        pieces = self._placed
        try:
            _tm, _mm, placed = topo.route_packed(
                plan, takes_d, deltas_d, k, k,
                take_out=take_buf.numpy(), merge_out=merge_buf.numpy(), delta_blocks=blk_d,
            )
            step = topo.prepare_pieces(
                take_buf.numpy(), merge_buf.numpy(), plan, self.config.nodes, pieces)
        finally:
            # Read on the host only: no copy holds them.
            self._staging.release(take_buf)
            self._staging.release(merge_buf)
        n_work = len(takes_d) + (len(deltas_d[0]) if deltas_d else 0)
        t0 = time.perf_counter_ns()
        steps = step.steps
        devs = [self._ship_flat(s.flat, sp.device) for s, sp in zip(steps, pieces.specs)]
        _obs_stage(hist.STAGE_H2D, t0, trace_mod.EV_H2D_PUT, n_work)
        t0 = time.perf_counter_ns()
        with self._state_mu:
            outs = topo.run_pieces(pieces, step, devs, self.node_slot)
        _obs_stage(hist.STAGE_DISPATCH, t0, trace_mod.EV_COMMIT_DISPATCH, len(takes_d))
        self._ticks += 1

        if not keys_d:
            self._observe_device_commit("mesh_step", t0, n_work)
            return
        live = [(s.cols, out) for s, out in zip(steps, outs) if s.L]
        self._read_back(live, [blk * k + slot for blk, slot in placed], keys_d, groups, t0)

    def _read_back(self, live: List, wanted: List[int], keys_d: List, groups: Dict,
                   t_dispatch: int) -> None:
        """Hand a dispatch's take results to the completer: ``live`` is
        (live columns, take-n's result rows) for each piece with takes,
        ``wanted`` the placed columns in ticket-key order. Each result is
        copied into pinned staging on its card's stream, an event is
        recorded on every card of the mesh, and the completion waits on
        each (one event a card), then fans the results out."""
        held = []  # (lease or None, host view) a piece with takes
        for _cols, out in live:
            if self._cuda:
                n = out.shape[1]
                res_buf = self._staging.lease((TAKE_RESULT_ROWS * _pow2(n),))
                res = res_buf[:TAKE_RESULT_ROWS * n].view(TAKE_RESULT_ROWS, n)
                res.copy_(out, non_blocking=True)
                held.append((res_buf, res))
            else:
                held.append((None, out))
        events = []
        if self._cuda:
            for card in self._cards:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(card))
                events.append(ev)
        # The placed columns, as indices into the pieces' live columns.
        cols = np.concatenate([c for c, _out in live])
        order = np.argsort(cols, kind="stable")
        at = order[np.searchsorted(cols[order], wanted)]
        groups_d = {key: groups[key] for key in keys_d}
        n_keys = len(keys_d)

        def complete() -> None:
            for ev in events:
                ev.synchronize()
            res = np.concatenate([r.numpy() for _buf, r in held], axis=1)[:, at]
            for buf, _r in held:
                if buf is not None:
                    self._staging.release(buf)
            if engine_mod.DEVICE_TIMING:
                dur = time.perf_counter_ns() - t_dispatch
                hist.STAGE_DEVICE_TAKE.record(dur)
                hist.kernel_histogram("mesh_step").record(dur)
                tr = trace_mod.TRACE
                if tr.enabled:
                    tr.record(trace_mod.EV_DEVICE_READY, dur, n_keys)
            self._complete_groups(keys_d, groups_d, *res)

        self._enqueue_completion(complete, keys_d, groups_d)

    def warmup(self) -> None:
        """Build the kernels and launch each of the mesh's once on every
        piece: the inherited take-n, join and decode_fold launches on
        all-padding operands, then the scratch gather and the converge on
        the piece's first row at every replica (the copies equal the row,
        so the converge writes it back unchanged); then every card
        synchronizes."""
        if not self._cuda:
            return
        from patrol_tpu_torch.ops import _build

        _build.lib()
        r, n = self.plan.replicas, self.config.nodes
        for st in self._placed.states:
            dev = st.pn.device
            self._warm_launches(st)
            rows = torch.zeros(1, dtype=torch.int64, device=dev)
            spn = torch.empty((r, 1, n, 2), dtype=torch.int64, device=dev)
            sel = torch.empty((r, 1), dtype=torch.int64, device=dev)
            with self._state_mu:
                converge_kernel.gather(st.pn, st.elapsed, rows, spn, sel)
                converge_kernel.converge(st.pn, st.elapsed, rows, spn, sel)
        for card in self._cards:
            torch.cuda.synchronize(card)

    # -- the inherited paths over pieces -------------------------------------

    def _row_view(self, *cols: np.ndarray):
        """The rows in ``cols`` become positions in one copy of them on the
        first piece's card; → their global rows. The rewrite does not
        depend on the layout, so a view readied before a resize still
        lands after it."""
        return self._placed.view(*cols)

    @contextlib.contextmanager
    def _viewed(self, view, write: bool = True):
        """The copy of the view's rows, gathered from each shard's home
        piece, written back to every piece that holds them after a launch
        that writes."""
        copy = self._placed.gather(view)
        yield copy
        if write:
            self._placed.scatter(view, copy)

    def _zero_rows(self, rows) -> None:
        self._placed.zero(rows)

    def _planes_to_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._placed.planes()

    def _join_planes(self, pn: np.ndarray, elapsed: np.ndarray) -> None:
        with self._state_mu:
            self._placed.join_planes(pn, elapsed)
            self._state_gen += 1  # a write outside any tick: the scrape epoch moves

    def _device_event(self):
        """An event behind the work just launched on every card of the
        mesh: the first card's stream waits on each other card's (no host
        wait), and the event is recorded there."""
        if self._cuda and len(self._cards) > 1:
            first = torch.cuda.current_stream(self.device)
            for card in self._cards[1:]:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(card))
                first.wait_event(ev)
        return super()._device_event()

    def stats(self) -> Dict[str, object]:
        """The reference's mesh gauges. ``mesh_converge_kernel`` names the
        reference's schedule ("tree" for a power-of-two R above 1, else
        "flat"); on each piece both are the one converge kernel."""
        with self._mesh_mu:
            out: Dict[str, object] = dict(self._mesh_metrics)
        out.update(
            mesh_replicas=self.plan.replicas,
            mesh_shards=self.plan.shards,
            mesh_commit_blocks=self._commit_blocks,
            mesh_warm_max=MESH_WARM_MAX,
            mesh_demotion="unsupported",
            # GC is inherited whole: the probe and zero_rows run on the
            # planes (every copy of a shard), reclaiming through the host
            # directory.
            mesh_gc="host-directory",
            mesh_converge_kernel=(
                "tree"
                if self.plan.replicas > 1 and self.plan.replicas & (self.plan.replicas - 1) == 0
                else "flat"
            ),
        )
        return out
