"""Process supervisor (reference: ``Command``, command.go:17-83).

Wires storage (the device engine), replication (UDP: the native
recvmmsg ``NativeReplicator`` or the asyncio ``Replicator``) and the API
(HTTP: the C++ epoll front of ``net/native_http.py`` or the asyncio one)
into one process and supervises them: an asyncio task group with signal
handling and a graceful-shutdown timeout. Used by the CLI and by
in-process multi-node harnesses.

With ``checkpoint_dir`` set, a node restores the checkpoint found there at
boot (back on the lane its membership view names), saves one every
``checkpoint_interval_s`` (0: only at shutdown) and one at shutdown.

With ``mesh_replicas`` > 0 the engine is the mesh engine
(``runtime/mesh_engine.py``): ``mesh_replicas`` × shards blocks over
``mesh_devices`` (default: every local device of ``device``'s platform:
each card, so a host with several cards serves across them), which may
repeat a device and may name distinct devices of one platform. A list
that mixes platforms, or whose length ``mesh_replicas`` does not divide,
raises ``ValueError`` before anything starts.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import logging
import signal
from typing import List, Optional

from patrol_tpu_torch.models.limiter import SMALL, LimiterConfig
from patrol_tpu_torch.net.api import API, serve
from patrol_tpu_torch.net.replication import Replicator, SlotTable
from patrol_tpu_torch.parallel import topology as topo
from patrol_tpu_torch.runtime.bucket import ClockFn, system_clock
from patrol_tpu_torch.runtime import engine as engine_mod
from patrol_tpu_torch.runtime.engine import DeviceEngine
from patrol_tpu_torch.runtime.mesh_engine import MeshEngine
from patrol_tpu_torch.runtime.repo import TPURepo


@dataclasses.dataclass
class Command:
    """All runtime config funnels into this struct (≙ command.go:18-25),
    which doubles as the test-harness entry point."""

    api_addr: str = "127.0.0.1:8080"
    node_addr: str = "127.0.0.1:16000"
    node_name: str = ""
    peer_addrs: List[str] = dataclasses.field(default_factory=list)
    clock: ClockFn = system_clock  # the injected-clock seam (command.go:23)
    shutdown_timeout_s: float = 30.0
    config: LimiterConfig = SMALL
    log: Optional[logging.Logger] = None
    handle_signals: bool = True
    # "native" (the C++ recvmmsg backend; raises if its library does not
    # build), "asyncio", or "auto": native when the library loads, else
    # asyncio.
    udp_backend: str = "auto"
    # Outgoing wire form: "delta" (batched wire-v2 delta-interval datagrams
    # to capability-advertising peers, aggregate full state to the rest),
    # "full"/"aggregate" (per-take full state) or "compat" (raw own-lane
    # headers for rolling upgrades). See ops/wire.py and net/delta.py.
    wire_mode: str = "delta"
    # HTTP front: "native" = the C++ epoll front (net/native_http.py), which
    # answers takes of host-resident buckets in C++ from the engine's native
    # host-lane store and speaks h2c (natively with libnghttp2, else spliced
    # to a loopback asyncio h2 server); raises if the host library does not
    # build. "python" = the asyncio front, the protocol reference (also the
    # h1 -> h2c Upgrade). "auto" = native when the library loads, else python.
    http_front: str = "auto"
    checkpoint_dir: Optional[str] = None
    # Periodic checkpoint interval; 0 saves only at shutdown.
    checkpoint_interval_s: float = 0.0
    # Build the kernels and launch each once at boot.
    warmup: bool = False
    mesh_replicas: int = 0
    # The mesh's device list (no CLI flag); None: every local device of
    # ``device``'s platform. ``[torch.device("cpu")] * 8`` is a 2 × 4 mesh
    # at mesh_replicas=2, ``[torch.device("cuda", i) for i in range(8)]``
    # the same one block a card.
    mesh_devices: Optional[list] = None
    # "cuda" (default) or "cpu" (the kernels' plain versions, for tests).
    device: str = "cuda"

    # Populated by run() for tests/introspection.
    engine: Optional[DeviceEngine] = None
    repo: Optional[TPURepo] = None
    replicator: Optional[object] = None  # Replicator or NativeReplicator
    native_front: Optional[object] = None  # NativeHTTPFront on the native front
    # Set by run() once every socket is bound and the API is accepting
    # (cleared when run() begins and again after shutdown).
    started: asyncio.Event = dataclasses.field(default_factory=asyncio.Event)
    # The bound HTTP port (useful with an ephemeral ``:0`` api_addr).
    api_port: int = 0
    # Seconds of profiling.prepare_cuda_trace at start-up (on a card; 0.0
    # when the process had done it already).
    trace_prepare_s: float = 0.0

    def check_ported(self) -> None:
        """Raise ``ValueError`` for a configuration that cannot start: an
        unknown backend or front, or a mesh device list that mixes
        platforms or that ``mesh_replicas`` does not divide."""
        if self.udp_backend not in ("auto", "asyncio", "native"):
            raise ValueError(f"unknown udp backend {self.udp_backend!r}")
        if self.http_front not in ("auto", "native", "python"):
            raise ValueError(f"unknown http front {self.http_front!r}")
        if self.mesh_replicas > 0 and self.mesh_devices is not None:
            topo.make_mesh(replicas=self.mesh_replicas, devices=self.mesh_devices)

    async def run(self, stop: Optional[asyncio.Event] = None) -> None:
        """Run until ``stop`` is set or SIGINT/SIGTERM arrives; then shut
        down gracefully (flush, drain HTTP, close UDP, stop engine) within
        the timeout."""
        if self.shutdown_timeout_s <= 0:
            raise ValueError("shutdown_timeout_s must be set")
        self.check_ported()
        log = self.log or logging.getLogger("patrol")
        stop = stop or asyncio.Event()
        self.started.clear()

        from patrol_tpu_torch.runtime import checkpoint as ckpt
        from patrol_tpu_torch.utils import histogram as hist_mod
        from patrol_tpu_torch.utils import profiling

        # Lane = rank of self in the sorted member list, unless a checkpoint
        # pins the node to its original lane: its checkpointed spend lives
        # there, even when the peer list (or its own address) changed.
        self_slot = None
        mem = None
        if self.checkpoint_dir and ckpt.exists(self.checkpoint_dir):
            mem = ckpt.load_membership(self.checkpoint_dir)
            if mem is not None and isinstance(mem.get("self_slot"), int):
                self_slot = mem["self_slot"]
        slots = SlotTable(
            self.node_addr, self.peer_addrs, max_slots=self.config.nodes,
            self_slot=self_slot,
        )
        if mem is not None:
            # The epoch counter survives restarts (monotone).
            slots.restore_epoch(mem.get("epoch"))
        node_name = self.node_name or self.node_addr
        hist_mod.set_node_identity(slots.self_slot, node_name)
        from patrol_tpu_torch.net import native_http

        http_front = self.http_front
        if http_front == "native":
            from patrol_tpu_torch import native

            native.load(required=True)  # raises with g++'s error
        elif http_front == "auto":
            http_front = "native" if native_http.available() else "python"
        if self.mesh_replicas > 0:
            engine = MeshEngine(
                self.config, replicas=self.mesh_replicas, node_slot=slots.self_slot,
                clock=self.clock,
                devices=self.mesh_devices or topo.local_devices(self.device),
            )
        else:
            engine = DeviceEngine(
                self.config, node_slot=slots.self_slot, clock=self.clock, device=self.device,
                # The native front serves host-resident takes from the C++
                # store; the asyncio front keeps the Python host lanes.
                native_host=(http_front == "native"),
            )
        if engine.device.type == "cuda":
            # The profiler's one-time set-up, here on the loop's thread
            # (the CLI's main one) before anything serves, rather than on
            # the executor thread of the first /debug/cuda/trace under load.
            try:
                self.trace_prepare_s = profiling.prepare_cuda_trace()
            except BaseException:
                engine.stop()
                raise
            log.info("profiler prepared", extra={"seconds": round(self.trace_prepare_s, 2)})
        from patrol_tpu_torch.net import native_replication

        use_native = self.udp_backend == "native" or (
            self.udp_backend == "auto" and native_replication.available()
        )
        replicator = None
        try:
            if use_native:
                replicator = native_replication.NativeReplicator(
                    self.node_addr, self.peer_addrs, slots, log_=log,
                    wire_mode=self.wire_mode,
                )
                if engine.device.type == "cuda":
                    replicator.pin_rx_ring()
            else:
                replicator = await Replicator.create(
                    self.node_addr, self.peer_addrs, slots, log=log,
                    wire_mode=self.wire_mode,
                )
        except BaseException:
            if replicator is not None:
                replicator.close()
            engine.stop()
            raise
        log.info(
            "UDP backend",
            extra={"requested": self.udp_backend,
                   "backend": "native" if use_native else "asyncio"},
        )
        repo = TPURepo(engine, send_incast=replicator.send_incast_request)
        replicator.repo = repo
        engine.on_broadcast = replicator.broadcast_states
        replicator.fleet.set_identity(node_name)

        if self.checkpoint_dir and ckpt.exists(self.checkpoint_dir):
            try:
                n = ckpt.restore(self.checkpoint_dir, engine)
            except BaseException:
                replicator.close()
                engine.stop()
                raise
            log.info("checkpoint restored", extra={"buckets": n, "dir": self.checkpoint_dir})

        if self.warmup:
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            await loop.run_in_executor(None, engine.warmup)
            log.info("kernels warmed", extra={"seconds": round(loop.time() - t0, 2)})
        log.debug(
            "peers",
            extra={
                "self": self.node_addr,
                "slot": slots.self_slot,
                "others": [f"{h}:{p}" for h, p in replicator.peers],
            },
        )

        def stats() -> dict:
            return {
                "engine_ticks": engine.ticks,
                "engine_evictions": engine.evictions,
                "engine_scalar_dropped": engine.scalar_dropped,
                "engine_pending_completions": engine.pending_completions,
                "engine_hosted_buckets": engine.hosted_buckets,
                "engine_host_takes": engine.host_takes,
                "engine_promotions": engine.promotions,
                "engine_demotions": engine.demotions,
                "buckets": len(engine.directory),
                "node_slot": slots.self_slot,
                "device": str(engine.device),
                # Bucket lifecycle: reclaims, sheds, sweeps, compactions,
                # tombstones, bytes in use against the budget, pressure.
                **engine.lifecycle_stats(),
                # Mesh serving (MeshEngine only): geometry, fused-dispatch
                # accounting, ``mesh_demotion: unsupported``.
                **(engine.stats() if isinstance(engine, MeshEngine) else {}),
                **profiling.COUNTERS.snapshot(),
                **replicator.stats(),
                "histograms": hist_mod.HISTOGRAMS.snapshot(),
            }

        api = API(repo, log=log, stats=stats)
        # /cluster/*, /debug/audit and /admin/peers are served from the
        # replicator's fleet gossip, audit and membership planes.
        api.fleet = replicator.fleet
        api.audit = replicator.audit
        api.membership = replicator.membership
        host, _, port = self.api_addr.rpartition(":")
        native_front = None
        try:
            if http_front == "native":
                native_front = native_http.NativeHTTPFront(api, host or "127.0.0.1", int(port))
                # h2c: the C++ front answers it itself when libnghttp2
                # loads; otherwise it splices preface-bearing connections
                # to this loopback asyncio server over the same API.
                server = await serve(api, "127.0.0.1", 0)
                h2_port = server.sockets[0].getsockname()[1]
                native_front.set_h2_backend(h2_port)
                self.api_port = native_front.port
                base_stats = stats

                def stats_with_http() -> dict:  # /debug/vars includes the front
                    return {**base_stats(), **native_front.stats(), "h2_backend_port": h2_port}

                api.stats = stats_with_http
            else:
                server = await serve(api, host or "127.0.0.1", int(port))
                self.api_port = server.sockets[0].getsockname()[1]
        except BaseException:
            if native_front is not None:
                native_front.close()
            replicator.close()
            engine.stop()
            raise
        log.info(
            "HTTP front",
            extra={
                "requested": self.http_front, "front": http_front,
                "h2": native_front.h2_mode if native_front else "python",
                "host_lanes": "native" if engine._native_store is not None
                else ("python" if engine_mod.HOST_FASTPATH else "off"),
            },
        )
        self.engine, self.repo, self.replicator = engine, repo, replicator
        self.native_front = native_front

        if self.handle_signals:
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                with contextlib.suppress(NotImplementedError, RuntimeError):
                    loop.add_signal_handler(sig, stop.set)

        log.info("API serving", extra={"addr": self.api_addr, "port": self.api_port})
        self.started.set()

        def membership_view():
            return replicator.membership.view()

        ckpt_task = None
        if self.checkpoint_dir and self.checkpoint_interval_s > 0:
            loop = asyncio.get_running_loop()

            async def periodic_checkpoint():
                while True:
                    await asyncio.sleep(self.checkpoint_interval_s)
                    try:
                        await loop.run_in_executor(
                            None, ckpt.save, self.checkpoint_dir, engine, membership_view()
                        )
                    except Exception:  # pragma: no cover - the node keeps serving
                        log.exception("periodic checkpoint failed")

            ckpt_task = asyncio.ensure_future(periodic_checkpoint())
        try:
            await stop.wait()
        finally:
            if ckpt_task is not None:
                ckpt_task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await ckpt_task
            if self.checkpoint_dir:
                try:
                    ckpt.save(self.checkpoint_dir, engine, membership_view())
                    log.info("checkpoint saved", extra={"dir": self.checkpoint_dir})
                except Exception:  # pragma: no cover - shutdown goes on
                    log.exception("final checkpoint failed")
            log.info("shutting down")
            # Graceful-shutdown flush: re-broadcast the final state of
            # recently-active buckets (bounded, paced) BEFORE the transport
            # closes, so a clean restart doesn't silently shed recent takes
            # whose last broadcast was lost. Best-effort: a failure leaves
            # peers to re-learn the state via incast on next contact.
            try:
                states = engine.drain_dirty_states(limit=1024) if replicator.peers else []
                for lo in range(0, len(states), 64):
                    replicator.broadcast_states(states[lo : lo + 64])
                    await asyncio.sleep(0.002)  # pace; lets the loop send
                if states:
                    profiling.COUNTERS.inc("shutdown_flush_states", len(states))
                    log.info("shutdown flush", extra={"states": len(states)})
            except Exception:  # pragma: no cover
                log.exception("shutdown flush failed")
            server.close()
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(
                    server.wait_closed(), timeout=self.shutdown_timeout_s
                )
            # The native front detaches from the host store before the
            # engine frees it.
            if native_front is not None:
                await asyncio.get_running_loop().run_in_executor(None, native_front.close)
            replicator.close()
            engine.stop()
            for handler in (self.log.handlers if self.log else []):
                with contextlib.suppress(Exception):
                    handler.flush()
            self.started.clear()
