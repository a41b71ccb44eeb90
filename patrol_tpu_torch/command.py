"""Process supervisor (reference: ``Command``, command.go:17-83).

Wires storage (the device engine) and the API (HTTP, asyncio front) into
one process and supervises them: an asyncio task group with signal
handling and a graceful-shutdown timeout. Used by the CLI and by
in-process harnesses.

This package serves a single node: UDP replication, the native C++ HTTP
front, the multi-device mesh engine and checkpoints are not ported yet,
and asking for any of them raises :class:`NotPortedError` before anything
starts.
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
from patrol_tpu_torch.runtime.bucket import ClockFn, system_clock
from patrol_tpu_torch.runtime.engine import DeviceEngine
from patrol_tpu_torch.runtime.repo import TPURepo


class NotPortedError(ValueError):
    """A configuration that needs a part of the system not ported yet."""


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
    # "python" (asyncio) is the only front of this package; "auto" means it.
    http_front: str = "auto"
    checkpoint_dir: Optional[str] = None
    # Build the kernels and launch each once at boot.
    warmup: bool = False
    mesh_replicas: int = 0
    # "cuda" (default) or "cpu" (the kernels' plain versions, for tests).
    device: str = "cuda"

    # Populated by run() for tests/introspection.
    engine: Optional[DeviceEngine] = None
    repo: Optional[TPURepo] = None
    # Set by run() once the API is accepting (cleared when run() begins
    # and again after shutdown).
    started: asyncio.Event = dataclasses.field(default_factory=asyncio.Event)
    # The bound HTTP port (useful with an ephemeral ``:0`` api_addr).
    api_port: int = 0

    def check_ported(self) -> None:
        """Raise :class:`NotPortedError` for a configuration this package
        cannot serve yet."""
        if self.http_front not in ("auto", "python"):
            raise NotPortedError(
                f"--http-front {self.http_front} is not yet ported "
                "(only the asyncio front is)"
            )
        if self.mesh_replicas > 0:
            raise NotPortedError("--mesh-replicas > 0 is not yet ported")
        if self.peer_addrs:
            raise NotPortedError(
                "peers are not yet ported: UDP replication is the next slice"
            )
        if self.checkpoint_dir:
            raise NotPortedError("checkpoints (--checkpoint-dir) are not yet ported")

    async def run(self, stop: Optional[asyncio.Event] = None) -> None:
        """Run until ``stop`` is set or SIGINT/SIGTERM arrives; then shut
        down gracefully (drain HTTP, stop engine) within the timeout."""
        if self.shutdown_timeout_s <= 0:
            raise ValueError("shutdown_timeout_s must be set")
        self.check_ported()
        log = self.log or logging.getLogger("patrol")
        stop = stop or asyncio.Event()
        self.started.clear()

        from patrol_tpu_torch.utils import histogram as hist_mod

        # A single node holds lane 0, as the rank of self in a one-member
        # list does in the JAX package's slot table.
        node_slot = 0
        node_name = self.node_name or self.node_addr
        hist_mod.set_node_identity(node_slot, node_name)
        engine = DeviceEngine(
            self.config, node_slot=node_slot, clock=self.clock, device=self.device
        )
        repo = TPURepo(engine, send_incast=None)

        if self.warmup:
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            await loop.run_in_executor(None, engine.warmup)
            log.info("kernels warmed", extra={"seconds": round(loop.time() - t0, 2)})

        def stats() -> dict:
            from patrol_tpu_torch.utils import profiling

            return {
                "engine_ticks": engine.ticks,
                "engine_evictions": engine.evictions,
                "engine_scalar_dropped": engine.scalar_dropped,
                "engine_pending_completions": engine.pending_completions,
                "buckets": len(engine.directory),
                "node_slot": node_slot,
                "device": str(engine.device),
                **profiling.COUNTERS.snapshot(),
                "histograms": hist_mod.HISTOGRAMS.snapshot(),
            }

        api = API(repo, log=log, stats=stats)
        host, _, port = self.api_addr.rpartition(":")
        server = await serve(api, host or "127.0.0.1", int(port))
        self.api_port = server.sockets[0].getsockname()[1]
        self.engine, self.repo = engine, repo

        if self.handle_signals:
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                with contextlib.suppress(NotImplementedError, RuntimeError):
                    loop.add_signal_handler(sig, stop.set)

        log.info("API serving", extra={"addr": self.api_addr, "port": self.api_port})
        self.started.set()
        try:
            await stop.wait()
        finally:
            log.info("shutting down")
            server.close()
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(
                    server.wait_closed(), timeout=self.shutdown_timeout_s
                )
            engine.stop()
            for handler in (self.log.handlers if self.log else []):
                with contextlib.suppress(Exception):
                    handler.flush()
            self.started.clear()
