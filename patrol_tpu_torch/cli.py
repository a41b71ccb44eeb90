"""CLI entry point (reference: cmd/patrol/main.go).

Flags mirror the JAX package's CLI: ``--api-addr``, ``--node-addr``,
repeatable ``--peer-addr``, ``--clock-offset``, ``--log-env``,
``--buckets`` / ``--node-lanes`` (state shape), plus ``--device``
(``cuda`` by default, ``cpu`` for the kernels' plain versions),
``--wire-mode``, ``--udp-backend`` and ``--http-front`` (``native``
builds the C++ host library with g++ and exits 1 if it cannot; ``auto``,
the default, takes it when it loads, else the asyncio path),
``--checkpoint-dir`` and ``--mesh-replicas`` (R × shards blocks over the
local devices of ``--device``, which must divide by R; on one card or
the CPU that is R = 1). A mesh over several distinct devices is not
ported yet and exits 2 with a clear error.

Run as ``python -m patrol_tpu_torch [flags]``.
"""

from __future__ import annotations

import argparse
import asyncio
import sys


def _addr(value: str) -> str:
    host, sep, port = value.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise argparse.ArgumentTypeError(f"address {value!r} is not host:port")
    return value


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="patrol-tpu-torch",
        description="CUDA distributed rate-limiting sidecar "
        "(POST /take/:bucket?rate=F:D&count=N)",
    )
    p.add_argument("--api-addr", type=_addr, default="127.0.0.1:8080", help="HTTP API address")
    p.add_argument("--node-addr", type=_addr, default="127.0.0.1:16000", help="replication UDP address")
    p.add_argument("--node-name", default="", help="node identity for fleet views; defaults to --node-addr")
    p.add_argument(
        "--peer-addr",
        type=_addr,
        action="append",
        default=[],
        dest="peer_addrs",
        help="peer node address (repeatable; include all cluster members)",
    )
    p.add_argument(
        "--udp-backend",
        choices=["auto", "native", "asyncio"],
        default="auto",
        help="replication transport: 'native' (C++ recvmmsg batches into "
        "a pinned rx ring; fails if its library does not build), 'asyncio', "
        "or 'auto' (native when its library loads, else asyncio)",
    )
    p.add_argument(
        "--wire-mode",
        choices=["delta", "full", "aggregate", "compat"],
        default="delta",
        help="outgoing replication wire form. Default 'delta': batched "
        "delta-interval datagrams (wire v2) to peers that answer the "
        "capability handshake, full-state aggregate datagrams to "
        "everyone else. 'full' (alias 'aggregate') opts out to the "
        "per-take full-state plane; 'compat' sends raw own-lane headers "
        "for rolling upgrades (see ops/wire.py and net/delta.py)",
    )
    p.add_argument(
        "--clock-offset",
        default="0",
        help="offset added to clock timestamps, Go duration syntax (testing)",
    )
    p.add_argument(
        "--log-env",
        choices=["development", "production"],
        default="production",
        help="logging environment",
    )
    p.add_argument("--buckets", type=int, default=65536, help="bucket-slot pool size")
    p.add_argument("--node-lanes", type=int, default=64, help="PN lanes (max cluster size)")
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where state and kernels live; cuda needs a card (no fallback)",
    )
    p.add_argument(
        "--http-front",
        choices=["auto", "python", "native"],
        default="auto",
        help="API server: 'native' (the C++ epoll front; answers takes of "
        "host-resident buckets in C++ and speaks h2c; fails if its library "
        "does not build), 'python' (asyncio, the protocol reference, also "
        "the h1 to h2c Upgrade), or 'auto' (native when its library loads)",
    )
    p.add_argument(
        "--shutdown-timeout",
        default="30s",
        help="graceful shutdown timeout, Go duration syntax",
    )
    p.add_argument("--checkpoint-dir", default=None, help="snapshot/restore directory")
    p.add_argument(
        "--checkpoint-interval",
        default="0",
        help="periodic checkpoint interval, Go duration syntax (0 = at shutdown only)",
    )
    p.add_argument(
        "--no-warmup",
        action="store_true",
        help="skip building and launching the kernels at boot",
    )
    p.add_argument(
        "--mesh-replicas",
        type=int,
        default=0,
        help="mesh serving: replicas of each bucket shard over the local devices "
        "of --device (must divide their count; 0 = the single-device engine)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from patrol_tpu_torch.command import Command, NotPortedError
    from patrol_tpu_torch.models.limiter import LimiterConfig
    from patrol_tpu_torch.native import NativeBuildError
    from patrol_tpu_torch.ops.rate import parse_duration
    from patrol_tpu_torch.runtime.bucket import offset_clock, system_clock
    from patrol_tpu_torch.utils.logging import configure

    try:
        offset_ns = parse_duration(args.clock_offset)
    except ValueError as exc:
        print(f"bad --clock-offset: {exc}", file=sys.stderr)
        return 2
    try:
        shutdown_ns = parse_duration(args.shutdown_timeout)
    except ValueError as exc:
        print(f"bad --shutdown-timeout: {exc}", file=sys.stderr)
        return 2
    try:
        checkpoint_ns = parse_duration(args.checkpoint_interval)
    except ValueError as exc:
        print(f"bad --checkpoint-interval: {exc}", file=sys.stderr)
        return 2

    log = configure(args.log_env)
    cmd = Command(
        api_addr=args.api_addr,
        node_addr=args.node_addr,
        node_name=args.node_name,
        peer_addrs=args.peer_addrs,
        udp_backend=args.udp_backend,
        wire_mode=args.wire_mode,
        clock=offset_clock(offset_ns) if offset_ns else system_clock,
        shutdown_timeout_s=shutdown_ns / 1e9,
        config=LimiterConfig(buckets=args.buckets, nodes=args.node_lanes),
        log=log,
        http_front=args.http_front,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_interval_s=checkpoint_ns / 1e9,
        warmup=not args.no_warmup,
        mesh_replicas=args.mesh_replicas,
        device=args.device,
    )
    try:
        cmd.check_ported()
    except NotPortedError as exc:
        print(f"not yet ported: {exc}", file=sys.stderr)
        return 2
    try:
        asyncio.run(cmd.run())
    except KeyboardInterrupt:
        pass
    except NotPortedError as exc:
        print(f"not yet ported: {exc}", file=sys.stderr)
        return 2
    except NativeBuildError as exc:
        print(f"native host library: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
