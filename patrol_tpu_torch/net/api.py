"""The Patrol HTTP API (reference: api.go:14-86) on an asyncio front.

Route semantics are byte-compatible with the reference:

* ``POST /take/:name?rate=F:D&count=N`` → get-or-create bucket, take at the
  injected clock, reply ``200``/``429`` with the remaining whole tokens as
  the body (api.go:51-86).
* Name longer than 231 bytes → ``400`` with the error text
  (api.go:55-58).
* Malformed ``rate``/``count`` are silently ignored: a bad rate behaves as
  the zero Rate (unconditional 429), a bad/zero count becomes 1
  (api.go:60-65, pinned by api_test.go:42-49).

Debug routes replace the reference's pprof suite (api.go:29-39) with
host+device-aware equivalents (see utils/profiling.py), plus Prometheus
text metrics — which the reference lists as future work (README.md:117).

The server is a hand-rolled asyncio.Protocol HTTP/1.1 implementation
(keep-alive, no external deps): the request hot path does one dict lookup
and one string split before handing off to the repo, and responses are
single ``transport.write`` calls.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Callable, List, Optional, Tuple
from urllib.parse import parse_qs, unquote

from patrol_tpu_torch.ops.rate import Rate, parse_rate
from patrol_tpu_torch.ops.wire import MAX_NAME_LENGTH_V1
from patrol_tpu_torch.runtime.directory import OverloadedError
from patrol_tpu_torch.runtime.repo import TPURepo

# Python-front take batching (VERDICT r3 item 7): /take requests that
# arrive within one event-loop iteration coalesce into ONE
# repo.submit_takes_batch call — one directory pass, one queue append +
# wake-up — instead of per-request submit_take lock/notify churn. The
# reference's goroutine-per-request front has no per-request global lock;
# this removes ours.
PYFRONT_BATCH = os.environ.get("PATROL_PYFRONT_BATCH", "1") != "0"


class _TakeBatcher:
    """Leader-immediate event-loop micro-batcher. The FIRST /take of each
    loop iteration dispatches immediately through the scalar path (zero
    added latency — a plain call_soon deferral measured a 40% rps LOSS at
    8 closed-loop workers because every response waited one scheduling
    round); requests parsed later in the SAME iteration (other readable
    sockets in this select cycle) accumulate and flush as ONE
    submit_takes_batch at iteration end. Low concurrency ⇒ everyone is a
    leader ⇒ identical to the per-request path; high concurrency ⇒ one
    leader + (k−1) batched ⇒ one directory pass and one engine wake-up
    for the bulk. Single-threaded by construction: every method runs on
    the event loop."""

    def __init__(self, repo: TPURepo):
        self.repo = repo
        self._pending: List[tuple] = []
        self._in_iter = False

    @staticmethod
    def _wire(ticket, fut, loop) -> None:
        def _done(t=ticket, f=fut):
            loop.call_soon_threadsafe(
                lambda: f.done() or f.set_result((t.remaining, t.ok))
            )

        ticket.add_done_callback(_done)

    def submit(self, name: str, rate: Rate, count: int) -> asyncio.Future:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        if not self._in_iter:
            self._in_iter = True
            loop.call_soon(self._iter_end, loop)
            try:
                self._wire(self.repo.submit_take(name, rate, count), fut, loop)
            except Exception as exc:  # e.g. DirectoryFullError
                fut.set_exception(exc)  # handler 500s, like take_async did
            return fut
        self._pending.append((name, rate, count, fut))
        return fut

    def _iter_end(self, loop) -> None:
        self._in_iter = False
        batch, self._pending = self._pending, []
        if not batch:
            return
        try:
            self._dispatch(batch, loop)
        except Exception as exc:
            # A swallowed exception here (call_soon context) would leave
            # every queued future unresolved — requests hanging forever.
            # Surface it per-request instead, like the per-request path.
            for *_, fut in batch:
                if not fut.done():
                    fut.set_exception(exc)

    def _dispatch(self, batch: List[tuple], loop) -> None:
        if len(batch) == 1:
            name, rate, count, fut = batch[0]
            self._wire(self.repo.submit_take(name, rate, count), fut, loop)
            return
        res = self.repo.submit_takes_batch(
            [b[0] for b in batch], [b[1] for b in batch], [b[2] for b in batch]
        )
        if res is None:
            # Pool spent with every row pinned: same per-request outcome
            # the engine's single path reports (DirectoryFullError class)
            # — fail the batch as 429/0 rather than 500ing the front.
            for *_, fut in batch:
                if not fut.done():
                    fut.set_result((0, False))
            return
        for (_, _, _, fut), (ticket, _created) in zip(batch, res):
            self._wire(ticket, fut, loop)

_STATUS_TEXT = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    409: "Conflict",
    429: "Too Many Requests",
    500: "Internal Server Error",
    503: "Service Unavailable",
}


class API:
    """Routing + handlers. ``repo`` is any object with ``take_async`` and
    the introspection hooks of :class:`TPURepo`."""

    def __init__(self, repo: TPURepo, log=None, stats: Optional[Callable[[], dict]] = None):
        self.repo = repo
        self.log = log
        self.stats = stats or (lambda: {})
        self.started_at = time.time()  # patrol-lint: clock-seam (uptime)
        # patrol-fleet: the replicator's metrics-gossip plane (set by the
        # supervisor); None ⇒ /cluster/* answers 503 (no fleet view).
        self.fleet = None
        # patrol-audit: the replicator's consistency plane (set by the
        # supervisor); None ⇒ /debug/audit answers 503.
        self.audit = None
        # patrol-membership: the replicator's elastic-membership plane
        # (set by the supervisor); None ⇒ /admin/peers answers 503.
        self.membership = None
        self._batcher = (
            _TakeBatcher(repo)
            if PYFRONT_BATCH and hasattr(repo, "submit_takes_batch")
            else None
        )

    async def handle(
        self, method: str, path: str, query: str
    ) -> Tuple[int, bytes, str]:
        """Returns (status, body, content_type)."""
        if path.startswith("/take/"):
            if method != "POST":
                return 405, b"method not allowed\n", "text/plain"
            return await self._take(path[len("/take/") :], query)
        if path == "/take_batch":
            if method != "POST":
                return 405, b"method not allowed\n", "text/plain"
            return await self._take_batch(query)
        if path.startswith("/tokens/"):
            if method != "GET":
                return 405, b"method not allowed\n", "text/plain"
            return await self._tokens(path[len("/tokens/") :])
        if path.startswith("/debug/") or path == "/metrics":
            return await self._debug(method, path, query)
        if path.startswith("/cluster/"):
            if method != "GET":
                return 405, b"method not allowed\n", "text/plain"
            return self._cluster(path)
        if path == "/admin/peers":
            return self._admin_peers(method, query)
        # /debug/jax/trace (the JAX profiler) is not served: the port has
        # no JAX, and /debug/cuda/trace is its device trace.
        return 404, b"not found\n", "text/plain"

    # -- the hot route (api.go:51-86) ---------------------------------------

    @staticmethod
    def _decode_name(raw_name: str):
        """→ (name, error_response|None). surrogateescape: reference names
        are raw bytes (bucket.go:64-88); %FF must stay byte 0xFF
        end-to-end — through the handlers, the directory, and the wire
        codec — and both HTTP fronts must agree (the C++ front decodes to
        raw bytes natively). The default 'replace' would collapse distinct
        non-UTF8 names into U+FFFD. Over-long names → the api.go:55-58
        400."""
        name = unquote(raw_name, errors="surrogateescape")
        if name.startswith("\x00"):
            # NUL-led names are the replication control channel (probe
            # pings, anti-entropy digests — net/replication.py
            # CTRL_PREFIX); a user bucket there would collide with
            # control packets and silently fail to replicate.
            return name, (400, b"reserved bucket name", "text/plain")
        try:
            name_bytes_len = len(name.encode("utf-8", "surrogateescape"))
        except UnicodeEncodeError:  # lone surrogates not from the escape range
            name_bytes_len = len(name.encode("utf-8", "surrogatepass"))
        if name_bytes_len > MAX_NAME_LENGTH_V1:
            return name, (
                400,
                f"bucket name larger than {MAX_NAME_LENGTH_V1}".encode(),
                "text/plain",
            )
        return name, None

    async def _take(self, raw_name: str, query: str) -> Tuple[int, bytes, str]:
        name, err = self._decode_name(raw_name)
        if err is not None:
            return err

        q = parse_qs(query, keep_blank_values=True)
        try:
            rate = parse_rate(q.get("rate", [""])[0])
        except ValueError:
            rate = Rate()  # parse errors silently ignored (api.go:61)
        try:
            count = int(q.get("count", ["0"])[0])
            if count < 0:
                count = 0
        except ValueError:
            count = 0
        if count == 0:
            count = 1  # api.go:63-65

        try:
            if self._batcher is not None:
                remaining, ok = await self._batcher.submit(name, rate, count)
            else:
                remaining, ok = await self.repo.take_async(name, rate, count)
        except OverloadedError:
            # Memory budget's hard watermark: admission of NEW names
            # sheds with an explicit signal (bucket lifecycle layer)
            # instead of growing state toward an OOM.
            return 429, b"overloaded", "text/plain"
        status = 200 if ok else 429
        if self.log is not None:
            self.log.debug(
                "take",
                extra={"code": status, "count": count, "rate": str(rate), "bucket": name},
            )
        return status, str(remaining).encode(), "text/plain"

    async def _take_batch(self, query: str) -> Tuple[int, bytes, str]:
        """``POST /take_batch?t=<name>,<rate>,<count>&t=...`` — many takes
        in ONE request, one response line per entry in request order:
        ``200 <remaining>`` / ``429 <remaining>`` / ``429 overloaded``
        (memory watermark shed of a NEW name) / ``400 <error>``.

        A Zipf crowd hammering one hot name pays one round-trip AND one
        device dispatch: the whole request lands in a single
        submit_takes_batch, where the engine's take-fold collapses
        same-bucket entries into one take-n row (runtime/engine.py).
        Per-entry fields ride the query value, ','-separated, so the
        request needs no body (both fronts drain but ignore bodies, like
        /take); names percent-encode ',' and '&'. rate/count parse
        exactly like /take: malformed rate ⇒ zero Rate (unconditional
        429), bad/zero count ⇒ 1 (api.go:60-65). The response status is
        200 whenever the batch parsed — per-entry outcomes live in the
        body, and a watermark shed 429s exactly the shed entries, never
        the whole request (live names in the same batch still serve).
        The C++ front forwards this route here via its non-/take seam
        (native_http.py _dispatch_other), so one handler serves both
        fronts."""
        lines: List[Optional[bytes]] = []
        idxs: List[int] = []
        names: List[str] = []
        rates: List[Rate] = []
        counts: List[int] = []
        # Manual '&'-split of the RAW query: parse_qs round-trips values
        # through UTF-8 and would corrupt non-UTF8 names; the name part is
        # split off BEFORE decoding so encoded ','/'&' bytes stay inside it.
        for part in query.split("&"):
            key, _, val = part.partition("=")
            if key != "t":
                continue
            raw_name, _, rest = val.partition(",")
            name, err = self._decode_name(raw_name)
            if err is not None:
                lines.append(b"400 " + err[1].rstrip(b"\n"))
                continue
            raw_rate, _, raw_count = rest.partition(",")
            try:
                rate = parse_rate(unquote(raw_rate, errors="surrogateescape"))
            except ValueError:
                rate = Rate()  # parse errors silently ignored (api.go:61)
            try:
                count = int(raw_count or "0")
                if count < 0:
                    count = 0
            except ValueError:
                count = 0
            if count == 0:
                count = 1  # api.go:63-65
            idxs.append(len(lines))
            lines.append(None)
            names.append(name)
            rates.append(rate)
            counts.append(count)
        if not lines:
            return 400, b"no take entries (t=<name>,<rate>,<count>)\n", "text/plain"
        if names:
            submit = getattr(self.repo, "submit_takes_batch", None)
            if submit is None:
                # Minimal repo (tests): per-entry scalar path, no shed lane.
                for i, (name, rate, count) in zip(idxs, zip(names, rates, counts)):
                    try:
                        remaining, ok = await self.repo.take_async(name, rate, count)
                    except OverloadedError:
                        lines[i] = b"429 overloaded"
                        continue
                    lines[i] = b"%d %d" % (200 if ok else 429, remaining)
            else:
                res = submit(names, rates, counts)
                if res is None:
                    # Pool spent with every row pinned — same per-entry
                    # outcome the batcher reports for this overload.
                    for i in idxs:
                        lines[i] = b"429 0"
                else:
                    loop = asyncio.get_running_loop()
                    futs = []
                    for ticket, _created in res:
                        fut: asyncio.Future = loop.create_future()

                        def _done(f=fut):
                            loop.call_soon_threadsafe(
                                lambda: f.done() or f.set_result(None)
                            )

                        ticket.add_done_callback(_done)
                        futs.append((ticket, fut))
                    for i, (ticket, fut) in zip(idxs, futs):
                        await fut
                        if getattr(ticket, "shed", False):
                            lines[i] = b"429 overloaded"
                        else:
                            lines[i] = b"%d %d" % (
                                200 if ticket.ok else 429,
                                ticket.remaining,
                            )
        body = b"\n".join(lines) + b"\n"
        if self.log is not None:
            self.log.debug(
                "take_batch", extra={"entries": len(lines), "submitted": len(names)}
            )
        return 200, body, "text/plain"

    async def _tokens(self, raw_name: str) -> Tuple[int, bytes, str]:
        """Read-only balance introspection — ``GET /tokens/:name`` returns
        the bucket's current whole-token balance WITHOUT taking (and
        without a refill projection, which would need the request's rate:
        balance = cap + Σadded − Σtaken, bucket.go:156's Tokens()). The
        reference exposes no such route; operators debugging a limit had
        to consume a token to see the balance. Unknown bucket → 404."""
        name, err = self._decode_name(raw_name)
        if err is not None:
            return err
        loop = asyncio.get_running_loop()
        # tokens_if_known gathers device state — off the event loop.
        tok = await loop.run_in_executor(None, self.repo.tokens_if_known, name)
        if tok is None:
            return 404, b"unknown bucket\n", "text/plain"
        return 200, str(tok).encode(), "text/plain"

    # -- debug / observability (≙ api.go:29-39) -----------------------------

    async def _debug(self, method: str, path: str, query: str) -> Tuple[int, bytes, str]:
        from patrol_tpu_torch.utils import profiling

        q = parse_qs(query)
        loop = asyncio.get_running_loop()

        if path == "/metrics" or path == "/debug/vars":
            body = self._metrics() if path == "/metrics" else json.dumps(
                self.stats(), indent=2
            ).encode()
            ctype = "text/plain; version=0.0.4" if path == "/metrics" else "application/json"
            return 200, body, ctype
        if path == "/debug/audit":
            # patrol-audit: the consistency plane's gauges plus the last
            # evaluated window's per-bucket overshoot detail.
            if self.audit is None:
                return 503, b"no audit plane\n", "text/plain"
            body = json.dumps(
                {
                    **self.audit.stats(),
                    "last_evaluation": self.audit.last_evaluation(),
                },
                indent=2,
            ).encode()
            return 200, body, "application/json"
        if path == "/debug/pprof/" or path == "/debug/pprof":
            index = (
                "patrol_tpu_torch debug index\n\n"
                "/debug/pprof/profile?seconds=N  sampling CPU profile, pprof protobuf (&debug=1 for text)\n"
                "/debug/pprof/mutex              lock-contention profile, pprof protobuf (&debug=1 for text)\n"
                "/debug/pprof/block              condition-wait profile, pprof protobuf (&debug=1 for text)\n"
                "/debug/pprof/goroutine          thread stack dump\n"
                "/debug/pprof/heap               allocation summary\n"
                "/debug/pprof/allocs             allocation summary\n"
                "/debug/trace/ring               flight-recorder rings, Chrome-trace JSON (&snapshot=N for anomaly snapshots)\n"
                "/debug/trace/spans              cross-node take spans JSON (&trace_id=N to filter)\n"
                "/debug/cuda/trace?seconds=N     torch.profiler capture (host ops, card kernels), Chrome-trace JSON path\n"
                "/debug/pprof/trace?seconds=N    the same capture (default 1 s)\n"
                "/debug/vars                     engine stats JSON (incl. histogram summaries)\n"
                "/metrics                        prometheus text exposition (gauges + latency histograms)\n"
                "/debug/audit                    patrol-audit consistency gauges + last overshoot evaluation JSON\n"
                "/cluster/metrics                fleet-merged exposition, node-labeled lanes (patrol-fleet gossip)\n"
                "/cluster/vars                   fleet-merged summaries JSON (patrol-fleet gossip)\n"
            )
            return 200, index.encode(), "text/plain"
        if path == "/debug/pprof/profile":
            seconds = float(q.get("seconds", ["5"])[0])
            prof = profiling.SamplingProfiler(duration_s=seconds)
            # Go convention (api.go:29-39): gzipped pprof protobuf by
            # default — `go tool pprof http://host/debug/pprof/profile`
            # and speedscope open it; ?debug=1 for human-readable text.
            if q.get("debug", ["0"])[0] not in ("0", ""):
                body = await loop.run_in_executor(None, prof.run)
                return 200, body.encode(), "text/plain"
            raw = await loop.run_in_executor(None, prof.run_pprof)
            return 200, raw, "application/octet-stream"
        if path in ("/debug/pprof/goroutine", "/debug/pprof/threadcreate"):
            return 200, profiling.thread_dump().encode(), "text/plain"
        if path in ("/debug/pprof/heap", "/debug/pprof/allocs"):
            return 200, profiling.heap_summary().encode(), "text/plain"
        if path in ("/debug/pprof/mutex", "/debug/pprof/block"):
            # REAL contention profiles (≙ main.go:24's mutex fraction +
            # api.go:29-39 routes): wait-time sampling around the engine/
            # directory locks and condition parks, as pprof protobuf.
            reg = profiling.REGISTRY
            mutex = path.endswith("mutex")
            if q.get("debug", ["0"])[0] not in ("0", ""):
                text = reg.mutex_text() if mutex else reg.block_text()
                return 200, text.encode(), "text/plain"
            raw = reg.mutex_pprof() if mutex else reg.block_pprof()
            return 200, raw, "application/octet-stream"
        if path == "/debug/trace/ring":
            from patrol_tpu_torch.utils import trace as trace_mod

            snap_arg = q.get("snapshot", [None])[0]
            if snap_arg is not None:
                snaps = trace_mod.TRACE.snapshots()
                if snap_arg in ("", "latest"):
                    idx = len(snaps) - 1
                else:
                    try:
                        idx = int(snap_arg)
                    except ValueError:
                        return 400, b"bad snapshot index\n", "text/plain"
                if not 0 <= idx < len(snaps):
                    return 404, b"no such snapshot\n", "text/plain"
                snap = snaps[idx]
                body = trace_mod.TRACE.chrome_trace(events=snap["events"])
                return 200, body, "application/json"
            return 200, trace_mod.TRACE.chrome_trace(), "application/json"
        if path == "/debug/trace/snapshots":
            from patrol_tpu_torch.utils import trace as trace_mod

            listing = [
                {"index": i, "reason": s["reason"], "at_ns": s["at_ns"],
                 "events": len(s["events"])}
                for i, s in enumerate(trace_mod.TRACE.snapshots())
            ]
            return 200, json.dumps(listing).encode(), "application/json"
        if path == "/debug/trace/spans":
            from patrol_tpu_torch.utils import trace as trace_mod

            tid = None
            if q.get("trace_id"):
                try:
                    tid = int(q["trace_id"][0])
                except ValueError:
                    return 400, b"bad trace_id\n", "text/plain"
            body = json.dumps(trace_mod.SPANS.export(tid)).encode()
            return 200, body, "application/json"
        if path == "/debug/pprof/cmdline":
            import sys

            return 200, "\x00".join(sys.argv).encode(), "text/plain"
        if path == "/debug/pprof/symbol":
            # go tool pprof symbolization probe (api.go:29-39 route set).
            # Python profiles carry symbol names inline (utils/pprof.py
            # string table), so there is nothing to resolve — answer the
            # probe in the expected format.
            return 200, b"num_symbols: 1\n", "text/plain"
        if path in ("/debug/cuda/trace", "/debug/pprof/trace"):
            # Go's /debug/pprof/trace is a runtime execution trace; here
            # both routes take the device trace (the reference's
            # /debug/jax/trace). Unlike the reference's /debug/pprof/trace,
            # both answer an overlapping capture with 409.
            default = "2" if path == "/debug/cuda/trace" else "1"
            try:
                seconds = float(q.get("seconds", [default])[0])
            except ValueError:
                return 400, b"bad seconds\n", "text/plain"
            if not seconds >= 0:
                return 400, b"bad seconds\n", "text/plain"
            try:
                out = await loop.run_in_executor(None, profiling.cuda_trace, seconds)
            except profiling.ProfilerBusyError:
                return 409, b"a trace capture is already running; retry later\n", "text/plain"
            return 200, f"trace written to {out}\n".encode(), "text/plain"
        return 404, b"not found\n", "text/plain"

    def _cluster(self, path: str) -> Tuple[int, bytes, str]:
        """patrol-fleet fleet views (net/fleet.py): ``/cluster/metrics``
        is the MERGED Prometheus exposition — every gossiped node's
        counter and histogram lanes, ``node``-labeled, strictly
        parseable — and ``/cluster/vars`` the JSON summary form. Served
        from the local gossip store: any node answers for the fleet."""
        from patrol_tpu_torch.utils import histogram as hist_mod

        if self.fleet is None:
            return 503, b"no fleet gossip plane on this node\n", "text/plain"
        if path == "/cluster/metrics":
            body = hist_mod.render_fleet_exposition(self.fleet.store).encode()
            return 200, body, "text/plain; version=0.0.4"
        if path == "/cluster/vars":
            body = json.dumps(
                {**self.fleet.store.summary(), "gossip": self.fleet.stats()},
                indent=2,
            ).encode()
            return 200, body, "application/json"
        return 404, b"not found\n", "text/plain"

    def _admin_peers(self, method: str, query: str) -> Tuple[int, bytes, str]:
        """patrol-membership admin surface (net/membership.py). Input
        rides the query string — both HTTP fronts drain but IGNORE
        request bodies, like /take.

        * ``GET /admin/peers`` → the live SlotTable view (epoch, lanes,
          tombstones) + the membership plane's counters.
        * ``POST /admin/peers?op=add&addr=host:port`` → admit a member;
          200 with the receipt (lane + epoch), 409 when no lane is
          assignable (lane space exhausted, or the address's lane is
          tombstoned — a retired lane needs the rejoin handshake).
        * ``POST /admin/peers?op=remove&addr=host:port`` → retire the
          member's lane behind a tombstone; 200 with the receipt carrying
          ``tombstone_epoch`` (the leaver's future rejoin credential),
          409 for self/unknown addresses.
        """
        if self.membership is None:
            return 503, b"no membership plane on this node\n", "text/plain"
        if method == "GET":
            body = json.dumps(
                {**self.membership.view(), **self.membership.stats()},
                indent=2,
            ).encode()
            return 200, body, "application/json"
        if method != "POST":
            return 405, b"method not allowed\n", "text/plain"
        q = parse_qs(query, keep_blank_values=True)
        op = q.get("op", [""])[0]
        addr = q.get("addr", [""])[0]
        if op not in ("add", "remove") or not addr or ":" not in addr:
            return 400, b"need op=add|remove and addr=host:port\n", "text/plain"
        receipt = (
            self.membership.local_join(addr)
            if op == "add"
            else self.membership.local_leave(addr)
        )
        if receipt is None:
            return 409, f"cannot {op} {addr}\n".encode(), "text/plain"
        receipt["epoch_now"] = self.membership.view()["epoch"]
        return 200, json.dumps(receipt, indent=2).encode(), "application/json"

    def _metrics(self) -> bytes:
        """Prometheus text exposition (patrol-scope): every numeric stat
        as a gauge plus the real latency histograms — cumulative
        ``_bucket``/``_sum``/``_count`` series a scraper can ingest
        (utils/histogram.py render_exposition; roundtrip-pinned by the
        parse fixture in tests and the CI smoke gate)."""
        from patrol_tpu_torch.utils import histogram as hist_mod

        uptime = time.time() - self.started_at  # patrol-lint: clock-seam (uptime)
        return hist_mod.render_exposition(self.stats(), uptime_s=uptime).encode()


class _HTTPProtocol(asyncio.Protocol):
    """Minimal HTTP/1.1 with keep-alive. Requests with bodies are accepted
    (drained by Content-Length) but bodies are ignored — /take carries all
    its input in the URL, like the reference."""

    def __init__(self, api: API):
        self.api = api
        self.buf = b""
        self.transport: Optional[asyncio.Transport] = None
        self._body_to_skip = 0
        self._h2 = None  # set when the h2c preface is sniffed
        # FIFO lock: pipelined requests are handled concurrently but their
        # responses are written in request order.
        self._write_order = asyncio.Lock()
        # In-flight HTTP/1.1 responses (scheduled, not yet written): an
        # h2c Upgrade must be refused while any are pending, or the 101 +
        # h2 frames would interleave with their HTTP/1.1 bytes.
        self._h1_inflight = 0

    def connection_made(self, transport) -> None:
        self.transport = transport
        try:
            import socket

            sock = transport.get_extra_info("socket")
            if sock is not None:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass

    def data_received(self, data: bytes) -> None:
        if self._h2 is not None:
            self._feed_h2(data)
            return
        self.buf += data
        # h2c prior-knowledge sniff (≙ h2c.NewHandler, command.go:41-44):
        # "PRI " is not a valid HTTP/1.1 method, so 4 bytes disambiguate.
        if self._body_to_skip == 0 and self.buf[:4] == b"PRI ":
            from patrol_tpu_torch.net import h2 as h2mod

            if h2mod.available():
                self._h2 = h2mod.H2Connection(self._on_h2_request)
                pending, self.buf = self.buf, b""
                self._feed_h2(pending)
                return
        while True:
            if self._body_to_skip:
                skip = min(self._body_to_skip, len(self.buf))
                self.buf = self.buf[skip:]
                self._body_to_skip -= skip
                if self._body_to_skip:
                    return
            end = self.buf.find(b"\r\n\r\n")
            if end < 0:
                if len(self.buf) > 65536:
                    self.transport.close()
                return
            head, self.buf = self.buf[:end], self.buf[end + 4 :]
            lines = head.split(b"\r\n")
            try:
                method, target, _version = lines[0].decode("latin-1").split(" ", 2)
            except ValueError:
                self.transport.close()
                return
            clen = 0
            keep_alive = True
            conn_upgrade = False
            upgrade_h2c = False
            h2_settings = None
            for line in lines[1:]:
                low = line.lower()
                if low.startswith(b"content-length:"):
                    try:
                        clen = int(line.split(b":", 1)[1])
                    except ValueError:
                        clen = 0
                elif low.startswith(b"connection:"):
                    if b"close" in low:
                        keep_alive = False
                    if b"upgrade" in low:
                        conn_upgrade = True
                elif low.startswith(b"upgrade:") and b"h2c" in low.split(b":", 1)[1]:
                    upgrade_h2c = True
                elif low.startswith(b"http2-settings:"):
                    h2_settings = line.split(b":", 1)[1].strip()
            path, _, query = target.partition("?")
            # h2c Upgrade (RFC 7540 §3.2 ≙ h2c.NewHandler's second mode,
            # command.go:41-44): 101, then h2 with the upgrade request as
            # stream 1 (half-closed remote). Requests with bodies keep
            # HTTP/1.1 — /take carries its input in the URL.
            if conn_upgrade and upgrade_h2c and clen == 0 and self._h1_inflight == 0:
                from patrol_tpu_torch.net import h2 as h2mod

                if h2mod.available():
                    self._upgrade_h2c(method, path, query, h2_settings)
                    return
            self._body_to_skip = clen
            self._h1_inflight += 1
            asyncio.ensure_future(self._respond(method, path, query, keep_alive))

    def _upgrade_h2c(self, method: str, path: str, query: str, h2_settings) -> None:
        from patrol_tpu_torch.net import h2 as h2mod

        self.transport.write(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Connection: Upgrade\r\nUpgrade: h2c\r\n\r\n"
        )
        self._h2 = h2mod.H2Connection(self._on_h2_request)
        if h2_settings:
            import base64

            try:  # §3.2.1: base64url-encoded SETTINGS payload
                pad = b"=" * (-len(h2_settings) % 4)
                self._h2.apply_upgrade_settings(
                    base64.urlsafe_b64decode(h2_settings + pad)
                )
            except ValueError:
                pass  # malformed settings: keep defaults
        # Server preface SETTINGS must precede the stream-1 response (§3.2).
        self.transport.write(self._h2.start())
        self._on_h2_request(1, method, path, query)
        pending, self.buf = self.buf, b""
        if pending:
            self._feed_h2(pending)

    def _feed_h2(self, data: bytes) -> None:
        try:
            out = self._h2.receive(data)
        except Exception as exc:
            if self.api.log is not None:
                self.api.log.error("h2 error", extra={"error": repr(exc)})
            self.transport.close()
            return
        if out:
            self.transport.write(out)
        if self._h2.closed:
            self.transport.close()

    def _on_h2_request(self, stream_id: int, method: str, path: str, query: str) -> None:
        asyncio.ensure_future(self._respond_h2(stream_id, method, path, query))

    async def _respond_h2(self, stream_id: int, method: str, path: str, query: str) -> None:
        try:
            status, body, ctype = await self.api.handle(method, path, query)
        except Exception as exc:  # pragma: no cover
            if self.api.log is not None:
                self.api.log.error("api error", extra={"error": repr(exc)})
            status, body, ctype = 500, b"internal error\n", "text/plain"
        if self.transport is None or self.transport.is_closing() or self._h2 is None:
            return
        self.transport.write(self._h2.send_response(stream_id, status, body, ctype))

    async def _respond(self, method: str, path: str, query: str, keep_alive: bool) -> None:
        try:
            await self._respond_inner(method, path, query, keep_alive)
        finally:
            self._h1_inflight -= 1

    async def _respond_inner(
        self, method: str, path: str, query: str, keep_alive: bool
    ) -> None:
        async with self._write_order:
            try:
                status, body, ctype = await self.api.handle(method, path, query)
            except Exception as exc:  # pragma: no cover
                if self.api.log is not None:
                    self.api.log.error("api error", extra={"error": repr(exc)})
                status, body, ctype = 500, b"internal error\n", "text/plain"
        if self.transport is None or self.transport.is_closing():
            return
        reason = _STATUS_TEXT.get(status, "Unknown")
        head = (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n"
            "\r\n"
        ).encode("latin-1")
        self.transport.write(head + body)
        if not keep_alive:
            self.transport.close()


async def serve(api: API, host: str, port: int) -> asyncio.AbstractServer:
    loop = asyncio.get_running_loop()
    return await loop.create_server(lambda: _HTTPProtocol(api), host, port)
