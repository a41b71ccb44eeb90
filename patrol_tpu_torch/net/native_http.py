"""Native HTTP front: the C++ epoll server (``native/patrol_http.cpp``)
pumped by a Python batch loop.

The whole socket path — accept, epoll, HTTP parse, percent-decoding,
Go-semantics rate parsing, response formatting — runs in C++, and
crosses into Python in batches:

* the pump thread drains up to ``batch`` parsed /take records in ONE
  ctypes call, submits them through the engine's ``submit_takes_batch``
  (device-resident rows coalesce into the same tick), and a completer
  thread answers them in ONE call back;
* when the engine owns a native host-lane store
  (``runtime/hoststore.py``), the epoll thread answers takes of
  host-resident buckets itself, without entering Python, and the pump
  drains the store's coalesced broadcasts and promotions;
* other routes (debug, metrics, /tokens, /take_batch) go to the port's
  :class:`patrol_tpu_torch.net.api.API` handlers on a private asyncio
  loop, so both fronts share one implementation of them.

h2c with prior knowledge is spoken natively when the system's libnghttp2
loads (HPACK decoding through its inflater); otherwise preface-bearing
connections are spliced byte for byte to a loopback Python h2 server set
with :meth:`NativeHTTPFront.set_h2_backend`. The h1 → h2c Upgrade stays
with the asyncio front.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import threading
import time

import numpy as np

from patrol_tpu_torch import native
from patrol_tpu_torch.ops.rate import Rate
from patrol_tpu_torch.utils import histogram as hist

log = logging.getLogger("patrol.native-http")

NAME_MAX = 256


def native_h2() -> bool:
    """Whether the C++ front speaks h2c itself: it does when it can load
    libnghttp2 for HPACK decoding (the same two names it tries), and
    otherwise splices h2c connections to the h2 backend, if one is set."""
    for name in ("libnghttp2.so.14", "libnghttp2.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        return all(
            hasattr(lib, sym)
            for sym in ("nghttp2_hd_inflate_new", "nghttp2_hd_inflate_del",
                        "nghttp2_hd_inflate_hd2", "nghttp2_hd_inflate_end_headers")
        )
    return False


class NativeHTTPFront:
    """C++ epoll HTTP/1.1 and h2c server + Python batch pump. Without
    libnghttp2, h2c clients are spliced byte for byte to a loopback Python
    h2 server when one is set with :meth:`set_h2_backend`; h1 keep-alive
    stays on the C++ fast path either way."""

    def __init__(self, api, host: str, port: int, batch: int = 1024):
        lib = native.load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self.lib = lib
        self.api = api
        self.h = lib.pt_http_start(host.encode(), port)
        if self.h < 0:
            raise OSError(-self.h, os.strerror(-self.h))
        self.h2_backend_port = 0
        # In-front host serving: when the engine owns a native host-lane
        # store, the epoll thread serves host-resident takes entirely in
        # C++; the pump then also drains the store's coalesced broadcast
        # and promotion events each cycle.
        self._engine = getattr(getattr(api, "repo", None), "engine", None)
        store = getattr(self._engine, "_native_store", None)
        if store is not None and self._engine.directory._ptdir >= 0:
            lib.pt_http_attach_host(
                self.h, store.h, self._engine.directory._ptdir
            )
        self.batch = batch
        b = batch
        self._tags = np.zeros(b, np.uint64)
        self._streams = np.zeros(b, np.int32)  # h2 stream ids (0 = h1)
        self._names = np.zeros((b, NAME_MAX), np.uint8)
        self._name_lens = np.zeros(b, np.int32)
        self._freqs = np.zeros(b, np.int64)
        self._pers = np.zeros(b, np.int64)
        self._counts = np.zeros(b, np.int64)
        self._statuses = np.zeros(b, np.int32)
        self._remaining = np.zeros(b, np.int64)
        ob = 64
        self._otags = np.zeros(ob, np.uint64)
        self._ostreams = np.zeros(ob, np.int32)
        self._otargets = np.zeros((ob, native.PATH_MAX), np.uint8)
        self._otarget_lens = np.zeros(ob, np.int32)
        self._omethods = np.zeros((ob, 8), np.uint8)
        self._ob = ob

        self._stopped = threading.Event()
        # Private loop for the async debug handlers (they use
        # run_in_executor internally, so they need a real running loop).
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._run_loop, name="patrol-http-debug", daemon=True
        )
        self._loop_thread.start()
        # Pipelined pump: the poll/submit thread hands (tags, tickets)
        # groups to the completer, so batch N+1 is being drained and
        # submitted WHILE batch N's device tick runs — without this the
        # front runs lock-step at ~2 ticks of latency per request.
        import queue as _queue

        self._cq: "_queue.Queue" = _queue.Queue(maxsize=64)
        self._completer_thread = threading.Thread(
            target=self._completer, name="patrol-http-complete", daemon=True
        )
        self._completer_thread.start()
        self._pump_thread = threading.Thread(
            target=self._pump, name="patrol-http-pump", daemon=True
        )
        self._pump_thread.start()

    @property
    def port(self) -> int:
        return self.lib.pt_http_port(self.h)

    def _run_loop(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    # -- the batch pump ------------------------------------------------------

    def _pump(self) -> None:
        repo = self.api.repo
        n_other = ctypes.c_int(0)
        # With a host store attached, dirty (coalesced-broadcast) marks
        # deliberately do NOT wake the poll — a take must never pay a pump
        # wakeup on its latency path — so the poll tick is shortened to
        # bound broadcast delay instead (≤5 ms to peers; replication is
        # eventual by design). Promotions still wake the poll predicate.
        store = getattr(self._engine, "_native_store", None)
        poll_ms = 5 if store else 50
        next_drain = 0.0
        # Promotion-event cursor: the store's counter moves ONLY on
        # take-pressure promotion threshold crossings, so a poll woken
        # early by one can bypass the drain cadence below for a
        # promotions-only drain — a newly-hot bucket must
        # not wait out max(poll tick, 4x last drain cost) to leave the
        # slow path. Broadcast building keeps the cadence gate.
        events_seen = store.events if store is not None else 0
        while not self._stopped.is_set():
            nt = self.lib.pt_http_poll(
                self.h, poll_ms,
                self._tags, self._streams, self._names, self._name_lens,
                self._freqs, self._pers, self._counts, self.batch,
                self._otags, self._ostreams, self._otargets,
                self._otarget_lens,
                self._omethods, self._ob, ctypes.byref(n_other),
            )
            if nt < 0:
                return
            if nt > 0:
                try:
                    self._submit_takes(repo, nt)
                except Exception:  # pragma: no cover - keep the front alive
                    log.exception("take pump failed; answering 500")
                    tags = self._tags[:nt].copy()
                    streams = self._streams[:nt].copy()
                    st = np.full(nt, 500, np.int32)
                    rem = np.zeros(nt, np.int64)
                    self.lib.pt_http_complete_takes(
                        self.h, tags, streams, st, rem, nt
                    )
            for j in range(n_other.value):
                self._dispatch_other(j)
            if self._engine is not None:
                drain = getattr(self._engine, "drain_native_broadcasts", None)
                now = time.monotonic()
                if drain is not None and now >= next_drain:
                    if store is not None:
                        events_seen = store.events
                    try:
                        drain()
                    except Exception:  # pragma: no cover
                        log.exception("native broadcast drain failed")
                    # Adaptive cadence: broadcast building must never own
                    # the core the epoll thread serves from — a drain that
                    # burned T of CPU doesn't rerun for 4T (≥ the poll
                    # tick). Coalescing makes the longer interval lossless
                    # (latest state subsumes); convergence lag stays
                    # bounded at ~4× the per-drain cost.
                    next_drain = time.monotonic()
                    next_drain += max(poll_ms / 1000.0, 4 * (next_drain - now))
                elif store is not None and store.events != events_seen:
                    # Cadence gate closed but a promote event woke the
                    # poll: promotions-only drain (dirty rows wait).
                    events_seen = store.events
                    try:
                        self._engine.drain_native_promotions()
                    except Exception:  # pragma: no cover
                        log.exception("native promotion drain failed")
        self._cq.put(None)  # unblock the completer at shutdown

    def _submit_takes(self, repo, nt: int) -> None:
        tags = self._tags[:nt].copy()
        streams = self._streams[:nt].copy()
        names = [
            bytes(self._names[i, : self._name_lens[i]]).decode(
                "utf-8", "surrogateescape"
            )
            for i in range(nt)
        ]
        rates = [
            Rate(freq=int(self._freqs[i]), per_ns=int(self._pers[i]))
            for i in range(nt)
        ]
        counts = self._counts[:nt]
        reserved = [i for i in range(nt) if names[i].startswith("\x00")]
        if reserved:
            # NUL-led names are the replication control channel
            # (net/replication.py CTRL_PREFIX) — not a legal bucket
            # namespace. The python front 400s them in _decode_name;
            # mirror that here BEFORE the engine can bind a row (the
            # in-front C++ path only ever serves rows this pump created,
            # so rejecting creation closes the namespace on this front).
            sel = np.array(reserved, np.intp)
            self.lib.pt_http_complete_takes(
                self.h, tags[sel], streams[sel],
                np.full(len(sel), 400, np.int32),
                np.zeros(len(sel), np.int64), len(sel),
            )
            keep = [i for i in range(nt) if i not in set(reserved)]
            if not keep:
                return
            ksel = np.array(keep, np.intp)
            tags, streams, counts = tags[ksel], streams[ksel], counts[ksel]
            names = [names[i] for i in keep]
            rates = [rates[i] for i in keep]
        res = repo.submit_takes_batch(names, rates, counts)
        if res is None:  # pool spent with everything pinned: rare overload
            raise RuntimeError("bucket pool spent; takes dropped")
        self._cq.put(
            (tags, streams, [t for t, _ in res], time.perf_counter_ns())
        )

    def _completer(self) -> None:
        while True:
            group = self._cq.get()
            if group is None:
                return
            tags, streams, tickets, t_sub = group
            nt = len(tickets)
            statuses = np.empty(nt, np.int32)
            remaining = np.empty(nt, np.int64)
            # Tickets submitted together complete in the same engine
            # tick(s); ordered waits cost one tick total, not one each.
            for i, t in enumerate(tickets):
                t.wait()
                statuses[i] = 200 if t.ok else 429
                remaining[i] = t.remaining
            # The front's engine-wait latency (submit to
            # batch completion), one observation per pump batch — the
            # Python-side complement of the C++ server's own ring
            # (http_latency_* in stats()).
            hist.FRONT_WAIT.record(time.perf_counter_ns() - t_sub)
            self.lib.pt_http_complete_takes(
                self.h, tags, streams, statuses, remaining, nt
            )

    def _dispatch_other(self, j: int) -> None:
        tag = int(self._otags[j])
        stream = int(self._ostreams[j])
        method = bytes(self._omethods[j]).split(b"\0", 1)[0].decode("ascii", "replace")
        target = bytes(self._otargets[j, : self._otarget_lens[j]]).decode(
            "utf-8", "surrogateescape"
        )
        path, _, query = target.partition("?")

        async def run():
            return await self.api.handle(method, path, query)

        fut = asyncio.run_coroutine_threadsafe(run(), self._loop)

        def done(f) -> None:
            try:
                status, body, ctype = f.result()
            except Exception:  # pragma: no cover
                log.exception("debug route failed")
                status, body, ctype = 500, b"internal error\n", "text/plain"
            self.lib.pt_http_complete_other(
                self.h, tag, stream, status, ctype.encode(), body, len(body)
            )

        fut.add_done_callback(done)

    # -- lifecycle / observability -------------------------------------------

    def set_h2_backend(self, port: int) -> None:
        """Set the loopback Python h2 server at 127.0.0.1:``port`` that
        preface-bearing connections are spliced to when libnghttp2 does
        not load (with it, the front answers h2c itself)."""
        rc = self.lib.pt_http_set_h2_backend(self.h, port)
        if rc != 0:
            raise OSError(-rc, "pt_http_set_h2_backend failed")
        self.h2_backend_port = port

    @property
    def h2_mode(self) -> str:
        """How h2c prior-knowledge connections are served: ``native``,
        ``splice`` (to the h2 backend) or ``refused`` (answered 400)."""
        if native_h2():
            return "native"
        return "splice" if self.h2_backend_port else "refused"

    def stats(self) -> dict:
        out = np.zeros(8, np.uint64)
        self.lib.pt_http_stats(self.h, out)
        return {
            "http_accepted": int(out[0]),
            "http_requests": int(out[1]),
            "http_active_conns": int(out[2]),
            "http_dropped": int(out[3]),
            # Server-side (parse → response queued), 4096-sample ring.
            "http_latency_p50_us": int(out[4]) // 1000,
            "http_latency_p99_us": int(out[5]) // 1000,
            "http_latency_max_us": int(out[6]) // 1000,
        }

    def close(self) -> None:
        # Detach the host store FIRST (under the server mutex): the engine
        # destroys the store after this front closes, and the epoll thread
        # must never touch freed blocks — even on the leaked-server path.
        if self._engine is not None and getattr(self._engine, "_native_store", None):
            self.lib.pt_http_attach_host(self.h, -1, -1)
        self._stopped.set()
        self._pump_thread.join(timeout=5)
        self._completer_thread.join(timeout=5)
        if self._pump_thread.is_alive() or self._completer_thread.is_alive():
            # pt_http_poll/complete_takes deliberately skip the registry
            # lock (they assume the pumps are joined first); destroying the
            # Server under a live pump would be a use-after-free. Leak the
            # native server instead — the process is shutting down anyway.
            # The host store must leak WITH it: a wedged pump may be
            # mid-drain inside the store, and engine.stop would otherwise
            # free the blocks under it.
            if self._engine is not None:
                self._engine._leak_native_store = True
            log.error(
                "http pump threads did not exit in 5s; leaking native server "
                "handle %d to avoid a use-after-free", self.h,
            )
        else:
            self.lib.pt_http_stop(self.h)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._loop_thread.join(timeout=5)


def available() -> bool:
    return native.load() is not None
