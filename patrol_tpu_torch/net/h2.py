"""Minimal HTTP/2 cleartext (h2c, prior-knowledge) server layer.

Parity target: the reference serves its API over h2c
(``h2c.NewHandler(api, &http2.Server{})``, command.go:41-44). This module
implements the slice of RFC 7540 the Patrol API surface needs — bodyless
requests in, small responses out, many streams per connection — as a
sans-io state machine (:class:`H2Connection`): bytes in via
:meth:`receive`, bytes out via the returned buffer + an async response
path. The HTTP front (net/api.py) sniffs the client preface and switches
a connection to this layer.

HPACK: header-block *decoding* (incl. Huffman, dynamic table) is delegated
via ctypes to the system ``libnghttp2`` — the same battle-tested inflater
curl links — because a hand-written Huffman table cannot be verified in
this environment. *Encoding* of responses uses only HPACK literals without
indexing (always-valid canonical form), so no deflater is needed. When
libnghttp2 is absent, the server simply stays HTTP/1.1-only.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
import threading
from typing import Callable, Dict, List, Tuple

# -- frame constants (RFC 7540 §6) ------------------------------------------

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA = 0x0
HEADERS = 0x1
PRIORITY = 0x2
RST_STREAM = 0x3
SETTINGS = 0x4
PUSH_PROMISE = 0x5
PING = 0x6
GOAWAY = 0x7
WINDOW_UPDATE = 0x8
CONTINUATION = 0x9

FLAG_END_STREAM = 0x1
FLAG_ACK = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

MAX_FRAME_SIZE = 16384  # we never exceed the default peer setting
DEFAULT_WINDOW = 65535  # RFC 7540 §6.9.2 initial flow-control window

SETTINGS_INITIAL_WINDOW_SIZE = 0x4


# -- libnghttp2 HPACK inflater ----------------------------------------------


class _NV(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.POINTER(ctypes.c_uint8)),
        ("value", ctypes.POINTER(ctypes.c_uint8)),
        ("namelen", ctypes.c_size_t),
        ("valuelen", ctypes.c_size_t),
        ("flags", ctypes.c_uint8),
    ]


_HD_INFLATE_FINAL = 0x01
_HD_INFLATE_EMIT = 0x02

_lib = None
_lib_mu = threading.Lock()
_lib_failed = False


def _load_nghttp2():
    global _lib, _lib_failed
    with _lib_mu:
        if _lib is not None or _lib_failed:
            return _lib
        name = ctypes.util.find_library("nghttp2") or "libnghttp2.so.14"
        try:
            lib = ctypes.CDLL(name)
            lib.nghttp2_hd_inflate_new.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
            lib.nghttp2_hd_inflate_new.restype = ctypes.c_int
            lib.nghttp2_hd_inflate_del.argtypes = [ctypes.c_void_p]
            lib.nghttp2_hd_inflate_hd2.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(_NV),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_size_t,
                ctypes.c_int,
            ]
            lib.nghttp2_hd_inflate_hd2.restype = ctypes.c_ssize_t
            lib.nghttp2_hd_inflate_end_headers.argtypes = [ctypes.c_void_p]
            _lib = lib
        except OSError:
            _lib_failed = True
        return _lib


def available() -> bool:
    return _load_nghttp2() is not None


class HpackDecoder:
    """Per-connection stateful HPACK inflater (dynamic table lives here)."""

    def __init__(self):
        lib = _load_nghttp2()
        if lib is None:
            raise RuntimeError("libnghttp2 unavailable")
        self._lib = lib
        self._inflater = ctypes.c_void_p()
        rv = lib.nghttp2_hd_inflate_new(ctypes.byref(self._inflater))
        if rv != 0:
            raise RuntimeError(f"nghttp2_hd_inflate_new: {rv}")

    def decode(self, block: bytes) -> List[Tuple[bytes, bytes]]:
        lib = self._lib
        buf = (ctypes.c_uint8 * len(block)).from_buffer_copy(block)
        offset = 0
        out: List[Tuple[bytes, bytes]] = []
        nv = _NV()
        flags = ctypes.c_int(0)
        # Keep calling until the inflater signals FINAL — it can need an
        # extra zero-consuming call after the last byte; calling
        # end_headers() before FINAL poisons the dynamic-table state for
        # the connection's next header block.
        while True:
            consumed = lib.nghttp2_hd_inflate_hd2(
                self._inflater,
                ctypes.byref(nv),
                ctypes.byref(flags),
                ctypes.cast(
                    ctypes.addressof(buf) + offset, ctypes.POINTER(ctypes.c_uint8)
                ),
                len(block) - offset,
                1,
            )
            if consumed < 0:
                raise ValueError(f"hpack inflate error {consumed}")
            offset += consumed
            if flags.value & _HD_INFLATE_EMIT:
                name = ctypes.string_at(nv.name, nv.namelen)
                value = ctypes.string_at(nv.value, nv.valuelen)
                out.append((name, value))
            if flags.value & _HD_INFLATE_FINAL:
                break
            if consumed == 0 and not (flags.value & _HD_INFLATE_EMIT):
                break  # stalled without FINAL: malformed block
        lib.nghttp2_hd_inflate_end_headers(self._inflater)
        return out

    def __del__(self):  # pragma: no cover
        try:
            if self._inflater:
                self._lib.nghttp2_hd_inflate_del(self._inflater)
        except Exception:
            pass


def _encode_literal(name: bytes, value: bytes) -> bytes:
    """HPACK 'literal without indexing, new name', no Huffman — the
    always-valid canonical encoding (RFC 7541 §6.2.2)."""

    def prefix_int(n: int, prefix_bits: int, first: int) -> bytes:
        limit = (1 << prefix_bits) - 1
        if n < limit:
            return bytes([first | n])
        out = bytearray([first | limit])
        n -= limit
        while n >= 128:
            out.append((n & 0x7F) | 0x80)
            n >>= 7
        out.append(n)
        return bytes(out)

    return (
        b"\x00"
        + prefix_int(len(name), 7, 0)
        + name
        + prefix_int(len(value), 7, 0)
        + value
    )


def encode_response_headers(status: int, ctype: str, length: int) -> bytes:
    return (
        _encode_literal(b":status", str(status).encode())
        + _encode_literal(b"content-type", ctype.encode())
        + _encode_literal(b"content-length", str(length).encode())
    )


def frame(ftype: int, flags: int, stream_id: int, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))[1:]
        + bytes([ftype, flags])
        + struct.pack(">I", stream_id & 0x7FFFFFFF)
        + payload
    )


# RespondFn: called with (stream_id, method, path, query); must eventually
# invoke H2Connection.send_response (possibly from another thread/task).
RespondFn = Callable[[int, str, str, str], None]


class H2Connection:
    """Sans-io h2c server connection. Feed bytes to :meth:`receive`; it
    returns bytes to write. Completed requests invoke ``on_request``;
    responses are framed by :meth:`send_response`."""

    def __init__(self, on_request: RespondFn):
        self.decoder = HpackDecoder()
        self.on_request = on_request
        self.buf = b""
        self.preface_done = False
        self.sent_settings = False
        self.closed = False
        # streams collecting header blocks across CONTINUATION frames
        self._pending: Dict[int, dict] = {}
        # -- send-side flow control (RFC 7540 §6.9) --------------------------
        # send_response may run on another thread than receive(), so window
        # state and the deferred-body queue share one lock.
        self._fc_mu = threading.Lock()
        self._conn_window = DEFAULT_WINDOW
        self._initial_window = DEFAULT_WINDOW
        self._stream_windows: Dict[int, int] = {}
        # stream_id -> remaining body bytes awaiting window (END_STREAM is
        # implied: every response we frame ends its stream).
        self._deferred: Dict[int, memoryview] = {}
        self._deferred_order: List[int] = []

    # -- input --------------------------------------------------------------

    def start(self) -> bytes:
        """The server connection preface (one SETTINGS frame, §3.4) —
        emitted by the first :meth:`receive`, or eagerly by the h2c
        Upgrade path (§3.2: the server's first h2 frame MUST be SETTINGS,
        and it must hit the wire before the stream-1 response).
        Advertises MAX_CONCURRENT_STREAMS explicitly: some clients
        (curl/nghttp2) treat an absent value as "don't reuse this
        connection" when deciding whether to multiplex."""
        if self.sent_settings:
            return b""
        self.sent_settings = True
        settings = struct.pack(">HI", 0x3, 256) + struct.pack(">HI", 0x4, 1 << 20)
        return frame(SETTINGS, 0, 0, settings)

    def apply_upgrade_settings(self, payload: bytes) -> None:
        """Apply the decoded ``HTTP2-Settings`` header of an h2c Upgrade
        request (§3.2.1: its payload is a SETTINGS frame body)."""
        self._apply_settings(payload)

    def receive(self, data: bytes) -> bytes:
        self.buf += data
        out = bytearray(self.start())
        if not self.preface_done:
            if len(self.buf) < len(PREFACE):
                return bytes(out)
            if not self.buf.startswith(PREFACE):
                self.closed = True
                return bytes(out)
            self.buf = self.buf[len(PREFACE) :]
            self.preface_done = True

        while len(self.buf) >= 9:
            length = int.from_bytes(self.buf[0:3], "big")
            ftype = self.buf[3]
            flags = self.buf[4]
            stream_id = int.from_bytes(self.buf[5:9], "big") & 0x7FFFFFFF
            if len(self.buf) < 9 + length:
                break
            payload = self.buf[9 : 9 + length]
            self.buf = self.buf[9 + length :]
            out += self._on_frame(ftype, flags, stream_id, payload)
        return bytes(out)

    def _on_frame(self, ftype: int, flags: int, stream_id: int, payload: bytes) -> bytes:
        if ftype == SETTINGS:
            if flags & FLAG_ACK:
                return b""
            self._apply_settings(payload)
            return frame(SETTINGS, FLAG_ACK, 0, b"") + self._flush_deferred()
        if ftype == PING:
            if flags & FLAG_ACK:
                return b""
            return frame(PING, FLAG_ACK, 0, payload)
        if ftype == WINDOW_UPDATE:
            if len(payload) >= 4:
                increment = int.from_bytes(payload[:4], "big") & 0x7FFFFFFF
                with self._fc_mu:
                    if stream_id == 0:
                        self._conn_window += increment
                    elif stream_id in self._stream_windows:
                        # Unknown ids are finished streams (entries are
                        # created at HEADERS, removed at END_STREAM); late
                        # updates for them must not re-create entries or
                        # the map would grow per-stream forever.
                        self._stream_windows[stream_id] += increment
            return self._flush_deferred()
        if ftype == PRIORITY:
            return b""
        if ftype == RST_STREAM:
            self._pending.pop(stream_id, None)
            with self._fc_mu:
                if self._deferred.pop(stream_id, None) is not None:
                    self._deferred_order.remove(stream_id)
                self._stream_windows.pop(stream_id, None)
            return b""
        if ftype == GOAWAY:
            self.closed = True
            return b""
        if ftype == DATA:
            # Request bodies are ignored (the API carries input in the URL,
            # like the reference) but END_STREAM may arrive here.
            st = self._pending.get(stream_id)
            if st and st.get("headers_done") and flags & FLAG_END_STREAM:
                self._dispatch(stream_id)
            return b""
        if ftype == HEADERS:
            block = payload
            pad = 0
            if flags & FLAG_PADDED:
                pad = block[0]
                block = block[1:]
            if flags & FLAG_PRIORITY:
                block = block[5:]
            if pad:
                block = block[: len(block) - pad]
            if stream_id not in self._pending:
                with self._fc_mu:
                    self._stream_windows.setdefault(stream_id, self._initial_window)
            st = self._pending.setdefault(
                stream_id, {"block": b"", "end_stream": False, "headers_done": False}
            )
            st["block"] += block
            st["end_stream"] = bool(flags & FLAG_END_STREAM)
            if flags & FLAG_END_HEADERS:
                st["headers_done"] = True
                st["headers"] = self.decoder.decode(st["block"])
                if st["end_stream"]:
                    self._dispatch(stream_id)
            return b""
        if ftype == CONTINUATION:
            st = self._pending.get(stream_id)
            if st is None:
                return b""
            st["block"] += payload
            if flags & FLAG_END_HEADERS:
                st["headers_done"] = True
                st["headers"] = self.decoder.decode(st["block"])
                if st["end_stream"]:
                    self._dispatch(stream_id)
            return b""
        return b""  # unknown frame types are ignored per spec

    def _dispatch(self, stream_id: int) -> None:
        st = self._pending.pop(stream_id, None)
        if not st:
            return
        headers = dict(st.get("headers", []))
        method = headers.get(b":method", b"GET").decode("latin-1")
        target = headers.get(b":path", b"/").decode("latin-1")
        path, _, query = target.partition("?")
        self.on_request(stream_id, method, path, query)

    # -- output -------------------------------------------------------------

    def send_response(
        self, stream_id: int, status: int, body: bytes, ctype: str
    ) -> bytes:
        hdrs = encode_response_headers(status, ctype, len(body))
        out = bytearray(frame(HEADERS, FLAG_END_HEADERS, stream_id, hdrs))
        with self._fc_mu:
            out += self._send_data_locked(stream_id, memoryview(body))
        return bytes(out)

    def _apply_settings(self, payload: bytes) -> None:
        for off in range(0, len(payload) - 5, 6):
            ident = int.from_bytes(payload[off : off + 2], "big")
            value = int.from_bytes(payload[off + 2 : off + 6], "big")
            if ident == SETTINGS_INITIAL_WINDOW_SIZE:
                with self._fc_mu:
                    # §6.9.2: adjust every open stream's window by the delta
                    # (windows may go negative; sends resume on updates).
                    delta = value - self._initial_window
                    self._initial_window = value
                    for sid in self._stream_windows:
                        self._stream_windows[sid] += delta

    def _send_data_locked(self, stream_id: int, data: memoryview) -> bytes:
        """Frame as much of ``data`` as the connection and stream windows
        allow (zero-length END_STREAM frames are always allowed, §6.9);
        park the remainder for :meth:`_flush_deferred`."""
        out = bytearray()
        if len(data) == 0:
            out += frame(DATA, FLAG_END_STREAM, stream_id, b"")
            self._stream_windows.pop(stream_id, None)
            return bytes(out)
        win = self._stream_windows.setdefault(stream_id, self._initial_window)
        while len(data) > 0:
            allow = min(len(data), MAX_FRAME_SIZE, self._conn_window, win)
            if allow <= 0:
                if stream_id not in self._deferred:
                    self._deferred_order.append(stream_id)
                self._deferred[stream_id] = data
                self._stream_windows[stream_id] = win
                return bytes(out)
            chunk = bytes(data[:allow])
            data = data[allow:]
            self._conn_window -= allow
            win -= allow
            last = len(data) == 0
            out += frame(DATA, FLAG_END_STREAM if last else 0, stream_id, chunk)
        self._stream_windows.pop(stream_id, None)
        return bytes(out)

    def _flush_deferred(self) -> bytes:
        with self._fc_mu:
            if not self._deferred:
                return b""
            out = bytearray()
            for sid in list(self._deferred_order):
                data = self._deferred.pop(sid)
                self._deferred_order.remove(sid)
                out += self._send_data_locked(sid, data)
                if self._conn_window <= 0:
                    break
            return bytes(out)
