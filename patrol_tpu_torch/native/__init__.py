"""ctypes bindings for the native host path (``patrol_host.cpp`` and
``patrol_http.cpp``, the port's own copies of the JAX package's sources).

:func:`build` compiles both sources with ``g++`` into one
``libpatrolhost.so`` under ``patrol_tpu_torch/_build/host-<key>/``
(listed in ``.gitignore``), where the key hashes the sources and the
flags: an edited source rebuilds, an unchanged one loads the cached
library. Several processes may build at once (the tests run in parallel
workers): one holds an exclusive lock on the directory's ``lock`` file
and builds to a temporary name, then renames it into place; the others
wait on the lock and load the result. Nothing is built beside the
sources.

:func:`load` returns None when the library cannot be built or loaded
(``auto`` callers then take the pure-Python path), and with
``required=True`` raises :class:`NativeBuildError` carrying g++'s
output instead. Plain C ABI, ctypes and numpy; no torch at import time
(:meth:`RxRing.pin` imports it when called).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger("patrol.native")


class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded."""


class NativeEffect(NamedTuple):
    """Declared cross-boundary effects of one C ABI symbol (the JAX
    package's table, kept symbol for symbol so the port's analysis
    passes, when they come, read the same contract). Python code cannot
    see into the .so: a ctypes call that parks the caller on a condition
    variable (``pt_http_poll``) or takes the host-lane store mutex
    (``pt_hls_lock``) is invisible to a lock-order or blocking-call walk
    of the Python source, so each symbol declares it here.

    * ``blocks`` — may block the calling thread for scheduling-relevant
      time: poll/condvar waits, thread create/join, or acquiring a mutex
      the epoll thread contends.
    * ``takes_host_mu`` — acquires the host-lane store mutex internally
      (or IS the acquisition).
    * ``requires_host_mu`` — caller must already hold that mutex (the
      ``*_locked`` family and ``pt_hls_unlock``).
    * ``callback_safe`` — pure compute on caller-owned buffers: no
      locks, no syscalls that block.
    * ``owns_buffers`` / ``borrows_until`` — buffer-ownership contract.
      Most symbols *borrow* their numpy arguments for the duration of the
      call only (``borrows_until="call"``); a symbol that RETAINS the
      pointers past its return (``owns_buffers=True``) names the
      releasing symbol in ``borrows_until`` — until that release runs,
      the Python side must never rebind or resize those arrays (the .so
      would keep reading freed storage: use-after-recycle).
    """

    blocks: bool
    takes_host_mu: bool
    requires_host_mu: bool
    callback_safe: bool
    owns_buffers: bool = False
    borrows_until: str = "call"


_E = NativeEffect

# One entry per ctypes symbol registered in _bind() below
# (tests/test_torch_native.py checks both directions).
NATIVE_EFFECTS: Dict[str, NativeEffect] = {
    # -- UDP replication plane (patrol_host.cpp) --
    "pt_udp_open": _E(False, False, False, False),
    "pt_udp_port": _E(False, False, False, False),
    "pt_udp_close": _E(False, False, False, False),
    "pt_recv_batch": _E(True, False, False, False),   # poll(timeout_ms); kernel rx stamps
    "pt_send_fanout": _E(True, False, False, False),  # POLLOUT stall wait
    "pt_send_pairs": _E(True, False, False, False),  # POLLOUT stall wait
    "pt_decode_batch": _E(False, False, False, True),
    "pt_encode_batch": _E(False, False, False, True),
    "pt_walk_batch": _E(False, False, False, True),
    # -- zero-copy rx ring (device-resident ingest) --
    # pt_rx_ring_create allocates C++-OWNED page-aligned planes that
    # Python views zero-copy via pt_rx_ring_plane until destroy: the
    # inverse of the usual borrow, declared owns_buffers so the
    # ownership pass tracks the retained-memory lifetime — rebinding or
    # freeing while the engine's H2D still reads a leased plane is the
    # use-after-recycle class (destroy therefore DEFERS while any plane
    # is leased; the last commit frees).
    "pt_rx_ring_create": _E(
        False, False, False, False,
        owns_buffers=True, borrows_until="pt_rx_ring_destroy",
    ),
    "pt_rx_ring_plane": _E(False, False, False, False),
    "pt_rx_ring_lease": _E(False, False, False, False),   # leaf mutex
    "pt_rx_ring_commit": _E(False, False, False, False),  # leaf mutex
    "pt_rx_ring_stats": _E(False, False, False, False),
    "pt_rx_ring_destroy": _E(False, False, False, False),
    # -- directory / rx fast path --
    # pt_dir_create RETAINS name_bytes/name_len: the C++ directory
    # verifies hash hits against those rows through the stored pointers
    # until pt_dir_destroy. Rebinding either array use-after-frees.
    "pt_dir_create": _E(
        False, False, False, False,
        owns_buffers=True, borrows_until="pt_dir_destroy",
    ),
    "pt_dir_insert": _E(False, False, False, False),
    "pt_dir_insert_batch": _E(False, False, False, False),
    "pt_dir_delete": _E(False, False, False, False),
    "pt_dir_resolve": _E(False, False, False, False),   # needs py dir lock
    "pt_dir_resolve_rt": _E(False, False, False, False),
    "pt_rx_classify": _E(False, False, False, False),   # needs py dir lock
    "pt_dir_destroy": _E(False, False, False, False),
    "pt_fold_hybrid": _E(True, False, False, False),    # thread fan-out/join
    # -- HTTP front (patrol_http.cpp) --
    "pt_http_start": _E(True, False, False, False),     # spawns epoll thread
    "pt_http_port": _E(False, False, False, False),
    "pt_http_poll": _E(True, False, False, False),      # condvar wait
    "pt_http_complete_takes": _E(False, False, False, False),
    "pt_http_complete_other": _E(False, False, False, False),
    "pt_http_stats": _E(False, False, False, False),
    "pt_http_set_h2_backend": _E(False, False, False, False),
    "pt_http_stop": _E(True, False, False, False),      # joins epoll thread
    "pt_http_attach_host": _E(True, False, False, False),  # server mu
    "pt_http_blast": _E(True, False, False, False),
    "pt_http_blast_h2": _E(True, False, False, False),
    # -- host-lane store (the engine's _host_mu lives here) --
    # pt_hls_create RETAINS cap_base/created/last_used (the directory's
    # side arrays): the in-front take path reads refill baselines through
    # the stored pointers until pt_hls_destroy.
    "pt_hls_create": _E(
        False, False, False, False,
        owns_buffers=True, borrows_until="pt_hls_destroy",
    ),
    "pt_hls_destroy": _E(False, False, False, False),
    "pt_hls_lock": _E(True, True, False, False),
    "pt_hls_unlock": _E(False, False, True, False),
    "pt_hls_host_locked": _E(False, False, True, False),
    "pt_hls_unhost_locked": _E(False, False, True, False),
    "pt_hls_drain_locked": _E(False, False, True, False),
    "pt_hls_stats": _E(True, True, False, False),       # lock_guard st->mu
    "pt_hls_events": _E(False, False, False, True),     # relaxed atomic read
    "pt_hls_take_probe": _E(True, True, False, False),  # lock_guard st->mu
    # -- pure parsing helpers --
    "pt_parse_rate": _E(False, False, False, True),
    "pt_parse_duration": _E(False, False, False, True),
}

PACKET = 256
# recvmmsg rx-ring row width (and the unicast tx bound): sized to the
# delta-interval datagram bound (ops/wire.py DELTA_PACKET_SIZE) so the
# compiled path accepts full 8-KiB intervals.
RX_RING_ROW = 8192
PATH_MAX = 2048  # kPathMax in patrol_http.cpp
_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "patrol_host.cpp", _HERE / "patrol_http.cpp")
BUILD_DIR = _HERE.parent / "_build"
LIB_NAME = "libpatrolhost.so"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_mu = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[BaseException] = None

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_boolp = np.ctypeslib.ndpointer(np.bool_, flags="C_CONTIGUOUS")


def lib_path() -> Path:
    """Where this tree's sources and flags build the library."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"host-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> Path:
    """Compile the library if this tree has not yet; → its path. Raises
    :class:`NativeBuildError` with g++'s output when the build fails."""
    so = lib_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.exists():  # another process built it while we waited
            return so
        tmp = so.with_name(f"{LIB_NAME}.{os.getpid()}.{threading.get_ident()}")
        try:
            res = subprocess.run(
                ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                capture_output=True, text=True, timeout=600,
            )
        except (OSError, subprocess.SubprocessError) as exc:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(f"g++ could not run: {exc}") from exc
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"g++ failed (rc {res.returncode}):\n{res.stderr}"
            )
        os.replace(tmp, so)
    return so


def load(required: bool = False) -> Optional[ctypes.CDLL]:
    """Build if needed and load the library. On failure → None (the
    failure is logged once and remembered), or, with ``required``, raise
    :class:`NativeBuildError`."""
    global _lib, _load_error
    with _mu:
        if _lib is None and _load_error is None:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (NativeBuildError, OSError, AttributeError) as exc:
                _load_error = exc
                log.warning("native library unavailable: %s", exc)
        if _lib is None and required:
            raise NativeBuildError(
                f"the native library did not build or load: {_load_error}"
            ) from _load_error
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every symbol's argument and return types."""
    lib.pt_udp_open.argtypes = [ctypes.c_char_p, ctypes.c_uint16]
    lib.pt_udp_open.restype = ctypes.c_int
    lib.pt_udp_port.argtypes = [ctypes.c_int]
    lib.pt_udp_port.restype = ctypes.c_int
    lib.pt_udp_close.argtypes = [ctypes.c_int]
    lib.pt_recv_batch.argtypes = [
        ctypes.c_int, _u8p, ctypes.c_int, ctypes.c_int, _i32p, _u32p,
        _u16p, _i64p, ctypes.c_int,
    ]
    lib.pt_recv_batch.restype = ctypes.c_int
    lib.pt_send_fanout.argtypes = [
        ctypes.c_int, _u8p, _i32p, ctypes.c_int, ctypes.c_int, _u32p,
        _u16p, ctypes.c_int,
    ]
    lib.pt_send_fanout.restype = ctypes.c_int
    lib.pt_send_pairs.argtypes = [
        ctypes.c_int, _u8p, _i32p, ctypes.c_int, ctypes.c_int, _u32p, _u16p,
        _u8p,
    ]
    lib.pt_send_pairs.restype = ctypes.c_int
    lib.pt_rx_ring_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.pt_rx_ring_create.restype = ctypes.c_int
    lib.pt_rx_ring_plane.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pt_rx_ring_plane.restype = ctypes.c_int64
    lib.pt_rx_ring_lease.argtypes = [ctypes.c_int]
    lib.pt_rx_ring_lease.restype = ctypes.c_int
    lib.pt_rx_ring_commit.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pt_rx_ring_commit.restype = ctypes.c_int
    lib.pt_rx_ring_stats.argtypes = [ctypes.c_int, _u64p]
    lib.pt_rx_ring_stats.restype = ctypes.c_int
    lib.pt_rx_ring_destroy.argtypes = [ctypes.c_int]
    lib.pt_rx_ring_destroy.restype = ctypes.c_int
    lib.pt_decode_batch.argtypes = [
        _u8p, _i32p, ctypes.c_int, ctypes.c_int, _f64p, _f64p, _u64p,
        _u8p, _i32p, _i32p, _i64p, _i64p, _i64p, _u64p, _i32p,
    ]
    lib.pt_decode_batch.restype = ctypes.c_int
    lib.pt_encode_batch.argtypes = [
        _f64p, _f64p, _u64p, _u8p, _i32p, _i32p, _i64p, _i64p, _i64p,
        ctypes.c_int, _u8p, _i32p,
    ]
    lib.pt_encode_batch.restype = ctypes.c_int
    lib.pt_walk_batch.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, _i64p, ctypes.c_int,
        _boolp, _i32p, _i64p, _i32p, _i64p, _i32p, _i32p, _i32p, _u64p,
        _i64p, _i64p, _i64p, _i64p, _i64p,
    ]
    lib.pt_walk_batch.restype = ctypes.c_int
    # -- HTTP front (patrol_http.cpp) --
    lib.pt_http_start.argtypes = [ctypes.c_char_p, ctypes.c_uint16]
    lib.pt_http_start.restype = ctypes.c_int
    lib.pt_http_port.argtypes = [ctypes.c_int]
    lib.pt_http_port.restype = ctypes.c_int
    lib.pt_http_poll.argtypes = [
        ctypes.c_int, ctypes.c_int,
        _u64p, _i32p, _u8p, _i32p, _i64p, _i64p, _i64p, ctypes.c_int,
        _u64p, _i32p, _u8p, _i32p, _u8p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.pt_http_poll.restype = ctypes.c_int
    lib.pt_http_complete_takes.argtypes = [
        ctypes.c_int, _u64p, _i32p, _i32p, _i64p, ctypes.c_int,
    ]
    lib.pt_http_complete_takes.restype = ctypes.c_int
    lib.pt_http_complete_other.argtypes = [
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.pt_http_complete_other.restype = ctypes.c_int
    lib.pt_http_stats.argtypes = [ctypes.c_int, _u64p]
    lib.pt_http_stats.restype = ctypes.c_int
    lib.pt_http_set_h2_backend.argtypes = [ctypes.c_int, ctypes.c_uint16]
    lib.pt_http_set_h2_backend.restype = ctypes.c_int
    lib.pt_http_stop.argtypes = [ctypes.c_int]
    lib.pt_http_stop.restype = ctypes.c_int
    lib.pt_dir_create.argtypes = [ctypes.c_int64, _u8p, _i32p]
    lib.pt_dir_create.restype = ctypes.c_int
    lib.pt_dir_insert.argtypes = [ctypes.c_int, ctypes.c_uint64, ctypes.c_int32]
    lib.pt_dir_insert.restype = ctypes.c_int
    lib.pt_dir_insert_batch.argtypes = [ctypes.c_int, _u64p, _i32p, ctypes.c_int]
    lib.pt_dir_insert_batch.restype = ctypes.c_int
    lib.pt_dir_delete.argtypes = [ctypes.c_int, ctypes.c_uint64, ctypes.c_int32]
    lib.pt_dir_delete.restype = ctypes.c_int
    lib.pt_dir_resolve.argtypes = [
        ctypes.c_int, ctypes.c_int, _u64p, _u8p, _i32p, _i64p, _i32p,
        _i64p, ctypes.c_int64,
    ]
    lib.pt_dir_resolve.restype = ctypes.c_int64
    lib.pt_rx_classify.argtypes = [
        ctypes.c_int, ctypes.c_int, _u64p, _u8p, _i32p,
        _f64p, _f64p, _u64p, _i64p, ctypes.c_int64,
        _i64p, _i64p, _i64p, _u8p,
        _i64p, _i32p, _i64p, ctypes.c_int64,
        _i64p, _i64p, _i64p, _i64p, _u8p,
    ]
    lib.pt_rx_classify.restype = ctypes.c_int64
    lib.pt_dir_destroy.argtypes = [ctypes.c_int]
    lib.pt_dir_destroy.restype = ctypes.c_int
    # -- host-lane store (in-front /take serving) --
    lib.pt_hls_create.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _i64p, _i64p, _i64p,
    ]
    lib.pt_hls_create.restype = ctypes.c_int
    lib.pt_hls_destroy.argtypes = [ctypes.c_int]
    lib.pt_hls_destroy.restype = ctypes.c_int
    lib.pt_hls_lock.argtypes = [ctypes.c_int]
    lib.pt_hls_lock.restype = ctypes.c_int
    lib.pt_hls_unlock.argtypes = [ctypes.c_int]
    lib.pt_hls_unlock.restype = ctypes.c_int
    lib.pt_hls_host_locked.argtypes = [ctypes.c_int, ctypes.c_int32]
    lib.pt_hls_host_locked.restype = ctypes.c_int64
    lib.pt_hls_unhost_locked.argtypes = [ctypes.c_int, ctypes.c_int32]
    lib.pt_hls_unhost_locked.restype = ctypes.c_int
    lib.pt_hls_drain_locked.argtypes = [
        ctypes.c_int, _i32p, _i64p, ctypes.c_int, _i32p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.pt_hls_drain_locked.restype = ctypes.c_int
    lib.pt_hls_stats.argtypes = [ctypes.c_int, _u64p]
    lib.pt_hls_stats.restype = ctypes.c_int
    lib.pt_hls_events.argtypes = [ctypes.c_int]
    lib.pt_hls_events.restype = ctypes.c_int64
    lib.pt_http_attach_host.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.pt_http_attach_host.restype = ctypes.c_int
    lib.pt_hls_take_probe.argtypes = [
        ctypes.c_int, ctypes.c_int, _u8p, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pt_hls_take_probe.restype = ctypes.c_int
    lib.pt_dir_resolve_rt.argtypes = [
        ctypes.c_int, _u8p, ctypes.c_int32, _i64p, ctypes.c_int64,
    ]
    lib.pt_dir_resolve_rt.restype = ctypes.c_int32
    lib.pt_fold_hybrid.argtypes = [
        _i64p, _i64p, _i64p, _i64p, _i64p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i64p, _i64p, _i64p, ctypes.c_int64,
        _i64p, _i64p, _i64p, _i64p, _i64p, _i64p, _i64p,
    ]
    lib.pt_fold_hybrid.restype = ctypes.c_int
    lib.pt_http_blast.argtypes = [
        ctypes.c_char_p, ctypes.c_uint16, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _u64p,
    ]
    lib.pt_http_blast.restype = ctypes.c_int
    lib.pt_http_blast_h2.argtypes = [
        ctypes.c_char_p, ctypes.c_uint16, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _u64p,
    ]
    lib.pt_http_blast_h2.restype = ctypes.c_int
    lib.pt_parse_rate.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pt_parse_rate.restype = ctypes.c_int
    lib.pt_parse_duration.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pt_parse_duration.restype = ctypes.c_int
    return lib


class NativeSocket:
    """One UDP socket, native recv/send batch ops, numpy in/out. The rx
    ring rows are ``RX_RING_ROW`` (8 KiB) wide so full delta-interval
    datagrams arrive untruncated on the compiled path."""

    def __init__(self, ip: str, port: int, max_batch: int = 512,
                 row: int = RX_RING_ROW):
        lib = load(required=True)
        self.lib = lib
        self.fd = lib.pt_udp_open(ip.encode(), port)
        if self.fd < 0:
            raise OSError(-self.fd, os.strerror(-self.fd))
        self.max_batch = max_batch
        self.row = max(row, PACKET)
        self._rx_buf = np.zeros((max_batch, self.row), np.uint8)
        self._rx_sizes = np.zeros(max_batch, np.int32)
        self._rx_ips = np.zeros(max_batch, np.uint32)
        self._rx_ports = np.zeros(max_batch, np.uint16)
        self._rx_stamps = np.zeros(max_batch, np.int64)

    @property
    def port(self) -> int:
        return self.lib.pt_udp_port(self.fd)

    def recv_batch(self, timeout_ms: int = 100):
        """→ (packets[n,row] uint8 view, sizes[n], src_ips[n], src_ports[n],
        stamps_ns[n]): ``stamps_ns`` is each datagram's kernel receive
        timestamp (SO_TIMESTAMP: CLOCK_REALTIME to the µs, in ns; 0 where none
        came)."""
        return self.recv_batch_into(self._rx_buf, timeout_ms)

    def recv_batch_into(self, buf: np.ndarray, timeout_ms: int = 100):
        """recvmmsg directly into ``buf`` (uint8[max_batch, row] — an rx
        ring plane for the zero-copy ingest path, or the socket's own
        staging buffer). Same return shape as :meth:`recv_batch`."""
        n = self.lib.pt_recv_batch(
            self.fd, buf, min(self.max_batch, len(buf)), buf.shape[1],
            self._rx_sizes, self._rx_ips, self._rx_ports, self._rx_stamps,
            timeout_ms,
        )
        if n < 0:
            raise OSError(-n, os.strerror(-n))
        return (
            buf[:n],
            self._rx_sizes[:n],
            self._rx_ips[:n],
            self._rx_ports[:n],
            self._rx_stamps[:n],
        )

    def send_fanout(self, payloads: np.ndarray, sizes: np.ndarray,
                    peer_ips: np.ndarray, peer_ports: np.ndarray) -> int:
        if len(payloads) == 0 or len(peer_ips) == 0:
            return 0
        payloads = np.ascontiguousarray(payloads, np.uint8)
        n = self.lib.pt_send_fanout(
            self.fd,
            payloads,
            np.ascontiguousarray(sizes, np.int32),
            len(payloads),
            payloads.shape[1],  # row stride: (n,256) matrices or wide rows
            np.ascontiguousarray(peer_ips, np.uint32),
            np.ascontiguousarray(peer_ports, np.uint16),
            len(peer_ips),
        )
        if n < 0:
            raise OSError(-n, os.strerror(-n))
        return n

    def send_pairs(self, payloads: np.ndarray, sizes: np.ndarray,
                   ips: np.ndarray, ports: np.ndarray) -> np.ndarray:
        """Row ``i`` of ``payloads`` (``sizes[i]`` bytes) to peer ``i``,
        every row in one call: sendmmsg in chunks, in order. Returns
        bool[n], True where the kernel took the datagram: a row refused
        (a bad destination) is skipped alone, and the rows after it still
        go."""
        ok = np.zeros(len(payloads), np.uint8)
        if len(payloads) == 0:
            return ok.astype(bool)
        payloads = np.ascontiguousarray(payloads, np.uint8)
        n = self.lib.pt_send_pairs(
            self.fd,
            payloads,
            np.ascontiguousarray(sizes, np.int32),
            len(payloads),
            payloads.shape[1],
            np.ascontiguousarray(ips, np.uint32),
            np.ascontiguousarray(ports, np.uint16),
            ok,
        )
        if n < 0:
            raise OSError(-n, os.strerror(-n))
        return ok.astype(bool)

    def close(self) -> None:
        self.lib.pt_udp_close(self.fd)


class RxRing:
    """Zero-copy rx ring (device-resident ingest): C++-owned page-aligned
    byte planes the recvmmsg loop fills directly and Python views without
    copying (``plane()``), recycled via lease/commit. The rx thread LEASES
    before receiving; the engine's completion pipeline COMMITS once the
    plane's copy to the device has finished — until then the plane bytes
    are pinned by contract (the C side refuses to free them: destroy
    defers while leased).

    On a CUDA node :meth:`pin` registers every plane as page-locked
    memory once, so the engine ships a plane prefix with one non-blocking
    copy and no staging bounce. A registered plane must stay registered
    while a copy from it may be in flight: :meth:`close` stops new leases
    and, once the last lease has committed, unregisters the planes and
    only then destroys the ring. Python-side bookkeeping (``_leased``)
    mirrors the native free-list under ``_mu``."""

    def __init__(self, n_planes: int = 4, max_batch: int = 512,
                 row: int = RX_RING_ROW):
        lib = load(required=True)
        self.lib = lib
        self.n_planes = n_planes
        self.max_batch = max_batch
        self.row = row
        h = lib.pt_rx_ring_create(n_planes, max_batch, row)
        if h < 0:
            raise OSError(-h, os.strerror(-h))
        self.h = h
        self._mu = threading.Lock()
        self._leased: set = set()
        self._closed = False
        self._destroyed = False
        self._final: dict = {}
        self._pinned = False
        self._views = []
        self._ptrs = []
        size = max_batch * row
        for i in range(n_planes):
            ptr = lib.pt_rx_ring_plane(h, i)
            buf = (ctypes.c_uint8 * size).from_address(ptr)
            self._ptrs.append(ptr)
            self._views.append(
                np.ctypeslib.as_array(buf).reshape(max_batch, row)
            )

    def pin(self) -> None:
        """Register every plane with CUDA as page-locked host memory
        (``cudaHostRegister``), once; torch then reports a tensor over a
        plane as pinned and copies it to the device asynchronously.
        Raises if CUDA refuses."""
        import torch

        with self._mu:
            if self._pinned or self._closed:
                return
            cudart = torch.cuda.cudart()
            size = self.max_batch * self.row
            done = []
            for ptr in self._ptrs:
                err = cudart.cudaHostRegister(ptr, size, 0)
                if int(err) != 0:
                    for p in done:
                        cudart.cudaHostUnregister(p)
                    raise RuntimeError(f"cudaHostRegister failed: {err}")
                done.append(ptr)
            self._pinned = True

    @property
    def pinned(self) -> bool:
        return self._pinned

    def lease(self) -> Optional[int]:
        """→ plane index, or None when every plane is in flight or the
        ring is closing (the caller uses its copying path for this
        batch)."""
        with self._mu:
            if self._closed:
                return None
            idx = self.lib.pt_rx_ring_lease(self.h)
            if idx < 0:
                return None
            self._leased.add(idx)
            return idx

    def plane(self, idx: int) -> np.ndarray:
        """Zero-copy numpy view of one plane (valid until close)."""
        return self._views[idx]

    def commit(self, idx: int) -> None:
        """Return a leased plane (engine completion callback — may run
        on any thread). The last commit after :meth:`close` releases the
        ring."""
        with self._mu:
            self._leased.discard(idx)
            self.lib.pt_rx_ring_commit(self.h, idx)
            self._release_if_done_locked()

    def stats(self) -> dict:
        """Lease counters; after the ring is released, their final values.
        While the rx loop runs it holds one lease across each receive
        wait, so ``rx_ring_leases`` runs ahead of ``rx_ring_commits`` by
        the planes in flight; once released the two are equal."""
        with self._mu:
            return dict(self._final) if self._destroyed else self._stats_locked()

    def _stats_locked(self) -> dict:
        out = np.zeros(4, np.uint64)
        if self.lib.pt_rx_ring_stats(self.h, out) < 0:
            return {}
        return {
            "rx_ring_leases": int(out[0]),
            "rx_ring_commits": int(out[1]),
            "rx_ring_lease_reuse": int(out[2]),
            "rx_ring_exhausted": int(out[3]),
        }

    def close(self) -> None:
        """Stop leasing; release the ring now, or at the last
        outstanding commit (an in-flight copy never reads freed or
        unregistered memory). The numpy views are invalid once it is
        released; callers stop reading them before close."""
        with self._mu:
            self._closed = True
            self._release_if_done_locked()

    def _release_if_done_locked(self) -> None:
        if not self._closed or self._leased or self._destroyed:
            return
        self._final = self._stats_locked()
        self._destroyed = True
        if self._pinned:
            import torch

            cudart = torch.cuda.cudart()
            for ptr in self._ptrs:
                cudart.cudaHostUnregister(ptr)
            self._pinned = False
        self.lib.pt_rx_ring_destroy(self.h)


class DecodeBuffers:
    """Reusable output buffers for :func:`decode_batch_raw` — the rx loop
    allocates once instead of zeroing ~2 MB of numpy arrays per batch
    (pt_decode_batch re-zeroes each valid name row itself)."""

    def __init__(self, max_batch: int):
        n = max_batch
        self.added = np.zeros(n, np.float64)
        self.taken = np.zeros(n, np.float64)
        self.elapsed = np.zeros(n, np.uint64)
        self.names = np.zeros((n, PACKET), np.uint8)
        self.name_lens = np.zeros(n, np.int32)
        self.slots = np.zeros(n, np.int32)
        self.caps = np.zeros(n, np.int64)
        self.lane_a = np.zeros(n, np.int64)
        self.lane_t = np.zeros(n, np.int64)
        self.hashes = np.zeros(n, np.uint64)
        # 0 = plain, 1 = capability advert (base trailer, MULTI bit),
        # 2 = valid multi-lane trailer (re-decode through ops.wire).
        self.multi = np.zeros(n, np.int32)


def decode_batch_raw(
    packets: np.ndarray, sizes: np.ndarray, buf: Optional[DecodeBuffers] = None
) -> Tuple[DecodeBuffers, int]:
    """Zero-materialization wire decode: fills ``buf`` (allocating one when
    None) and returns ``(buf, n)``. Names stay raw zero-padded byte rows
    (``buf.names[i, :name_lens[i]]``) with their FNV-1a hash in
    ``buf.hashes`` — the directory's vectorized lookup consumes these
    directly; Python strings are only materialized for directory misses and
    incast requests. ``name_lens[i] < 0`` marks a malformed packet."""
    lib = load(required=True)
    n = len(packets)
    if buf is None or len(buf.added) < n:
        buf = DecodeBuffers(n)
    packets = np.ascontiguousarray(packets, np.uint8)
    in_stride = packets.shape[1] if packets.ndim == 2 and n else PACKET
    lib.pt_decode_batch(
        packets,
        np.ascontiguousarray(sizes, np.int32),
        n, in_stride, buf.added, buf.taken, buf.elapsed, buf.names,
        buf.name_lens, buf.slots, buf.caps, buf.lane_a, buf.lane_t,
        buf.hashes, buf.multi,
    )
    return buf, n


def decode_batch(packets: np.ndarray, sizes: np.ndarray):
    """Vectorized wire decode → (added[f64], taken[f64], elapsed[i64],
    names[list[str]], origin_slots[i32], valid[bool], caps[i64], lane_added
    [i64], lane_taken[i64]) — caps/lane values in nanotokens, -1 = absent.
    Materializes every name as a Python string; the hot rx loop uses
    :func:`decode_batch_raw` instead."""
    buf, n = decode_batch_raw(packets, sizes)
    valid = buf.name_lens[:n] >= 0
    out_names: List[str] = [
        bytes(buf.names[i, : buf.name_lens[i]]).decode("utf-8", "surrogateescape")
        if valid[i]
        else ""
        for i in range(n)
    ]
    return (
        buf.added[:n].copy(), buf.taken[:n].copy(),
        buf.elapsed[:n].astype(np.int64), out_names, buf.slots[:n].copy(),
        valid, buf.caps[:n].copy(), buf.lane_a[:n].copy(), buf.lane_t[:n].copy(),
    )


def encode_batch(
    added: Sequence[float],
    taken: Sequence[float],
    elapsed_ns: Sequence[int],
    names: Sequence[str],
    origin_slots: Sequence[int],
    caps: Optional[Sequence[int]] = None,
    lane_added: Optional[Sequence[int]] = None,
    lane_taken: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized wire encode → (packets[n,256], sizes[n]); size -1 marks a
    state whose name was too large (caller decides; see replication).
    ``caps``/``lane_added``/``lane_taken`` are per-state nanotoken values
    (-1 = omit from the trailer); omitted entirely ⇒ base-form trailers."""
    lib = load(required=True)
    n = len(names)
    name_buf = np.zeros((n, PACKET), np.uint8)
    name_lens = np.zeros(n, np.int32)
    for i, name in enumerate(names):
        raw = name.encode("utf-8", "surrogateescape")
        name_lens[i] = len(raw)
        if len(raw) <= PACKET:
            name_buf[i, : len(raw)] = np.frombuffer(raw, np.uint8)
    out = np.zeros((n, PACKET), np.uint8)
    out_sizes = np.zeros(n, np.int32)

    def _i64(vals):
        if vals is None:
            return np.full(n, -1, np.int64)
        return np.ascontiguousarray(np.asarray(vals, np.int64))

    lib.pt_encode_batch(
        np.ascontiguousarray(np.asarray(added, np.float64)),
        np.ascontiguousarray(np.asarray(taken, np.float64)),
        np.ascontiguousarray(np.asarray(elapsed_ns, np.int64).view(np.uint64)),
        name_buf, name_lens,
        np.ascontiguousarray(np.asarray(origin_slots, np.int32)),
        _i64(caps), _i64(lane_added), _i64(lane_taken),
        n, out, out_sizes,
    )
    return out, out_sizes
