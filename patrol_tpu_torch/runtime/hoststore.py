"""Native host-lane store: the C++ twin of the engine's HostLanes tier.

The host-resident lanes live in plain int64 blocks owned by the port's
host library (``native/patrol_http.cpp``, ``HostStore``), so:

* the native HTTP front's epoll thread serves host-resident takes
  entirely in C++ — resolve (``pt_dir_resolve_rt``), lane arithmetic
  (``hls_take_locked``, step for step :meth:`HostLanes.take`), response
  formatting — without entering Python;
* the engine keeps running its own HostLanes code paths (rx absorb,
  snapshot, promotion drain, demotion) unchanged: each block is exposed
  as numpy views (:class:`NativeHostLanes`, the HostLanes attribute
  surface), and the engine's ``_host_mu`` becomes
  :class:`NativeHostMutex`, the same native mutex the epoll thread takes;
* broadcasts coalesce: the C++ take path marks rows dirty, and the
  front's pump drains the dirty set and emits each row's latest full
  state once per drain (lossless for a state-based CRDT: a later state
  subsumes every earlier one).

Block layout (int64 words): added[nodes] | taken[nodes] | elapsed_ns |
win_start_ns | win_takes | win_rx | resident | dirty. Blocks live until
the store is destroyed, so Python views stay valid across unhost and
re-host.

The store keeps pointers to the directory's ``cap_base_nt``,
``created_ns`` and ``last_used_ns`` arrays (``pt_hls_create``): the
directory allocates them once at its capacity and never rebinds them.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

from patrol_tpu_torch import native

# Native take-pressure promotion threshold (takes per window). Default 0 =
# off: an in-front take costs a fraction of a microsecond, so there is no
# per-bucket rate past which a device tick answers one row's takes faster;
# promotion stays rx-pressure and scalar driven (the Python paths, whose
# thresholds are unchanged). Read when a store is created.
NATIVE_PROMOTE_TAKES = int(os.environ.get("PATROL_NATIVE_PROMOTE_TAKES", 0))


class NativeHostLanes:
    """numpy-view proxy over one C++ host-lane block, presenting the exact
    HostLanes attribute surface (``added``/``taken`` int64 lane views,
    scalar properties, ``roll_window``/``take``) so every engine code path
    that touches host lanes runs unchanged on the shared memory. All
    mutation happens under the engine's ``_host_mu`` — which IS the C++
    store mutex (:class:`NativeHostMutex`), so the epoll thread's inline
    takes serialize with it."""

    __slots__ = ("added", "taken", "_sc")

    def __init__(self, ptr: int, nodes: int):
        words = 2 * nodes + 6
        buf = (ctypes.c_int64 * words).from_address(ptr)
        blk = np.ctypeslib.as_array(buf)
        self.added = blk[:nodes]
        self.taken = blk[nodes : 2 * nodes]
        self._sc = blk[2 * nodes :]

    @property
    def elapsed_ns(self) -> int:
        return int(self._sc[0])

    @elapsed_ns.setter
    def elapsed_ns(self, v: int) -> None:
        self._sc[0] = v

    @property
    def win_start_ns(self) -> int:
        return int(self._sc[1])

    @win_start_ns.setter
    def win_start_ns(self, v: int) -> None:
        self._sc[1] = v

    @property
    def win_takes(self) -> int:
        return int(self._sc[2])

    @win_takes.setter
    def win_takes(self, v: int) -> None:
        self._sc[2] = v

    @property
    def win_rx(self) -> int:
        return int(self._sc[3])

    @win_rx.setter
    def win_rx(self, v: int) -> None:
        self._sc[3] = v

    # The HostLanes methods themselves, bound to this proxy: one
    # implementation, two backings (assigned by _bind_methods when a store
    # is made, since the engine module imports this one).


def _bind_methods() -> None:
    from patrol_tpu_torch.runtime.engine import HostLanes

    NativeHostLanes.roll_window = HostLanes.roll_window
    NativeHostLanes.take = HostLanes.take


class NativeHostMutex:
    """Context-manager wrapper over the store's native mutex — drop-in for
    the engine's ``threading.Lock`` ``_host_mu``. ctypes releases the GIL
    for the blocking acquire; the epoll thread never takes the GIL, so
    the lock order is cycle-free."""

    __slots__ = ("_lib", "_h")

    def __init__(self, lib, h: int):
        self._lib = lib
        self._h = h

    def __enter__(self):
        self._lib.pt_hls_lock(self._h)
        return self

    def __exit__(self, *exc):
        self._lib.pt_hls_unlock(self._h)
        return False


class NativeHostStore:
    """Engine-side handle for the C++ host-lane store."""

    def __init__(self, lib, h: int, nodes: int, directory):
        self.lib = lib
        self.h = h
        self.nodes = nodes
        self.directory = directory
        self._dirty = np.zeros(4096, np.int32)
        # Per-dirty-row C++ lane snapshot: added[nodes]|taken[nodes]|elapsed.
        self._snap = np.zeros((4096, 2 * nodes + 1), np.int64)
        self._promote = np.zeros(1024, np.int32)
        self._np = ctypes.c_int(0)
        self._closed = False
        _bind_methods()

    @classmethod
    def create(
        cls,
        nodes: int,
        node_slot: int,
        directory,
        clock_offset_ns: int,
        window_ns: int,
        promote_takes: Optional[int] = None,
    ) -> Optional["NativeHostStore"]:
        if promote_takes is None:
            promote_takes = NATIVE_PROMOTE_TAKES
        lib = native.load()
        if lib is None or directory._ptdir < 0:
            return None
        h = lib.pt_hls_create(
            nodes, node_slot, promote_takes, window_ns, clock_offset_ns,
            directory.cap_base_nt, directory.created_ns,
            directory.last_used_ns,
        )
        if h < 0:
            return None
        return cls(lib, h, nodes, directory)

    def mutex(self) -> NativeHostMutex:
        return NativeHostMutex(self.lib, self.h)

    # -- callers hold the store mutex (the engine's _host_mu) ---------------

    def host_locked(self, row: int) -> NativeHostLanes:
        ptr = self.lib.pt_hls_host_locked(self.h, row)
        if ptr == 0:
            raise MemoryError("pt_hls_host_locked failed")
        return NativeHostLanes(ptr, self.nodes)

    def unhost_locked(self, row: int) -> None:
        self.lib.pt_hls_unhost_locked(self.h, row)

    def drain_locked(self) -> Tuple[List[int], np.ndarray, List[int]]:
        """→ (dirty_rows, lane_snapshots[nd, 2*nodes+1], promote_rows);
        clears both queues. The snapshots are taken in C++ under the held
        lock — the caller does its per-row work (wire building) OUTSIDE
        the lock against the copies."""
        nd = self.lib.pt_hls_drain_locked(
            self.h, self._dirty, self._snap, len(self._dirty),
            self._promote, len(self._promote), ctypes.byref(self._np),
        )
        if nd <= 0 and self._np.value <= 0:
            return [], self._snap[:0], []
        nd = max(nd, 0)
        return (
            self._dirty[:nd].tolist(),
            self._snap[:nd],
            self._promote[: self._np.value].tolist(),
        )

    def drain_promotes_locked(self) -> List[int]:
        """Pop ONLY the promote queue (zero dirty-row capacity leaves the
        broadcast queue and its dirty flags in place for the cadence-gated
        drain). Used by the pump's promotions-only fast path."""
        out: List[int] = []
        while True:
            self.lib.pt_hls_drain_locked(
                self.h, self._dirty, self._snap, 0,
                self._promote, len(self._promote), ctypes.byref(self._np),
            )
            n = self._np.value
            if n <= 0:
                return out
            out.extend(self._promote[:n].tolist())

    # -- lock-free ----------------------------------------------------------

    @property
    def events(self) -> int:
        """Promotion-event counter: bumped by the C++ take path only on
        take-pressure threshold crossings. Lock-free read."""
        return int(self.lib.pt_hls_events(self.h))

    def stats(self) -> dict:
        out = np.zeros(4, np.uint64)
        self.lib.pt_hls_stats(self.h, out)
        return {
            "native_host_takes": int(out[0]),
            "native_host_resident": int(out[1]),
            "native_host_blocks": int(out[2]),
        }

    @property
    def native_takes(self) -> int:
        out = np.zeros(4, np.uint64)
        self.lib.pt_hls_stats(self.h, out)
        return int(out[0])

    def destroy(self) -> None:
        """Free the store. The HTTP front must be detached and no proxy
        views may be touched afterwards (engine.stop ordering)."""
        if not self._closed:
            self._closed = True
            self.lib.pt_hls_destroy(self.h)
