"""Checkpoint and resume (counterpart of ``patrol_tpu/runtime/checkpoint.py``,
in numpy and torch).

The replicated CRDT is two int64 planes and the host metadata one JSON
object, so a checkpoint is exact. Restoring a stale checkpoint is safe:
state is a join-semilattice, so later merges catch it up.

Format (the JAX package's, version 1; either package restores the
other's): ``<dir>/state.npz`` (``pn``, ``elapsed``) and
``<dir>/directory.json`` (name → row, ``created_ns``, ``cap_base_nt``,
``node_slot``, the shape, and as extra keys the GC tombstones and the
membership view), each written to a temp file and renamed.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

FORMAT_VERSION = 1


def save(directory: str, engine, membership: dict | None = None) -> str:
    """Snapshot an engine's planes and directory; → the directory. Safe on
    a live engine: queued work drains first, and the planes are read with
    the host-resident lanes joined in, residency untouched (a periodic
    checkpoint must not erode the host fast path).

    ``membership`` (the node's ``SlotTable.view()``) rides as an extra key;
    a restarting node reads it back with :func:`load_membership` to come
    back on its original lane."""
    os.makedirs(directory, exist_ok=True)
    engine.flush()
    pn, elapsed = engine.snapshot_planes()

    d = engine.directory
    rows = dict(d._rows)  # name -> row
    meta = {
        "version": FORMAT_VERSION,
        "node_slot": engine.node_slot,
        "buckets": engine.config.buckets,
        "nodes": engine.config.nodes,
        "rows": rows,
        "created_ns": {str(r): int(d.created_ns[r]) for r in rows.values()},
        "cap_base_nt": {str(r): int(d.cap_base_nt[r]) for r in rows.values()},
        # A reclaimed bucket's own-lane residue survives a restart, or a
        # peer's echo of its pre-reclaim lane could absorb later spend.
        "tombstones": {name: list(t) for name, t in d.export_tombstones().items()},
    }
    if membership is not None:
        meta["membership"] = membership

    fd, tmp_npz = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    os.close(fd)
    with open(tmp_npz, "wb") as f:
        np.savez(f, pn=pn, elapsed=elapsed)
    os.replace(tmp_npz, os.path.join(directory, "state.npz"))

    fd, tmp_json = tempfile.mkstemp(dir=directory, suffix=".json.tmp")
    os.close(fd)
    with open(tmp_json, "w") as f:
        json.dump(meta, f)
    os.replace(tmp_json, os.path.join(directory, "directory.json"))
    return directory


def load_membership(directory: str) -> dict | None:
    """The membership view saved with the checkpoint, or None (no file,
    or a checkpoint without one). Read at boot, before the engine is
    built: its ``self_slot`` pins the node to its original lane."""
    path = os.path.join(directory, "directory.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    mem = meta.get("membership")
    return mem if isinstance(mem, dict) else None


def exists(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, "state.npz")) and os.path.exists(
        os.path.join(directory, "directory.json")
    )


def restore(directory: str, engine) -> int:
    """Load a checkpoint into an engine of the same shape; → buckets
    restored. The planes join the engine's under SIGNED int64 max, as the
    JAX package's ``jnp.maximum`` does (``ops.merge.merge_dense`` is an
    unsigned max, which differs on a wrapped lane), in place on the
    engine's device (on a mesh, into every piece's copy of each shard), so
    restoring onto a live engine is a join, never a rollback."""
    with open(os.path.join(directory, "directory.json")) as f:
        meta = json.load(f)
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta.get('version')}")
    if meta["buckets"] != engine.config.buckets or meta["nodes"] != engine.config.nodes:
        raise ValueError(
            "checkpoint shape mismatch: "
            f"ckpt ({meta['buckets']}×{meta['nodes']}) vs "
            f"engine ({engine.config.buckets}×{engine.config.nodes})"
        )

    # Host-resident rows move to the device before the join, which sees
    # only the device planes (flush_hosted raises on a timeout rather than
    # restore into rows still hosted). Idle demotion is paused over the
    # flush, load and join: a demotion in between would zero the rows the
    # join lands on.
    engine._demotion_paused = True
    try:
        engine.flush_hosted()
        engine.flush()

        with np.load(os.path.join(directory, "state.npz")) as data:
            pn, elapsed = data["pn"], data["elapsed"]
        # Into every copy of a mesh's shards, under the state mutex.
        engine._join_planes(pn, elapsed)
        del pn, elapsed

        d = engine.directory
        with d._mu:
            for name, row in meta["rows"].items():
                row = int(row)
                # A full bind: eviction eligibility, name bytes and hash,
                # and the resolve table, so the wire rx path finds it.
                d._bind_locked(name, row, int(meta["created_ns"][str(row)]))
                d.cap_base_nt[row] = int(meta["cap_base_nt"][str(row)])
                d._next_fresh = max(d._next_fresh, row + 1)
        # Tombstones go in after the binds: restore_tombstones skips names
        # the checkpoint bound again (their lanes carry the spend).
        d.restore_tombstones(meta.get("tombstones", {}))
        return len(meta["rows"])
    finally:
        engine._demotion_paused = False
