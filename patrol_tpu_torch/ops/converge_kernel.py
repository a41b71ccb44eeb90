"""The mesh converge: the wrappers over ``csrc/converge.cu`` and their
plain PyTorch versions.

Replaces ``patrol_tpu/parallel/topology.py::converge`` (its tree and flat
schedules; XLA collectives in the reference). One mesh dispatch on one
card (:func:`patrol_tpu_torch.parallel.topology.mesh_step`) copies its T
take rows into a scratch of R replica copies, ``spn int64[R, T, N, 2]``
and ``sel int64[R, T]``, and writes their join back:

* :func:`gather` — every copy ``r`` of row ``t`` from the canonical row
  ``rows[t]``;
* :func:`converge` — the signed int64 max over the R copies into the
  canonical rows.

``rows`` are T distinct rows in ``[0, B)``; the kernels write nothing
for a row outside it. On a CUDA state each wrapper launches its kernel,
or raises; the plain version runs only for a state that lies on the CPU.
"""

from __future__ import annotations

import torch

from patrol_tpu_torch.ops import _build


def gather_plain(
    pn: torch.Tensor, elapsed: torch.Tensor, rows: torch.Tensor,
    spn: torch.Tensor, sel: torch.Tensor,
) -> None:
    """The plain version of the gather: one ``index_select`` of the rows,
    copied into every replica."""
    spn.copy_(pn.index_select(0, rows).unsqueeze(0).expand_as(spn))
    sel.copy_(elapsed.index_select(0, rows).unsqueeze(0).expand_as(sel))


def converge_plain(
    pn: torch.Tensor, elapsed: torch.Tensor, rows: torch.Tensor,
    spn: torch.Tensor, sel: torch.Tensor,
) -> None:
    """The plain version of the converge: ``amax`` over the replica dim
    (signed), then ``index_copy_`` into the canonical rows."""
    pn.index_copy_(0, rows, spn.amax(dim=0))
    elapsed.index_copy_(0, rows, sel.amax(dim=0))


def _check(pn, elapsed, rows, spn, sel) -> torch.device:
    dev = pn.device
    for name, t in (("pn", pn), ("elapsed", elapsed), ("rows", rows), ("spn", spn), ("sel", sel)):
        _build.check_int64(name, t, dev)
    b, n, two = pn.shape
    if two != 2 or elapsed.shape != (b,):
        raise ValueError("state must be pn[B,N,2] and elapsed[B]")
    if spn.dim() != 4 or spn.shape[1:] != (rows.numel(), n, 2):
        raise ValueError(f"spn must be [R, {rows.numel()}, {n}, 2], got {tuple(spn.shape)}")
    if sel.shape != spn.shape[:2] or rows.dim() != 1:
        raise ValueError(
            f"sel must be {tuple(spn.shape[:2])} and rows 1-D, got {tuple(sel.shape)} "
            f"and {tuple(rows.shape)}"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _launch(gather_mode: int, name: str, pn, elapsed, rows, spn, sel) -> None:
    b, n, _ = pn.shape
    r, t = sel.shape
    if r * t == 0:
        return
    if pn.data_ptr() % 16 or spn.data_ptr() % 16:
        raise ValueError("pn and spn must be 16-byte aligned (lanes move as 16-byte vectors)")
    with _build.on_device(pn.device):
        rc = _build.lib().patrol_converge(
            gather_mode, pn.data_ptr(), elapsed.data_ptr(), b, n, spn.data_ptr(),
            sel.data_ptr(), r, t, rows.data_ptr(), _build.stream_handle(pn),
        )
    _build.check_rc(rc, name)
    _build.count_launch(name)


def gather(
    pn: torch.Tensor, elapsed: torch.Tensor, rows: torch.Tensor,
    spn: torch.Tensor, sel: torch.Tensor,
) -> None:
    """Fill ``spn[r, t]`` / ``sel[r, t]`` from canonical row ``rows[t]``
    for every replica ``r``."""
    if _check(pn, elapsed, rows, spn, sel).type == "cpu":
        gather_plain(pn, elapsed, rows, spn, sel)
        return
    _launch(1, "mesh_gather", pn, elapsed, rows, spn, sel)


def converge(
    pn: torch.Tensor, elapsed: torch.Tensor, rows: torch.Tensor,
    spn: torch.Tensor, sel: torch.Tensor,
) -> None:
    """Write the signed max over the replica copies of each take row into
    its canonical row, in place."""
    if _check(pn, elapsed, rows, spn, sel).type == "cpu":
        converge_plain(pn, elapsed, rows, spn, sel)
        return
    _launch(0, "converge", pn, elapsed, rows, spn, sel)
