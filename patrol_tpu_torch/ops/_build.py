"""Build, load and count the package's hand-written CUDA kernels.

The sources are ``patrol_tpu_torch/csrc/*.cu``: plain C entry points over
device pointers, no PyTorch headers. :func:`lib` compiles them with
``nvcc`` for ``sm_90a`` on first use — one ``nvcc -c`` per source, all
started together, then one link into ``libpatrol_kernels.so`` — into
``patrol_tpu_torch/_build/<hash>/`` (listed in ``.gitignore``), keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the cached library. It is loaded with ``ctypes``.
A missing ``nvcc`` or a failed build raises; nothing falls back.

:data:`LAUNCHES` counts kernel launches per wrapper name. A wrapper adds
one exactly where it launches its kernel, so a run can show that its
main path went through the kernels (``chip_smoke.py`` zeroes the counts
before the main path and reads them after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libpatrol_kernels.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# name -> launches since the last reset_launches().
LAUNCHES: Dict[str, int] = {
    "pair_join": 0, "row_join": 0, "tick_join": 0, "take_n": 0, "decode_fold": 0,
    "row_rmw": 0, "lifecycle_probe": 0,
    "gcra_admit": 0, "conc_admit": 0, "quota_admit": 0,
    "mesh_gather": 0, "converge": 0,
}

_lib = None
_lib_mu = threading.Lock()


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "patrol_tpu_torch/csrc cannot be built"
        )
    return found


def build_key(srcs: List[Path]) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link the shared library;
    returns its path. Reuses a library already built from the same
    sources. ``build.log`` beside it keeps nvcc's output (``-Xptxas -v``
    register and spill counts)."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out_dir = BUILD_DIR / build_key(srcs)
    so = out_dir / LIB_NAME
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for src, obj in zip(srcs, objs)
    ]
    logs = []
    failed = []
    for src, p in zip(srcs, procs):
        out, _ = p.communicate()
        logs.append(f"== {src.name} (rc {p.returncode})\n{out.decode(errors='replace')}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
    )
    logs.append(f"== link (rc {link.returncode})\n{link.stdout.decode(errors='replace')}")
    (out_dir / "build.log").write_text("\n".join(logs))
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink(missing_ok=True)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_mu:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            p, i64 = ctypes.c_void_p, ctypes.c_longlong
            cdll.patrol_join.argtypes = [
                p, p, i64, i64, p, p, p, i64, p, p, p, p, i64, p, p, i64, p,
            ]
            cdll.patrol_take_n.argtypes = [p, p, i64, i64, i64, p, p, i64, p]
            cdll.patrol_decode_fold.argtypes = [
                p, p, i64, i64, p, i64, i64, p, p, p, p, i64, p, p, p, p,
            ]
            cdll.patrol_row_rmw.argtypes = [p, i64, p, p, p, p, i64, ctypes.c_int, p]
            cdll.patrol_lifecycle_probe.argtypes = [
                p, p, i64, i64, i64, p, p, p, p, p, p, i64, p,
            ]
            cdll.patrol_cert_occupancy.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            cdll.patrol_cert_fused.argtypes = [
                ctypes.c_int, p, p, i64, i64, i64, p, p, p, i64, i64, ctypes.c_int, p,
            ]
            cdll.patrol_converge.argtypes = [
                ctypes.c_int, p, p, i64, i64, p, p, i64, i64, p, p,
            ]
            for fn in (cdll.patrol_join, cdll.patrol_take_n,
                       cdll.patrol_decode_fold, cdll.patrol_row_rmw,
                       cdll.patrol_lifecycle_probe, cdll.patrol_cert_occupancy,
                       cdll.patrol_cert_fused, cdll.patrol_converge):
                fn.restype = ctypes.c_int
            _lib = cdll
        return _lib


def stream_handle(t: torch.Tensor) -> int:
    """The raw cudaStream_t of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {rc}")


def check_int64(name: str, t: torch.Tensor, device: torch.device) -> None:
    """Wrapper argument contract: contiguous int64 on the state's device."""
    check_operand(name, t, torch.int64, device)


def check_operand(
    name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device
) -> None:
    """Wrapper argument contract: contiguous ``dtype`` (int64, int32, uint8
    or bool) on the state's device."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, state is on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
