"""The port stands alone: importing every module of ``patrol_tpu_torch``
pulls in neither ``jax`` nor ``patrol_tpu``, and no port file imports
either (an AST walk, so a lazy import inside a function is caught too).
The CLI starts a replicating node from ``--peer-addr`` and refuses what is
not ported yet (``--udp-backend native``) with exit code 2.

The import check runs in a subprocess, because this test process has
already imported jax (``tests/conftest.py``)."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import patrol_tpu_torch

PKG_DIR = Path(patrol_tpu_torch.__file__).resolve().parent
REPO = PKG_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "patrol_tpu")


def _modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages([str(PKG_DIR)], prefix="patrol_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "patrol_tpu_torch.runtime.engine" in mods and len(mods) >= 25
    assert {"patrol_tpu_torch.ops.row_rmw_kernel",
            "patrol_tpu_torch.scripts.probe_dma_scatter"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'patrol_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted(PKG_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = {}
    for path in files:
        roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
        bad = roots & set(FORBIDDEN)
        if bad:
            offenders[str(path.relative_to(REPO))] = sorted(bad)
    assert len(files) > 25
    assert offenders == {}


def test_package_import_leaves_cuda_uninitialised():
    # Importing the port must not build kernels or touch a card: the
    # tests import every module on hosts without nvcc or a GPU.
    code = (
        "import torch, patrol_tpu_torch.runtime.engine, patrol_tpu_torch.ops._build as b\n"
        "print(torch.cuda.is_initialized(), b._lib is None)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "True"]


def test_replication_modules_are_part_of_the_port():
    mods = set(_modules())
    for m in ("net.replication", "net.delta", "net.antientropy", "net.membership",
              "net.faultnet", "net.fleet", "net.audit", "net.v1node", "utils.slo",
              "ops.ingest", "ops.ingest_kernel", "ops.delta"):
        assert f"patrol_tpu_torch.{m}" in mods, m
    assert (PKG_DIR / "csrc" / "decode_fold.cu").is_file()


def _free_port(kind):
    import socket

    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_refuses_the_native_udp_backend():
    res = subprocess.run(
        [sys.executable, "-m", "patrol_tpu_torch", "--udp-backend", "native",
         "--device", "cpu", "--no-warmup"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 2
    assert "not yet ported" in res.stderr and "udp-backend native" in res.stderr


def test_cli_starts_a_node_with_peers():
    import http.client
    import signal
    import socket
    import time

    api = _free_port(socket.SOCK_STREAM)
    me = f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}"
    peer = f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "patrol_tpu_torch", "--api-addr", f"127.0.0.1:{api}",
         "--node-addr", me, "--peer-addr", me, "--peer-addr", peer,
         "--wire-mode", "delta", "--udp-backend", "asyncio",
         "--buckets", "64", "--node-lanes", "4", "--device", "cpu", "--no-warmup"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 90
        while True:
            assert proc.poll() is None, proc.communicate()[1]
            try:
                conn = http.client.HTTPConnection("127.0.0.1", api, timeout=5)
                conn.request("GET", "/debug/vars")
                stats = json.loads(conn.getresponse().read())
                conn.close()
                break
            except OSError:
                assert time.monotonic() < deadline, "the node did not start serving"
                time.sleep(0.1)
        assert stats["replication_peers"] == 1 and stats["device"] == "cpu"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
