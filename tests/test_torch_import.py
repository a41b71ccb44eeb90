"""The port stands alone: importing every module of ``patrol_tpu_torch``
pulls in neither ``jax`` nor ``patrol_tpu``, and no port file imports
either (an AST walk, so a lazy import inside a function is caught too).
The CLI starts a replicating node from ``--peer-addr``, serves on the
native HTTP front, checkpoints at SIGINT and restores at restart
(``--checkpoint-dir``), and refuses ``--mesh-replicas 2`` on one device
by the mesh's own rule; the native UDP backend and HTTP front are ported, and
their C++ sources are the port's own copies: no port file reads a path
under ``patrol_tpu/``.

The import check runs in a subprocess, because this test process has
already imported jax (``tests/conftest.py``)."""

import ast
import json
import pkgutil
import re
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
            "patrol_tpu_torch.scripts.probe_dma_scatter",
            "patrol_tpu_torch.scripts.delta_timer",
            "patrol_tpu_torch.scripts.lifecycle_ab",
            "patrol_tpu_torch.scripts.cert_ab"} <= set(mods)
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


def test_lifecycle_and_checkpoint_import_without_jax():
    code = (
        "import json, sys\n"
        "import patrol_tpu_torch.runtime.checkpoint, patrol_tpu_torch.ops.lifecycle\n"
        "print(json.dumps(sorted(k for k in sys.modules\n"
        "                        if k.split('.')[0] in ('jax', 'jaxlib', 'patrol_tpu'))))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


ANALYSIS_MODULES = (
    "patrol_tpu_torch.analysis.driver", "patrol_tpu_torch.analysis.lint",
    "patrol_tpu_torch.analysis.protocol", "patrol_tpu_torch.analysis.linearizability",
    "patrol_tpu_torch.analysis.abi", "patrol_tpu_torch.analysis.lin_pins",
    "patrol_tpu_torch.ops.obligations", "patrol_tpu_torch.scripts.protocol_repo",
    "patrol_tpu_torch.scripts.lin_repo", "patrol_tpu_torch.scripts.abi_repo",
)


def test_check_stages_import_without_jax_or_the_jax_package():
    # The port's check stages are copies of JAX-free reference modules:
    # importing them (and their registry) loads neither jax nor any
    # patrol_tpu module; the protocol and lin stages need no torch either.
    code = (
        "import importlib, json, sys\n"
        f"for m in {ANALYSIS_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules\n"
        "                        if k.split('.')[0] in ('jax', 'jaxlib', 'patrol_tpu'))))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    stages = (
        "import json, sys\n"
        "import patrol_tpu_torch.scripts.protocol_repo, patrol_tpu_torch.scripts.lin_repo\n"
        "import patrol_tpu_torch.analysis.linearizability, patrol_tpu_torch.ops.obligations\n"
        "print(json.dumps('torch' in sys.modules))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", stages], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) is False


def test_check_stage_sources_name_no_jax_import():
    # A textual check beside the AST walk below: no line of the new stage
    # files imports jax or a module of the JAX package.
    bad = re.compile(r"^\s*(import jax|from jax|from patrol_tpu\.|import patrol_tpu\.|"
                     r"from patrol_tpu import|import patrol_tpu\s*$)", re.MULTILINE)
    files = [REPO / (m.replace(".", "/") + ".py") for m in ANALYSIS_MODULES]
    files.append(PKG_DIR / "analysis" / "__init__.py")
    for path in files:
        assert path.is_file(), path
        assert not bad.search(path.read_text()), path


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


def _string_constants(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value


def test_no_port_file_reads_a_path_under_the_jax_package():
    # The native library builds from patrol_tpu_torch/native/*.cpp: no port
    # file names a path inside patrol_tpu/ (its sources, its build) as a
    # string, nor joins one from the package's directory name. A
    # ``file.py:line`` citation of a TPU kernel (chip_smoke.py's
    # "replaces" fields) names a line, not a path to read.
    citation = re.compile(r"patrol_tpu/[\w/]+\.py:\d+")
    files = sorted(PKG_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = {}
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        bad = [
            v for v in _string_constants(tree)
            if (v == "patrol_tpu" or v.startswith("patrol_tpu/") or "/patrol_tpu/" in v)
            and not citation.fullmatch(v)
        ]
        if bad:
            offenders[str(path.relative_to(REPO))] = bad
    assert offenders == {}
    assert {p.name for p in (PKG_DIR / "native").glob("*.cpp")} == {
        "patrol_host.cpp", "patrol_http.cpp",
    }


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
              "ops.ingest", "ops.ingest_kernel", "ops.delta", "native",
              "net.native_replication", "net.native_http", "runtime.hoststore"):
        assert f"patrol_tpu_torch.{m}" in mods, m
    assert (PKG_DIR / "csrc" / "decode_fold.cu").is_file()


def _free_port(kind):
    import socket

    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_refuses_the_native_udp_backend():
    # Every option of this set is ported now, the mesh too, so the CLI no
    # longer refuses it as unported. On the one CPU device, 2 replicas are
    # refused by the mesh's own rule, as the JAX package's CLI refuses them
    # on one device.
    res = subprocess.run(
        [sys.executable, "-m", "patrol_tpu_torch", "--udp-backend", "native",
         "--http-front", "native", "--checkpoint-dir", "ckpt", "--mesh-replicas", "2",
         "--device", "cpu", "--no-warmup"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert "not yet ported" not in res.stderr
    assert "2 replicas do not divide 1 devices" in res.stderr


def test_cli_checkpoints_at_sigint_and_restores_at_restart(tmp_path):
    """``--checkpoint-dir`` serves: SIGINT writes a checkpoint (the
    periodic one runs too), and a restart restores it, so the spent bucket
    answers as it did before and /debug/vars carries the lifecycle block."""
    import http.client
    import signal
    import socket
    import time

    ckdir = tmp_path / "ckpt"

    def serve_and_take(takes):
        api = _free_port(socket.SOCK_STREAM)
        proc = subprocess.Popen(
            [sys.executable, "-m", "patrol_tpu_torch", "--api-addr", f"127.0.0.1:{api}",
             "--node-addr", f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}",
             "--http-front", "python", "--udp-backend", "asyncio",
             "--checkpoint-dir", str(ckdir), "--checkpoint-interval", "200ms",
             "--buckets", "64", "--node-lanes", "4", "--device", "cpu", "--no-warmup"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        try:
            deadline = time.monotonic() + 90
            answers = []
            while len(answers) < takes:
                assert proc.poll() is None, proc.communicate()[1]
                try:
                    conn = http.client.HTTPConnection("127.0.0.1", api, timeout=5)
                    conn.request("POST", "/take/ck?rate=3:1h")
                    resp = conn.getresponse()
                    answers.append((resp.status, resp.read()))
                    conn.close()
                except OSError:
                    assert time.monotonic() < deadline, "the node did not start serving"
                    time.sleep(0.1)
            conn = http.client.HTTPConnection("127.0.0.1", api, timeout=5)
            conn.request("GET", "/debug/vars")
            stats = json.loads(conn.getresponse().read())
            conn.close()
            time.sleep(0.5)  # a periodic checkpoint or two
            proc.send_signal(signal.SIGINT)
            assert proc.wait(timeout=60) == 0
            return answers, stats
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            proc.stdout.close()
            proc.stderr.close()

    first, stats = serve_and_take(2)
    assert first == [(200, b"2"), (200, b"1")]
    assert "engine_gc_sweeps" in stats and stats["engine_buckets_bound"] == 1
    assert (ckdir / "state.npz").is_file() and (ckdir / "directory.json").is_file()
    again, _ = serve_and_take(2)
    assert again == [(200, b"0"), (429, b"0")]  # restored: one token left


def test_cli_serves_on_the_native_http_front():
    """``--http-front native`` serves: the C++ front answers takes (those
    of the host-resident bucket in C++), /debug/vars reports the front and
    the host lanes, and SIGINT shuts the node down cleanly."""
    import http.client
    import signal
    import socket
    import time

    from patrol_tpu_torch import native

    if native.load() is None:
        import pytest

        pytest.skip("the native host library does not build here")
    api = _free_port(socket.SOCK_STREAM)
    proc = subprocess.Popen(
        [sys.executable, "-m", "patrol_tpu_torch", "--api-addr", f"127.0.0.1:{api}",
         "--node-addr", f"127.0.0.1:{_free_port(socket.SOCK_DGRAM)}",
         "--http-front", "native", "--udp-backend", "asyncio",
         "--buckets", "64", "--node-lanes", "4", "--device", "cpu", "--no-warmup"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 90
        answers = []
        while len(answers) < 3:
            assert proc.poll() is None, proc.communicate()[1]
            try:
                conn = http.client.HTTPConnection("127.0.0.1", api, timeout=5)
                conn.request("POST", "/take/cli?rate=2:1h")
                resp = conn.getresponse()
                answers.append((resp.status, resp.read()))
                conn.close()
            except OSError:
                assert time.monotonic() < deadline, "the node did not start serving"
                time.sleep(0.1)
        conn = http.client.HTTPConnection("127.0.0.1", api, timeout=5)
        conn.request("GET", "/debug/vars")
        stats = json.loads(conn.getresponse().read())
        conn.close()
        assert answers == [(200, b"1"), (200, b"0"), (429, b"0")]
        assert stats["http_requests"] >= 4 and stats["engine_hosted_buckets"] == 1
        assert stats["engine_host_takes"] == 3 and stats["engine_ticks"] == 0
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


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
