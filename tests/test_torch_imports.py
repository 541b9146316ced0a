"""ramba_tpu_torch stands alone: it, chip_smoke.py and the sweep scripts
import neither JAX nor the JAX package, nor Triton (every hand kernel is
CUDA C++), and with no card and no request for the CPU it refuses to run
instead of quietly running on the CPU.

Module names are compared exactly (``ramba_tpu`` or ``ramba_tpu.*``), since
``ramba_tpu_torch`` itself starts with the string ``ramba_tpu``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "ramba_tpu_torch").rglob("*.py")
    if "_build" not in p.parts
) + ["chip_smoke.py", "scripts/elemred_ab.py", "scripts/elemred_sweep.py",
     "scripts/scan_ab.py", "scripts/stencil_sweep.py",
     "scripts/fence_probe.py", "tests/torch_dist_worker.py",
     "scripts/fleet_router_torch.py", "scripts/fleet_collector_torch.py",
     "scripts/warm_pool_torch.py", "scripts/ramba_fsck_torch.py"]


def _forbidden(name: str) -> bool:
    return any(name == root or name.startswith(root + ".")
               for root in ("jax", "jaxlib", "ramba_tpu", "triton"))


def test_forbidden_is_exact():
    assert _forbidden("ramba_tpu") and _forbidden("ramba_tpu.core.expr")
    assert _forbidden("jax.numpy")
    assert _forbidden("triton") and _forbidden("triton.language")
    assert not _forbidden("ramba_tpu_torch") and not _forbidden("jaxtyping_x")
    assert not _forbidden("ramba_tpu_torch.core.expr")


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_or_reference_import(rel):
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{rel} imports {bad}"


def test_importing_the_port_loads_no_jax():
    # -I: no PYTHONPATH hooks or user site; the repo goes on sys.path by hand
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import ramba_tpu_torch, ramba_tpu_torch.convert,"
        " ramba_tpu_torch.models.jacobi, ramba_tpu_torch.ops.elemred,"
        " ramba_tpu_torch.ops.stencil_kernel, ramba_tpu_torch.ops.kernel_backend,"
        " ramba_tpu_torch.groupby, ramba_tpu_torch.ops.segred,"
        " ramba_tpu_torch.ops.manipulation, ramba_tpu_torch.ops.cuda_expr,"
        " ramba_tpu_torch.ops.linalg, ramba_tpu_torch.ops.scan,"
        " ramba_tpu_torch.core.interop, ramba_tpu_torch.core.masked,"
        " ramba_tpu_torch.ops.extras, ramba_tpu_torch.fft,"
        " ramba_tpu_torch.linalg, ramba_tpu_torch.core.rewrite,"
        " ramba_tpu_torch.models.pi, ramba_tpu_torch.models.kmeans,"
        " ramba_tpu_torch.parallel.distributed, ramba_tpu_torch.core.rankflush,"
        " ramba_tpu_torch.core.rankselect, ramba_tpu_torch.core.rankdot,"
        " ramba_tpu_torch.compile.classes, ramba_tpu_torch.compile.persist,"
        " ramba_tpu_torch.observe.ledger, ramba_tpu_torch.core.autotune,"
        " ramba_tpu_torch.analyze, ramba_tpu_torch.analyze.lint,"
        " ramba_tpu_torch.analyze.plancert, ramba_tpu_torch.core.memo,"
        " ramba_tpu_torch.core.plancache, ramba_tpu_torch.observe.fleet,"
        " ramba_tpu_torch.fleet, ramba_tpu_torch.fleet.artifacts,"
        " ramba_tpu_torch.fleet.replica, ramba_tpu_torch.fleet.router,"
        " ramba_tpu_torch.fleet.migrate, ramba_tpu_torch.compile.warmpool;"
        "import runpy; runpy.run_path(sys.argv[1] + '/chip_smoke.py',"
        " run_name='chip_smoke_probe');"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'ramba_tpu', 'triton')"
        " or m.startswith(('jax.', 'jaxlib.', 'ramba_tpu.', 'triton.'))];"
        "print(repr(bad))"
    )
    env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-I", "-c", code, str(REPO)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_stencil_nodes_never_load_torch_dynamo():
    """Typing an ``sstencil`` node must not touch meta tensors: their first
    use imports ``torch._dynamo``, seconds of host time on the first call."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import numpy as np, ramba_tpu_torch as rt;"
        "from ramba_tpu_torch.models import jacobi;"
        "u = jacobi.jacobi2d(np.ones((16, 16)), 3);"
        "print(float(rt.sum(u)), 'torch._dynamo' in sys.modules)"
    )
    env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-I", "-c", code, str(REPO)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "False"


def test_groupby_graphs_never_load_torch_dynamo():
    """Typing ``segment_reduce`` and ``take`` nodes (the aval rules) and
    running them must not touch meta tensors either."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import numpy as np, ramba_tpu_torch as rt;"
        "g = rt.arange(12.0).groupby(0, np.arange(12) % 3, 3);"
        "r = [g.sum(), g.mean(), g.var(), g - g.mean()];"
        "print(float(rt.sum(r[3])), 'torch._dynamo' in sys.modules)"
    )
    env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-I", "-c", code, str(REPO)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "False"


def test_no_card_and_no_cpu_request_raises(monkeypatch):
    import torch

    import ramba_tpu_torch as rt
    from ramba_tpu_torch import common

    monkeypatch.setattr(common, "_device", None)
    monkeypatch.delenv("RAMBA_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.arange(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.zeros((2, 2))
    monkeypatch.setenv("RAMBA_TORCH_DEVICE", "cpu")
    assert float(rt.sum(rt.arange(4))) == 6.0


def test_chip_smoke_refuses_without_a_card():
    """With no CUDA device chip_smoke exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=120,
                         cwd=str(REPO))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_indexing_and_scan_graphs_never_load_torch_dynamo():
    """Typing and running the indexing, masked, sort, matmul and scan
    nodes must not touch meta tensors either."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import numpy as np, ramba_tpu_torch as rt;"
        "a = rt.arange(-6.0, 6.0); a[a > 0] += 1.0; a[[1, 20]] = 3.0;"
        "r = [a[[2, -1, 40]], rt.sort(a), rt.argsort(a), rt.cumsum(a),"
        " rt.arange(6.0).reshape(2, 3) @ rt.ones((3, 2)),"
        " np.concatenate([a, a]), a[a < 0].sum()];"
        "print(float(rt.sum(r[3])), 'torch._dynamo' in sys.modules)"
    )
    env = dict(os.environ, RAMBA_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-I", "-c", code, str(REPO)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "False"
