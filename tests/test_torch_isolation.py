"""The port stands alone: no JAX, nothing of ``repro``, card by default.

The machine with the card has no JAX, so ``repro_torch`` and
``chip_smoke.py`` may import neither JAX nor the JAX package (whose
``serving`` reaches JAX through ``workload -> models -> model``). The
scheduling layer the port needs is its own copy; the copies must stay the
JAX package's code, so a change to one side shows up here.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "check_f32_sync.py",
    REPO / "tools" / "flash_ab.py", REPO / "tools" / "ssd_scan_ab.py",
    REPO / "tools" / "serve_ab.py", REPO / "tools" / "decode_ab.py",
    REPO / "tests" / "test_torch_kernels_cuda.py",
    REPO / "examples" / "serve_real_model_torch.py",
    REPO / "examples" / "train_small_torch.py",
    REPO / "tools" / "mesh_step.py"]

# modules kept as verbatim copies of the JAX package's pure-Python layer
COPIES = ["configs/base.py", "configs/llama3_2_1b.py",
          "configs/mamba2_2_7b.py", "configs/qwen2_5_32b.py",
          "configs/mistral_nemo_12b.py", "configs/internvl2_26b.py",
          "configs/musicgen_large.py", "configs/minicpm3_4b.py",
          "configs/granite_moe_3b_a800m.py", "configs/grok_1_314b.py",
          "configs/recurrentgemma_9b.py", "core/__init__.py",
          "core/lifecycle.py", "core/request.py", "core/batch_table.py",
          "core/slack.py", "core/policies.py", "core/arbiter.py",
          "serving/backend.py", "serving/registry.py", "serving/metrics.py",
          "serving/traffic.py", "serving/session.py", "serving/workload.py",
          "serving/server.py", "serving/faults.py",
          "serving/gateway/__init__.py", "serving/gateway/app.py",
          "serving/gateway/bridge.py", "serving/gateway/http.py",
          "serving/gateway/middleware.py", "serving/gateway/prom.py",
          "serving/gateway/sanitizer.py", "serving/gateway/telemetry.py",
          "models/cost.py"]


def _forbidden_imports(path: Path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.name}:{node.lineno}: {name}")
    return bad


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    assert _forbidden_imports(path) == []


def test_importing_the_engine_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.serving.engine, repro_torch.kernels, "
            "repro_torch.serving.gateway, repro_torch.launch.serve, "
            "repro_torch.launch.gateway; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("rel", COPIES)
def test_scheduling_copies_match_the_jax_package(rel):
    ours = (PORT / rel).read_text()
    theirs = (REPO / "src" / "repro" / rel).read_text()
    assert ours == theirs, f"repro_torch/{rel} drifted from repro/{rel}"


def test_engine_without_device_raises_without_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.serving import TorchEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(get_config("llama3.2-1b").reduced())
