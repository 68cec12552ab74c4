"""The port's serving launcher against the JAX package's.

``repro_torch.launch.serve`` takes ``repro.launch.serve``'s flags: over the
simulator both must write the same JSON (virtual time makes it exact; only
the recorded command line differs). Over the torch engine on the CPU
(``--device cpu --reduced``, float32) on the JAX engine's own weights
(``params_from_jax``), every request of the seeded trace must get the JAX
launcher's tokens (exact equality, as in tests/test_torch_engine.py), with
and without injected faults. Without ``--device`` the launcher wants the
card and raises where there is none.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.launch.serve as jax_serve  # noqa: E402
import repro_torch.launch.serve as torch_serve  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

SIM_FLAGS = {
    "default-lazyb": [],
    "graphb-bursty": ["--policy", "graphb", "--bursty"],
    "tenants-mem-shares": [
        "--models", "transformer:0.6,gnmt:0.4", "--mem-slots", "16",
        "--mem-shares", "transformer:0.5,gnmt:0.5", "--arbiter", "rr"],
    "faults-retry-cancel-queue": [
        "--fault-spec", "transient:0.05,straggler:0.1x4", "--max-retries",
        "2", "--cancel-expired", "--max-queue", "64"],
    "tiers-shed": ["--sla-tiers", "gold:0.05,bulk:0.5", "--shed"],
}


def _without_argv(doc):
    doc = dict(doc)
    doc["invocation"] = {k: v for k, v in doc["invocation"].items()
                         if k != "argv"}
    return doc


def _run_jax_main(monkeypatch, flags):
    """``repro.launch.serve.main`` reads ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *flags])
    jax_serve.main()


@pytest.mark.parametrize("flags", list(SIM_FLAGS.values()), ids=list(SIM_FLAGS))
def test_sim_json_equals_the_jax_launcher(flags, tmp_path, monkeypatch):
    jax_out, torch_out = tmp_path / "jax.json", tmp_path / "torch.json"
    _run_jax_main(monkeypatch, [*flags, "--json-out", str(jax_out)])
    assert torch_serve.main([*flags, "--json-out", str(torch_out)]) == 0
    ref = json.loads(jax_out.read_text())
    got = json.loads(torch_out.read_text())
    assert got["summary"]["completed"] > 0
    assert _without_argv(got) == _without_argv(ref)
    assert got["invocation"]["argv"][:2] == ["-m", "repro_torch.launch.serve"]


def _jax_session(monkeypatch, flags):
    """Run the JAX launcher's main and keep its session and engines."""
    captured, engines = {}, {}
    run_session, jax_engine = jax_serve._run_session, jax_serve._jax_engine

    def keep_session(session, trace, label, args):
        captured["session"] = session
        return run_session(session, trace, label, args)

    def keep_engine(name, args, max_slots=None):
        engines[name] = jax_engine(name, args, max_slots)
        return engines[name]

    monkeypatch.setattr(jax_serve, "_run_session", keep_session)
    monkeypatch.setattr(jax_serve, "_jax_engine", keep_engine)
    _run_jax_main(monkeypatch, ["--engine", "jax", *flags])
    params = {name: params_from_jax(jax.tree.map(np.asarray, eng.params),
                                    device="cpu")
              for name, (eng, _) in engines.items()}
    return captured["session"], params


def _tokens(session):
    """Per-request tokens in submission order (rids differ across runs)."""
    return [list(h.tokens) for h in session.handles.values()]


def _torch_session(flags, params=None):
    args = torch_serve.parse_args(
        ["--engine", "torch", "--device", "cpu", "--reduced", *flags])
    return torch_serve.serve(args, params)


# a fault voids the whole batched run, so every member is charged a retry,
# and a retry replays the request from its prefill: at 0.2 per run the
# budget must outlast many voided attempts
FAULTS = ["--fault-spec", "transient:0.2", "--max-retries", "32"]


@pytest.mark.parametrize("faults", [False, True], ids=["clean", "faults"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b", "minicpm3-4b",
                                  "granite-moe-3b-a800m",
                                  "recurrentgemma-9b"])
def test_torch_engine_tokens_equal_the_jax_launcher(arch, faults,
                                                    monkeypatch):
    flags = ["--arch", arch, "--rate", "6", "--duration", "1",
             "--max-batch", "4"] + (FAULTS if faults else [])
    ref_session, params = _jax_session(monkeypatch, flags)
    session, code = _torch_session(flags, params)
    assert code == 0
    ref = _tokens(ref_session)
    got = _tokens(session)
    assert len(got) == len(ref) >= 3
    assert all(h.state.value == "done" for h in session.handles.values())
    assert got == ref
    if faults:
        assert any(h.request.retries > 0 for h in session.handles.values())
    engine = getattr(session.backend, "inner", session.backend)
    assert engine.cfg.d_model == 256 and engine.max_len == 64
    assert engine.model.flags.dtype == torch.float32


def test_faults_on_the_torch_engine_keep_tokens_and_leak_nothing(tmp_path):
    flags = ["--arch", "llama3.2-1b", "--rate", "8", "--duration", "1",
             "--max-batch", "4"]
    clean, code = _torch_session(flags)
    assert code == 0
    out = tmp_path / "faults.json"
    fault_flags = [*flags, *FAULTS, "--assert-no-leak"]
    faulty, code = _torch_session([*fault_flags, "--json-out", str(out)])
    assert code == 0
    doc = json.loads(out.read_text())
    assert sum(per["transient"] for per in doc["injected_faults"].values()) > 0
    assert doc["summary"]["retried"] > 0
    assert doc["memory"]["slots_live"] == 0
    assert doc["args"]["device"] == "cpu" and doc["args"]["reduced"]
    handles = list(faulty.handles.values())
    assert all(h.state.value == "done" for h in handles)
    assert any(h.request.retries > 0 for h in handles)
    assert _tokens(faulty) == _tokens(clean)
    # the same flags through main: the gate's exit code
    assert torch_serve.main(["--engine", "torch", "--device", "cpu",
                             "--reduced", *fault_flags]) == 0


def test_multi_tenant_torch_engines_split_the_slot_budget(tmp_path):
    out = tmp_path / "tenants.json"
    session, code = _torch_session(
        ["--models", "llama3.2-1b:0.5,mamba2-2.7b:0.5", "--mem-slots", "8",
         "--rate", "8", "--duration", "1", "--max-batch", "4",
         "--assert-no-leak", "--json-out", str(out)])
    assert code == 0
    caps = {name: eng.max_slots
            for name, eng in session.backend.backends.items()}
    assert set(caps) == {"llama3.2-1b", "mamba2-2.7b"}
    assert sum(caps.values()) == 8 and min(caps.values()) >= 1
    doc = json.loads(out.read_text())
    assert doc["memory"]["slots_live"] == 0
    assert set(doc["per_model"]) == set(caps)
    for name in caps:
        assert doc["per_model"][name]["completed"] > 0
    assert all(h.state.value == "done" for h in session.handles.values())


@pytest.mark.parametrize("module,extra", [
    ("repro_torch.launch.serve", []),
    ("repro_torch.launch.gateway", ["--port", "0"])])
def test_torch_engine_without_device_raises_without_cuda(module, extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", module, "--engine", "torch", "--arch",
         "llama3.2-1b", *extra],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "completed" not in out.stdout


def test_example_serves_and_verifies_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "serve_real_model_torch.py"),
         "--device", "cpu", "--reduced", "--n", "4"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "4/4 generations equal" in out.stdout
