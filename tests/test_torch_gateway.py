"""The port's HTTP/SSE gateway: the JAX package's gateway modules, copied,
over the port's session stack.

Mirrors tests/test_gateway.py: an end-to-end SSE exchange over the sim
backend through ``repro_torch.launch.gateway.build_app``; the launcher as a
subprocess that drains on SIGTERM without ever importing JAX or
``repro``; and a client that disconnects mid-stream from a ``TorchEngine``
(CPU, a tiny llama on the JAX engine's weights): its handle reaches
CANCELLED and frees its slot, and the surviving streams are bit-exact
against the no-disconnect control run and equal the JAX gateway's tokens.
"""
import asyncio
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                       / "benchmarks"))
import loadgen  # noqa: E402

import jax  # noqa: E402

import repro_torch.launch.gateway as launch_gateway  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.policies import LazyBatching as JaxLazyBatching  # noqa: E402
from repro.core.slack import SlackPredictor as JaxSlackPredictor  # noqa: E402
from repro.serving.engine import JaxEngine  # noqa: E402
from repro.serving.gateway import GatewayApp as JaxGatewayApp  # noqa: E402
from repro.serving.npu_model import NPUPerfModel as JaxNPU, TPU_V5E  # noqa: E402
from repro.serving.session import ServingSession as JaxSession  # noqa: E402
from repro.serving.workload import LengthDist as JaxLengthDist  # noqa: E402
from repro.serving.workload import from_model_config as jax_workload  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policies import LazyBatching  # noqa: E402
from repro_torch.core.slack import SlackPredictor  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serving import (H100_SXM, HandleState, LengthDist,  # noqa: E402
                                 NPUPerfModel, ServingSession, TorchEngine,
                                 from_model_config)

REPO = Path(__file__).resolve().parents[1]
HOST = "127.0.0.1"
_KW = dict(d_model=64, d_ff=128, vocab_size=128, num_prefix_embeddings=0)


def _sim_args(*extra):
    return launch_gateway.parse_args(
        ["--port", "0", "--time-scale", "200", "--tick-ms", "1", "--quiet",
         "--sla-tiers", "gold:0.05,bulk:0.5", "--mem-slots", "48", *extra])


async def _post(port, body, timeout=30.0):
    loop = asyncio.get_running_loop()
    return await asyncio.wait_for(
        loadgen.do_request(HOST, port, "/v1/generate", body, loop.time()),
        timeout=timeout)


def test_e2e_sim_streaming_metrics_and_drain():
    async def scenario():
        app = launch_gateway.build_app(_sim_args())
        await app.start()
        results = await asyncio.gather(*[
            _post(app.port, {"model": "transformer",
                             "sla_class": "gold" if i % 2 else "bulk"})
            for i in range(12)])
        status, metrics = await loadgen.fetch(HOST, app.port, "/metrics")
        status_h, _ = await loadgen.fetch(HOST, app.port, "/healthz")
        status_r, _ = await loadgen.fetch(HOST, app.port, "/readyz")
        stats = await app.drain()
        return app, results, status, metrics.decode(), status_h, status_r, stats

    app, results, mstatus, metrics, hstatus, rstatus, stats = (
        asyncio.run(scenario()))
    assert hstatus == 200 and rstatus == 200
    for r in results:
        assert r["status"] == 200 and r["fate"] == "done"
        assert r["tokens"] > 0
        assert r["ttft_s"] is not None and r["ttft_s"] <= r["latency_s"]
    assert len(stats.finished) == 12
    assert mstatus == 200
    assert 'gateway_attainment{model="transformer",sla_class=' in metrics
    assert "gateway_arena_slots_total 48" in metrics
    assert "gateway_requests_total" in metrics
    assert app.session.backend.memory_stats().slots_live == 0
    assert app.access_log.records[-1]["event"] == "drain"


def _imported(stderr_lines):
    """Top-level module names from ``-X importtime`` lines."""
    names = set()
    for line in stderr_lines:
        if line.startswith("import time:") and "|" in line:
            name = line.rsplit("|", 1)[1].strip()
            names.add(name.split(".")[0])
    return names


def test_launcher_sigterm_drains_cleanly_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    json_out = tmp_path / "gw.json"
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m",
         "repro_torch.launch.gateway", "--port", "0", "--time-scale", "200",
         "--sla-tiers", "gold:0.05,bulk:0.5", "--mem-slots", "32",
         "--assert-no-leak", "--json-out", str(json_out)],
        env=env, stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        port = None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            try:
                record = json.loads(line)
            except ValueError:
                continue
            if record.get("event") == "ready":
                port = record["port"]
                break
        assert port is not None, "gateway never logged ready"

        async def drive():
            return await asyncio.gather(*[
                _post(port, {"sla_class": "gold" if i % 2 else "bulk"})
                for i in range(6)])

        results = asyncio.run(drive())
        assert all(r["status"] == 200 for r in results)
        proc.send_signal(signal.SIGTERM)
        _, rest = proc.communicate(timeout=60)
        lines += rest.splitlines()
        code = proc.returncode
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert code == 0
    imported = _imported(lines)
    assert "repro_torch" in imported
    assert not imported & {"jax", "jaxlib", "repro"}, sorted(imported)
    doc = json.loads(json_out.read_text())
    assert doc["summary"]["completed"] == 6
    assert doc["memory"]["slots_live"] == 0
    assert doc["invocation"]["argv"][:2] == ["-m",
                                             "repro_torch.launch.gateway"]


# ---------------------------------------------------------------------------
# cancellation under streaming: TorchEngine against the JAX gateway
# ---------------------------------------------------------------------------

class _SlowRuns:
    """Make every run take ``delay_s`` longer, in wall time and in the time
    it reports, so a client abort lands between run boundaries (the tiny
    engine decodes a request inside one tick). The reported time must grow
    too: the pump runs the session until its clock reaches the wall's, and
    a run that reported less than it took would keep the session catching
    up, run after run, to the end of every request within one tick."""

    def __init__(self, inner, delay_s=0.05):
        self._inner, self._delay = inner, delay_s

    def execute_run(self, model, sb, node_ids):
        time.sleep(self._delay)
        t, per_node = self._inner.execute_run(model, sb, node_ids)
        if per_node is not None:
            per_node = [x + self._delay / len(per_node) for x in per_node]
        return t + self._delay, per_node

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.fixture(scope="module")
def jax_engine():
    cfg = dataclasses.replace(jax_get_config("llama3.2-1b").reduced(), **_KW)
    return cfg, JaxEngine(cfg, max_len=32, n_slots=4)


def _jax_app(jax_engine):
    cfg, engine = jax_engine
    wl = jax_workload(cfg, prompt_dist=JaxLengthDist((6,), (1.0,)),
                      decode_dist=JaxLengthDist((8,), (1.0,)))
    pred = JaxSlackPredictor.build([wl], JaxNPU(TPU_V5E), 60.0)
    session = JaxSession(backend=_SlowRuns(engine), seed=9)
    session.register(wl.name, wl, policy=JaxLazyBatching(pred, max_batch=4))
    return JaxGatewayApp(session, port=0, time_scale=1.0, tick=0.002,
                         default_sla=60.0, log_enabled=False), engine


def _torch_app(jax_engine):
    params = params_from_jax(jax.tree.map(np.asarray, jax_engine[1].params),
                             device="cpu")
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), **_KW)
    wl = from_model_config(cfg, prompt_dist=LengthDist((6,), (1.0,)),
                           decode_dist=LengthDist((8,), (1.0,)))
    engine = TorchEngine(cfg, max_len=32, n_slots=4, device="cpu",
                         params=params)
    pred = SlackPredictor.build([wl], NPUPerfModel(H100_SXM), 60.0)
    session = ServingSession(backend=_SlowRuns(engine), seed=9)
    session.register(wl.name, wl, policy=LazyBatching(pred, max_batch=4))
    args = launch_gateway.parse_args(
        ["--port", "0", "--time-scale", "1", "--quiet", "--sla", "60",
         "--engine", "torch", "--device", "cpu"])
    return launch_gateway.build_app(args, session=session), engine


async def _stream_one(port, disconnect_after=None, decode_len=8):
    """One raw SSE exchange; abort after ``disconnect_after`` tokens."""
    reader, writer = await asyncio.open_connection(HOST, port)
    body = json.dumps({"prompt_len": 6, "decode_len": decode_len}).encode()
    writer.write((f"POST /v1/generate HTTP/1.1\r\nhost: {HOST}\r\n"
                  f"content-type: application/json\r\n"
                  f"content-length: {len(body)}\r\n"
                  f"connection: close\r\n\r\n").encode() + body)
    await writer.drain()
    await loadgen._read_headers(reader)
    tokens, fate = [], None
    async for event, data in loadgen._sse_events(reader):
        if event == "token":
            tokens.append(data["token"])
            if disconnect_after is not None and len(tokens) >= disconnect_after:
                writer.transport.abort()     # vanish mid-stream
                return tokens, "aborted"
        elif event in ("done", "error"):
            fate = data.get("fate", event)
    writer.close()
    return tokens, fate


async def _scenario(make_app, disconnect_idx):
    app, engine = make_app()
    await app.start()
    results = [None] * 4
    tasks = []
    loop = asyncio.get_running_loop()
    for i in range(4):
        submitted = len(app.session.handles)

        async def one(i=i):
            # stream 1 decodes longest, so the cancel lands with decode left
            results[i] = await _stream_one(
                app.port, disconnect_after=1 if i == disconnect_idx else None,
                decode_len=20 if i == 1 else 8)

        tasks.append(asyncio.create_task(one()))
        # serialize submission order: prompts are drawn at submit
        deadline = loop.time() + 30
        while len(app.session.handles) == submitted and loop.time() < deadline:
            await asyncio.sleep(0.005)
    await asyncio.gather(*tasks)
    if disconnect_idx is not None:
        deadline = loop.time() + 30
        handle = list(app.session.handles.values())[disconnect_idx]
        while not handle.done and loop.time() < deadline:
            await asyncio.sleep(0.005)
    stats = await app.drain()
    return results, stats, app, engine


def test_torch_client_disconnect_cancels_and_survivors_bit_exact(jax_engine):
    jax_results, jax_stats, _, _ = asyncio.run(
        _scenario(lambda: _jax_app(jax_engine), None))
    results, stats, app, engine = asyncio.run(
        _scenario(lambda: _torch_app(jax_engine), 1))
    ref_results, ref_stats, _, _ = asyncio.run(
        _scenario(lambda: _torch_app(jax_engine), None))

    handles = list(app.session.handles.values())
    assert handles[1].state is HandleState.CANCELLED
    assert len(stats.cancelled_requests) == 1
    assert len(stats.finished) == 3
    assert len(ref_stats.finished) == 4 and len(jax_stats.finished) == 4
    assert engine.slots_in_use == 0
    assert app.session.backend.memory_stats().slots_live == 0
    for i in (0, 2, 3):
        tokens, fate = results[i]
        assert fate == "done" and len(tokens) == 8
        assert tokens == ref_results[i][0] == jax_results[i][0]
    # the control runs agree on the long stream too
    assert ref_results[1] == jax_results[1]
    assert len(ref_results[1][0]) == 20
    assert results[1][1] == "aborted" and len(results[1][0]) >= 1
    assert results[1][0] == ref_results[1][0][:len(results[1][0])]
