"""The port's dry-run tools (``repro_torch.launch.{collectives, counting,
dryrun, roofline, hillclimb}``) and the kernels' shape-only path, on the
CPU.

A process group is global to its process (and pytest-xdist runs many
tests in one), so everything that brings up the fake group runs in a
subprocess with a time limit:

* ``collective_stats``: exact counts and operand bytes of known
  redistributions on a fake (4, 4) mesh (an all-gather of a split, an
  all-reduce of a pending sum, a reduce-scatter of a pending sum, an
  all-to-all from one split to another) — the counterpart of
  ``tests/test_launch.py::test_collective_stats_parsing``;
* per-device flops of a reduced llama prefill on a fake (4, 4) mesh equal
  its matrix products worked out by hand (every product split 16 ways)
  plus the kernels' formulas (flash split 16 ways, RMSNorm's rows 4
  ways);
* a decode step's cache writes move no cache-sized collective when the
  cache's spec lets the kernel run locally (``prefer="kv"``); the
  baseline spec (``head_dim`` split) gathers each layer's cache for the
  kernel, and the records show it;
* ``python -m repro_torch.launch.dryrun`` on one full-width combination
  over 256 fake ranks: exit 0 and the JAX record's keys.

In this process: the shape-only path is taken on fake and meta tensors
and never on real ones; ``terms_record`` on one probe dict equals JAX's
on ``model_flops``, ``useful_ratio`` and ``hlo_flops_global``, and each
term is the probe's quantity over the port's constant;
``hillclimb.EXPERIMENTS`` keeps JAX's targets and labels in order.
"""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import _shape  # noqa: E402
from repro_torch.launch import collectives as C  # noqa: E402
from repro_torch.launch import hillclimb as THC  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _run(snippet: str, tag: str, timeout: int = 240) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", snippet], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=REPO)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith(tag + " ")]
    assert line, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(line[0][len(tag) + 1:])


def _import_jax_module(name: str):
    """A ``repro.launch`` module that sets ``XLA_FLAGS`` when imported,
    with this process's environment left as it was."""
    pytest.importorskip("jax")
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


# ---------------------------------------------------------------------------
# collectives, flops and cache writes on a fake (4, 4) mesh
# ---------------------------------------------------------------------------

_FAKE_SNIPPET = r"""
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Partial, Replicate, Shard, DTensor
from repro_torch.configs import get_shape
from repro_torch.launch import mesh as M
from repro_torch.launch.collectives import collective_stats
from repro_torch.launch.counting import CountingMode
from repro_torch.launch.steps import lower_combo

M.init_fake_group(16)
mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
out = {}

mode = CountingMode()
with mode.counting():
    x = torch.empty(64, 32, dtype=torch.bfloat16)
    a = DTensor.from_local(x, mesh, (Shard(0), Replicate()),
                           run_check=False)          # (256, 32) over data
    mode.reset()
    a.redistribute(mesh, (Replicate(), Replicate()))             # gather
    p = DTensor.from_local(torch.empty(256, 32), mesh,
                           (Replicate(), Partial()), run_check=False)
    p.redistribute(mesh, (Replicate(), Replicate()))             # reduce
    p.redistribute(mesh, (Replicate(), Shard(0)))                # scatter
    s = DTensor.from_local(torch.empty(64, 32), mesh,
                           (Replicate(), Shard(0)), run_check=False)
    s.redistribute(mesh, (Replicate(), Shard(1)))                # to-all
    out["redistributions"] = collective_stats(mode.collectives)
    out["links"] = sorted({(r["ranks"], r["link"])
                           for r in mode.collectives})

OVER = dict(num_layers=2, d_model=256, d_ff=512, num_heads=4,
            num_kv_heads=4, head_dim=64, vocab_size=512)
rec, combo = lower_combo("llama3.2-1b", "prefill_32k", mesh,
                         cfg_overrides=OVER)
out["prefill"] = {"flops": rec["cost"]["flops"], "kernels": rec["kernels"],
                  "bytes": rec["cost"]["bytes accessed"],
                  "arg": rec["memory"]["argument_size_in_bytes"]}
for prefer in ("kv", "trailing"):
    rec, combo = lower_combo("llama3.2-1b", "decode_32k", mesh,
                             cfg_overrides=OVER, cache_prefer=prefer)
    out["decode_" + prefer] = {
        "largest": max([r["bytes"] for r in rec["collectives"]] + [0]),
        "kinds": collective_stats(rec["collectives"]),
        "kernels": {k: v["count"] for k, v in rec["kernels"].items()}}
print("FAKE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_run():
    return _run(_FAKE_SNIPPET, "FAKE")


def test_collective_stats_of_known_redistributions(fake_run):
    """(256, 32) bf16 split over data 4 gathered: one all-gather of the
    (64, 32) local shard; a (256, 32) f32 pending sum over model 4 made
    whole: one all-reduce of 32 KiB, and split: one reduce-scatter of the
    whole local input; (256, 32) f32 split over model moved from dim 0 to
    dim 1: one all-to-all of the (64, 32) shard. Every group of 4
    consecutive ranks or of stride 4 lies in one node of 8 only for the
    model axis (ranks 0..3)."""
    st = fake_run["redistributions"]
    assert st["all-gather"] == {"count": 1, "bytes": 64 * 32 * 2}
    assert st["all-reduce"] == {"count": 1, "bytes": 256 * 32 * 4}
    assert st["reduce-scatter"] == {"count": 1, "bytes": 256 * 32 * 4}
    assert st["all-to-all"] == {"count": 1, "bytes": 64 * 32 * 4}
    assert set(st) <= set(C.COLLECTIVE_OPS)
    assert [tuple(x) for x in fake_run["links"]] == [(4, "network"),
                                                     (4, "nvlink")]


def test_collective_stats_sums_records_by_kind():
    recs = [{"kind": "all-gather", "bytes": 10}, {"kind": "all-reduce",
                                                   "bytes": 4},
            {"kind": "all-gather", "bytes": 6}]
    assert C.collective_stats(recs) == {"all-gather": {"count": 2,
                                                       "bytes": 16},
                                        "all-reduce": {"count": 1,
                                                       "bytes": 4}}
    assert C.total_collective_bytes(recs) == 20
    assert C.collective_kind("_c10d_functional.all_gather_into_tensor."
                             "default") == "all-gather"
    assert C.collective_kind("reduce_scatter_tensor") == "reduce-scatter"
    assert C.collective_kind("_c10d_functional.wait_tensor.default") is None


def test_prefill_flops_per_device_equal_the_products_by_hand(fake_run):
    """A reduced llama prefill (2 layers, d 256, 4 / 4 heads of 64, d_ff
    512, vocab 512 tied) at prefill_32k (B 32, S 32768) on (data 4, model
    4): batch over data, heads / ffn / vocab over model, so every matrix
    product runs on 1/16 of its global work (row-parallel ones as pending
    sums), and so does flash; RMSNorm's rows split over data only."""
    B, S, d, H, KV, hd, ff, V, L = 32, 32768, 256, 4, 4, 64, 512, 512, 2
    T = B * S
    per_layer = 2 * T * d * (H * hd + 2 * KV * hd) + 2 * T * H * hd * d \
        + 2 * T * d * ff * 2 + 2 * T * ff * d
    head = 2 * B * d * V                       # the last token's logits
    pairs = S * (S + 1) // 2
    flash = 2 * B * H * (hd + hd) * pairs
    norms = 4 * T * d * (2 * L) + 4 * B * d   # ln1, ln2 per layer, final
    want = (L * per_layer + head + L * flash) / 16 + norms / 4
    got = fake_run["prefill"]
    assert got["flops"] == pytest.approx(want, rel=1e-9)
    assert got["kernels"]["flash_attention"]["count"] == L
    assert got["kernels"]["flash_attention"]["flops"] == L * flash / 16
    assert got["kernels"]["fused_rmsnorm"]["count"] == 2 * L + 1
    assert got["bytes"] > 0 and got["arg"] > 0


def test_decode_cache_writes_move_no_cache_sized_collective(fake_run):
    """Cache (L 2, 128, 32768, 4, 64) bf16 on (data 4, model 4): a rank's
    shard of one layer's K is 32 rows x 32768 x 64 values x 2 bytes,
    whichever of K/V heads or ``head_dim`` the model axis splits. Split
    over the K/V heads (``prefer="kv"``) the decode kernel and the writes
    run on it in place: no collective comes near its size. Split along
    ``head_dim`` (the baseline) each layer's K and V move to the heads'
    split for the kernel, an all-to-all of the whole shard (XLA instead
    all-reduces partial scores)."""
    shard = 32 * 32768 * 64 * 2
    kv, base = fake_run["decode_kv"], fake_run["decode_trailing"]
    assert kv["largest"] < shard // 100, kv
    assert base["largest"] == shard, base
    moved = base["kinds"]["all-to-all"]
    assert 4 * shard <= moved["bytes"] < 4 * shard + shard // 100, moved
    for run in (kv, base):
        assert run["kernels"] == {"fused_rmsnorm": 5,
                                  "ragged_decode_attention": 2}


# ---------------------------------------------------------------------------
# the dry run's command line on 256 fake ranks
# ---------------------------------------------------------------------------

_CLI_SNIPPET = r"""
import json, sys, tempfile, os
from repro_torch.launch import dryrun
d = tempfile.mkdtemp()
code = dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                    "--out", d])
rec = json.load(open(os.path.join(d, os.listdir(d)[0])))
print("CLI " + json.dumps({"code": code, "name": os.listdir(d)[0],
                           "jax": [m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "repro")],
                           "rec": {k: v for k, v in rec.items()
                                   if k != "traceback"}}))
"""


def test_dryrun_cli_traces_a_full_width_combination():
    out = _run(_CLI_SNIPPET, "CLI")
    rec = out["rec"]
    assert out["code"] == 0 and rec["ok"], rec.get("error")
    assert out["jax"] == []             # neither JAX nor the JAX package
    assert out["name"] == "llama3.2-1b__decode_32k__pod16x16.json"
    # the JAX record's keys, trace_s in place of lower_s / compile_s
    assert {"arch", "shape", "mesh", "ok", "n_devices", "memory", "cost",
            "collectives", "trace_s"} <= set(rec)
    assert rec["n_devices"] == 256
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes"}
    assert set(rec["cost"]) == {"flops", "bytes accessed"}
    assert set(rec["collectives"]) <= set(C.COLLECTIVE_OPS)
    assert rec["kernels"]["ragged_decode_attention"]["count"] == 16


# ---------------------------------------------------------------------------
# the kernels' shape-only path
# ---------------------------------------------------------------------------

def _kernel_calls(make):
    """Each wrapper on tensors from ``make(shape, dtype)``: [(name, out)]."""
    f32, bf = torch.float32, torch.bfloat16
    q = make((2, 8, 4, 32), bf)
    kv = make((2, 8, 2, 32), bf)
    dq = make((3, 4, 32), bf)
    cache = make((3, 16, 2, 32), bf)
    lens = torch.tensor([1, 5, 16], dtype=torch.int32)
    if make((1,), f32).device.type == "meta":
        lens = lens.to("meta")
    x = make((2, 8, 4, 16), f32)
    return [
        ("flash_attention", K.flash_attention(q, kv, kv)),
        ("ragged_decode_attention",
         K.ragged_decode_attention(dq, cache, cache, lens)),
        ("fused_rmsnorm", K.fused_rmsnorm(make((5, 32), bf),
                                          make((32,), f32))),
        ("ssd_chunked", K.ssd_chunked(x, make((2, 8, 4), f32),
                                      make((4,), f32), make((2, 8, 8), f32),
                                      make((2, 8, 8), f32), 4)),
    ]


@pytest.mark.parametrize("kind", ["fake", "meta"])
def test_shape_only_path_on_fake_and_meta_tensors(kind):
    from torch._subclasses.fake_tensor import FakeTensorMode
    seen = []
    before = K.launch_counts()
    with _shape.recording(lambda *a: seen.append(a)):
        if kind == "fake":
            with FakeTensorMode():
                outs = _kernel_calls(lambda s, dt: torch.empty(s, dtype=dt))
        else:
            outs = _kernel_calls(lambda s, dt: torch.empty(s, dtype=dt,
                                                           device="meta"))
    assert K.launch_counts() == before          # no launch counted
    assert [name for name, _, _ in seen] == [n for n, _ in outs]
    shapes = {n: o for n, o in outs}
    assert tuple(shapes["flash_attention"].shape) == (2, 8, 4, 32)
    assert tuple(shapes["ragged_decode_attention"].shape) == (3, 4, 32)
    assert shapes["fused_rmsnorm"].dtype == torch.bfloat16
    y, final = shapes["ssd_chunked"]
    assert tuple(final.shape) == (2, 4, 16, 8) and final.dtype == \
        torch.float32
    work = {name: (flops, nbytes) for name, flops, nbytes in seen}
    # the bound column's formulas: causal pairs of S 8, q/k/v/o once
    assert work["flash_attention"] == (2 * 2 * 4 * 64 * 36,
                                       (2 * 8 * 4 * 32 * 2 + 2 * 2 * 8 * 2
                                        * 32) * 2)
    assert work["ragged_decode_attention"] == (
        4 * 4 * 32 * 3 * 16, 2 * 3 * 4 * 32 * 2 + 2 * 3 * 16 * 2 * 32 * 2
        + 8 * 3)
    assert work["fused_rmsnorm"] == (4 * 5 * 32, 2 * 5 * 32 * 2 + 32 * 4)


def test_shape_only_path_never_taken_on_real_tensors():
    seen = []
    g = torch.Generator().manual_seed(0)
    with _shape.recording(lambda *a: seen.append(a)):
        outs = _kernel_calls(lambda s, dt: torch.randn(s, generator=g).to(dt))
    assert seen == []
    for name, out in outs:
        for t in (out if isinstance(out, tuple) else (out,)):
            assert torch.isfinite(t.float()).all(), name
    assert not _shape.shape_only(torch.zeros(2), None)
    assert _shape.shape_only(torch.zeros(2, device="meta"))


# ---------------------------------------------------------------------------
# roofline terms and the hillclimb's table against the JAX package's
# ---------------------------------------------------------------------------

PROBE = {"arch": "llama3.2-1b", "shape": "train_4k", "mesh": "pod16x16",
         "flops": 3.1e15, "bytes": 2.4e13, "coll_bytes": 7.5e11}


def test_terms_record_equals_jax_on_the_model_flops():
    JR = _import_jax_module("repro.launch.roofline")
    want = JR.terms_record(dict(PROBE), train=True)
    got = TR.terms_record(dict(PROBE), train=True)
    for key in ("model_flops", "hlo_flops_global", "useful_ratio"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["compute_s"] == PROBE["flops"] / TM.PEAK_FLOPS
    assert got["memory_s"] == PROBE["bytes"] / TM.HBM_BW
    # no link split in the probe: every byte crosses the network
    assert got["collective_s"] == PROBE["coll_bytes"] / TM.NETWORK_BW
    split = TR.terms_record(dict(PROBE, coll_nvlink=5e11, coll_network=2.5e11,
                                 n_dev=256), train=True)
    assert split["collective_s"] == pytest.approx(
        5e11 / TM.NVLINK_BW + 2.5e11 / TM.NETWORK_BW, rel=1e-12)
    assert got["analytic_memory_s"] == pytest.approx(
        JR.analytic_bytes("llama3.2-1b", "train_4k", 256) / TM.HBM_BW,
        rel=1e-12)
    terms = {k: got[k + "_s"] for k in ("compute", "memory", "collective")}
    assert got["dominant"] == max(terms, key=terms.get) == "collective"
    assert TR.fmt_seconds(2.5) == JR.fmt_seconds(2.5) == "2.50s"
    assert TR.render_table([got]).splitlines()[0] == \
        JR.render_table([want]).splitlines()[0]


def test_hillclimb_experiments_keep_the_jax_targets_and_labels():
    JH = _import_jax_module("repro.launch.hillclimb")
    assert list(THC.EXPERIMENTS) == list(JH.EXPERIMENTS)
    for name, spec in JH.EXPERIMENTS.items():
        port = THC.EXPERIMENTS[name]
        assert (port["arch"], port["shape"]) == (spec["arch"], spec["shape"])
        assert [s[0] for s in port["steps"]] == [s[0] for s in spec["steps"]]
        assert [s[2] for s in port["steps"]] == [s[2] for s in spec["steps"]]
    # the steps with no counterpart equal the step before them
    qwen = [THC.effective(s[2]) for s in THC.EXPERIMENTS["qwen"]["steps"]]
    assert qwen[0] == qwen[1] == qwen[2] == {}
    assert qwen[3] != qwen[2]
