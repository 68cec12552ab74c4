"""``repro_torch.launch.steps`` against ``repro.launch.steps``, on the CPU.

* ``make_flags``: every field the two ``RuntimeFlags`` share is equal,
  for all 10 architectures × 4 input shapes; the JAX fields the port
  drops are exactly ``use_scan``, ``scan_unroll``, ``grouped_decode``,
  ``pallas_decode`` and ``attn_chunk``, and overrides of them are dropped.
* ``serve_fsdp`` at ``model_n`` 1, 8 and 16.
* ``build_combo``: every argument leaf's shape and dtype, spec and
  per-device bytes equal JAX's — JAX's from ``jax.eval_shape`` and its
  spec functions on stand-in meshes, as ``tests/test_torch_sharding.py``
  derives them — for every architecture × shape on (data 16, model 16)
  and (pod 2, data 16, model 16).
* Against JAX's own ``build_combo`` (lowered, not compiled, in a
  subprocess with 16 host devices, as ``tests/test_launch.py`` runs it):
  for a reduced llama on a (4, 4) mesh the port's local shard shapes
  (rank 0 of a fake group of 16, ``Combo.place``) equal
  ``NamedSharding.shard_shape`` leaf by leaf, decode and train.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCHITECTURES, INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import make_batch_specs as jax_batch_specs  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro.launch import steps as JSTEPS  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import RuntimeFlags as JaxFlags  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as TSTEPS  # noqa: E402
from repro_torch.launch.mesh import spec_leaves  # noqa: E402
from repro_torch.models import RuntimeFlags  # noqa: E402
from repro_torch.training.tree import flatten_with_paths  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SINGLE = (("data", 16), ("model", 16))
MULTI = (("pod", 2), ("data", 16), ("model", 16))
COMBOS = [(a, s) for a in sorted(ARCHITECTURES) for s in INPUT_SHAPES]


def _meshes(*axes):
    """(JAX stand-in, port stand-in) of a mesh of ``axes``."""
    names = tuple(n for n, _ in axes)
    sizes = tuple(s for _, s in axes)
    return (types.SimpleNamespace(axis_names=names,
                                  devices=np.empty(sizes, np.int8)),
            types.SimpleNamespace(mesh_dim_names=names, shape=sizes))


# ---------------------------------------------------------------------------
# make_flags, serve_fsdp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", COMBOS)
def test_make_flags_equals_jax_on_shared_fields(arch, shape):
    jf = JSTEPS.make_flags(jax_get_config(arch), INPUT_SHAPES[shape])
    tf = TSTEPS.make_flags(get_config(arch), INPUT_SHAPES[shape])
    jfields = {f.name for f in dataclasses.fields(jf)}
    tfields = {f.name for f in dataclasses.fields(tf)}
    assert jfields - tfields == set(TSTEPS.NO_COUNTERPART)
    assert tfields <= jfields
    for name in tfields - {"dtype"}:
        assert getattr(tf, name) == getattr(jf, name), name
    assert tf.dtype == torch.bfloat16 and jf.dtype == jnp.bfloat16
    # the JAX keyword arguments before the drop, overrides included
    kw = TSTEPS.flag_kwargs(get_config(arch), INPUT_SHAPES[shape])
    assert JaxFlags(**kw) == jf


def test_make_flags_drops_the_fields_with_no_counterpart():
    cfg, shape = get_config("qwen2.5-32b"), INPUT_SHAPES["decode_32k"]
    over = {"grouped_decode": True, "pallas_decode": True, "attn_chunk": 64,
            "scan_unroll": 2, "use_scan": False, "kv_quant": True}
    tf = TSTEPS.make_flags(cfg, shape, overrides=over)
    assert tf == RuntimeFlags(kv_quant=True)
    with pytest.raises(TypeError):
        TSTEPS.make_flags(cfg, shape, overrides={"no_such_flag": 1})


@pytest.mark.parametrize("model_n", [1, 8, 16])
def test_serve_fsdp_equals_jax(model_n):
    got = {a: TSTEPS.serve_fsdp(get_config(a), model_n)
           for a in ARCHITECTURES}
    want = {a: JSTEPS.serve_fsdp(jax_get_config(a), model_n)
            for a in ARCHITECTURES}
    assert got == want
    assert got["grok-1-314b"] and not got["llama3.2-1b"]


# ---------------------------------------------------------------------------
# build_combo's arguments, specs and per-device bytes
# ---------------------------------------------------------------------------

_JAX_TREES: dict = {}


def _jax_args(arch, shape_name):
    """JAX's ``build_combo`` arguments as ShapeDtypeStructs, and a
    function of a stand-in mesh giving their specs, as its
    ``build_combo`` derives them (cached per tree)."""
    cfg = jax_get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    flags = JSTEPS.make_flags(cfg, shape)
    model = JaxModel(cfg, flags)
    batch = jax_batch_specs(cfg, shape)
    key = jax.random.key(0)

    def tree(name, fn):
        k = (arch, name)
        if k not in _JAX_TREES:
            _JAX_TREES[k] = jax.eval_shape(fn)
        return _JAX_TREES[k]

    if shape.kind == "train":
        state = tree("state", lambda: JT.init_state(model, key))
        return (state, batch), lambda m: (
            JM.param_pspecs(state, mesh=m, fsdp=True),
            JM.batch_pspecs(batch, mesh=m))
    params = tree("params", lambda: model.init(key))

    def pspec(m):
        model_n = dict(zip(m.axis_names, m.devices.shape)).get("model", 1)
        return JM.param_pspecs(params, mesh=m,
                               fsdp=JSTEPS.serve_fsdp(cfg, model_n))

    if shape.kind == "prefill":
        return (params, batch), lambda m: (pspec(m),
                                           JM.batch_pspecs(batch, mesh=m))
    B = shape.global_batch
    cache = tree(f"cache {shape_name}",
                 lambda: model.init_cache(B, shape.seq_len))
    tok = jax.ShapeDtypeStruct((B,), jnp.int32)
    return (params, cache, tok, tok), lambda m: (
        pspec(m), JM.cache_pspecs(cache, mesh=m),
        JM.batch_pspecs({"t": tok}, mesh=m)["t"],
        JM.batch_pspecs({"t": tok}, mesh=m)["t"])


def _key(path) -> tuple:
    """A JAX path as the names of its steps (dict keys, attribute names,
    list indices)."""
    return tuple(str(getattr(k, "key", getattr(k, "name", getattr(
        k, "idx", k)))) for k in path)


def _jax_leaves(args, specs) -> dict:
    """{(arg index, path names): (shape, dtype name, spec)} of JAX's
    argument leaves."""
    out = {}
    for i, (a, s) in enumerate(zip(args, specs)):
        la = jax.tree_util.tree_flatten_with_path(a)[0]
        ls = jax.tree_util.tree_leaves(s, is_leaf=lambda x: isinstance(x, P))
        assert len(la) == len(ls)
        for (path, x), sp in zip(la, ls):
            out[(i,) + _key(path)] = (
                tuple(x.shape), jnp.dtype(x.dtype).name,
                tuple(sp) + (None,) * (len(x.shape) - len(sp)))
    return out


def _port_leaves(args, specs) -> dict:
    out = {}
    for i, (a, s) in enumerate(zip(args, specs)):
        la = flatten_with_paths(a)
        ls = spec_leaves(s)
        assert len(la) == len(ls)
        for (path, x), sp in zip(la, ls):
            out[(i,) + tuple(str(k) for k in path)] = (
                tuple(x.shape), str(x.dtype).replace("torch.", ""),
                tuple(sp))
    return out


def _device_bytes(leaves, sizes) -> int:
    """Per-device argument bytes: each leaf's dims divided along its spec
    (a split that does not divide rounds up, as JAX pads it)."""
    item = {"bfloat16": 2, "float32": 4, "int32": 4, "int8": 1}
    total = 0
    for shape, dtype, spec in leaves.values():
        n = 1
        for dim, entry in zip(shape, spec):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= -(-dim // math.prod(sizes[a] for a in axes))
        total += n * item[dtype]
    return total


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_build_combo_args_specs_and_bytes_equal_jax(arch, shape):
    jargs, jspec_fn = _jax_args(arch, shape)
    for axes in (SINGLE, MULTI):
        jm, tm = _meshes(*axes)
        combo = TSTEPS.build_combo(arch, shape, tm)
        assert all(leaf.device.type == "meta" for a in combo.args
                   for _, leaf in flatten_with_paths(a))
        want = _jax_leaves(jargs, jspec_fn(jm))
        got = _port_leaves(combo.args, combo.in_specs)
        assert sorted(got) == sorted(want), axes
        assert {k: g[:2] for k, g in got.items()} == \
            {k: w[:2] for k, w in want.items()}, axes
        assert {k: g[2] for k, g in got.items()} == \
            {k: w[2] for k, w in want.items()}, axes
        sizes = dict(axes)
        assert _device_bytes(got, sizes) == _device_bytes(want, sizes)
        # one placement per mesh dim for every leaf
        assert len(combo.in_shardings) == len(combo.args)


# ---------------------------------------------------------------------------
# local shard shapes against JAX's own build_combo on a (4, 4) mesh
# ---------------------------------------------------------------------------

_SHARD_SNIPPET = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import jax
from repro.launch.steps import build_combo as jax_build_combo
from repro.sharding import make_rules, use_rules
from repro_torch.launch import mesh as M
from repro_torch.launch.counting import CountingMode
from repro_torch.launch.steps import build_combo

OVER = dict(num_layers=2, d_model=256, d_ff=512, num_heads=4,
            num_kv_heads=4, head_dim=64, vocab_size=512)
M.init_fake_group(16)
from torch.distributed.device_mesh import init_device_mesh
tmesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
jmesh = jax.make_mesh((4, 4), ("data", "model"),
                      axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for shape in ("decode_32k", "train_4k"):
    jc = jax_build_combo("llama3.2-1b", shape, jmesh, cfg_overrides=OVER)
    rules = make_rules(jmesh, "train" if shape == "train_4k" else "serve")
    with jmesh, use_rules(rules):
        jax.jit(jc.fn, in_shardings=jc.in_shardings).lower(*jc.args)
    want = {}
    for i, (a, s) in enumerate(zip(jc.args, jc.in_shardings)):
        for (path, x), sh in zip(jax.tree_util.tree_flatten_with_path(a)[0],
                                 jax.tree_util.tree_leaves(s)):
            names = [str(getattr(k, "key", getattr(k, "name", getattr(
                k, "idx", k)))) for k in path]
            want[repr([i] + names)] = list(sh.shard_shape(x.shape))
    tc = build_combo("llama3.2-1b", shape, tmesh, cfg_overrides=OVER)
    got = {}
    with CountingMode().counting():
        for i, a in enumerate(tc.place()):
            from repro_torch.training.tree import flatten_with_paths
            for path, leaf in flatten_with_paths(a):
                got[repr([i] + [str(k) for k in path])] = list(
                    leaf.to_local().shape)
    out[shape] = {"want": want, "got": got}
print("SHARDS " + json.dumps(out))
"""


def test_shard_shapes_equal_jax_build_combo_on_a_4x4_mesh():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _SHARD_SNIPPET],
                       capture_output=True, text=True, timeout=240,
                       env=env, cwd=REPO)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("SHARDS ")]
    assert line, r.stderr[-3000:]
    out = json.loads(line[0][len("SHARDS "):])
    for shape, d in out.items():
        assert len(d["got"]) == len(d["want"]) > 0, shape
        assert d["got"] == d["want"], shape
