"""The port's sharding layer against the JAX package's, on the CPU.

* ``make_rules``: the same mapping for the axis sets (data,), (data,
  model), (pod, data, model) and (model,), serve and train.
* ``param_pspecs`` leaf by leaf on every architecture's train state at
  full width (parameters and both AdamW moments): JAX's from
  ``jax.eval_shape``, the port's from ``Model.init(device="meta")``, at
  (data 16, model 16) with fsdp on and off and at (pod 2, data 16, model
  16); the ``param_pspec`` cases of ``tests/test_launch.py``.
* ``cache_pspecs`` in both ``prefer`` modes on every architecture's
  ``init_cache`` at ``decode_32k``'s batch and length; ``batch_pspecs``
  and ``make_batch_specs`` for the four registered shapes.
* ``shard`` raises on a rank mismatch and is the identity without rules.
* Train steps on gloo meshes of separate processes
  (``tools/mesh_step.py``'s ranks, a ``FileStore`` under ``tmp_path``,
  a 60 s group timeout and a 150 s limit on every rank's wait): reduced llama
  replicated on (data 2); on (data 2, model 2) with the state split by
  ``param_pspecs(fsdp=True)``, reduced llama at one K/V head (the query
  heads split over ``model``, the K/V heads sliced to each rank's group),
  reduced llama under sequence parallelism (``act_seq`` over ``model``:
  the products of sequence-split activations on local shards) and
  reduced granite MoE. From JAX weights (``params_from_jax``), the
  loss equals the port's single-process loss and JAX's ``make_train_step``
  loss to rtol 1e-5, every leaf's whole gradient the single process's to
  ``||dg|| / ||g|| <= 1e-5``, the whole updated parameters to 1e-5; every
  rank holds its leaves at their global shape divided along their spec.
* Serve steps (``launch.steps``' prefill_step and serve_step) on the same
  (data 2, model 2) gloo mesh, all in one run of four processes: reduced
  llama, mamba2, minicpm3, granite and recurrentgemma, prefill and decode
  under both cache specs, llama's decode over a ring (``window``) and over
  an int8 cache, from JAX weights and seeded small inputs; the logits and
  every updated cache leaf equal the port's single process and JAX's
  ``combo.fn`` on a 1-device mesh (rtol 1e-5).
"""
import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import sharding as JS  # noqa: E402
from repro.configs import ARCHITECTURES  # noqa: E402
from repro.configs import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import make_batch_specs as jax_batch_specs  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro.models import Model as JaxModel, RuntimeFlags as JaxFlags  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
from repro.training.optimizer import OptimizerConfig as JaxOpt  # noqa: E402
from repro_torch import sharding as TS  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.data import make_batch_specs  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models import Model, RuntimeFlags, params_from_jax  # noqa: E402
from repro_torch.training import TrainState, init_adamw  # noqa: E402
from repro_torch.training.tree import flatten_with_paths  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import mesh_step  # noqa: E402


def _meshes(*axes):
    """(JAX stand-in, port stand-in) of a mesh of ``axes`` ((name, size),
    ...): what the spec functions read of a ``Mesh`` / ``DeviceMesh``."""
    names = tuple(n for n, _ in axes)
    sizes = tuple(s for _, s in axes)
    return (types.SimpleNamespace(axis_names=names,
                                  devices=np.empty(sizes, np.int8)),
            types.SimpleNamespace(mesh_dim_names=names, shape=sizes))


SINGLE = (("data", 16), ("model", 16))
MULTI = (("pod", 2), ("data", 16), ("model", 16))


def _jax_specs(tree) -> dict:
    """{path keys: spec tuple} of a JAX spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "name", getattr(
        k, "idx", k)))) for k in path): tuple(spec) for path, spec in flat}


def _port_specs(tree, spec_tree) -> dict:
    """{path keys: spec} of the port's spec tree over ``tree``."""
    return {tuple(str(k) for k in path): spec for (path, _), spec in zip(
        flatten_with_paths(tree), TM.spec_leaves(spec_tree))}


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["serve", "train"])
@pytest.mark.parametrize("axes", [("data",), ("data", "model"),
                                  ("pod", "data", "model"), ("model",)])
def test_make_rules_maps_like_jax(axes, kind):
    jm, tm = _meshes(*[(a, 2) for a in axes])
    assert TS.make_rules(tm, kind).mapping == \
        JS.make_rules(jm, kind).mapping
    assert TS.SERVE_RULES == JS.SERVE_RULES
    assert TS.TRAIN_RULES == JS.TRAIN_RULES


def test_placements_put_pod_before_data():
    from torch.distributed.tensor import Replicate, Shard
    _, tm = _meshes(*MULTI)
    rules = TS.make_rules(tm, "train")
    assert rules.spec(("batch", "seq", "heads", None)) == (
        ("pod", "data"), None, "model", None)
    assert rules.placements(("batch", "seq", "heads", None)) == (
        Shard(0), Shard(0), Shard(2))
    assert rules.placements(("embed",)) == (Replicate(),) * 3


def test_shard_is_the_identity_without_rules_and_checks_rank():
    x = torch.zeros(2, 3)
    assert TS.current_rules() is None
    assert TS.shard(x, "batch") is x            # no rules: no check
    _, tm = _meshes(("data", 2))
    with TS.use_rules(TS.make_rules(tm, "train")):
        with pytest.raises(ValueError, match="rank mismatch"):
            TS.shard(x, "batch")
        assert TS.shard(x, "batch", "embed") is x   # a plain tensor
    assert TS.current_rules() is None


# ---------------------------------------------------------------------------
# parameter, cache and batch specs
# ---------------------------------------------------------------------------

# the cases of tests/test_launch.py: (path, shape, fsdp, what JAX asserts)
PARAM_CASES = {
    "embed": (["embed", "tok"], (152064, 5120), True,
              lambda s: s == ("model", "data")),
    "wq_fallback": (["blocks", "attn", "wq"], (64, 5120, 40, 128), True,
                    lambda s: s[0] is None and "model" in s),
    "w_gate": (["blocks", "mlp", "w_gate"], (16, 2048, 8192), True,
               lambda s: s[2] == "model"),
    "w_down": (["blocks", "mlp", "w_down"], (16, 8192, 2048), True,
               lambda s: s[1] == "model"),
    "step": (["opt", "step"], (), True, lambda s: s == ()),
    "A_log": (["blocks", "ssm", "A_log"], (64, 80), True,
              lambda s: s == (None, "model")),
    "indivisible": (["blocks", "x"], (64, 7, 9), True,
                    lambda s: s == (None, None, None)),
    "no_fsdp": (["blocks", "mlp", "w_gate"], (16, 2048, 8192), False,
                lambda s: "data" not in s),
}


class _K:
    def __init__(self, key):
        self.key = key


@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_param_pspec_cases_of_the_jax_tests(case):
    keys, shape, fsdp, want = PARAM_CASES[case]
    kw = dict(model_n=16, data_n=16, fsdp=fsdp, pod=False)
    got = TM.param_pspec(keys, shape, **kw)
    assert got == tuple(JM.param_pspec([_K(k) for k in keys], shape, **kw))
    assert want(got)


def _port_state_tree(model):
    params = model.init(device="meta")
    return TM.state_tree(TrainState(params, init_adamw(params)))


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_param_pspecs_match_jax_on_every_train_state(arch):
    jmodel = JaxModel(jax_get_config(arch), JaxFlags(dtype=jnp.bfloat16))
    jstate = jax.eval_shape(lambda: JT.init_state(jmodel,
                                                  jax.random.key(0)))
    tree = _port_state_tree(Model(get_config(arch),
                                  RuntimeFlags(dtype=torch.bfloat16)))
    for axes, fsdp in ((SINGLE, True), (SINGLE, False), (MULTI, True)):
        jm, tm = _meshes(*axes)
        want = _jax_specs(JM.param_pspecs(jstate, mesh=jm, fsdp=fsdp))
        got = _port_specs(tree, TM.param_pspecs(tree, mesh=tm, fsdp=fsdp))
        assert got == want, (axes, fsdp)
    # both moments and the step are in the tree
    assert any(k[:2] == ("opt", "mu") for k in got)
    assert any(k[:2] == ("opt", "nu") for k in got)


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_cache_pspecs_match_jax_at_decode_32k(arch):
    shape = INPUT_SHAPES["decode_32k"]
    B, T = shape.global_batch, shape.seq_len
    jmodel = JaxModel(jax_get_config(arch), JaxFlags(dtype=jnp.bfloat16))
    jcache = jax.eval_shape(lambda: jmodel.init_cache(B, T))
    cache = Model(get_config(arch),
                  RuntimeFlags(dtype=torch.bfloat16)).init_cache(
        B, T, device="meta")
    jl = jax.tree_util.tree_flatten_with_path(jcache)[0]
    tl = flatten_with_paths(cache)
    assert [tuple(leaf.shape) for _, leaf in tl] == \
        [tuple(leaf.shape) for _, leaf in jl]
    for axes in (SINGLE, MULTI):
        jm, tm = _meshes(*axes)
        for prefer in ("trailing", "kv"):
            want = _jax_specs(JM.cache_pspecs(jcache, mesh=jm,
                                              prefer=prefer))
            got = _port_specs(cache, TM.cache_pspecs(cache, mesh=tm,
                                                     prefer=prefer))
            assert got == want, (axes, prefer)


_DTYPES = {jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.mark.parametrize("shape_name", sorted(INPUT_SHAPES))
def test_batch_specs_match_jax(shape_name):
    assert dataclasses.astuple(INPUT_SHAPES[shape_name]) == \
        dataclasses.astuple(JAX_SHAPES[shape_name])
    for arch in sorted(ARCHITECTURES):
        jspecs = jax_batch_specs(jax_get_config(arch), JAX_SHAPES[shape_name])
        specs = make_batch_specs(get_config(arch), INPUT_SHAPES[shape_name])
        assert list(specs) == list(jspecs), arch
        for k, v in specs.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == jspecs[k].shape, (arch, k)
            assert v.dtype == _DTYPES[jnp.dtype(jspecs[k].dtype)], (arch, k)
        for axes in (SINGLE, MULTI, (("data", 3),), (("model", 4),)):
            jm, tm = _meshes(*axes)
            want = {k: tuple(s) for k, s in
                    JM.batch_pspecs(jspecs, mesh=jm).items()}
            assert TM.batch_pspecs(specs, mesh=tm) == want, (arch, axes)


def test_named_gives_one_placement_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    _, tm = _meshes(*MULTI)
    got = TM.named(tm, {"a": (("pod", "data"), None, "model"),
                        "b": [(None,), ()]})
    assert got == {"a": (Shard(0), Shard(0), Shard(2)),
                   "b": [(Replicate(),) * 3, (Replicate(),) * 3]}


# ---------------------------------------------------------------------------
# train steps on gloo meshes
# ---------------------------------------------------------------------------

def _pair(arch, **kw):
    return tuple(dataclasses.replace(get(arch).reduced(), **kw)
                 for get in (jax_get_config, get_config))


MESH_CASES = {
    "dp_llama": ("llama3.2-1b", {}, (("data", 2),), False),
    "tp_llama_kv1": ("llama3.2-1b", dict(num_kv_heads=1),
                     (("data", 2), ("model", 2)), True),
    "tp_granite_moe": ("granite-moe-3b-a800m", {},
                       (("data", 2), ("model", 2)), True),
    # sequence parallelism (the hillclimb's act_seq rule): the matrix
    # products of sequence-split activations run on local shards
    "sp_llama": ("llama3.2-1b", {}, (("data", 2), ("model", 2)), True,
                 {"act_seq": "model"}),
}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_train_step_equals_one_process_and_jax(case, tmp_path):
    arch, kw, axes, fsdp, *rules = MESH_CASES[case]
    jcfg, tcfg = _pair(arch, **kw)
    jm = JaxModel(jcfg, JaxFlags(dtype=jnp.float32))
    jstate = JT.init_state(jm, jax.random.key(0))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(2, jcfg.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    _, jmet = jax.jit(JT.make_train_step(jm, JaxOpt()))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                             device="cpu")

    outs = mesh_step.run_ranks(dict(cfg=tcfg, mesh=list(axes), fsdp=fsdp,
                                    params=params, batch=batch,
                                    rules=rules[0] if rules else {}),
                               int(np.prod([s for _, s in axes])), tmp_path)
    loss, grads, new = mesh_step.one_process(tcfg, params, batch)

    out = outs[0]
    np.testing.assert_allclose(out["loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(out["step_loss"], loss, rtol=1e-5)
    np.testing.assert_allclose(out["loss"], float(jmet["loss"]), rtol=1e-5)
    for key, g in grads.items():
        rel = float((out["grads"][key] - g).norm() / g.norm())
        assert rel <= 1e-5, f"{key}: {rel:.2e}"
    for key, v in new.items():
        np.testing.assert_allclose(out["params"][key].numpy(), v.numpy(),
                                   rtol=0, atol=1e-5, err_msg=key)

    sizes = dict(axes)
    split = set()
    for o in outs:
        for key, (shape, local, spec) in o["local"].items():
            assert local == mesh_step.local_shape(shape, spec, sizes), key
            split.update(a for e in spec for a in TS.axis_names(e)
                         if a in sizes)
    assert split == ({"data", "model"} if fsdp else set())
    if case == "tp_llama_kv1":      # q heads split, the one K/V head not
        assert outs[0]["local"]["['blocks']['attn']['wq']"][2][2] == "model"
        assert "model" not in (outs[0]["local"]
                               ["['blocks']['attn']['wk']"][2][2] or ())


# ---------------------------------------------------------------------------
# serve steps (launch.steps' prefill_step and serve_step) on gloo meshes
# ---------------------------------------------------------------------------

SERVE_CASES = {c[0]: c for c in mesh_step.serve_cases()}


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    """Every serve case once on the (data 2, model 2) mesh of four gloo
    processes, from JAX's seed-0 weights of each reduced family."""
    archs = mesh_step.SERVE_FAMILIES
    pairs = {a: _pair(a) for a in archs}
    jparams = {a: JaxModel(pairs[a][0], JaxFlags(dtype=jnp.float32)).init(
        jax.random.key(0)) for a in archs}
    params = {a: params_from_jax(jax.tree.map(np.asarray, jparams[a]),
                                 device="cpu") for a in archs}
    cfgs = {a: pairs[a][1] for a in archs}
    inputs = {n: mesh_step.serve_inputs(cfgs[c[1]], c[2], c[3])
              for n, c in SERVE_CASES.items()}
    outs = mesh_step.run_serve(list(SERVE_CASES.values()), cfgs, params,
                               inputs, tmp_path_factory.mktemp("serve"))
    return dict(pairs=pairs, jparams=jparams, params=params, inputs=inputs,
                outs=outs)


def _jax_serve(case, jcfg, jparams, inputs):
    """JAX's ``combo.fn`` of the case on a 1-device mesh: {"logits",
    "cache" by path}."""
    from repro.launch.steps import build_combo as jax_build_combo
    _, arch, shape, flags, prefer = case
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    combo = jax_build_combo(
        arch, shape, mesh,
        cfg_overrides={f.name: getattr(jcfg, f.name)
                       for f in dataclasses.fields(jcfg)},
        flag_overrides=dict(flags, dtype=jnp.float32), cache_prefer=prefer)
    args = jax.tree.map(jnp.asarray, inputs)
    with mesh, JS.use_rules(JS.make_rules(mesh, "serve")):
        logits, cache = combo.fn(jparams, *args)
    return {"logits": np.asarray(logits),
            "cache": {"".join(f"[{k!r}]" for k in p): np.asarray(v)
                      for p, v in flatten_with_paths(
                          jax.tree.map(np.asarray, cache))}}


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max()) or 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(SERVE_CASES))
def test_mesh_serve_step_equals_one_process_and_jax(name, serve_run):
    """The logits and every updated cache leaf of a prefill or decode step
    on (data 2, model 2) equal the port's step in one process and JAX's
    ``build_combo`` step on a 1-device mesh (rtol 1e-5, atol 1e-5 of the
    leaf's largest entry); every placed input leaf is split as its spec.
    An int8 cache's new row may hold an entry a level apart from JAX's
    (at most 8; the logits then to 1e-2, as tests/test_torch_variants.py
    holds int8 decode)."""
    case = SERVE_CASES[name]
    arch = case[1]
    jcfg, tcfg = serve_run["pairs"][arch]
    inputs = serve_run["inputs"][name]
    one = mesh_step.serve_step(
        mesh_step.serve_combo(case, tcfg, mesh_step.standin_mesh()),
        serve_run["params"][arch], inputs)
    ref = _jax_serve(case, jcfg, serve_run["jparams"][arch], inputs)
    got = serve_run["outs"][0][name]
    _close(got["logits"], one["logits"], f"{name} logits vs one process")
    assert sorted(got["cache"]) == sorted(ref["cache"]), name
    apart = 0
    for key, r in ref["cache"].items():
        _close(got["cache"][key], one["cache"][key], f"{name} {key}")
        if r.dtype == np.int8:
            # the new row's levels: a product rounded apart in XLA and
            # PyTorch may round one entry to the next level (as in
            # tests/test_torch_variants.py)
            d = np.abs(got["cache"][key].numpy().astype(np.int32) - r)
            assert d.max() <= 1, f"{name} {key}: {d.max()} levels apart"
            apart += int(d.sum())
        else:
            _close(got["cache"][key], r, f"{name} {key} vs JAX")
    assert apart <= 8, f"{name}: {apart} int8 entries a level apart"
    if apart:
        np.testing.assert_allclose(got["logits"], ref["logits"], rtol=1e-2,
                                   atol=1e-2, err_msg=f"{name} vs JAX")
    else:
        _close(got["logits"], ref["logits"], f"{name} logits vs JAX")
    sizes = dict(mesh_step.MESH)
    for o in serve_run["outs"]:
        for key, (shape, local, spec) in o[name]["local"].items():
            assert local == mesh_step.local_shape(shape, spec, sizes), key
