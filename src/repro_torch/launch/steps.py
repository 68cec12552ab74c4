"""Per-(architecture × input-shape) step builders for the dry run: the
port of ``repro.launch.steps``.

``build_combo`` builds the model, derives the specs of every input
(``repro_torch.launch.mesh``) and returns the step of the requested
phase with its inputs as meta tensors:

  * ``train_4k``     -> ``train_step(state, batch)``          (AdamW update)
  * ``prefill_32k``  -> ``prefill_step(params, batch)``       (logits + cache)
  * ``decode_32k``   -> ``serve_step(params, cache, token, pos)`` (ONE token)
  * ``long_500k``    -> ``serve_step`` with the sliding-window cache
                        (attention archs) / constant state (SSM, hybrid)

``lower_combo`` is the dry run's entry: where the JAX package lowers the
step for XLA, it places fake inputs on the mesh as DTensors of their
specs' placements and runs the step once under the logical-axis rules
and :class:`repro_torch.launch.counting.CountingMode`, which records what
the step would do on rank 0's local shards. No parameter or cache is ever
allocated.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..configs import get_config, get_shape
from ..configs.base import InputShape, ModelConfig
from ..data.pipeline import make_batch_specs
from ..models.model import Model, RuntimeFlags
from ..sharding import make_rules, mesh_context, use_rules
from ..training import (AdamWState, OptimizerConfig, TrainState, init_state,
                        make_train_step)
from ..training.tree import map_tree
from . import mesh as M

# the JAX RuntimeFlags fields with no counterpart in the port (see
# repro_torch.models.model.RuntimeFlags): XLA's scan settings, the
# decode forms the port's one decode path replaces, the attention chunk
NO_COUNTERPART = ("use_scan", "scan_unroll", "grouped_decode",
                  "pallas_decode", "attn_chunk")


def input_specs(arch: str, shape_name: str = "train_4k") -> dict:
    """Meta-tensor stand-ins for every model input of one phase."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    return make_batch_specs(cfg, shape)


def flag_kwargs(cfg: ModelConfig, shape: InputShape, *,
                overrides: Optional[dict] = None) -> dict:
    """The JAX ``make_flags`` keyword arguments, before the fields with no
    counterpart are dropped."""
    kw = dict(use_scan=True)
    if shape.kind == "train":
        kw["remat"] = True
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        # sub-quadratic long-context variant: ring-buffer sliding window
        kw["window"] = cfg.long_context_window
    if cfg.moe is not None and shape.kind == "decode":
        kw["moe_group_rows"] = max(1, shape.global_batch // 32)
    if overrides:
        kw.update(overrides)
    return kw


def make_flags(cfg: ModelConfig, shape: InputShape, *,
               overrides: Optional[dict] = None) -> RuntimeFlags:
    """The JAX ``make_flags`` on the port's ``RuntimeFlags``: the fields
    in ``NO_COUNTERPART`` are dropped, overrides of them included."""
    kw = flag_kwargs(cfg, shape, overrides=overrides)
    return RuntimeFlags(**{k: v for k, v in kw.items()
                           if k not in NO_COUNTERPART})


def serve_fsdp(cfg: ModelConfig, model_n: int, *,
               budget_bytes: float = 8e9) -> bool:
    """Weight-gather (ZeRO-inference) serving only when pure tensor
    parallelism cannot fit the parameters (grok-1-314b)."""
    return cfg.param_count() * 2 / model_n > budget_bytes


@dataclass
class Combo:
    """Everything needed to trace one (arch × shape × mesh) combination:
    ``args`` as meta-tensor trees, ``in_specs`` their spec trees and
    ``in_shardings`` their DTensor placements per leaf (JAX's
    ``NamedSharding`` trees). A train step's state is the
    :func:`repro_torch.launch.mesh.state_tree` layout."""
    cfg: ModelConfig
    shape: InputShape
    mesh: object               # a DeviceMesh
    model: Model
    fn: object                 # the step callable
    args: tuple                # meta-tensor trees
    in_specs: tuple
    in_shardings: tuple
    spec_fn: object = None     # trees like args -> their spec trees

    def place(self, args=None, *, device=None) -> tuple:
        """``args`` (trees like ``self.args``, of any batch and length:
        their specs are derived from their own shapes, by the rules that
        gave ``in_specs``; by default empty tensors of ``self.args``'
        shapes on ``device``, the mesh's device type unless given — fake
        ones under a ``FakeTensorMode``) as DTensors on the mesh; a train
        state's parameters require grad."""
        if args is None:
            dev = device or self.mesh.device_type
            args = tuple(map_tree(lambda t: torch.empty(
                t.shape, dtype=t.dtype, device=dev), a) for a in self.args)
            specs = self.in_specs
        else:
            specs = self.spec_fn(args)
        out = []
        for i, (a, spec) in enumerate(zip(args, specs)):
            if i == 0 and self.shape.kind == "train":
                placed = M.distribute(a, spec, self.mesh)
                placed["params"] = M.distribute(a["params"], spec["params"],
                                                self.mesh, requires_grad=True)
                out.append(placed)
            else:
                out.append(M.distribute(a, spec, self.mesh))
        return tuple(out)


def _train_fn(model: Model, opt_cfg: OptimizerConfig):
    step = make_train_step(model, opt_cfg)

    def train_step(state: dict, batch: dict):
        opt = state["opt"]
        new, metrics = step(TrainState(state["params"], AdamWState(
            opt["step"], opt["mu"], opt["nu"])), batch)
        return M.state_tree(new), metrics

    return train_step


def build_combo(arch: str, shape_name: str, mesh, *,
                flag_overrides: Optional[dict] = None,
                fsdp_override: Optional[bool] = None,
                rules_overrides: Optional[dict] = None,
                cfg_overrides: Optional[dict] = None,
                cache_prefer: str = "trailing",
                param_prefer: Optional[dict] = None,
                batch: Optional[int] = None) -> Combo:
    """``rules_overrides`` is taken by :func:`lower_combo`; accepted here
    as by the JAX ``build_combo``. ``batch`` (the port's own) replaces the
    shape's global batch: a step that does not fit one card at the
    registered batch runs there at a cut one."""
    del rules_overrides
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = get_shape(shape_name)
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    flags = make_flags(cfg, shape, overrides=flag_overrides)
    model = Model(cfg, flags)
    model_n = M.mesh_sizes(mesh).get("model", 1)
    batch = make_batch_specs(cfg, shape, dtype=flags.dtype)

    def combo(fn, args, spec_fn):
        specs = spec_fn(args)
        return Combo(cfg, shape, mesh, model, fn, args, specs,
                     tuple(M.named(mesh, s) for s in specs), spec_fn)

    if shape.kind == "train":
        state = M.state_tree(init_state(model, device="meta"))
        return combo(_train_fn(model, OptimizerConfig()), (state, batch),
                     lambda a: (M.param_pspecs(a[0], mesh=mesh, fsdp=True,
                                               prefer=param_prefer),
                                M.batch_pspecs(a[1], mesh=mesh)))

    fsdp = serve_fsdp(cfg, model_n) if fsdp_override is None else fsdp_override
    params = model.init(device="meta")

    def params_spec(p):
        return M.param_pspecs(p, mesh=mesh, fsdp=fsdp, prefer=param_prefer)

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad(), mesh_context(batch["tokens"]):
                return model.prefill(params, batch["tokens"],
                                     prefix=batch.get("prefix"))

        return combo(prefill_step, (params, batch),
                     lambda a: (params_spec(a[0]),
                                M.batch_pspecs(a[1], mesh=mesh)))

    # decode: ONE new token against a seq_len-deep cache
    B = shape.global_batch
    cache = model.init_cache(B, shape.seq_len, device="meta")

    def serve_step(params, cache, token, pos):
        with torch.no_grad(), mesh_context(token):
            return model.decode_step(params, cache, token, pos)

    def decode_specs(a):
        tok = M.batch_pspecs({"t": a[2]}, mesh=mesh)["t"]
        return (params_spec(a[0]),
                M.cache_pspecs(a[1], mesh=mesh, prefer=cache_prefer),
                tok, tok)

    tok = torch.empty((B,), dtype=torch.int32, device="meta")
    return combo(serve_step, (params, cache, tok, tok), decode_specs)


def lower_combo(arch: str, shape_name: str, mesh, *,
                donate_cache: bool = False, **kw):
    """Trace one combination on ``mesh`` (a mesh over a fake process
    group: this rank's shards are what is counted). Returns (record,
    combo); the record holds ``cost`` ({"flops", "bytes accessed"}),
    ``memory`` ({"argument_size_in_bytes", "output_size_in_bytes"}),
    ``collectives`` (one record per collective, for
    ``repro_torch.launch.collectives``), ``kernels`` (shape-only calls
    per kernel, with their flops and bytes) and ``trace_s``.

    ``donate_cache`` changes nothing: the port's decode writes the cache
    in place, which is what donating it buys XLA (no copy of the cache
    into a fresh output buffer). It is accepted as the JAX ``lower_combo``
    accepts it."""
    from .counting import CountingMode, local_bytes
    del donate_cache
    combo = build_combo(arch, shape_name, mesh, **kw)
    rules = make_rules(mesh, "train" if combo.shape.kind == "train"
                       else "serve")
    rk = kw.get("rules_overrides")
    if rk:
        rules.mapping.update(rk)
    mode = CountingMode()
    with mode.counting():
        args = combo.place()
        mode.reset()
        # wall-clock is the measured quantity here: the trace's own time
        t0 = time.perf_counter()
        with use_rules(rules):
            out = combo.fn(*args)
        trace_s = time.perf_counter() - t0
        record = {
            "cost": {"flops": mode.flops, "bytes accessed": mode.bytes},
            "memory": {"argument_size_in_bytes": local_bytes(args),
                       "output_size_in_bytes": local_bytes(out)},
            "collectives": mode.collectives,
            "kernels": mode.kernels,
            "trace_s": trace_s,
        }
    return record, combo


__all__ = ["Combo", "NO_COUNTERPART", "build_combo", "flag_kwargs",
           "input_specs", "lower_combo", "make_flags", "serve_fsdp"]
