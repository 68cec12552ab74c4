"""End-to-end driver of the PyTorch port: LazyBatching serving a REAL model.

The port's counterpart of ``examples/serve_real_model.py``. Builds the
model through ``repro_torch.launch.serve``'s engine helper, serves a Poisson
request trace ONLINE through ``ServingSession`` + LazyBatching +
``TorchEngine``, and verifies the results instead of assuming them:

  * every request's *streamed* tokens must equal the engine's batched
    ``execute_run`` results, and
  * both must equal an isolated (batch of 1, node by node) generation of
    the same prompt through the same engine. A difference is allowed only
    at a near-tie, where the reference's top-2 logits lie within 1e-3 of
    each other; near-ties are printed, any other difference exits 1.

It runs on the card at full width in float32 with TF32 off, so batched
and isolated products round alike; ``--device cpu --reduced`` serves the
reduced model on the CPU.

  python examples/serve_real_model_torch.py [--arch llama3.2-1b] [--n 8]
  PYTHONPATH=src python examples/serve_real_model_torch.py \\
      --device cpu --reduced --n 4
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.policies import LazyBatching  # noqa: E402
from repro_torch.core.request import SubBatch  # noqa: E402
from repro_torch.core.slack import SlackPredictor  # noqa: E402
from repro_torch.launch.serve import _torch_engine  # noqa: E402
from repro_torch.serving import (H100_SXM, HandleState,  # noqa: E402
                                 NPUPerfModel, ServingSession)

NEAR_TIE = 1e-3          # top-2 logit gap under which a split is allowed


def _isolated(engine, wl, prompt, n_tokens):
    """Generate alone through the same engine (batch of 1, node by node):
    the ground truth lazy batching must reproduce."""
    req = wl.sample_request(np.random.default_rng(123), 0.0)
    seq, prefix_len, cycle_len = wl.build_sequence(len(prompt), n_tokens)
    req.sequence, req.prefix_len, req.cycle_len = seq, prefix_len, cycle_len
    req.prompt_len, req.decode_len = len(prompt), n_tokens
    engine.register(req, prompt)
    sb = SubBatch([req])
    while not req.done:
        engine.execute("m", sb, req.next_node_id)
        sb.advance(0.0)
    return engine.states[req.rid].generated[:n_tokens]


def _top2_gap(engine, tokens) -> float:
    with torch.no_grad():
        logits, _ = engine.model.prefill(
            engine.params, torch.tensor([tokens], device=engine.device))
    top2 = torch.topk(logits[0].float(), 2).values
    return float(top2[0] - top2[1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--n", type=int, default=8, help="number of requests")
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--sla", type=float, default=60.0,
                    help="SLA target in seconds")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced model (max_len 64, short prompts)")
    args = ap.parse_args()
    args.dtype = "float32"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    engine, wl = _torch_engine(args.arch, args)
    cfg = engine.cfg
    rng = np.random.default_rng(args.seed)
    predictor = SlackPredictor.build([wl], NPUPerfModel(H100_SXM), args.sla)
    policy = LazyBatching(predictor, max_batch=args.max_batch)
    session = ServingSession(policy, engine, seed=args.seed)

    streamed = {}                       # rid -> tokens seen via on_token

    def on_token(handle, token):
        streamed.setdefault(handle.request.rid, []).append(token)

    handles, prompts = [], {}
    t = 0.0
    for _ in range(args.n):
        t += rng.exponential(1.0 / args.rate)
        r = wl.sample_request(rng, t)
        prompt = rng.integers(2, cfg.vocab_size, size=r.prompt_len)
        prompts[r.rid] = prompt
        handles.append(session.submit(r, prompt_tokens=prompt,
                                      on_token=on_token))
    session.duration = t

    width = "reduced" if args.reduced else "full-width"
    print(f"serving {args.n} requests on {width} {args.arch} "
          f"({cfg.param_count() / 1e6:.1f}M params, float32, "
          f"{engine.device}), max_batch={args.max_batch} ...")
    stats = session.drain()
    s = stats.summary()
    print(f"completed {s['completed']}/{args.n}  "
          f"avg latency {s['avg_latency_ms']:.0f}ms  "
          f"nodes executed {engine.nodes_executed}  "
          f"runs {engine.runs_executed}  "
          f"preemptions {policy.n_preemptions}")
    if s["completed"] != args.n or not all(
            h.state is HandleState.DONE for h in handles):
        print("not every request finished")
        return 1

    print("verifying streamed tokens against batch results and an "
          "isolated (unbatched) reference ...")
    n_equal, n_ties, n_bad = 0, 0, 0
    for h in handles:
        r = h.request
        got = engine.states[r.rid].generated[:r.decode_len]
        if not streamed.get(r.rid, [])[:r.decode_len] == got == \
                h.tokens[:r.decode_len]:
            print(f"  rid={r.rid}: streamed tokens diverge from batch "
                  f"execute_run")
            n_bad += 1
            continue
        ref = _isolated(engine, wl, prompts[r.rid], r.decode_len)
        if got == ref:
            n_equal += 1
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
        gap = _top2_gap(engine, [int(x) for x in prompts[r.rid]] + ref[:j])
        if gap < NEAR_TIE:
            n_ties += 1
            print(f"  rid={r.rid}: near-tie at token {j} (top-2 gap "
                  f"{gap:.3e}); batched {got[j]} vs isolated {ref[j]}")
        else:
            n_bad += 1
            print(f"  rid={r.rid}: batched {got} != isolated {ref} "
                  f"(token {j}, top-2 gap {gap:.3e})")
    print(f"{n_equal}/{args.n} generations equal the unbatched reference "
          f"token for token, {n_ties} near-ties, {n_bad} differences")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
