"""Served-workload descriptions: node graphs + request generation.

A workload is a template of *segments*; a request instantiates the template
with its sampled prompt / decode lengths into a linear node sequence
(paper §II-A: serialized node-wise execution; dynamic graphs unrolled).

Node ids are shared across unroll repetitions when weights are shared
(``cell`` nodes): RNN cells, transformer decode-cycle layers. The cost of a
node execution for one sample is

    flops(ctx)  = flops + flops_per_ctx · ctx
    bytes(ctx)  = act_bytes + bytes_per_ctx · ctx     (+ weight_bytes, batch-amortized)

where ctx is the sample's current context length (attention reads grow with
progress — the ragged-batch effect of lazily merged requests).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..configs.base import ModelConfig
from ..models import cost as C
from ..core.request import Request


# ---------------------------------------------------------------------------
# Length distributions (paper Fig. 11: WMT-2019 output-length characterization)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LengthDist:
    """Categorical distribution over integer lengths."""
    lengths: Tuple[int, ...]
    probs: Tuple[float, ...]

    def sample(self, rng: np.random.Generator) -> int:
        return int(rng.choice(self.lengths, p=self.probs))

    def quantile(self, q: float) -> int:
        acc = 0.0
        for l, p in zip(self.lengths, self.probs):
            acc += p
            if acc >= q:
                return l
        return self.lengths[-1]

    @property
    def mean(self) -> float:
        return float(np.dot(self.lengths, self.probs))


def wmt_like_length_dist(max_len: int = 80) -> LengthDist:
    """Synthetic mixture matched to the paper's Fig. 11 quantiles:
    ~70% of sentences <= 20 words, ~90% <= 30 words, tail to ``max_len``.
    """
    lengths = np.arange(1, max_len + 1)
    # lognormal-ish mass matched at the 70%/90% anchors (P[<=20]~0.74,
    # P[<=30]~0.90 — paper Fig. 11)
    mu, sigma = math.log(13.5), 0.62
    pdf = np.exp(-((np.log(lengths) - mu) ** 2) / (2 * sigma ** 2)) / lengths
    probs = pdf / pdf.sum()
    return LengthDist(tuple(int(l) for l in lengths), tuple(float(p) for p in probs))


def fixed_length(n: int) -> LengthDist:
    return LengthDist((n,), (1.0,))


# ---------------------------------------------------------------------------
# Node / workload descriptions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NodeDesc:
    node_id: str
    flops: float
    weight_bytes: float
    act_bytes: float
    flops_per_ctx: float = 0.0
    bytes_per_ctx: float = 0.0
    m_rows: int = 1          # systolic rows contributed per sample (MXU fill)
    cell: bool = False       # weight-shared across unroll steps
    # execution metadata for real-engine dispatch (set by from_model_config;
    # empty for the analytic paper workloads, which are never engine-served):
    phase: str = ""          # "emb" | "prefill" | "decode" | "head"
    layer: int = -1          # model layer index for prefill/decode nodes

    def sample_flops(self, ctx: int) -> float:
        return self.flops + self.flops_per_ctx * ctx

    def sample_bytes(self, ctx: int) -> float:
        return self.act_bytes + self.bytes_per_ctx * ctx


@dataclass(frozen=True)
class Segment:
    ids: Tuple[str, ...]
    repeat: str = "once"      # "once" | "prompt" | "decode"


@dataclass
class Workload:
    name: str
    nodes: Dict[str, NodeDesc]
    segments: List[Segment]
    prompt_dist: Optional[LengthDist] = None
    decode_dist: Optional[LengthDist] = None
    kind: str = "static"      # static | seq2seq | autoregressive

    # ------------------------------------------------------------------
    def sample_request(self, rng: np.random.Generator, arrival: float) -> Request:
        p = self.prompt_dist.sample(rng) if self.prompt_dist else 0
        d = self.decode_dist.sample(rng) if self.decode_dist else 0
        seq, prefix_len, cycle_len = self.build_sequence(p, d)
        req = Request(workload=self, arrival=arrival, sequence=seq)
        req.prompt_len = p
        req.decode_len = d
        req.prefix_len = prefix_len
        req.cycle_len = cycle_len
        return req

    def build_sequence(self, prompt_len: int, decode_len: int):
        seq: List[Tuple[str, int]] = []
        cycle_len = 0
        prefix_len = 0
        for seg in self.segments:
            if seg.repeat == "once":
                seq.extend((nid, prompt_len) for nid in seg.ids)
            elif seg.repeat == "prompt":
                for t in range(prompt_len):
                    seq.extend((nid, t + 1) for nid in seg.ids)
            elif seg.repeat == "decode":
                cycle_len = len(seg.ids)
                prefix_len = len(seq)
                for t in range(decode_len):
                    seq.extend((nid, prompt_len + t + 1) for nid in seg.ids)
            else:
                raise ValueError(seg.repeat)
        if cycle_len == 0:
            prefix_len = len(seq)
        return seq, prefix_len, cycle_len

    # ------------------------------------------------------------------
    def cycle_ids(self) -> Tuple[str, ...]:
        for seg in self.segments:
            if seg.repeat == "decode":
                return seg.ids
        return ()

    def cycle_end_id(self) -> Optional[str]:
        """Last node id of the decode cycle — the natural run-commit
        boundary for iteration-level scheduling (None for static graphs,
        which keep single-node commits)."""
        cyc = self.cycle_ids()
        return cyc[-1] if cyc else None

    def commit_boundaries(self) -> frozenset:
        """Segment-final node ids: the points where preemptive policies end
        a committed run so admission/preemption/merging are re-evaluated at
        least once per segment (prefill) and per decode cycle. Memoized —
        it is consulted on every scheduling decision."""
        b = getattr(self, "_commit_boundaries", None)
        if b is None:
            b = frozenset(seg.ids[-1] for seg in self.segments)
            self._commit_boundaries = b
        return b

    def predicted_remaining_nodes(self, req: Request, dec_timesteps: int):
        """Conservative remaining node iterator for the slack model
        (Algorithm 1): true remaining prefix + ``dec_timesteps``-capped decode
        cycles. The *actual* decode length is never consulted — only the
        profile-driven dec_timesteps overprovision (paper §IV-C).
        """
        cyc = self.cycle_ids()
        if not cyc:
            yield from req.sequence[req.idx:]
            return
        prefix_len, cycle_len = req.prefix_len, req.cycle_len
        prompt = getattr(req, "prompt_len", 0)
        if req.idx < prefix_len:
            yield from req.sequence[req.idx:prefix_len]
            done_cycles, in_cycle = 0, 0
        else:
            done_cycles, in_cycle = divmod(req.idx - prefix_len, cycle_len)
            # finish the current cycle
            for j in range(in_cycle, cycle_len):
                yield (cyc[j], prompt + done_cycles + 1)
            done_cycles += 1
        remaining = max(dec_timesteps - done_cycles, 1 if not req.done else 0)
        for t in range(remaining):
            for nid in cyc:
                yield (nid, prompt + done_cycles + t + 1)


# ---------------------------------------------------------------------------
# Paper workloads (Table II + §VI-C): ResNet, GNMT, Transformer, VGG,
# MobileNet, LAS, BERT
# ---------------------------------------------------------------------------

def _conv_node(nid, cin, cout, k, h, w, stride=1, dtype=2) -> NodeDesc:
    ho, wo = h // stride, w // stride
    flops = 2 * ho * wo * cout * cin * k * k
    weights = cin * cout * k * k * dtype
    act = (h * w * cin + ho * wo * cout) * dtype
    return NodeDesc(nid, flops, weights, act, m_rows=ho * wo)


def _fc_node(nid, cin, cout, dtype=2, cell=False) -> NodeDesc:
    return NodeDesc(nid, 2 * cin * cout, cin * cout * dtype,
                    (cin + cout) * dtype, m_rows=1, cell=cell)


def resnet50() -> Workload:
    nodes, order = {}, []

    def add(nd):
        nodes[nd.node_id] = nd
        order.append(nd.node_id)

    add(_conv_node("conv1", 3, 64, 7, 224, 224, stride=2))
    stages = [(64, 256, 3, 56), (256, 512, 4, 28), (512, 1024, 6, 14),
              (1024, 2048, 3, 7)]
    cin = 64
    for si, (mid_in, cout, blocks, hw) in enumerate(stages):
        mid = cout // 4
        for b in range(blocks):
            pre = f"s{si}b{b}"
            add(_conv_node(pre + "_c1", cin, mid, 1, hw, hw))
            add(_conv_node(pre + "_c2", mid, mid, 3, hw, hw))
            add(_conv_node(pre + "_c3", mid, cout, 1, hw, hw))
            cin = cout
    add(_fc_node("fc", 2048, 1000))
    return Workload("resnet", nodes, [Segment(tuple(order))], kind="static")


def vgg16() -> Workload:
    nodes, order = {}, []
    spec = [(3, 64, 224), (64, 64, 224), (64, 128, 112), (128, 128, 112),
            (128, 256, 56), (256, 256, 56), (256, 256, 56),
            (256, 512, 28), (512, 512, 28), (512, 512, 28),
            (512, 512, 14), (512, 512, 14), (512, 512, 14)]
    for i, (cin, cout, hw) in enumerate(spec):
        nd = _conv_node(f"conv{i}", cin, cout, 3, hw, hw)
        nodes[nd.node_id] = nd
        order.append(nd.node_id)
    for i, (cin, cout) in enumerate([(25088, 4096), (4096, 4096), (4096, 1000)]):
        nd = _fc_node(f"fc{i}", cin, cout)
        nodes[nd.node_id] = nd
        order.append(nd.node_id)
    return Workload("vggnet", nodes, [Segment(tuple(order))], kind="static")


def mobilenet_v1() -> Workload:
    nodes, order = {}, []

    def add(nd):
        nodes[nd.node_id] = nd
        order.append(nd.node_id)

    add(_conv_node("conv0", 3, 32, 3, 224, 224, stride=2))
    spec = [(32, 64, 112, 1), (64, 128, 112, 2), (128, 128, 56, 1),
            (128, 256, 56, 2), (256, 256, 28, 1), (256, 512, 28, 2)] + \
           [(512, 512, 14, 1)] * 5 + [(512, 1024, 14, 2), (1024, 1024, 7, 1)]
    for i, (cin, cout, hw, s) in enumerate(spec):
        ho = hw // s
        dw = NodeDesc(f"dw{i}", 2 * ho * ho * cin * 9, cin * 9 * 2,
                      (hw * hw + ho * ho) * cin * 2, m_rows=ho * ho)
        add(dw)
        add(_conv_node(f"pw{i}", cin, cout, 1, ho, ho))
    add(_fc_node("fc", 1024, 1000))
    return Workload("mobilenet", nodes, [Segment(tuple(order))], kind="static")


def _lstm_cell(nid, d, dtype=2) -> NodeDesc:
    # 4 gates, input + hidden matmuls
    flops = 2 * 4 * d * (2 * d)
    weights = 4 * d * 2 * d * dtype
    return NodeDesc(nid, flops, weights, 4 * d * dtype, m_rows=1, cell=True)


def gnmt(max_len: int = 80) -> Workload:
    """8-layer LSTM seq2seq with attention (GNMT [6]), d=1024.

    Encoder layers run time-unrolled with *stationary weights* (weights are
    loaded once per layer and all prompt timesteps stream through), so each
    encoder layer is ONE node whose cost scales with the prompt length.
    Decoder cells reload weights every output step (the output token feeds
    back through all layers) — one cell node per layer per step.
    """
    d, vocab = 1024, 32000
    cell_flops = 2 * 4 * d * 2 * d
    cell_weights = 4 * d * 2 * d * 2
    nodes: Dict[str, NodeDesc] = {}
    enc = []
    for i in range(8):
        nd = NodeDesc(f"enc{i}", 0.0, cell_weights, d * 2,
                      flops_per_ctx=cell_flops, bytes_per_ctx=4 * d * 2,
                      m_rows=16)
        nodes[nd.node_id] = nd
        enc.append(nd.node_id)
    dec = []
    for i in range(8):
        nd = _lstm_cell(f"dec{i}", d)
        nodes[nd.node_id] = nd
        dec.append(nd.node_id)
    att = NodeDesc("att", 0.0, d * d * 2, d * 2, flops_per_ctx=2 * 2 * d,
                   bytes_per_ctx=d * 2, cell=True)
    nodes["att"] = att
    head = _fc_node("head", d, vocab, cell=True)
    nodes["head"] = head
    emb = NodeDesc("emb", 0.0, d * 2, d * 2)
    nodes["emb"] = emb
    dist = wmt_like_length_dist(max_len)
    return Workload(
        "gnmt", nodes,
        [Segment(("emb",) + tuple(enc)),
         Segment(tuple(dec) + ("att", "head"), repeat="decode")],
        prompt_dist=dist, decode_dist=dist, kind="seq2seq")


def transformer(max_len: int = 80) -> Workload:
    """Transformer-base, 6 enc + 6 dec, d=512, ff=2048 (MLPerf)."""
    d, ff, vocab = 512, 2048, 32000
    nodes: Dict[str, NodeDesc] = {}
    enc_ids = []
    for i in range(6):
        # full-sequence encoder layer: costs scale with prompt ctx
        per_tok = 2 * d * (4 * d + 2 * ff)
        nd = NodeDesc(f"enc{i}", 0.0, (4 * d * d + 2 * d * ff) * 2,
                      d * 2, flops_per_ctx=per_tok, bytes_per_ctx=2 * d * 2,
                      m_rows=16)
        nodes[nd.node_id] = nd
        enc_ids.append(nd.node_id)
    dec_ids = []
    for i in range(6):
        per_step = 2 * d * (4 * d + 2 * d + 2 * ff)     # self + cross proj + ffn
        nd = NodeDesc(f"dec{i}", per_step, (6 * d * d + 2 * d * ff) * 2,
                      2 * d * 2, flops_per_ctx=2 * 2 * d,
                      bytes_per_ctx=2 * d * 2, cell=True)
        nodes[nd.node_id] = nd
        dec_ids.append(nd.node_id)
    head = _fc_node("head", d, vocab, cell=True)
    nodes["head"] = head
    emb = NodeDesc("emb", 0.0, d * 2, d * 2)
    nodes["emb"] = emb
    dist = wmt_like_length_dist(max_len)
    return Workload(
        "transformer", nodes,
        [Segment(("emb",) + tuple(enc_ids)),
         Segment(tuple(dec_ids) + ("head",), repeat="decode")],
        prompt_dist=dist, decode_dist=dist, kind="seq2seq")


def las() -> Workload:
    """Listen-Attend-and-Spell: 3-layer pyramidal BiLSTM encoder + 2-layer
    attention decoder (d=512)."""
    d = 512
    nodes: Dict[str, NodeDesc] = {}
    enc_ids = []
    for i in range(3):
        nd = NodeDesc(f"enc{i}", 0.0, 2 * 4 * d * 2 * d * 2, d * 2,
                      flops_per_ctx=2 * 2 * 4 * d * 2 * d / (2 ** i),
                      m_rows=8)
        nodes[nd.node_id] = nd
        enc_ids.append(nd.node_id)
    dec_ids = []
    for i in range(2):
        nd = _lstm_cell(f"dec{i}", d)
        nodes[nd.node_id] = nd
        dec_ids.append(nd.node_id)
    att = NodeDesc("att", 0.0, d * d * 2, d * 2, flops_per_ctx=2 * 2 * d,
                   bytes_per_ctx=d * 2, cell=True)
    nodes["att"] = att
    head = _fc_node("head", d, 10000, cell=True)
    nodes["head"] = head
    frames = LengthDist(tuple(range(100, 500, 50)), (0.125,) * 8)
    chars = LengthDist(tuple(range(10, 81, 10)), (0.125,) * 8)
    return Workload(
        "las", nodes,
        [Segment(tuple(enc_ids))] +
        [Segment(tuple(dec_ids) + ("att", "head"), repeat="decode")],
        prompt_dist=frames, decode_dist=chars, kind="seq2seq")


def bert_base(seq: int = 128) -> Workload:
    d, ff = 768, 3072
    nodes: Dict[str, NodeDesc] = {}
    ids = []
    for i in range(12):
        per_tok = 2 * d * (4 * d + 2 * ff) + 2 * 2 * d * seq
        nd = NodeDesc(f"enc{i}", per_tok * seq, (4 * d * d + 2 * d * ff) * 2,
                      seq * d * 2 * 2, m_rows=seq)
        nodes[nd.node_id] = nd
        ids.append(nd.node_id)
    head = _fc_node("head", d, 2)
    nodes["head"] = head
    return Workload("bert", nodes, [Segment(tuple(ids) + ("head",))],
                    kind="static")


# ---------------------------------------------------------------------------
# Assigned-architecture adapters: ModelConfig -> served Workload
# ---------------------------------------------------------------------------

def from_model_config(cfg: ModelConfig, *, prompt_dist: LengthDist = None,
                      decode_dist: LengthDist = None,
                      dtype_bytes: int = 2) -> Workload:
    """Expose one of the 10 assigned architectures as a servable workload
    (LazyBatching as a first-class feature across every arch family)."""
    prompt_dist = prompt_dist or fixed_length(128)
    decode_dist = decode_dist or wmt_like_length_dist(64)
    nodes: Dict[str, NodeDesc] = {}

    d = cfg.d_model
    emb = NodeDesc("emb", 0.0, d * dtype_bytes * 64, d * dtype_bytes,
                   phase="emb")
    nodes["emb"] = emb

    kinds = C._layer_kinds(cfg)
    prefill_ids, decode_ids = [], []
    typical_prompt = prompt_dist.quantile(0.5)
    for i, kind in enumerate(kinds):
        k = "dense" if kind == "attn" else kind
        win = cfg.hybrid.local_window if (cfg.hybrid and kind == "attn") else None
        # prefill node: whole prompt in one pass -> per-ctx coefficients
        c1 = C.block_cost(cfg, k, 1, 1, 1, window=win, dtype_bytes=dtype_bytes)
        c2 = C.block_cost(cfg, k, 1, 1, 2, window=win, dtype_bytes=dtype_bytes)
        dflops = c2.flops - c1.flops            # per-ctx growth at decode
        dbytes = c2.act_bytes - c1.act_bytes
        pid = f"P{i}"
        per_tok = C.block_cost(cfg, k, 1, typical_prompt, typical_prompt,
                               window=win, dtype_bytes=dtype_bytes)
        nodes[pid] = NodeDesc(
            pid, 0.0, per_tok.weight_bytes, d * dtype_bytes,
            flops_per_ctx=per_tok.flops / typical_prompt,
            bytes_per_ctx=per_tok.act_bytes / typical_prompt,
            m_rows=8, cell=True, phase="prefill", layer=i)
        prefill_ids.append(pid)
        did = f"D{i}"
        nodes[did] = NodeDesc(
            did, c1.flops - dflops, c1.weight_bytes,
            c1.act_bytes - dbytes, flops_per_ctx=dflops,
            bytes_per_ctx=dbytes, m_rows=1, cell=True,
            phase="decode", layer=i)
        decode_ids.append(did)
    head = NodeDesc("head", 2 * d * cfg.vocab_size,
                    d * cfg.vocab_size * dtype_bytes,
                    (d + cfg.vocab_size) * dtype_bytes, cell=True,
                    phase="head")
    nodes["head"] = head
    return Workload(
    # prefill executes once over the whole prompt (chunked internally)
        cfg.name, nodes,
        [Segment(("emb",) + tuple(prefill_ids)),
         Segment(tuple(decode_ids) + ("head",), repeat="decode")],
        prompt_dist=prompt_dist, decode_dist=decode_dist,
        kind="autoregressive")


PAPER_WORKLOADS = {
    "resnet": resnet50,
    "gnmt": gnmt,
    "transformer": transformer,
    "vggnet": vgg16,
    "mobilenet": mobilenet_v1,
    "las": las,
    "bert": bert_base,
}


def get_workload(name: str) -> Workload:
    if name in PAPER_WORKLOADS:
        return PAPER_WORKLOADS[name]()
    from ..configs import ARCHITECTURES
    if name in ARCHITECTURES:
        return from_model_config(ARCHITECTURES[name])
    raise KeyError(f"unknown workload {name!r}")
