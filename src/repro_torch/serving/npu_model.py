"""Analytical NPU latency model (paper Table I + §V).

The paper uses a cycle-level simulator of a TPU-like systolic NPU
(128x128 @ 700 MHz, 360 GB/s, fixed-latency memory). The LazyBatching
scheduler only ever consumes *per-node latencies* — the paper itself reduces
them to a profiled lookup table — so we model each node execution as a
roofline term:

    latency = overhead + max(compute, memory)
    compute = sum_i flops_i(ctx_i) / (peak_flops · util · eff)
    memory  = (weight_bytes + sum_i bytes_i(ctx_i)) / mem_bw

where the compute term carries a systolic *fill penalty*
``(1 + fill_rows / (m_rows · batch))``: a weight-stationary array streams
``m_rows · batch`` activation rows per weight tile, and each tile costs an
extra ~fill_rows cycles of pipeline fill, so low-row nodes (FC layers,
decode steps) underutilise the MXU. Batching raises the row count AND
amortizes weight traffic — together these produce the paper's Fig. 3
throughput/latency tradeoff curve.

Two hardware profiles: the paper's NPU (Table I) for figure reproduction,
and TPU v5e for the roofline work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from .workload import NodeDesc, Workload


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # FLOP/s
    mem_bw: float              # bytes/s
    array_rows: int = 128
    fill_rows: int = 32        # per-tile pipeline fill cost (rows)
    sys_eff: float = 0.65      # sustained systolic efficiency
    node_overhead: float = 8e-6  # scheduling/dispatch overhead per node (s)


PAPER_NPU = HardwareSpec(
    name="paper-npu",
    peak_flops=2 * 128 * 128 * 700e6,     # 22.9 TFLOP/s (Table I)
    mem_bw=360e9,
)

TPU_V5E = HardwareSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    mem_bw=819e9,
    node_overhead=2e-6,
)

# NVIDIA H100 SXM (NVIDIA H100 Tensor Core GPU data sheet): 989 TFLOP/s
# dense bf16, 3.35 TB/s HBM3. The card the PyTorch port serves on; the
# slack predictor of a TorchEngine session is built on it. sys_eff,
# fill_rows and node_overhead keep the class defaults: they are not
# measured on this card.
H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops=989e12,
    mem_bw=3.35e12,
)


class NPUPerfModel:
    def __init__(self, hw: HardwareSpec = PAPER_NPU):
        self.hw = hw

    def node_latency(self, node: NodeDesc, ctxs: Sequence[int]) -> float:
        """Latency of executing ``node`` for a (merged) batch whose samples
        have context lengths ``ctxs``."""
        hw = self.hw
        flops = sum(node.sample_flops(c) for c in ctxs)
        act = sum(node.sample_bytes(c) for c in ctxs)
        m_eff = max(1, node.m_rows * len(ctxs))
        fill = 1.0 + hw.fill_rows / m_eff
        compute = flops * fill / (hw.peak_flops * hw.sys_eff) if flops else 0.0
        memory = (node.weight_bytes + act) / hw.mem_bw
        return hw.node_overhead + max(compute, memory)

    # ------------------------------------------------------------------
    def profile_table(self, wl: Workload, *, typical_ctx: Optional[int] = None
                      ) -> Dict[str, float]:
        """Single-batch per-node latency lookup table — the paper's one-time
        offline profiling pass (``NodeLatency(n)``, §IV-C). Conservative:
        decode nodes are profiled at the dec_timesteps-level context."""
        table = {}
        if typical_ctx is None:
            p = wl.prompt_dist.quantile(0.9) if wl.prompt_dist else 1
            d = wl.decode_dist.quantile(0.9) if wl.decode_dist else 0
            typical_ctx = max(1, p + d)
        for nid, node in wl.nodes.items():
            table[nid] = self.node_latency(node, [typical_ctx])
        return table

    def single_input_exec_time(self, wl: Workload, prompt_len: int,
                               decode_len: int) -> float:
        """Exact single-batch end-to-end time (Table II validation)."""
        seq, _, _ = wl.build_sequence(prompt_len, decode_len)
        return sum(self.node_latency(wl.nodes[nid], [ctx]) for nid, ctx in seq)
