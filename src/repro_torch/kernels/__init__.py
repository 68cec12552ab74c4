"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper counts the kernels it launches in a plain integer attribute
(``fused_rmsnorm.launches`` ...): a run can show that its main path went
through the kernels and not through their plain versions.

``flash_attention``, ``fused_rmsnorm`` and ``ssd_chunked`` take gradients:
with grad mode on and an input that requires grad they go through a
``torch.autograd.Function`` (``FlashAttention``, ``FusedRMSNorm``,
``SSDChunked``) whose forward is the same launch and whose backward is
PyTorch ops. ``ragged_decode_attention`` raises there instead.

On fake or meta inputs (a dry run's trace) each wrapper takes a
shape-only path instead (``_shape.py``): empty outputs of the right
shapes, the kernel's flops and bytes handed to the trace, no launch.
"""
from .flash_attn import FlashAttention, flash_attention, flash_attention_plain
from .ragged_decode_attn import (decode_route, ragged_decode_attention,
                                 ragged_decode_attention_plain,
                                 ragged_decode_n8_plain,
                                 ragged_decode_n8_tf32_plain,
                                 ragged_decode_tc_plain)
from .rmsnorm import FusedRMSNorm, fused_rmsnorm, fused_rmsnorm_plain
from .ssd_chunk import (SSDChunked, ssd_chunk_intra_plain, ssd_chunked,
                        ssd_chunked_plain, ssd_chunked_recurrent_plain,
                        ssd_chunked_tiled_plain, ssd_route)

# the wrappers the serving paths launch
KERNELS = (ragged_decode_attention, fused_rmsnorm, flash_attention,
           ssd_chunked)


def launch_counts() -> dict:
    """Launches per wrapper, of ragged decode's three tensor-core routes,
    and of the SSD scan's tensor-core, split-TF32, recurrent and
    tensor-core scan routes."""
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    counts["ragged_decode_attention_tc"] = ragged_decode_attention.tc_launches
    counts["ragged_decode_attention_n8"] = ragged_decode_attention.n8_launches
    counts["ragged_decode_attention_n8_tf32"] = (
        ragged_decode_attention.n8_tf32_launches)
    counts["ssd_chunked_tc"] = ssd_chunked.tc_launches
    counts["ssd_chunked_tf32"] = ssd_chunked.tf32_launches
    counts["ssd_chunked_recurrent"] = ssd_chunked.recurrent_launches
    counts["ssd_chunked_tc_scan"] = ssd_chunked.tc_scan_launches
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    ragged_decode_attention.tc_launches = 0
    ragged_decode_attention.n8_launches = 0
    ragged_decode_attention.n8_tf32_launches = 0
    ssd_chunked.tc_launches = 0
    ssd_chunked.tf32_launches = 0
    ssd_chunked.recurrent_launches = 0
    ssd_chunked.tc_scan_launches = 0


__all__ = [
    "FlashAttention", "FusedRMSNorm", "SSDChunked",
    "flash_attention", "flash_attention_plain", "decode_route",
    "ragged_decode_attention", "ragged_decode_attention_plain",
    "ragged_decode_n8_plain", "ragged_decode_n8_tf32_plain",
    "ragged_decode_tc_plain", "fused_rmsnorm", "fused_rmsnorm_plain",
    "ssd_chunk_intra_plain", "ssd_chunked", "ssd_chunked_plain",
    "ssd_chunked_recurrent_plain", "ssd_chunked_tiled_plain", "ssd_route",
    "KERNELS", "launch_counts", "reset_launch_counts",
]
