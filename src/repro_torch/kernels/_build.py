"""Build the port's CUDA sources into shared libraries and bind them.

Each ``csrc/<name>.cu`` compiles, with ``nvcc`` for ``sm_90a``, into its
own ``build/repro_torch/lib<name>.so`` under the repository root, at first
use, and again whenever a source (or a shared ``.cuh`` header) is newer
than its library. The libraries export plain C functions that take raw
device pointers, sizes, a dtype code and the CUDA stream; they are loaded
with ``ctypes``. Nothing here includes PyTorch's C++ headers, so a build
takes seconds, not minutes.

``build_all()`` starts one ``nvcc`` per stale source, all at once, and
waits for every one of them.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the exported launchers, per source: {symbol: argtypes};
# a C pointer is c_void_p, an int c_int, a float c_float
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "ragged_decode_attn": {
        # q, k, v, lengths, slots, out, part_acc, part_ml, counters, B, H,
        # KV, D, N, T, n_split, split_t, dtype, stream
        "repro_ragged_decode_attention": [_VP] * 9 + [_I] * 9 + [_VP],
        # bf16 at 8 < G <= 16 on the tensor cores: q, k, v, lengths, slots,
        # out, B, H, KV, D, N, T, span, n_split, split_t, cluster, stream
        "repro_ragged_decode_tc": [_VP] * 6 + [_I] * 10 + [_VP],
        # D, info (five ints out)
        "repro_ragged_decode_tc_info": [_I, _VP],
        # bf16 at G <= 8 on the tensor cores, D 64 or 128: the arguments
        # of repro_ragged_decode_tc
        "repro_ragged_decode_n8": [_VP] * 6 + [_I] * 10 + [_VP],
        "repro_ragged_decode_n8_info": [_I, _VP],
        # float32 at G <= 8 as split TF32, D 64 or 128: the same arguments
        "repro_ragged_decode_n8_tf32": [_VP] * 6 + [_I] * 10 + [_VP],
        "repro_ragged_decode_n8_tf32_info": [_I, _VP]},
    "flash_attn": {
        # q, k, v, o, B, S, T, H, KV, width, Dqk, Dv, q_offset, window,
        # scale, dtype, stream
        "repro_flash_attention": [_VP] * 4 + [_I] * 10 + [_F, _I, _VP],
        # B, S, T, H, KV, width, Dqk, Dv, info (five ints out)
        "repro_flash_tc_info": [_I] * 8 + [_VP],
        # bf16 at width 256 in a forced layout: q, k, v, o, B, S, T, H, KV,
        # width, Dqk, Dv, q_offset, window, scale, heads, info, stream
        "repro_flash_attention_heads": [_VP] * 4 + [_I] * 10
                                       + [_F, _I, _VP, _VP]},
    "ssd_chunk": {
        # one entry per route. CUDA and tensor cores: x, dt, A, B, C, y,
        # states, cum_exp, decay, final, B, S, nh, hd, N, chunk, then dtype
        # (CUDA cores) or heads per CTA (tensor cores), stream
        "repro_ssd_chunk": [_VP] * 10 + [_I] * 7 + [_VP],
        "repro_ssd_chunk_tc": [_VP] * 10 + [_I] * 7 + [_VP],
        # split TF32: x, dt, A, B, C, scores, y, states, cum_exp, decay,
        # final, B, S, nh, hd, N, chunk, heads per CTA, stream
        "repro_ssd_chunk_tf32": [_VP] * 11 + [_I] * 7 + [_VP],
        # x, dt, A, B, C, scores, y, final, B, S, nh, hd, N, chunk, dtype,
        # stream
        "repro_ssd_chunk_recurrent": [_VP] * 8 + [_I] * 7 + [_VP],
        # x, dt, A, B, C, y, final, B, S, nh, hd, N, chunk, stream
        "repro_ssd_chunk_tc_scan": [_VP] * 7 + [_I] * 6 + [_VP],
        # N, info (four ints out)
        "repro_ssd_tc_scan_info": [_I, _VP]},
    "rmsnorm": {
        # x, scale, y, rows, D, stride, flags (16-byte slots, x and scale
        # dtypes), eps, device, stream
        "repro_rmsnorm": [_VP] * 3 + [_I] * 4 + [_F, _I, _VP]},
}

_LOADED: Dict[str, object] = {}


def sources() -> Sequence[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's "
            "CUDA kernels are built from source at first use")
    return str(path)


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return max(p.stat().st_mtime for p in deps) > lib.stat().st_mtime


def build_all(names: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every stale source (or ``names``) in parallel; returns
    ``{name: compiler log}`` for the ones built. Raises on a failure."""
    todo = [n for n in (names or sources()) if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".so.{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def function(name: str, symbol: str):
    """The bound C launcher ``symbol`` of ``csrc/<name>.cu``, building the
    source first when its library is missing or stale."""
    fn = _LOADED.get(symbol)
    if fn is None:
        argtypes = SIGNATURES[name][symbol]
        if _stale(name):
            build_all([name])
        # PyDLL keeps the GIL across the call: a launcher only enqueues
        # work and returns, so releasing and retaking the GIL around it
        # would cost more than it frees
        fn = getattr(ctypes.PyDLL(str(library_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[symbol] = fn
    return fn


def dtype_code(dtype) -> int:
    """0 for float32, 1 for bfloat16 (the csrc/common.cuh DType codes)."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return codes[dtype]

