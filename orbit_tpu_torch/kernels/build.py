"""Build and load the port's CUDA kernels (``orbit_tpu_torch/csrc/*.cu``).

On first use the sources are compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, under
``build/orbit_tpu_torch_kernels/<hash of the sources>/`` at the repository
root, and loaded with ``ctypes``. A later process with the same sources
loads the library it finds there. There is no fallback: without ``nvcc``
the build raises.

Every C entry returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that code is not 0, so a launch the device
refused (too much shared memory, a bad grid) never passes silently.
:data:`LAUNCHES` counts, per kernel, the launches its wrapper made.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "orbit_tpu_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches made by its wrapper (plain integers; reset with
# reset_launch_counts before a run whose launches are to be counted)
LAUNCHES = {"fused_qkv_attention": 0, "fused_mlp_block": 0,
            "fused_qkv_attention_bwd": 0, "fused_mlp_block_bwd": 0,
            "mahalanobis_logits": 0, "fused_dw_act": 0,
            "tiny_attention": 0, "tiny_attention_bwd": 0}

# rows per partial sum of the backward kernels' column sums off the wgmma
# route (kSumRows in csrc/common.cuh): ceil(rows / COLSUM_ROWS) x N floats
COLSUM_ROWS = 256

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, w, b, out, B, S, D, H, stream
    "orbit_fused_qkv_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the same with the wgmma route's sequences per row tile before the stream
    "orbit_fused_qkv_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, ln_g, ln_b, w1, b1, w2, b2, out, rows, D, hidden, eps, stream
    "orbit_fused_mlp_block_f32": [_P] * 8 + [_I, _I, _I, _F, _P],
    # the same with the wgmma route's workspaces xn and h after out
    "orbit_fused_mlp_block_bf16": [_P] * 10 + [_I, _I, _I, _F, _P],
    # x, w, b, g, qkv, dqkv, partial, dx, dw, db, B, S, D, H, stream
    "orbit_fused_qkv_attention_bwd_f32": [_P] * 10 + [_I] * 4 + [_P],
    "orbit_fused_qkv_attention_bwd_bf16": [_P] * 10 + [_I] * 4 + [_P],
    # x, g, ln_g, ln_b, w1, b1, w2, stats, xn, hg, hid, dxn, partial, dx,
    # dln_g, dln_b, dw1, db1, dw2, db2, rows, D, hidden, eps, stream
    "orbit_fused_mlp_block_bwd_f32": [_P] * 20 + [_I, _I, _I, _F, _P],
    "orbit_fused_mlp_block_bwd_bf16": [_P] * 20 + [_I, _I, _I, _F, _P],
    # qkv, out, B, S, D, H, stream
    "orbit_tiny_attention_f32": [_P, _P, _I, _I, _I, _I, _P],
    # the same with the plan's sequences a tile, stage rows and blocks before
    # the stream
    "orbit_tiny_attention_bf16": [_P, _P] + [_I] * 7 + [_P],
    # qkv, g, dqkv, B, S, D, H, stream
    "orbit_tiny_attention_bwd_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    # the same with the plan's blocks before the stream
    "orbit_tiny_attention_bwd_bf16": [_P, _P, _P] + [_I] * 5 + [_P],
    # f, mu, P, class_mask, partial, out, M, D, C, splits, scale, stream
    "orbit_mahalanobis_logits": [_P] * 6 + [_I, _I, _I, _I, _F, _P],
    # x, taps, a1, b1, a2, b2, out, N, H, W, C, K, pad_top, pad_left, act1,
    # act2, stream
    "orbit_fused_dw_f32": [_P] * 7 + [_I] * 9 + [_P],
    "orbit_fused_dw_bf16": [_P] * 7 + [_I] * 9 + [_P],
    # a, b, c, M, N, K, a_mn, b_k, bn, stream: the mainloop's layout check
    "orbit_wgmma_check": [_P] * 3 + [_I] * 6 + [_P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's nvcc run, if it ran one


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for path in cu + cuh:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the orbit_tpu_torch "
                       "kernels are built from source on first use")


def library_path() -> Path:
    return BUILD_ROOT / _digest() / "liborbit_tpu_torch_kernels.so"


def build() -> Path:
    """Compile the kernels if this exact source set has not been built;
    return the library's path. The compiler's output (``-Xptxas -v``:
    registers, shared memory, spills per kernel) is kept in ``nvcc.log``
    beside it."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    nvcc = _find_nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f".{os.getpid()}.tmp"
    cu, _ = _sources()
    objs = [so.with_name(f"{src.stem}{tag}.o") for src in cu]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(cu, objs)]
    tmp = so.with_name(f".{so.name}{tag}")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(cmd, out) for cmd, out, p in zip(cmds, outs, procs) if p.returncode]
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        cmds.append(link)
        outs.append(proc.stdout)
        if proc.returncode:
            failed.append((link, proc.stdout))
    build_seconds = time.perf_counter() - t0
    (so.parent / "nvcc.log").write_text("".join(
        " ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outs)))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        cmd, out = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out[-6000:]}")
    os.replace(tmp, so)  # atomic: a concurrent build never loads a torn file
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.orbit_cuda_error_string.argtypes = [ctypes.c_int]
            lib.orbit_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def aligned(t, nbytes: int = 32):
    """``t`` contiguous with a data pointer on an ``nbytes`` boundary (the
    tensor-core fragment loads read 32-byte aligned rows); copies a view
    that starts elsewhere."""
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def check(code: int, kernel: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if code:
        msg = library().orbit_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} at launch: {msg}")


def mainloop_product(a, b, *, a_mn: bool, b_k: bool, bn: int):
    """C = A . B (f32) on the wgmma mainloop alone (``csrc/wgmma_check.cu``),
    for checking one operand layout and tile width against ``torch.matmul``:
    ``a`` is A (M, K), or A^T (K, M) if ``a_mn``; ``b`` is B (K, N), or B^T
    (N, K) if ``b_k``; both bf16 on one card, bn 128 or 192. No op calls it
    and it counts no launch."""
    import torch
    if (a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or a.dim() != 2
            or b.dim() != 2 or a.device.type != "cuda" or b.device != a.device):
        raise ValueError("mainloop_product takes two 2-D bf16 tensors on one CUDA device")
    a, b = aligned(a), aligned(b)
    m, k = (a.shape[1], a.shape[0]) if a_mn else a.shape
    n = b.shape[0] if b_k else b.shape[1]
    c = torch.empty((m, n), device=a.device, dtype=torch.float32)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = library().orbit_wgmma_check(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                                           int(a_mn), int(b_k), bn, stream)
    check(code, "wgmma_check")
    return c

