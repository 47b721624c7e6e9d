"""Build the package's CUDA kernels with nvcc and load them with ctypes.

The sources under ``convtasnet_tpu_torch/csrc/`` compile into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds): one ``nvcc -c`` per ``.cu`` file, all started together, then one
``nvcc -shared`` link. The library lands in ``convtasnet_tpu_torch/_build/``
under a name keyed on a hash of the sources, so an edited source rebuilds at
first use and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL_P = ctypes.POINTER(ctypes.c_longlong)
# ctn_tcn_block_{f32,bf16}: 21 pointers, 9 ints, the stream (see tcn_block.cu)
_BLOCK_ARGTYPES = [_P] * 21 + [_I] * 9 + [_P]
# ctn_tcn_block_bwd[_cln]_{f32,bf16}: 17 pointers, 8 ints, the stream
# (see tcn_block_bwd.cu)
_BWD_ARGTYPES = [_P] * 17 + [_I] * 8 + [_P]
# ctn_tcn_block_pair_{f32,bf16}: 22 pointers, 10 ints, the stream
# (see tcn_block_pair.cu)
_PAIR_ARGTYPES = [_P] * 22 + [_I] * 10 + [_P]
# ctn_tcn_block_pair_bwd_{f32,bf16}: 29 pointers, 9 ints, the stream
# (see tcn_block_pair_bwd.cu)
_PAIR_BWD_ARGTYPES = [_P] * 29 + [_I] * 9 + [_P]
# ctn_tcn_block_tp2_{f32,bf16}: 12 pointers (the last the workspace of the
# f32 route and of the bf16 wide route), 7 ints, the stream (see
# tcn_block_tp.cu)
_TP2_ARGTYPES = [_P] * 12 + [_I] * 7 + [_P]
# ctn_dpt_{inter,intra}_{f32,bf16}: 9 pointers, 8 ints, the heads' real
# width, the workspace of the route above a head width of 128, the stream
# (dpt_common.cuh)
_ATTN_ARGTYPES = [_P] * 9 + [_I] * 9 + [_P, _P]
# ctn_dpt_ffn_{f32,bf16}: 9 pointers (the last the workspace), 5 ints, the
# stream (dpt_ffn.cu)
_FFN_ARGTYPES = [_P] * 9 + [_I] * 5 + [_P]
# ctn_dpt_{inter,intra}_bwd_{f32,bf16}: 13 pointers, 8 ints, the heads'
# real width, the wide route's workspace, the stream (dpt_bwd_common.cuh)
_ATTN_BWD_ARGTYPES = [_P] * 13 + [_I] * 9 + [_P, _P]
# ctn_dpt_ffn_bwd_{f32,bf16}: 15 pointers, 5 ints, the stream (dpt_ffn_bwd.cu)
_FFN_BWD_ARGTYPES = [_P] * 15 + [_I] * 5 + [_P]


def _sources() -> list:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc "
                       "from the CUDA toolkit (on PATH or /usr/local/cuda)")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libconvtasnet_kernels_{digest.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the sources if their library is missing; returns the seconds
    the compile took (0.0 when the library was already built)."""
    lib = library_path()
    if lib.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, _, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
    objs = [str(obj) for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build never loads half
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, with argtypes set."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    signatures = {
        "ctn_tcn_block_f32": _BLOCK_ARGTYPES,
        "ctn_tcn_block_bf16": _BLOCK_ARGTYPES,
        "ctn_tcn_block_partials": [_I, _I, _I, _LL_P, _LL_P],
        "ctn_tcn_block_stores_y": [_I, _I, _I],
        "ctn_tcn_block_bwd_f32": _BWD_ARGTYPES,
        "ctn_tcn_block_bwd_bf16": _BWD_ARGTYPES,
        "ctn_tcn_block_bwd_cln_f32": _BWD_ARGTYPES,
        "ctn_tcn_block_bwd_cln_bf16": _BWD_ARGTYPES,
        "ctn_tcn_block_bwd_workspace": [_I] * 7 + [_LL_P, _LL_P],
        "ctn_tcn_block_pair_f32": _PAIR_ARGTYPES,
        "ctn_tcn_block_pair_bf16": _PAIR_ARGTYPES,
        "ctn_tcn_block_pair_workspace": [_I] * 6 + [_LL_P, _LL_P],
        "ctn_tcn_block_pair_bwd_f32": _PAIR_BWD_ARGTYPES,
        "ctn_tcn_block_pair_bwd_bf16": _PAIR_BWD_ARGTYPES,
        "ctn_tcn_block_pair_bwd_workspace": [_I] * 6 + [_LL_P, _LL_P],
        "ctn_tcn_block_tp2_workspace": [_I] * 5 + [_LL_P, _LL_P],
        "ctn_tcn_block_tp2_f32": _TP2_ARGTYPES,
        "ctn_tcn_block_tp2_bf16": _TP2_ARGTYPES,
        "ctn_dpt_inter_f32": _ATTN_ARGTYPES,
        "ctn_dpt_inter_bf16": _ATTN_ARGTYPES,
        "ctn_dpt_intra_f32": _ATTN_ARGTYPES,
        "ctn_dpt_intra_bf16": _ATTN_ARGTYPES,
        "ctn_dpt_ffn_f32": _FFN_ARGTYPES,
        "ctn_dpt_ffn_bf16": _FFN_ARGTYPES,
        "ctn_dpt_ffn_workspace": [_I] * 3 + [_LL_P],
        "ctn_dpt_inter_bwd_f32": _ATTN_BWD_ARGTYPES,
        "ctn_dpt_inter_bwd_bf16": _ATTN_BWD_ARGTYPES,
        "ctn_dpt_intra_bwd_f32": _ATTN_BWD_ARGTYPES,
        "ctn_dpt_intra_bwd_bf16": _ATTN_BWD_ARGTYPES,
        "ctn_dpt_attn_bwd_workspace": [_I] * 7 + [_LL_P, _LL_P],
        "ctn_dpt_intra_workspace": [_I] * 6 + [_LL_P],
        "ctn_dpt_attn_wide_workspace": [_I] * 7 + [_LL_P],
        "ctn_dpt_intra_bwd_spill": [_I] * 6 + [_LL_P],
        "ctn_dpt_ffn_bwd_f32": _FFN_BWD_ARGTYPES,
        "ctn_dpt_ffn_bwd_bf16": _FFN_BWD_ARGTYPES,
        "ctn_dpt_ffn_bwd_workspace": [_I] * 4 + [_LL_P, _LL_P],
        "ctn_wg_matmul_check": [_P] * 3 + [_I] * 5 + [_P],
        "ctn_wg_wgrad_check": [_P] * 2 + [_I] * 4 + [_P] * 2,
        "ctn_tf32_matmul_check": [_P] * 4 + [_I] * 3 + [_P],
        "ctn_tf32_wgrad_check": [_P] * 2 + [_I] * 4 + [_P] * 2,
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ctn_tcn_block_weights.argtypes = [_I, _I, _I]
    lib.ctn_tcn_block_weights.restype = ctypes.c_longlong
    lib.ctn_error_string.argtypes = [_I]
    lib.ctn_error_string.restype = ctypes.c_char_p
    return lib
