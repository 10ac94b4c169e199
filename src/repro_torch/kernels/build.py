"""Build and bind the hand-written CUDA kernels (``kernels/csrc``).

The sources are compiled at first use, on the machine with the card, by
``nvcc`` for ``sm_90a``: one ``nvcc -c`` per source, all started together,
then one link into a shared library with a plain C interface that ctypes
loads.  The library lands in ``kernels/_build/<hash of the sources>/``
(listed in ``.gitignore``), so a changed source builds anew and an
unchanged one is reused within a checkout.  Nothing is built on import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.kernels import tiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("quoka_score.cu", "flash_attention.cu", "selected_attention.cu",
           "selected_attention_paged.cu")
HEADERS = ("attn_tile.cuh", "attn_mma.cuh", "ptx.cuh")
LIB_NAME = "libquoka_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *tiling.NVCC_DEFINES)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# n_split, part_o, part_ml (tiling.split_args), then the stream
_SPLIT = [_I, _P, _P, _P]
# argument types of each extern "C" launcher, in source order
SIGNATURES = {
    "quoka_score_launch": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I]
                          + [_L] * 9 + [_I] * 4 + [_P],
    "flash_attention_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I] + [_L] * 14 + [_I, _I, _F] + _SPLIT,
    "selected_attention_launch": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _I, _I, _I, _I, _I] + [_L] * 14
                                 + [_F] + _SPLIT,
    "selected_attention_paged_launch": [_I, _I] + [_P] * 8 + [_I] * 9
                                       + [_L] * 14 + [_F] + _SPLIT,
}

_lib = None
last_build_seconds = 0.0
last_build_log = ""


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + \
            ["/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card (CUDA toolkit needed)")
    return found


def build() -> Path:
    """Compile the sources (if this hash is not built yet) and return the
    library path.  Sets ``last_build_seconds`` and ``last_build_log``."""
    global last_build_seconds, last_build_log
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        last_build_seconds = 0.0
        return lib_path
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src}\n{out}")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp_lib] + [o for _, o, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"link failed:\n{link.stdout}")
        staged = Path(tmp) / "out"
        staged.mkdir()
        os.replace(tmp_lib, staged / LIB_NAME)
        (staged / "build.log").write_text("\n".join(logs))
        try:
            os.replace(staged, out_dir)     # atomic publish
        except OSError:
            if not lib_path.exists():       # another process published it
                raise
    last_build_seconds = time.perf_counter() - t0
    last_build_log = (out_dir / "build.log").read_text()
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise when a launcher reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
