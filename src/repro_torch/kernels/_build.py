"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded through ``ctypes`` — no PyTorch
headers, so a build takes seconds. The sources compile in parallel (one
``nvcc`` each), then link. The library is built at first use into
``kernels/build/`` (listed in ``.gitignore``), under a name that hashes the
sources and flags, so an edited source is never served by a stale build.

A missing ``nvcc``, a failed build or a non-zero ``cudaGetLastError()``
after a launch raises; nothing here falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# a, w, c, flip, out, <ints>, stream — every pointer and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints and cut them
_MATMUL_ARGS = [_P] * 5 + [_I] * 4 + [_P]
_CONV_ARGS = [_P] * 5 + [_I] * 13 + [_P]
# a, wa, ca, fa, wb, cb, fb, out, <ints>, stream
_PAIR_ARGS = [_P] * 8 + [_I] * 15 + [_P]
# a, w, scale, out, M, N, Kw, a_bf16, stream
_BW_ARGS = [_P] * 4 + [_I] * 4 + [_P]
# q, k, v, out, B, Hq, Hkv, S, hd, causal, bf16, scale (float32), stream
_FLASH_ARGS = [_P] * 4 + [_I] * 7 + [ctypes.c_float, _P]
# q, k, v, out, B, Hq, Hkv, S, hd, hd_v, causal, scale (float32), the
# (batch, head, row) element strides of q, k, v and out (int64), stream
_FLASH_TC_ARGS = ([_P] * 4 + [_I] * 7 + [ctypes.c_float]
                  + [ctypes.c_longlong] * 12 + [_P])
SIGNATURES = {
    "xnor_matmul_vpu": _MATMUL_ARGS,
    "xnor_matmul_mxu": _MATMUL_ARGS,
    "xnor_conv2d_vpu": _CONV_ARGS,
    "xnor_conv2d_mxu": _CONV_ARGS,
    "xnor_conv2d_pair_vpu": _PAIR_ARGS,
    "xnor_conv2d_pair_mxu": _PAIR_ARGS,
    "binary_weight_matmul": _BW_ARGS,
    "flash_attention": _FLASH_ARGS,
    "flash_attention_tc": _FLASH_TC_ARGS,
}
# measurement entry points that no path calls: the rate probe (form,
# blocks, iters, sink, stream; csrc/mma_probe.cu) and the K7 "simt" plan
# query (hd, bf16, int[6]; csrc/flash_attention.cu)
PROBES = {"mma_rate_probe": [_I] * 3 + [_P] * 2,
          "flash_attention_simt_plan": [_I, _I, _P]}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME
    (default /usr/local/cuda). Raises when there is none."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{_digest()}.so"


def build() -> Path:
    """Compile and link the library unless this exact build exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{_digest()}_{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        cmd = [nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== nvcc {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    log_text = "\n".join(log)
    (BUILD_DIR / f"build_{_digest()}.log").write_text(log_text)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log_text}")
    tmp = BUILD_DIR / f"lib_{tag}.so.tmp"
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in jobs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode:
        raise RuntimeError(f"linking {lib.name} failed:\n{link.stdout}")
    os.replace(tmp, lib)            # atomic: a concurrent loader sees all
    for _, obj, _ in jobs:
        obj.unlink()
    return lib


def build_log() -> str:
    """nvcc's output for the current build (``-Xptxas -v``: registers,
    shared memory and spills of every kernel), or "" before a build."""
    path = BUILD_DIR / f"build_{_digest()}.log"
    return path.read_text() if path.exists() else ""


_LOAD_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature.
    Thread-safe: replica threads whose first launches come together wait
    for one build instead of running two."""
    with _LOAD_LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in (SIGNATURES | PROBES).items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call the C launcher ``name``; raise if the launch was refused."""
    lib = load()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {rc} ({msg})")
