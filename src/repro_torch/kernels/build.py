"""Build the CUDA sources under ``repro_torch/csrc`` and load them with ctypes.

Each ``*.cu`` file is compiled by its own ``nvcc`` into a shared library
with a plain C interface (all started together, so the build takes as long
as the slowest file), for ``sm_90a``.  The libraries go to
``build/repro_torch/<hash>/`` at the root of the checkout, on first use;
the hash covers every source, header and flag, so an edited source builds
afresh.  A missing ``nvcc`` or a failed build raises: there is no fallback.

Every C entry point takes pointers and the stream as ``void*``, ints as
``int``, element counts as ``int64_t`` and scalars as ``float``, and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises when
that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["CSRC", "NVCC_FLAGS", "build_dir", "build_all", "library",
           "check", "build_log"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
#: C signature of every entry point, by library.
SIGNATURES = {
    "edge_aggregate": {
        # a, x, w, out, n, f, t, bn, bk, fc, dtype, stream
        "fused_aggregate_combine": [_VOID] * 4 + [_INT] * 7 + [_VOID],
        # n, f, bn, bk, fc
        "fused_ranks": [_INT] * 5,
        # n, f, t, bn, bk, fc, dtype
        "fused_active_clusters": [_INT] * 7,
    },
    "edge_aggregate_unfused": {
        # a, x, y, n, f, bn, bk, fc, dtype, stream
        "aggregate_pass": [_VOID] * 3 + [_INT] * 6 + [_VOID],
        # n, f, bn, bk, fc
        "aggregate_ranks": [_INT] * 5,
        # n, f, bn, bk, fc, dtype
        "aggregate_active_clusters": [_INT] * 6,
        # y, w, out, n, f, t, bn, fc, dtype, stream
        "combine_pass": [_VOID] * 3 + [_INT] * 6 + [_VOID],
        # n, f, t, bn, fc
        "combine_ranks": [_INT] * 5,
        # n, f, t, bn, fc, dtype
        "combine_active_clusters": [_INT] * 6,
    },
    "segment_reduce": {
        # u_snd, u_rcv, new_src, mult, halo, cut, n, k, magic, n_tiles,
        # idx_bytes, div_shift, route, pack_shift, stream
        "schedule_counts": [_VOID] * 6 + [_I64] * 3 + [_INT] * 5 + [_VOID],
    },
    "flash_attention": {
        # q, k, v, o, b, s, h, hk, d, causal, window, softcap, scale, dtype,
        # stream
        "flash_attention": [_VOID] * 4 + [_INT] * 7 + [_F32] * 2 + [_INT]
        + [_VOID],
    },
    "embedding_bag": {
        # table, ids, out, v, d, b, hot, id_stride, out_stride, vec,
        # bags_per_block, grid, dtype, stream
        "embedding_bag": [_VOID] * 3 + [_I64] + [_INT] * 3 + [_I64] * 2
        + [_INT] * 4 + [_VOID],
    },
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """``build/repro_torch/<hash>`` beside ``src/`` in the checkout."""
    root = Path(__file__).resolve().parents[3]
    return root / "build" / "repro_torch" / _sources_hash()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the port's "
                       "kernels are built from source and have no fallback")


def build_log() -> str:
    """The compiler's output of the last build (registers, spills)."""
    path = build_dir() / "build.log"
    return path.read_text() if path.exists() else ""


def build_all() -> Path:
    """Compile every library that is not built yet; returns the directory."""
    out_dir = build_dir()
    todo = [name for name in SIGNATURES
            if not (out_dir / f"lib{name}.so").exists()]
    if not todo:
        return out_dir
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures, log = [], []
    for name, tmp, proc in procs:
        output, _ = proc.communicate()
        log.append(f"== {name}.cu (exit {proc.returncode})\n{output}")
        if proc.returncode == 0:
            os.replace(tmp, out_dir / f"lib{name}.so")
        else:
            os.unlink(tmp)
            failures.append(name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failures:
        raise RuntimeError(f"nvcc failed for {failures}:\n" + "\n".join(log))
    return out_dir


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]


def check(code: int, what: str) -> None:
    """Raise unless a C entry point returned ``cudaSuccess`` (0)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
