"""Build the CUDA kernels in `csrc/` and load them with ctypes.

Each `csrc/*.cu` file compiles with its own nvcc, all started together,
and the objects link into one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds). The library lands in
`tpu_bvh_torch/_build/`, named by a hash of the sources and flags, and is
built at first use. Each C entry launches on the stream it is given and
returns `cudaGetLastError()`.

`launch` is the one way the wrappers in `ops/` start a kernel: it passes
the tensors as pointers, appends the stream, checks the return code,
counts the call in `launches` under the kernel's name and reports it to
`introspect.record` under the same name. `query` calls an entry that
launches nothing (an occupancy or a cluster query).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from . import introspect

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# IEEE division and no FMA contraction: every kernel must agree bit for
# bit with its plain PyTorch version (no --use_fast_math).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as c_void_p, sizes as c_int.
_SIGNATURES = {
    "tbvh_scan32": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "tbvh_refit_dense": [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "tbvh_refit_dense_nodes": [_P, _I, _P, _P, _I, _P, _P, _P, _P],
    "tbvh_refit_long": [_P, _P, _P, _P, _I, _I, _P, _P, _P],
    "tbvh_scan32_links": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "tbvh_raster_sweep": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "tbvh_collapse_block": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "tbvh_collapse_prep": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P],
    "tbvh_collapse_coarse": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P],
    "tbvh_ray_sweep": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "tbvh_ploc_round": [_P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P, _I, _P],
    "tbvh_ploc_nn": [_P, _I, _I, _I, _I, _I, _P, _I, _P, _P],
    "tbvh_ploc_emit_compact": [_P, _I, _P, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _I, _P],
    "tbvh_ploc_finish": [_P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _I, _P],
    "tbvh_ploc_finish_clusters": [_P],
    "tbvh_scan32_fwd": [_P, _I, _P, _P, _P, _P, _P],
    "tbvh_scan32_rev": [_P, _I, _P, _P, _P, _P, _P],
    "tbvh_psv_nsv": [_P, _I, _P, _P, _P, _P, _P],
    "tbvh_psv_nsv_payload": [_P, _P, _I, _P, _P, _P, _P, _P, _P],
    "tbvh_psv_nsv_grid": [_I, _P],
    "tbvh_scan32_grid": [_I, _P],
    "tbvh_child_positions": [_P, _I, _P, _P, _P, _P, _P],
    "tbvh_plane_scan": [_P, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    "tbvh_batched_build": [_P, _I, _I, _P, _P, _P, _P, _P, _P],
    "tbvh_batched_block": [_P, _I, _I, _P, _P, _P, _P, _P, _P],
    "tbvh_traverse_bvh2": [_I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _I, _P, _I, _I,
                           _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "tbvh_front_tri_box": [_P, _I, _P, _P, _P, _P, _P],
    "tbvh_front_keys": [_P, _I, _P, _P, _P, *[_I] * 11, _P, _P],
    "tbvh_front_gather": [_P, _P, _P, _I, _P, _P, _P, _P],
    "tbvh_traverse_packed": [_P, _I, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P,
                             _P, _P, _P, _P, _P, _P, _P, _P],
}

_lib = None
launches = collections.Counter()  # calls of each kernel's C entry by `launch`, by kernel name
_epoch = 0  # look-back launches in this process: the last tag `next_epoch` handed out
build_seconds = None  # wall time of the last build in this process
build_report = ""  # nvcc and ptxas output of the library's build


def _sources(suffixes=(".cu",)):
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(suffixes))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def build() -> str:
    """Compile `csrc/*.cu` into the shared library unless an identical
    build exists; returns its path. A build sets `build_seconds` and keeps
    the compiler's report (registers, shared memory, spills) in
    `build_report` and in a file beside the library, which a process that
    finds the library built reads."""
    global build_seconds, build_report
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources((".cu", ".cuh")):  # the headers count too
        with open(s, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"libtbvh_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        if not build_report and os.path.exists(path + ".ptxas"):
            with open(path + ".ptxas") as f:
                build_report = f.read()
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o, s],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        outs = [p.communicate()[0] for p in procs]
        for s, p, out in zip(srcs, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n{out}")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    build_seconds = time.perf_counter() - t0
    report = "".join(outs)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    build_report = report + res.stdout + res.stderr
    with open(path + ".ptxas", "w") as f:  # kept beside the library for later processes
        f.write(build_report)
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def launch(name: str, entry: str, *args, like, count, symbols) -> None:
    """One call of the C entry `entry` (a key of `_SIGNATURES`) on the
    current stream of `like`'s device: each tensor argument goes as its
    `data_ptr()`, every other as it is (ints, None for a null pointer, a
    pointer plus an offset), and the stream last. Raises on a non-zero
    return; else counts one in `launches[name]` and reports the launch to
    `introspect.record` under `name`, with `count` (its bytes, flops and
    info) and `symbols` (the CUDA kernel's name pattern, or a tuple of
    them)."""
    # ints and None first: an isinstance that fails on torch.Tensor is slow
    err = getattr(lib(), entry)(
        *[a if type(a) is int or a is None else a.data_ptr() if isinstance(a, torch.Tensor)
          else a for a in args],
        stream_of(like))
    check(entry, err)
    launches[name] += 1
    introspect.record(name, count, symbols)


def query(entry: str, *args) -> None:
    """Call an entry that launches nothing (its arguments as ctypes takes
    them) and check its return code; counts nothing."""
    check(entry, getattr(lib(), entry)(*args))


def next_epoch() -> int:
    """A tag for one launch's look-back status words: 30 bits, never 0 (a
    zeroed word), and one count for every kernel, so no launch reads a word
    an earlier launch left as its own."""
    global _epoch
    _epoch = _epoch % ((1 << 30) - 1) + 1
    return _epoch


def look_back_work(store: dict, device, stream: int, words: int):
    """(status, ticket, epoch) of one launch of a single-pass scan with
    decoupled look-back: the status words (i64, at least `words`) and the
    ticket (i32[1]), kept in `store` per device and stream and grown as
    needed, and the launch's `next_epoch`. Both start as zeros; a launch
    leaves the ticket at 0 and its words tagged with its epoch, so no call
    clears them."""
    key = (device, stream)
    status, ticket = store.get(key, (None, None))
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
    if status is None or status.numel() < words:
        status = torch.zeros(words, dtype=torch.int64, device=device)
    store[key] = (status, ticket)
    return status, ticket, next_epoch()


def stream_of(x) -> int:
    """Raw handle of PyTorch's current stream on `x`'s device: the value of
    `torch.cuda.current_stream(x.device).cuda_stream`, read without making
    a `Stream` object (a few microseconds of host time a launch)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require(x, name: str, dtype, shape=None) -> None:
    """Validate a kernel argument: CUDA, dtype, shape, contiguity. Kept
    cheap (`is_cuda`, the `Size` compared as it is): a PLOC round checks
    five."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if shape is not None and x.shape != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
