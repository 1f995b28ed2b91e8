"""Build and bind the CUDA kernels in tpurast_torch/csrc/.

The sources have a plain C interface, so they compile with nvcc alone (no
PyTorch headers) into one shared library that ctypes loads: seconds per
build instead of minutes. Each source compiles in an nvcc of its own, all
started together, and one more call links the objects. The library lands in tpurast_torch/_build/,
named by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads the existing file. This is the pattern of
tpurast/assets/native.py without its fallback: if nvcc is missing or the
build fails, the caller gets the error (with nvcc's output), never the
plain torch path.

Every pointer and the stream cross as c_void_p (a bare Python int would
be cut to 32 bits), and every entry point returns cudaGetLastError() of
its launch, which ``call`` turns into an exception.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    # No a*b+c contraction: the kernels must round exactly like the
    # eager torch plain versions (edge functions decide coverage).
    "--fmad=false",
    "-Xptxas=-v",
    "-Xcompiler",
    "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C signatures (see the extern "C" functions in csrc/*.cu).
SIGNATURES = {
    "tr_raster": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _I, _P, _P, _P, _P],
    "tr_resolve": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "tr_plan": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "tr_sample": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "tr_shade_gbuffer": [_P, _P, _L, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "tr_shade_deferred": [_P, _P, _P, _I, _P, _L, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "tr_plane_scale": [_P, _I, _I, _I, _I, _I, _I, _P, _P],
    "tr_vmem_take": [_P, _I, _P, _L, _P, _P],
    "tr_trace_mark": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "tr_bin": [_P, _P, _P, _I, _I] + [_I] * 10 + [_P] * 7 + [_L, _P],
    "tr_setup": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "tr_encode": [_P, _I, _I, _I, _I, _P, _P],
}
# Host functions that return a count (see csrc/*.cu): their int arguments.
COUNTS = {"tr_bin_scratch": 9}


# Kernels with a tr_<name>_info entry point: (leading int arguments, int
# outputs). The outputs are registers per thread and resident blocks per
# SM; the shade kernels' take the rows' format code (shade.ROW_FORMATS) and
# also give threads and static shared bytes per block.
INFO = {"tr_raster_info": (0, 2), "tr_plan_info": (0, 2), "tr_plan_large_info": (0, 2), "tr_sample_info": (0, 2),
        "tr_shade_gbuffer_info": (1, 4), "tr_shade_deferred_info": (1, 4), "tr_vmem_take_info": (0, 2),
        "tr_setup_info": (0, 2), "tr_encode_info": (0, 2)}


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the tpurast_torch "
        "CUDA kernels are built from csrc/ at first use and need the CUDA toolkit"
    )


def _sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".h"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> tuple[pathlib.Path, float, str]:
    """Compile the library if it is not built yet. Returns (path, build
    seconds (0.0 when cached), nvcc's output)."""
    lib_path = BUILD_DIR / f"libtpurast_torch_{_digest()}.so"
    if lib_path.exists():
        return lib_path, 0.0, ""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = [p for p in _sources() if p.suffix == ".cu"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(pathlib.Path(tmp) / f"{p.stem}.o") for p in srcs]
        with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
            logs = list(pool.map(_nvcc, [[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", o] for p, o in zip(srcs, objs)]))
        linked = str(pathlib.Path(tmp) / lib_path.name)
        logs.append(_nvcc([nvcc, "-shared", "-o", linked, *objs]))
        os.replace(linked, lib_path)
    return lib_path, time.perf_counter() - t0, "".join(logs)


@functools.cache
def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built on first call)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, (n_in, n_out) in INFO.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] * n_in + [ctypes.POINTER(ctypes.c_int)] * n_out
        fn.restype = ctypes.c_int
    for name, n_in in COUNTS.items():
        fn = getattr(lib, name)
        fn.argtypes = [_I] * n_in
        fn.restype = _L
    lib.tr_trace_alloc.argtypes = [_L, ctypes.POINTER(_P), ctypes.POINTER(_P)]
    lib.tr_trace_alloc.restype = ctypes.c_int
    lib.tr_error_string.argtypes = [ctypes.c_int]
    lib.tr_error_string.restype = ctypes.c_char_p
    return lib


def kernel_info(name: str, *args: int) -> tuple[int, ...]:
    """(registers per thread, resident blocks per SM) of a kernel of INFO
    ("raster", "plan", "plan_large", "sample", "vmem_take", "setup", "encode") as
    built, from the CUDA runtime; for "shade_gbuffer" and "shade_deferred",
    given the rows' format code, also (threads, static shared bytes) per
    block."""
    outs = [ctypes.c_int() for _ in range(INFO[f"tr_{name}_info"][1])]
    err = getattr(library(), f"tr_{name}_info")(*args, *map(ctypes.byref, outs))
    if err != 0:
        raise RuntimeError(f"tr_{name}_info: CUDA error {err} ({library().tr_error_string(err).decode()})")
    return tuple(o.value for o in outs)


def host_mapped(nbytes: int) -> tuple[int, int]:
    """(host address, device address) of ``nbytes`` zeroed bytes of pinned
    host memory mapped into the devices' address space
    (csrc/trace.cu tr_trace_alloc): kernels write it, the host reads it
    with no copy. Lives as long as the process."""
    host, dev = _P(), _P()
    err = library().tr_trace_alloc(nbytes, ctypes.byref(host), ctypes.byref(dev))
    if err != 0:
        raise RuntimeError(f"tr_trace_alloc: CUDA error {err} ({library().tr_error_string(err).decode()})")
    return host.value, dev.value


def call(name: str, *args) -> None:
    """Launch entry point ``name`` on the current stream of its tensors'
    device; raise on a CUDA error. Tensor arguments are passed by data
    pointer."""
    lib = library()
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = getattr(lib, name)(*conv, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.tr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
