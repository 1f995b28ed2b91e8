"""ctypes loader for the native BC decoders (tpurast_torch/native/bcdec.cpp).

Compiles the shared library on first use (g++ -O3, ``compile_library``,
which assets/zstd.py shares) into tpurast_torch/_build/, named by a hash of
the source: the compiler writes a temporary file that os.replace then moves
into place, so a process that loads the library never sees a half-written
one, whatever other processes build at the same time. Injects the BC7
partition/anchor tables, and exposes numpy-in/numpy-out wrappers with the
exact signatures of the reference implementations in bcdec.py / bc6h.py.
Falls back cleanly when no compiler is available (``available()`` returns
False) — set TPURAST_NATIVE=0 to force the numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import subprocess

import numpy as np

log = logging.getLogger("tpurast_torch.native")

_SRC = pathlib.Path(__file__).resolve().parent.parent / "native" / "bcdec.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
_LIB = None  # set by _build()
_lib = None
_tried = False


class BuildError(RuntimeError):
    """The host compiler failed on one of the port's native sources."""


def compile_library(src: pathlib.Path, stem: str) -> pathlib.Path:
    """Build ``src`` with g++ into _build/lib{stem}_{hash}.so unless it is
    there already, and return its path. The compiler writes a temporary
    file that os.replace moves into place. Raises BuildError naming the
    compiler's error."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = _BUILD_DIR / f"lib{stem}_{digest}.so"
    if lib.exists():
        return lib
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), str(src)],
            check=True,
            capture_output=True,
            text=True,
        )
        os.replace(tmp, lib)
    except OSError as e:
        raise BuildError(f"g++ could not build {src.name}: {e}") from e
    except subprocess.CalledProcessError as e:
        raise BuildError(f"g++ failed on {src.name}:\n{e.stderr.strip()}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _build() -> bool:
    global _LIB
    if not _SRC.exists():
        return False
    try:
        _LIB = compile_library(_SRC, "tpurast_torch_bcdec")
        return True
    except BuildError as e:
        log.warning("native bcdec build failed (%s); using numpy decoders", e)
        return False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("TPURAST_NATIVE", "1") == "0":
        return None
    if not _build():
        return None
    lib = ctypes.CDLL(str(_LIB))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.bc7_init.argtypes = [i32p] * 5
    lib.decode_bc7.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.decode_bc4.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.decode_bc6h.argtypes = [u8p, ctypes.c_int64, u16p]
    lib.decode_bc6h_sf.argtypes = [u8p, ctypes.c_int64, u16p]

    from tpurast_torch.assets import _bc7_tables as t

    lib.bc7_init(
        np.ascontiguousarray(t.PARTITIONS_2, dtype=np.int32),
        np.ascontiguousarray(t.PARTITIONS_3, dtype=np.int32),
        np.ascontiguousarray(t.ANCHOR_SECOND_2, dtype=np.int32),
        np.ascontiguousarray(t.ANCHOR_SECOND_3, dtype=np.int32),
        np.ascontiguousarray(t.ANCHOR_THIRD_3, dtype=np.int32),
    )
    _lib = lib
    log.debug("native bcdec loaded from %s", _LIB)
    return _lib


def available() -> bool:
    return _load() is not None


def decode_bc7(blocks: np.ndarray) -> np.ndarray:
    lib = _load()
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(-1, 16)
    out = np.empty((blocks.shape[0], 4, 4, 4), dtype=np.uint8)
    lib.decode_bc7(blocks, blocks.shape[0], out.reshape(-1))
    return out


def decode_bc4(blocks: np.ndarray) -> np.ndarray:
    lib = _load()
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(-1, 8)
    out = np.empty((blocks.shape[0], 4, 4), dtype=np.uint8)
    lib.decode_bc4(blocks, blocks.shape[0], out.reshape(-1))
    return out


def decode_bc6h(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    lib = _load()
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(-1, 16)
    half = np.empty((blocks.shape[0], 16, 3), dtype=np.uint16)
    fn = lib.decode_bc6h_sf if signed else lib.decode_bc6h
    fn(blocks, blocks.shape[0], half.reshape(-1))
    return half.view(np.float16).astype(np.float32).reshape(-1, 4, 4, 3)
