"""Zstandard frames (RFC 8878) through the port's own decoder.

The reference's KTX2 textures are Zstandard-supercompressed; the port
decodes them with tpurast_torch/native/zstd.cpp, compiled with g++ on first
use into tpurast_torch/_build/ (assets/native.py ``compile_library``) and
called through ctypes, so no machine needs a zstd package. A failed build
raises, naming the compiler's error; a corrupt, truncated or oversized
frame raises Ktx2Error. There is no fallback. (The writer's side,
assets/ktx2_write.py, may use the zstandard package where it is installed
and writes stored frames where it is not.)
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

from tpurast_torch.assets import native
from tpurast_torch.assets.ktx2 import Ktx2Error

_SRC = pathlib.Path(__file__).resolve().parent.parent / "native" / "zstd.cpp"

_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    """The decoder's shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.compile_library(_SRC, "tpurast_torch_zstd")))
            lib.zstd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
            lib.zstd_decompress.restype = ctypes.c_int64
            lib.zstd_error_name.argtypes = [ctypes.c_int64]
            lib.zstd_error_name.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def decompress(data: bytes, capacity: int) -> bytes:
    """Every frame of ``data`` decoded, at most ``capacity`` bytes; raises
    Ktx2Error on a corrupt, truncated or oversized input."""
    lib = library()
    data = bytes(data)
    out = ctypes.create_string_buffer(max(1, capacity))
    n = lib.zstd_decompress(data, len(data), out, capacity)
    if n < 0:
        raise Ktx2Error(f"zstd: {lib.zstd_error_name(n).decode()} (code {n})")
    return out.raw[:n]
