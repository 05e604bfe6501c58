"""On-demand compilation + ctypes binding of the native components."""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from typing import Optional

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "ringbuffer.cpp")
_IQ_SRC = os.path.join(_HERE, "iqconvert.cpp")


# Built libraries go to one git-ignored directory of the checkout,
# compiled from the committed sources at first use.
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                          ".native_build")


def _lib_path() -> str:
    return os.path.join(_BUILD_DIR, "libradiocore_ring.so")


def _compile(src: str, path: str) -> Optional[str]:
    if (os.path.exists(path)
            and os.path.getmtime(path) >= os.path.getmtime(src)):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for cxx in ("g++", "c++", "clang++"):
        try:
            # Build to a temp file then atomically rename so concurrent
            # processes never load a half-written .so.
            fd, tmp = tempfile.mkstemp(suffix=".so",
                                       dir=os.path.dirname(path))
            os.close(fd)
            subprocess.run(
                [cxx, "-O3", "-std=c++17", "-shared", "-fPIC",
                 src, "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)
            return path
        except (OSError, subprocess.SubprocessError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            continue
    return None


def _build() -> Optional[str]:
    return _compile(_SRC, _lib_path())


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.rc_ring_create.restype = ctypes.c_void_p
    lib.rc_ring_create.argtypes = [ctypes.c_size_t]
    lib.rc_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.rc_ring_capacity.restype = ctypes.c_size_t
    lib.rc_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.rc_ring_occupancy.restype = ctypes.c_size_t
    lib.rc_ring_occupancy.argtypes = [ctypes.c_void_p]
    lib.rc_ring_reset.argtypes = [ctypes.c_void_p]
    lib.rc_ring_put.restype = ctypes.c_int
    lib.rc_ring_put.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t]
    lib.rc_ring_get.restype = ctypes.c_int
    lib.rc_ring_get.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t]
    return lib


def native_available() -> bool:
    """True when the native ring compiled and loaded on this machine."""
    return _load() is not None


class NativeRing:
    """ctypes handle to one C++ SPSC byte ring."""

    def __init__(self, capacity_bytes: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native ring unavailable (no C++ toolchain)")
        self._lib = lib
        self._handle = lib.rc_ring_create(capacity_bytes)
        if not self._handle:
            raise MemoryError("rc_ring_create failed")

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.rc_ring_destroy(self._handle)
                self._handle = None
        except Exception:
            pass

    @property
    def occupancy_bytes(self) -> int:
        """Bytes currently readable."""
        return self._lib.rc_ring_occupancy(self._handle)

    def reset(self) -> None:
        """Drop all buffered bytes (the overflow semantics hook)."""
        self._lib.rc_ring_reset(self._handle)

    def put_bytes(self, buf) -> int:
        """Copy ``data`` in; returns False (no space) without blocking."""
        addr = ctypes.cast(
            (ctypes.c_char * len(buf)).from_buffer_copy(buf)
            if isinstance(buf, (bytes, bytearray)) else
            ctypes.c_void_p(buf.ctypes.data), ctypes.c_void_p)
        n = buf.nbytes if hasattr(buf, "nbytes") else len(buf)
        return self._lib.rc_ring_put(self._handle, addr, n)

    def get_bytes(self, out) -> int:
        """Pop exactly ``n`` bytes, or None if fewer are buffered."""
        addr = ctypes.c_void_p(out.ctypes.data)
        return self._lib.rc_ring_get(self._handle, addr, out.nbytes)


def load_native_ring(capacity_bytes: int) -> NativeRing:
    """Build (once) and load the C++ SPSC ring extension via ctypes."""
    return NativeRing(capacity_bytes)


# ---------------------------------------------------------------------------
# IQ sample-format conversion (iqconvert.cpp)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _load_iq() -> Optional[ctypes.CDLL]:
    path = _compile(_IQ_SRC, os.path.join(_BUILD_DIR,
                                          "libradiocore_iq.so"))
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    for name, src_t in (("rc_iq_u8_to_f32", ctypes.c_uint8),
                        ("rc_iq_s8_to_f32", ctypes.c_int8),
                        ("rc_iq_s16_to_f32", ctypes.c_int16)):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(src_t), ctypes.POINTER(ctypes.c_float),
                       ctypes.c_size_t]
    lib.rc_iq_f32_to_s16.restype = None
    lib.rc_iq_f32_to_s16.argtypes = [ctypes.POINTER(ctypes.c_float),
                                     ctypes.POINTER(ctypes.c_int16),
                                     ctypes.c_size_t]
    return lib


def iq_native_available() -> bool:
    """True when the native IQ converter compiled and loaded."""
    return _load_iq() is not None


def iq_convert_native(raw, fmt: str):
    """Convert raw interleaved IQ scalars to float32 via the C++ kernels.

    ``raw`` is a 1-D NumPy array of the wire dtype (u8/s8/s16); returns a
    float32 array of the same length, or None when the native library is
    unavailable (caller falls back to NumPy).
    """
    import numpy as np

    lib = _load_iq()
    if lib is None:
        return None
    fns = {"cu8": ("rc_iq_u8_to_f32", ctypes.c_uint8, np.uint8),
           "cs8": ("rc_iq_s8_to_f32", ctypes.c_int8, np.int8),
           "cs16": ("rc_iq_s16_to_f32", ctypes.c_int16, np.int16)}
    name, src_t, np_t = fns[fmt]
    if raw.dtype != np_t:
        raise TypeError(f"{fmt} expects dtype {np.dtype(np_t)}, "
                        f"got {raw.dtype}")
    raw = np.ascontiguousarray(raw)
    out = np.empty(raw.shape, np.float32)
    getattr(lib, name)(
        raw.ctypes.data_as(ctypes.POINTER(src_t)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        raw.size)
    return out


def iq_f32_to_s16_native(f32):
    """float32 → int16 quantize (recording path); None if unavailable."""
    import numpy as np

    lib = _load_iq()
    if lib is None:
        return None
    f32 = np.ascontiguousarray(f32, np.float32)
    out = np.empty(f32.shape, np.int16)
    lib.rc_iq_f32_to_s16(
        f32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        f32.size)
    return out
