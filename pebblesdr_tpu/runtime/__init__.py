"""Native runtime bindings: C++ IQ ring buffer + wire-format decode (ctypes).

Builds libpebble_runtime.so on first import if g++ is available (make -C
pebblesdr_tpu/runtime); all callers fall back to pure-numpy paths when the
native library is missing, so the framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
_SO = os.path.join(_DIR, "libpebble_runtime.so")

_lib = None


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _DIR], check=True, capture_output=True,
                       timeout=120)
        return os.path.exists(_SO)
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def load():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) and not _build():
        return None
    lib = ctypes.CDLL(_SO)
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_acquire_write.restype = ctypes.c_void_p
    lib.ring_acquire_write.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ring_commit_write.argtypes = [ctypes.c_void_p]
    lib.ring_acquire_read.restype = ctypes.c_void_p
    lib.ring_acquire_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ring_release_read.argtypes = [ctypes.c_void_p]
    lib.ring_filled.restype = ctypes.c_size_t
    lib.ring_filled.argtypes = [ctypes.c_void_p]
    lib.ring_overruns.restype = ctypes.c_uint64
    lib.ring_overruns.argtypes = [ctypes.c_void_p]
    for name in ("decode_u8", "decode_i8", "decode_i16", "decode_u16",
                 "decode_f32", "deint_i16", "deint_i8_to_i16",
                 "deint_u8_to_i16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int]
    lib.udp_pump_create.restype = ctypes.c_void_p
    lib.udp_pump_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_int]
    lib.udp_pump_port.restype = ctypes.c_int
    lib.udp_pump_port.argtypes = [ctypes.c_void_p]
    lib.udp_pump_read.restype = ctypes.c_int
    lib.udp_pump_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int]
    lib.udp_pump_counters.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_uint64)] * 4
    lib.udp_pump_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


class NativeRing:
    """ProducerConsumer-equivalent buffer ring backed by the C++ runtime."""

    def __init__(self, n_buffers: int, buf_bytes: int):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable (no g++/make?)")
        self.buf_bytes = buf_bytes
        self._ring = self._lib.ring_create(n_buffers, buf_bytes)

    def __del__(self):
        if getattr(self, "_ring", None):
            self._lib.ring_destroy(self._ring)
            self._ring = None

    def write(self, data: bytes, timeout_ms: int = -1,
              drop_oldest: bool = True) -> bool:
        assert len(data) <= self.buf_bytes
        ptr = self._lib.ring_acquire_write(self._ring, timeout_ms,
                                           1 if drop_oldest else 0)
        if not ptr:
            return False
        ctypes.memmove(ptr, data, len(data))
        self._lib.ring_commit_write(self._ring)
        return True

    def read(self, nbytes: int | None = None, timeout_ms: int = -1) -> bytes | None:
        ptr = self._lib.ring_acquire_read(self._ring, timeout_ms)
        if not ptr:
            return None
        out = ctypes.string_at(ptr, nbytes or self.buf_bytes)
        self._lib.ring_release_read(self._ring)
        return out

    @property
    def filled(self) -> int:
        return self._lib.ring_filled(self._ring)

    @property
    def overruns(self) -> int:
        return self._lib.ring_overruns(self._ring)


_DECODERS = {"u8": "decode_u8", "i8": "decode_i8", "i16": "decode_i16",
             "u16": "decode_u16", "f32": "decode_f32"}
_DTYPES = {"u8": np.uint8, "i8": np.int8, "i16": np.int16, "u16": np.uint16,
           "f32": np.float32}


def decode_iq_planes(raw: bytes | np.ndarray, fmt: str,
                     swap_iq: bool = False) -> np.ndarray:
    """Interleaved wire bytes -> [2, n] float32 (re, im) planes.

    Native fast path when the runtime lib is present; numpy fallback
    otherwise.  The [2, n] plane layout is what the chain's entry planes
    are built from.
    """
    arr = np.frombuffer(raw, dtype=_DTYPES[fmt]) if isinstance(raw, (bytes, bytearray)) \
        else np.ascontiguousarray(raw, dtype=_DTYPES[fmt])
    n = arr.size // 2
    lib = load()
    if lib is not None:
        out = np.empty((2, n), np.float32)
        getattr(lib, _DECODERS[fmt])(
            arr.ctypes.data_as(ctypes.c_void_p), n,
            out[0].ctypes.data_as(ctypes.c_void_p),
            out[1].ctypes.data_as(ctypes.c_void_p),
            1 if swap_iq else 0)
        return out
    # numpy fallback (same math as core.iqformat)
    x = arr.astype(np.float32)
    if fmt == "u8":
        x = (x - 128.0) / 128.0
    elif fmt == "i8":
        x = x / 128.0
    elif fmt == "i16":
        x = x / 32768.0
    elif fmt == "u16":
        x = (x - 32768.0) / 32768.0
    i, q = x[0::2], x[1::2]
    if swap_iq:
        i, q = q, i
    return np.stack([i, q])


_DEINT16 = {"i16": "deint_i16", "i8": "deint_i8_to_i16",
            "u8": "deint_u8_to_i16"}


def deint_iq_planes_i16(raw: bytes | np.ndarray, fmt: str,
                        swap_iq: bool = False) -> np.ndarray:
    """Interleaved integer wire bytes -> [2, n] INT16 (re, im) planes.

    The native-container fast path: the chain accepts i16 entry planes and
    dequantizes them on the device (Receiver._entry), so the host never
    converts to float and ships half the bytes.  i8/u8 rescale to full-scale i16
    (lossless << 8); fmt must be one of i16/i8/u8."""
    if fmt not in _DEINT16:
        raise ValueError(f"no i16 passthrough for wire format {fmt!r}")
    arr = np.frombuffer(raw, dtype=_DTYPES[fmt]) if isinstance(raw, (bytes, bytearray)) \
        else np.ascontiguousarray(raw, dtype=_DTYPES[fmt])
    n = arr.size // 2
    lib = load()
    if lib is not None:
        out = np.empty((2, n), np.int16)
        getattr(lib, _DEINT16[fmt])(
            arr.ctypes.data_as(ctypes.c_void_p), n,
            out[0].ctypes.data_as(ctypes.c_void_p),
            out[1].ctypes.data_as(ctypes.c_void_p),
            1 if swap_iq else 0)
        return out
    # numpy fallback
    if fmt == "i16":
        x = arr.astype(np.int16)
    elif fmt == "i8":
        x = (arr.astype(np.int16) << 8)
    else:  # u8
        x = ((arr.astype(np.int16) - 128) << 8)
    i, q = x[0::2], x[1::2]
    if swap_iq:
        i, q = q, i
    return np.stack([i, q])


_FMT_CODES = {"i16": 0, "u8": 1, "i8": 2, "u16": 3, "f32": 4}


class NativeUdpPump:
    """High-rate UDP IQ receiver on a dedicated C++ thread: header strip,
    LE16 sequence-gap tracking (zero fill + count), wire-format decode to
    deinterleaved float32 planes, whole blocks committed into a native ring
    with drop-oldest overrun semantics.

    The native data plane for Msps network sources (SDR-IP at 2 Msps is ~8 k
    datagrams/s — a per-datagram Python loop steals time the chain feeder
    needs); the ProducerConsumer producer-thread role, filled by a socket.
    """

    def __init__(self, port: int = 0, header_bytes: int = 0,
                 seq_le16_offset: int = -1, fmt: str = "i16",
                 swap_iq: bool = False, block_samples: int = 32768,
                 ring_buffers: int = 16, bind_host: str = "",
                 drop_oldest: bool = False):
        # drop_oldest=False (default): backpressure to the 8 MB socket
        # buffer — kernel loss surfaces as tracked sequence gaps, never a
        # silent splice.  True: real-time freshness (ProducerConsumer POLL
        # drop-oldest semantics), counted in counters['overruns'].
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable (no g++/make?)")
        self.block_samples = block_samples
        self._pump = self._lib.udp_pump_create(
            bind_host.encode(), port, header_bytes, seq_le16_offset,
            _FMT_CODES[fmt], 1 if swap_iq else 0, block_samples, ring_buffers,
            1 if drop_oldest else 0)
        if not self._pump:
            raise OSError(f"udp pump failed to bind port {port}")
        self.port = self._lib.udp_pump_port(self._pump)

    def read_planes(self, timeout_ms: int = 5000) -> np.ndarray | None:
        """One block as [2, block_samples] float32 (re, im) planes, or None
        on timeout."""
        out = np.empty((2, self.block_samples), np.float32)
        ok = self._lib.udp_pump_read(
            self._pump, out.ctypes.data_as(ctypes.c_void_p), timeout_ms)
        return out if ok else None

    def read_block(self, timeout_ms: int = 5000) -> np.ndarray | None:
        """One block as complex64 (convenience; the planes path avoids the
        complex round trip)."""
        p = self.read_planes(timeout_ms)
        return None if p is None else (p[0] + 1j * p[1]).astype(np.complex64)

    @property
    def counters(self) -> dict:
        vals = [ctypes.c_uint64() for _ in range(4)]
        self._lib.udp_pump_counters(self._pump, *[ctypes.byref(v) for v in vals])
        return {"datagrams": vals[0].value, "dropped_datagrams": vals[1].value,
                "overruns": vals[2].value, "bytes": vals[3].value}

    def close(self) -> None:
        if getattr(self, "_pump", None):
            self._lib.udp_pump_destroy(self._pump)
            self._pump = None

    def __del__(self):
        self.close()
