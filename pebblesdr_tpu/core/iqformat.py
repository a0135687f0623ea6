"""Wire-format IQ decode: raw device/file bytes -> [n] complex64 in [-1, 1).

Capability parity with DeviceInterfaceBase::normalizeIQ (pebblelib/
deviceinterfacebase.h:105-117) and the CPX wire formats (pebblelib/cpx.h:43-92):
  u8  (offset-128, rtl-sdr/hackrf)     CPXU8
  i8                                    CPX8
  u16 (offset-32768)                    CPXU16
  i16 (most soundcard/SDR-IQ devices)   CPX16
  f32                                   CPXFLOAT
plus optional I/Q order swap (some devices deliver QI).

Decode runs as a jit-able device kernel so that byte->float conversion happens
on the device right after the transfer rather than on the host (the reference converts on the
CPU consumer thread).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_SCALES = {
    "u8": 1.0 / 128.0,
    "i8": 1.0 / 128.0,
    "u16": 1.0 / 32768.0,
    "i16": 1.0 / 32768.0,
    "f32": 1.0,
    "f64": 1.0,
}

_DTYPES = {
    "u8": jnp.uint8,
    "i8": jnp.int8,
    "u16": jnp.uint16,
    "i16": jnp.int16,
    "f32": jnp.float32,
    "f64": jnp.float32,  # down-converted at ingest
}

_OFFSETS = {"u8": 128.0, "u16": 32768.0}


@functools.partial(jax.jit, static_argnames=("fmt", "swap_iq"))
def decode_iq(raw: jax.Array, fmt: str = "i16", swap_iq: bool = False) -> jax.Array:
    """Decode interleaved raw samples [2*n] (or [..., 2*n]) to complex64 [..., n].

    raw must already have the integer/float dtype named by fmt (use
    ``np.frombuffer`` host-side or pass the device array straight through).
    """
    x = raw.astype(jnp.float32)
    offset = _OFFSETS.get(fmt, 0.0)
    x = (x - offset) * _SCALES[fmt]
    i = x[..., 0::2]
    q = x[..., 1::2]
    if swap_iq:
        i, q = q, i
    return jax.lax.complex(i, q)


def decode_iq_host(raw_bytes: bytes, fmt: str = "i16", swap_iq: bool = False) -> np.ndarray:
    """Host-side variant for file/socket ingest paths (numpy, no device)."""
    np_dtype = {"u8": np.uint8, "i8": np.int8, "u16": np.uint16,
                "i16": np.int16, "f32": np.float32, "f64": np.float64}[fmt]
    x = np.frombuffer(raw_bytes, dtype=np_dtype).astype(np.float32)
    x = (x - _OFFSETS.get(fmt, 0.0)) * _SCALES[fmt]
    i, q = x[0::2], x[1::2]
    if swap_iq:
        i, q = q, i
    return (i + 1j * q).astype(np.complex64)


def encode_iq_u8(x: np.ndarray) -> bytes:
    """complex64 [-1,1) -> interleaved u8 (rtl_tcp wire format, serve path)."""
    out = np.empty(2 * x.shape[-1], dtype=np.uint8)
    out[0::2] = np.clip(np.round(x.real * 128.0 + 128.0), 0, 255).astype(np.uint8)
    out[1::2] = np.clip(np.round(x.imag * 128.0 + 128.0), 0, 255).astype(np.uint8)
    return out.tobytes()
