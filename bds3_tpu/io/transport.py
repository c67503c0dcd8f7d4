"""Host->device capture transport: bulk upload with optional 4-bit packing.

The tracking compute path is device-resident (one `lax.scan` dispatch per
run, track/driver.py); what remains on the wire is the IF capture itself.
Where the host->device link, not the device, bounds the run, the wall
time is set by transport bytes.  Whether that happens on a PCIe-attached
GPU is not measured yet.

`packing="int4"` halves those bytes by re-quantizing int8 samples to the
4-bit grid the reference's own dataset uses natively (NUT4NT packed
captures, `BDS-3_B2a/include/unpack_cplx.m` — there every sample is 4-bit
before the receiver ever sees it) and unpacking on device.  For a
noise_std ~2 capture the int8->int4 requantization costs < 0.3 dB C/N0
(clip at +-7 ~ 2 sigma), invisible next to the 3 dB the reference gives up
to 1-bit GNSS front ends.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def pack_int4(arr: np.ndarray) -> np.ndarray:
    """Pack int8 samples to 4 bits, PLANAR halves: byte j carries sample
    j in its low nibble and sample j + ceil(n/2) in its high nibble.

    Planar (not interleaved) so the device unpack is a concatenation of
    two contiguous (n/2,) arrays, with no trailing size-2 axis for the
    compiler to lay out.

    Values are clipped to [-8, 7].  Odd-length inputs are zero-padded by
    one sample; `unpack_int4` takes the true length to drop the pad.
    """
    a = np.clip(arr, -8, 7).astype(np.int8)
    half = (len(a) + 1) // 2
    if len(a) % 2:
        a = np.concatenate([a, np.zeros(1, np.int8)])
    nib = a.view(np.uint8) & 0xF
    return (nib[:half] | (nib[half:] << 4)).astype(np.uint8)


@functools.partial(jax.jit, static_argnames=("n",))
def unpack_int4(packed, n: int):
    """Device-side unpack of `pack_int4` bytes back to (n,) int8."""
    b = packed.astype(jnp.uint8)
    lo = (b & 0xF).astype(jnp.int8)
    hi = ((b >> 4) & 0xF).astype(jnp.int8)
    # sign-extend the 4-bit two's-complement nibble
    lo = ((lo ^ 8) - 8).astype(jnp.int8)
    hi = ((hi ^ 8) - 8).astype(jnp.int8)
    return jnp.concatenate([lo, hi])[:n]


def pack_int2(arr: np.ndarray, thresh: int = 3) -> np.ndarray:
    """Pack int8 samples to 2-bit sign+magnitude, PLANAR quarters: byte
    j carries samples j, j+q, j+2q, j+3q (q = ceil(n/4)) in bit pairs
    (LSB first).  Code = (sign << 1) | (|x| >= thresh) -> levels
    {-3, -1, +1, +3} on unpack — the classic 2-bit GNSS front-end
    quantization (~0.55 dB C/N0 loss at thresh ~ sigma)."""
    a = np.asarray(arr, dtype=np.int8)
    q = (len(a) + 3) // 4
    if len(a) != 4 * q:
        a = np.concatenate([a, np.zeros(4 * q - len(a), np.int8)])
    sign = (a < 0).astype(np.uint8)
    mag = (np.abs(a.astype(np.int16)) >= thresh).astype(np.uint8)
    code = (sign << 1) | mag
    return (code[:q] | (code[q:2*q] << 2) | (code[2*q:3*q] << 4)
            | (code[3*q:] << 6)).astype(np.uint8)


@functools.partial(jax.jit, static_argnames=("n",))
def unpack_int2(packed, n: int):
    """Device-side unpack of `pack_int2` bytes back to (n,) int8
    (levels -3, -1, +1, +3)."""
    b = packed.astype(jnp.uint8)
    quarters = []
    for k in range(4):
        code = (b >> (2 * k)) & 3
        mag = (code & 1).astype(jnp.int8)
        sign = ((code >> 1) & 1).astype(jnp.int8)
        quarters.append(((1 - 2 * sign) * (1 + 2 * mag)).astype(jnp.int8))
    return jnp.concatenate(quarters)[:n]


def upload_capture(signal, packing: str = "none"):
    """Upload an int8 capture (ndarray / memmap / StreamingCapture slice
    source) to the default device as one bulk transfer; returns a device
    int8 array.

    packing="int4": re-quantize to 4 bits host-side, ship half the bytes,
    unpack on device (see module docstring for the accuracy budget).
    """
    n = len(signal)
    host = signal[0:n] if not isinstance(signal, np.ndarray) else signal
    host = np.ascontiguousarray(host, dtype=np.int8)
    if packing == "int4":
        return unpack_int4(jnp.asarray(pack_int4(host)), n)
    if packing == "int2":
        return unpack_int2(jnp.asarray(pack_int2(host)), n)
    if packing != "none":
        raise ValueError(f"unknown packing {packing!r}")
    return jnp.asarray(host)
