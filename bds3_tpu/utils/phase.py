"""Precision-safe local-carrier synthesis.

Computing 2*pi*f*t directly in float32 is catastrophically wrong for GNSS
spans: f ~ 1.5e7 Hz, t up to 20 ms gives phases ~ 3e5 cycles, where float32
resolution is ~0.03 cycles.  The reference gets away with float64 MATLAB;
on device we stay in float32 by reducing modulo one cycle *before* the
rounding can hurt:

  cycles(n) = n * a mod 1,   a = f / fs mod 1  (host float64)

is evaluated as  (k * c1 + r * a) mod 1  with n = 4096*k + r and
c1 = (4096 * a) mod 1 precomputed in float64 on host.  Both products stay
below ~4e3 cycles, keeping absolute float32 phase error < 2e-3 rad over
millions of samples.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_SPLIT = 4096


def phase_tables(freqs_hz: np.ndarray, fs: float) -> tuple[np.ndarray, np.ndarray]:
    """Host-side float64 reduction of per-sample cycle increments.

    Returns (a, c1) float32 arrays shaped like freqs_hz.
    """
    a = np.mod(np.asarray(freqs_hz, dtype=np.float64) / fs, 1.0)
    c1 = np.mod(_SPLIT * a, 1.0)
    return a.astype(np.float32), c1.astype(np.float32)


def carrier_table(a: jnp.ndarray, c1: jnp.ndarray, n: int,
                  sign: float = -1.0) -> jnp.ndarray:
    """Device-side e^{sign * j*2*pi*f*t} for t = (0..n-1)/fs, complex64.

    a, c1: outputs of phase_tables, any leading batch shape; result has
    shape a.shape + (n,).
    """
    idx = jnp.arange(n, dtype=jnp.int32)
    k = (idx // _SPLIT).astype(jnp.float32)
    r = (idx % _SPLIT).astype(jnp.float32)
    cyc = jnp.mod(
        a[..., None] * r + c1[..., None] * k, 1.0
    )
    ang = (2.0 * np.pi * sign) * cyc
    return jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
