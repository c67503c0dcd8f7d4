"""Optional band-pass-sampling decimation for acquisition.

Parity with the reference's resampling strategy
(`BDS-3_B2a/acquisition.m:52-124`, identical in the B1C variant): filter
the IF capture to the code main lobe (zero-phase FIR), pick a bandpass
sampling frequency from the acceptable range, nearest-index decimate, and
alias the IF down.  The recovery of the original-rate code phase and
carrier frequency mirrors the reference's "downsampling recovery"
(acquisition.m:337-356).

It trades FFT length for one device filtering pass; the B1C preset
turns it on (the reference ships it off, initSettings.m).
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy import signal as sp_signal

from bds3_tpu.config import Settings


@dataclasses.dataclass
class ResamplePlan:
    old_fs: float
    old_if: float
    new_fs: float
    new_if: float


def plan_resample(s: Settings) -> ResamplePlan | None:
    """Bandpass-sampling plan (acquisition.m:74-122), or None if the
    sampling rate is already below the threshold."""
    bw = s.code_freq_basis * 2 + 0.5e6
    fu = s.intermediate_freq + bw / 2
    n = max(int(np.floor(fu / bw)), 1)
    lower = 2 * fu / n
    fl = s.intermediate_freq - bw / 2
    upper = 2 * fl / (n - 1) if n > 1 else lower
    new_fs = float(np.ceil((lower + upper) / 2))
    new_if = float(np.fmod(s.intermediate_freq, new_fs))
    return ResamplePlan(s.sampling_freq, s.intermediate_freq, new_fs, new_if)


def resample_signal(signal: np.ndarray, s: Settings,
                    plan: ResamplePlan) -> np.ndarray:
    """Zero-phase band-pass filter + nearest-index decimation
    (acquisition.m:59-115)."""
    fs = plan.old_fs
    bw = s.code_freq_basis * 2 + 0.5e6
    w1 = (plan.old_if - bw / 2) * 2 / fs - 0.002
    w2 = (plan.old_if + bw / 2) * 2 / fs + 0.002
    b = sp_signal.firwin(701, [max(w1, 1e-6), min(w2, 1 - 1e-6)],
                         pass_zero=False)
    filtered = sp_signal.filtfilt(b, [1.0], np.asarray(signal, np.float64))
    n_out = int(np.floor((len(signal) - 1) / fs * plan.new_fs))
    idx = np.ceil(np.arange(n_out) / plan.new_fs * fs).astype(np.int64)
    idx[0] = 0
    return filtered[idx].astype(np.float32)


def resample_signal_device(signal, s: Settings,
                           plan: ResamplePlan):
    """Device equivalent of `resample_signal` (returns jnp array).

    The reference's zero-phase filtfilt with a SYMMETRIC firwin kernel
    equals (away from the boundary transient) a single convolution with
    the kernel's autocorrelation conv(b, b[::-1]) = conv(b, b): that
    runs as one device FFT convolution instead of a host scipy filtfilt
    over the multi-MB window (the reason the reference marks its own
    resampling path as costly).  The nearest-index decimation is a
    device gather.  Differences vs the host path are confined to the
    first/last ~3*ntaps samples (filtfilt's reflect padding), which the
    acquisition correlation never keys on (tests/test_resample.py).
    """
    import jax.numpy as jnp

    fs = plan.old_fs
    bw = s.code_freq_basis * 2 + 0.5e6
    w1 = (plan.old_if - bw / 2) * 2 / fs - 0.002
    w2 = (plan.old_if + bw / 2) * 2 / fs + 0.002
    b = sp_signal.firwin(701, [max(w1, 1e-6), min(w2, 1 - 1e-6)],
                         pass_zero=False)
    bb = np.convolve(b, b).astype(np.float32)         # zero-phase kernel
    x = jnp.asarray(signal).astype(jnp.float32)
    n = x.shape[0]
    k = len(bb)
    # FFT convolution with a power-of-2 length (a direct multi-MSample
    # 1-D conv is far costlier; the FFT length is not yet tuned)
    nfft = 1
    while nfft < n + k:
        nfft <<= 1
    # kernel spectrum computed ON DEVICE from the 1401-tap constant (a
    # host-side np.fft.rfft would embed a multi-MB complex literal in
    # the compiled program)
    spec = jnp.fft.rfft(x, nfft) * jnp.fft.rfft(jnp.asarray(bb), nfft)
    full = jnp.fft.irfft(spec, nfft)
    filtered = full[(k - 1) // 2 : (k - 1) // 2 + n]  # 'same' alignment
    n_out = int(np.floor((len(signal) - 1) / fs * plan.new_fs))
    idx = np.ceil(np.arange(n_out) / plan.new_fs * fs).astype(np.int64)
    idx[0] = 0
    return jnp.take(filtered, jnp.asarray(idx))


def recover_results(acq, plan: ResamplePlan):
    """Map code phase and carrier frequency back to the original rate.

    Code phase scales by the fs ratio (acquisition.m:311-314).  For the
    carrier, the complex mixer always locks the correlation peak at the
    positive-frequency alias new_if + fd — even when new_if exceeds the
    resampled Nyquist — so doppler = carrFreq - new_if unconditionally.
    (Deviation: the reference's mirror branch for IF >= fs/2,
    acquisition.m:317-325, contradicts its own complex mixing and yields
    MHz-scale errors on synthesized truth; verified in
    tests/test_resample.py.)"""
    code_phase = np.floor(
        acq.code_phase / plan.new_fs * plan.old_fs
    ).astype(np.int64)
    carr = np.asarray(acq.carr_freq, dtype=np.float64)
    doppler = carr - plan.new_if
    acq.code_phase = code_phase
    acq.carr_freq = doppler + plan.old_if
    return acq
