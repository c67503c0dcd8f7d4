"""Batched parallel-code-phase-search (PCPS) acquisition on the device.

Redesign of the reference's per-PRN, per-Doppler-bin loops
(`BDS-3_B1C/acquisition.m:169-222`, `BDS-3_B2a/acquisition.m:170-211`):
the (PRN x Doppler x codePhase) search cube becomes batched XLA FFTs.
Loop order is Doppler-chunk outer / PRN-chunk inner so each chunk of mixed
signal spectra is reused across all satellites; running (peak, bin, phase)
maxima are carried through a `lax.scan` so the full cube never materializes
in device memory.

Behavioral parity notes:
- coarse correlation: local code = first `n_coh` samples of the sampled
  code table zero-padded to `n_fft`; signal window = first `n_fft` samples;
  corr = ifft(fft(mixed signal) * conj(fft(code))) (acquisition.m:176-219).
- combining: B1C weighted (|d|*sqrt(11)+|p|*sqrt(29))/sqrt(40)
  (B1C acquisition.m:218-219); B2a plain |d|+|p| (B2a acquisition.m:209).
- detection metric: B1C GLRT peak/sigPower with
  sigPower = sqrt(var(sig[:n_coh])*n_coh) (B1C acquisition.m:150,235);
  B2a peak/secondPeak with a +-1 chip exclusion zone inside the same
  Doppler row, non-circular clipping (B2a acquisition.m:223-252).
- fine search: B1C one 10 ms zero-DC coherent correlation on a 25 Hz grid
  over [f0-step, f0+step] (B1C acquisition.m:246-305); B2a `fine_noncoh`
  1 ms coherent sums combined non-coherently over [f0-step/2, f0+step/2]
  (B2a acquisition.m:256-322).  The per-code carrier phase factor has unit
  modulus and drops out of the non-coherent sum, so the B2a search is one
  einsum over (PRN, bin, code) — no per-bin loop.

All mixing uses the canonical local carrier e^{-j*2*pi*f*t}; for real IF
captures this is conjugate-equivalent to the reference's e^{+j} and yields
identical magnitudes and frequency estimates.  Carrier phases are built
with the mod-one-cycle float32-safe scheme in utils/phase.py.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from bds3_tpu.config import Settings, Signal
from bds3_tpu.signals import sample_chips
from bds3_tpu.signals.b1c import b1c_data_boc11, b1c_pilot_boc11
from bds3_tpu.signals.b2a import b2a_codes_matrix
from bds3_tpu.signals.sampling import sample_chips_floor
from bds3_tpu.utils.phase import carrier_table, phase_tables


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class AcqConfig:
    """Static (hashable) parameters of one acquisition compile."""

    signal: Signal
    fs: float
    n_fft: int           # correlation FFT length [samples], power of two
    n_search: int        # code-phase search span (one code period)
    n_coh: int           # coherent local-code length [samples]
    samples_per_code: int
    n_bins: int
    freq_base: float     # first Doppler bin absolute frequency [Hz]
    freq_step: float
    fine_step: float
    fine_bins: int
    fine_span_low: float  # fine grid start relative to coarse freq [Hz]
    fine_noncoh: int      # non-coherent 1-code rounds in fine search
    combine_weighted: bool  # B1C sqrt(11)/sqrt(29) weighting
    bin_chunk: int
    prn_chunk: int
    exclude_chip_samples: int  # B2a second-peak exclusion half-width


@dataclasses.dataclass
class AcqResults:
    """Per-PRN acquisition outputs (0-based code phase in samples)."""

    prns: np.ndarray          # (P,) PRN numbers searched
    carr_freq: np.ndarray     # (P,) acquired carrier freq (IF+Doppler) [Hz]
    code_phase: np.ndarray    # (P,) 0-based sample offset of code start
    peak_metric: np.ndarray   # (P,) detection metric
    detected: np.ndarray      # (P,) bool, metric > threshold
    coarse_freq: np.ndarray   # (P,) coarse-bin frequency [Hz]

    def detected_prns(self) -> np.ndarray:
        return self.prns[self.detected]


def make_acq_config(s: Settings) -> AcqConfig:
    # bin_chunk/prn_chunk bound the per-step (PRN x bin x n_fft) working
    # set of coarse_search; they are not yet sized on the current device
    spc = s.samples_per_code
    if s.signal == Signal.B2A:
        n_coh = spc
        fine_bins = int(round(s.acq_step / s.acq_fine_step)) + 1
        fine_span_low = -s.acq_step / 2.0
        fine_noncoh = s.acq_noncoh_rounds
        combine_weighted = False
        bin_chunk, prn_chunk = 13, 16
    else:
        n_coh = int(round(spc / 10 * s.acq_coh_ms))
        fine_bins = 2 * int(round(s.acq_step / s.acq_fine_step)) + 1
        fine_span_low = -s.acq_step
        fine_noncoh = 1
        combine_weighted = True
        bin_chunk, prn_chunk = 3, 8
    # FFT length: power of two >= one code period of search span plus
    # the coherent window, so every lag in [0, spc) is a full *linear*
    # correlation (the reference's 2x zero-pad circular trick,
    # acquisition.m:176-180, minus its wraparound artifacts).  Power-of-two
    # lengths avoid large-prime FFT sizes; whether a smaller smooth length
    # is faster on the current device is not yet measured.
    n_fft = _pow2_ceil(spc + n_coh)
    return AcqConfig(
        signal=s.signal,
        fs=s.sampling_freq,
        n_fft=n_fft,
        n_search=spc,
        n_coh=n_coh,
        samples_per_code=spc,
        n_bins=s.num_doppler_bins,
        freq_base=s.intermediate_freq - s.acq_search_band,
        freq_step=s.acq_step,
        fine_step=s.acq_fine_step,
        fine_bins=fine_bins,
        fine_span_low=fine_span_low,
        fine_noncoh=fine_noncoh,
        combine_weighted=combine_weighted,
        bin_chunk=bin_chunk,
        prn_chunk=prn_chunk,
        exclude_chip_samples=int(math.ceil(s.sampling_freq / s.code_freq_basis)) * 2,
    )


def acq_code_tables(s: Settings, prns: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(P, n_coh) int8 sampled data/pilot local codes for the coarse search.

    B2a: one full 1 ms code period (makeB2aDataTable semantics).
    B1C: first acq_coh_ms ms of the 10 ms BOC(1,1) table (makeDataTable).
    """
    cfg = make_acq_config(s)
    d, q = full_code_tables(s, prns)
    return d[:, : cfg.n_coh], q[:, : cfg.n_coh]


def full_code_tables(s: Settings, prns) -> tuple[np.ndarray, np.ndarray]:
    """(P, samples_per_code) int8 full-period ceil-sampled tables.

    Cached: Settings is frozen/hashable and re-sampling 63 PRNs at the
    reference rate costs seconds of host time per acquire() call."""
    return _full_code_tables_cached(s, tuple(int(p) for p in prns))


@functools.lru_cache(maxsize=8)
def _full_code_tables_cached(s: Settings, prns) -> tuple[np.ndarray, np.ndarray]:
    if s.signal == Signal.B2A:
        data = b2a_codes_matrix(pilot=False)
        pilot = b2a_codes_matrix(pilot=True)
        d = np.stack([
            sample_chips(data[p - 1], s.sampling_freq, s.code_freq_basis,
                         s.samples_per_code) for p in prns
        ])
        q = np.stack([
            sample_chips(pilot[p - 1], s.sampling_freq, s.code_freq_basis,
                         s.samples_per_code) for p in prns
        ])
    else:
        d = np.stack([
            sample_chips(b1c_data_boc11(p), s.sampling_freq,
                         2 * s.code_freq_basis, s.samples_per_code)
            for p in prns
        ])
        q = np.stack([
            sample_chips(b1c_pilot_boc11(p), s.sampling_freq,
                         2 * s.code_freq_basis, s.samples_per_code)
            for p in prns
        ])
    return d.astype(np.int8), q.astype(np.int8)


def fine_code_tables(s: Settings, prns) -> tuple[np.ndarray, np.ndarray]:
    """Local codes for the fine search, (P, fine_noncoh*samples_per_code).

    B1C: the full-period ceil-sampled tables (acquisition.m:257-262).
    B2a: floor-sampled codes tiled over fine_noncoh periods
    (B2a acquisition.m:279-284).
    """
    return _fine_code_tables_cached(s, tuple(int(p) for p in prns))


@functools.lru_cache(maxsize=8)
def _fine_code_tables_cached(s: Settings, prns) -> tuple[np.ndarray, np.ndarray]:
    cfg = make_acq_config(s)
    if s.signal == Signal.B1C:
        return full_code_tables(s, prns)
    data = b2a_codes_matrix(pilot=False)
    pilot = b2a_codes_matrix(pilot=True)
    n = cfg.fine_noncoh * s.samples_per_code
    d = np.stack([
        sample_chips_floor(data[p - 1], s.sampling_freq, s.code_freq_basis, n)
        for p in prns
    ])
    q = np.stack([
        sample_chips_floor(pilot[p - 1], s.sampling_freq, s.code_freq_basis, n)
        for p in prns
    ])
    return d.astype(np.int8), q.astype(np.int8)


@functools.lru_cache(maxsize=8)
def _device_acq_tables(s: Settings, prns):
    """Device-resident (d8, p8, fd, fp): uploaded once per (Settings,
    prns) instead of ~190 MB of code tables per acquire() call.

    Retention note: each (Settings, prns) key pins ~190 MB of device
    memory for the process lifetime (up to 8 entries, and distinct PRN
    subsets or Settings variants each add one).  Memory-constrained
    multi-config runs should call `clear_acq_caches()` between
    configs."""
    d8, p8 = acq_code_tables(s, np.asarray(prns))
    fd, fp = fine_code_tables(s, np.asarray(prns))
    return (jnp.asarray(d8), jnp.asarray(p8),
            jnp.asarray(fd), jnp.asarray(fp))


def clear_acq_caches() -> None:
    """Drop all cached host/device acquisition code tables (frees the
    device allocations pinned by `_device_acq_tables`)."""
    _device_acq_tables.cache_clear()
    _full_code_tables_cached.cache_clear()
    _fine_code_tables_cached.cache_clear()


def glrt_noise_power(window) -> float:
    """GLRT denominator sqrt(var(x) * N) (BDS-3_B1C/acquisition.m:150).

    For complex IQ captures the variance must be taken over the complex
    samples (E|x|^2 - |E x|^2, i.e. I and Q power combined), so the dtype
    is preserved until after the complex check — a premature real cast
    would silently drop the Q component and bias the detection metric
    by sqrt(2)."""
    win = np.asarray(window)
    win = win.astype(np.complex128 if np.iscomplexobj(win) else np.float64)
    return math.sqrt(float(np.var(win).real) * win.shape[0])


def _combine(abs_d: jnp.ndarray, abs_p: jnp.ndarray, cfg: AcqConfig) -> jnp.ndarray:
    if cfg.combine_weighted:
        return (abs_d * np.sqrt(11.0) + abs_p * np.sqrt(29.0)) / np.sqrt(40.0)
    return abs_d + abs_p


def _as_device_signal(signal: jnp.ndarray) -> jnp.ndarray:
    if jnp.iscomplexobj(signal):
        return signal.astype(jnp.complex64)
    return signal.astype(jnp.float32)


def _code_spectra(codes: jnp.ndarray, n_fft: int, n_coh: int) -> jnp.ndarray:
    padded = jnp.zeros((codes.shape[0], n_fft), jnp.float32)
    padded = padded.at[:, :n_coh].set(codes[:, :n_coh].astype(jnp.float32))
    return jnp.conj(jnp.fft.fft(padded, axis=-1))


@functools.partial(jax.jit, static_argnames=("cfg",))
def coarse_search(
    signal: jnp.ndarray,       # (>= n_fft,) float32 (real) or complex64
    data_codes: jnp.ndarray,   # (P, n_coh) int8
    pilot_codes: jnp.ndarray,  # (P, n_coh) int8
    a_bins: jnp.ndarray,       # (n_bins_pad,) float32 phase table a
    c1_bins: jnp.ndarray,      # (n_bins_pad,) float32 phase table c1
    cfg: AcqConfig,
):
    """Full (PRN x Doppler x phase) search -> per-PRN (peak, bin, phase)."""
    P = data_codes.shape[0]
    sig = _as_device_signal(signal[: cfg.n_fft])

    n_pc = -(-P // cfg.prn_chunk)
    P_pad = n_pc * cfg.prn_chunk
    Cd = jnp.pad(_code_spectra(data_codes, cfg.n_fft, cfg.n_coh),
                 ((0, P_pad - P), (0, 0))).reshape(n_pc, cfg.prn_chunk, cfg.n_fft)
    Cp = jnp.pad(_code_spectra(pilot_codes, cfg.n_fft, cfg.n_coh),
                 ((0, P_pad - P), (0, 0))).reshape(n_pc, cfg.prn_chunk, cfg.n_fft)

    n_bc = a_bins.shape[0] // cfg.bin_chunk
    valid = (jnp.arange(n_bc * cfg.bin_chunk) < cfg.n_bins).astype(jnp.float32)
    a_c = a_bins.reshape(n_bc, cfg.bin_chunk)
    c1_c = c1_bins.reshape(n_bc, cfg.bin_chunk)
    valid_c = valid.reshape(n_bc, cfg.bin_chunk)

    init = (
        jnp.full((P_pad,), -jnp.inf, jnp.float32),
        jnp.zeros((P_pad,), jnp.int32),
        jnp.zeros((P_pad,), jnp.int32),
    )

    def bin_step(carry, xs):
        bchunk_idx, a_b, c1_b, v_b = xs
        carr = carrier_table(a_b, c1_b, cfg.n_fft)       # (B_c, n_fft) c64
        mixed = jnp.fft.fft(carr * sig[None, :], axis=-1)

        def prn_step(_, codes):
            cd, cp = codes
            corr_d = jnp.abs(jnp.fft.ifft(mixed[None] * cd[:, None, :], axis=-1))
            corr_p = jnp.abs(jnp.fft.ifft(mixed[None] * cp[:, None, :], axis=-1))
            comb = _combine(corr_d, corr_p, cfg)[:, :, : cfg.n_search]
            comb = comb * v_b[None, :, None] + (v_b[None, :, None] - 1.0) * 1e30
            flat = comb.reshape(cfg.prn_chunk, -1)
            idx = jnp.argmax(flat, axis=-1)
            val = jnp.take_along_axis(flat, idx[:, None], axis=-1)[:, 0]
            return None, (val, (idx // cfg.n_search).astype(jnp.int32),
                          (idx % cfg.n_search).astype(jnp.int32))

        _, (vals, bs, phs) = jax.lax.scan(prn_step, None, (Cd, Cp))
        vals = vals.reshape(P_pad)
        bs = bs.reshape(P_pad) + bchunk_idx * cfg.bin_chunk
        phs = phs.reshape(P_pad)
        best_v, best_b, best_p = carry
        better = vals > best_v
        return (
            jnp.where(better, vals, best_v),
            jnp.where(better, bs, best_b),
            jnp.where(better, phs, best_p),
        ), None

    (best_v, best_b, best_p), _ = jax.lax.scan(
        bin_step, init, (jnp.arange(n_bc, dtype=jnp.int32), a_c, c1_c, valid_c)
    )
    return best_v[:P], best_b[:P], best_p[:P]


@functools.partial(jax.jit, static_argnames=("cfg",))
def second_peak(
    signal: jnp.ndarray,
    data_codes: jnp.ndarray,
    pilot_codes: jnp.ndarray,
    best_bin: jnp.ndarray,     # (P,) int32
    best_phase: jnp.ndarray,   # (P,) int32
    a_bins: jnp.ndarray,
    c1_bins: jnp.ndarray,
    cfg: AcqConfig,
) -> jnp.ndarray:
    """B2a second-highest peak in the winning Doppler row, excluding +-1
    chip around the main peak.

    The reference excludes a +-1 chip zone with non-circular clipping over
    its 2 ms buffer (B2a acquisition.m:223-249); with our one-code-period
    search domain the exclusion is circular modulo the code period — same
    statistic without the buffer-edge artifacts."""
    sig = _as_device_signal(signal[: cfg.n_fft])
    carr = carrier_table(a_bins[best_bin], c1_bins[best_bin], cfg.n_fft)
    mixed = jnp.fft.fft(carr * sig[None, :], axis=-1)   # (P, N)
    row = _combine(
        jnp.abs(jnp.fft.ifft(mixed * _code_spectra(data_codes, cfg.n_fft, cfg.n_coh), axis=-1)),
        jnp.abs(jnp.fft.ifft(mixed * _code_spectra(pilot_codes, cfg.n_fft, cfg.n_coh), axis=-1)),
        cfg,
    )[:, : cfg.n_search]
    n = cfg.n_search
    j = jnp.arange(n)[None, :]
    ph = best_phase[:, None]
    chip = cfg.exclude_chip_samples
    dist = jnp.abs((j - ph + n // 2) % n - n // 2)
    mask = dist >= chip
    return jnp.max(jnp.where(mask, row, -jnp.inf), axis=-1)


@functools.partial(jax.jit, static_argnames=("cfg",))
def fine_search(
    signal: jnp.ndarray,
    fine_data: jnp.ndarray,      # (P, n_win) int8 local data code
    fine_pilot: jnp.ndarray,     # (P, n_win) int8 local pilot code
    code_phase: jnp.ndarray,     # (P,) int32, 0-based
    a_coarse: jnp.ndarray,       # (P,) phase tables of per-PRN coarse freq
    c1_coarse: jnp.ndarray,      # (P,)
    a_off: jnp.ndarray,          # (F,) phase tables of the shared offsets
    c1_off: jnp.ndarray,         # (F,)
    cfg: AcqConfig,
) -> jnp.ndarray:
    """Fine carrier search; returns (P, F) scores (argmax done on host).

    The fine frequency f[p, f] = coarse[p] + offset[f], so the carrier
    factorizes: e^{-j2pi f s} = e^{-j2pi coarse_p s} * e^{-j2pi off_f s}.
    Mixing the code-wiped windows by the per-PRN coarse carrier and
    contracting against ONE shared (F, seg) offset matrix replaces the
    (P, F, seg) carrier cube of the naive form (~0.9 GB device-memory traffic at
    the B2a reference rate — it made fine search slower than the whole
    coarse cube search)."""
    spc = cfg.samples_per_code
    n_win = cfg.fine_noncoh * spc
    sig = _as_device_signal(signal)
    start = jnp.where(code_phase + n_win > sig.shape[0],
                      code_phase - spc, code_phase)
    start = jnp.clip(start, 0)
    windows = jax.vmap(
        lambda s0: jax.lax.dynamic_slice(sig, (s0,), (n_win,))
    )(start)  # (P, n_win)

    if cfg.signal == Signal.B1C:
        windows = windows - jnp.mean(windows, axis=-1, keepdims=True)
        seg = n_win
    else:
        seg = spc
    k_rounds = n_win // seg
    carr_c = carrier_table(a_coarse, c1_coarse, n_win)   # (P, n_win) c64
    offs = carrier_table(a_off, c1_off, seg)             # (F, seg) c64
    wm = windows.astype(carr_c.dtype) * carr_c
    x_d = (wm * fine_data.astype(jnp.float32)).reshape(-1, k_rounds, seg)
    x_p = (wm * fine_pilot.astype(jnp.float32)).reshape(-1, k_rounds, seg)

    def score(x):
        # full f32: a TF32 contraction over ~1e5-sample segments would
        # blur neighbouring 25 Hz fine bins
        c = jnp.einsum("pks,fs->pfk", x, offs,
                       precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(jnp.abs(c), axis=-1)       # (P, F)

    if cfg.combine_weighted:
        return (score(x_d) * 11.0 + score(x_p) * 29.0) / 40.0
    return score(x_d) + score(x_p)


def acquire(
    signal: np.ndarray,
    settings: Settings,
    prns=None,
) -> AcqResults:
    """Host orchestrator: coarse search -> metric -> fine carrier estimate.

    `signal` must cover n_fft samples plus the fine window (B2a:
    (2+fine_noncoh) ms; B1C: (10+X) ms + one code period).
    """
    s = settings
    prns = np.asarray(prns if prns is not None else s.acq_satellite_list)

    if s.resampling and s.sampling_freq > s.resampling_threshold:
        # bandpass-sampling decimation (acquisition.m:52-124); results are
        # mapped back to the original rate below.  The zero-phase filter +
        # decimate runs as one device FFT conv + gather
        # (resample_signal_device); the host scipy filtfilt in
        # resample_signal stays as its reference.
        from bds3_tpu.acquire.resample import (
            plan_resample,
            recover_results,
            resample_signal_device,
        )

        plan = plan_resample(s)
        signal = resample_signal_device(signal, s, plan)
        s_low = dataclasses.replace(
            s, sampling_freq=plan.new_fs, intermediate_freq=plan.new_if,
            resampling=False,
        )
        acq = acquire(signal, s_low, prns)
        return recover_results(acq, plan)

    cfg = make_acq_config(s)
    d8, p8, fd_dev, fp_dev = _device_acq_tables(
        s, tuple(int(p) for p in prns))
    sig = jnp.asarray(signal)

    n_bc = -(-cfg.n_bins // cfg.bin_chunk)
    bins = np.arange(n_bc * cfg.bin_chunk)
    bin_freqs = cfg.freq_base + cfg.freq_step * bins
    a_bins, c1_bins = phase_tables(bin_freqs, cfg.fs)

    best_v, best_b, best_p = coarse_search(
        sig, d8, p8, jnp.asarray(a_bins), jnp.asarray(c1_bins), cfg
    )
    best_v = np.asarray(best_v)
    best_b = np.asarray(best_b, dtype=np.int32)
    best_p = np.asarray(best_p, dtype=np.int32)
    coarse_freq = cfg.freq_base + cfg.freq_step * best_b.astype(np.float64)

    if s.signal == Signal.B2A:
        second = np.asarray(second_peak(
            sig, d8, p8, jnp.asarray(best_b), jnp.asarray(best_p),
            jnp.asarray(a_bins), jnp.asarray(c1_bins), cfg,
        ))
        metric = best_v / second
    else:
        sig_power = glrt_noise_power(signal[: cfg.n_coh])
        metric = best_v / sig_power

    offsets = cfg.fine_span_low + cfg.fine_step * np.arange(cfg.fine_bins)
    fine_freqs = coarse_freq[:, None] + offsets[None, :]  # (P, F) float64
    a_c, c1_c = phase_tables(coarse_freq, cfg.fs)
    a_o, c1_o = phase_tables(offsets, cfg.fs)
    scores = np.asarray(fine_search(
        sig, fd_dev, fp_dev, jnp.asarray(best_p),
        jnp.asarray(a_c), jnp.asarray(c1_c),
        jnp.asarray(a_o), jnp.asarray(c1_o), cfg,
    ))
    best_fine = np.argmax(scores, axis=-1)
    carr = fine_freqs[np.arange(len(prns)), best_fine]
    carr = np.where(carr == 0.0, 1.0, carr)  # acquisition.m:303-305
    detected = metric > s.acq_threshold
    return AcqResults(
        prns=prns,
        carr_freq=carr,
        code_phase=best_p.astype(np.int64),
        peak_metric=metric,
        detected=detected,
        coarse_freq=coarse_freq,
    )
