"""The tracking epoch scan: closed-loop DLL/PLL over `lax.scan`, channels
vmapped.

Redesign of the reference per-channel, per-epoch Python-style
loops (`BDS-3_B2a/tracking.m:195-436`, `BDS-3_B1C/WB_tracking.m:206-496`,
`NB_tracking.m`): the only true sequential dependency is the small scalar
loop state (NCO phases/frequencies, filter memories), so each scan step
does one *epoch* of work — ~1e5-1e6 samples of mix+correlate across
all channels at once — and `lax.scan` carries the loop state.  The
variable MATLAB `blksize` becomes a fixed-size masked window (SURVEY.md
section 7.4 item 2).

Memory-access design: the scan body never touches the large signal block.
Epoch windows are pre-gathered *outside* the scan at per-channel nominal
strides (cursor0 + e*floor(expected advance) - guard), so every scan step
reads static-shape windows; the few-sample difference between
the true NCO cursor and the nominal window start rides in a per-epoch
`off` scalar folded into the phase bases and the validity mask.

Phase generation follows the split-table scheme described in
track/state.py; behavioral parity notes for each discriminator are cited
inline.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bds3_tpu.config import Signal, TrackMode
from bds3_tpu.track.state import SPLIT, ChannelConsts, ChannelState, TrackConfig

W11 = float(np.sqrt(29.0 / 33.0))  # QMBOC pilot BOC(1,1) amplitude
W61 = float(np.sqrt(4.0 / 33.0))   # QMBOC pilot BOC(6,1) amplitude

START_GUARD = 16  # window starts this many samples before the nominal cursor
CODE_PAD = 16     # circular padding of code tables (both correlator paths)


def window_length(cfg: TrackConfig) -> int:
    """Static pre-gathered window length (SPLIT-aligned, see state.py)."""
    return cfg.n_win


def _code_indices(cfg: TrackConfig, m: int, ck_int, ck_frac,
                  base_chips, d_step, k_idx, r_f, j_f):
    """Per-sample gather index into an m-entries-per-chip table.

    Reproduces the reference indexing `ceil(tcode*m)` with circular wrap
    (local-code pad [end, code, first], e.g. tracking.m:156-164): 0-based
    index = (ceil(chi*m) - 1) mod (L*m).  base_chips already includes the
    epoch code-phase remainder, the tap offset, and the -off*step window
    correction."""
    lm = cfg.code_length * m
    sm = jnp.float32(cfg.step_base * m)
    frac = base_chips * m + ck_frac[k_idx] + r_f * sm + j_f * (d_step * m)
    idx = ck_int[k_idx] + jnp.ceil(frac).astype(jnp.int32) - 1
    return jnp.mod(idx, lm)


def _epoch(cfg: TrackConfig, tables, consts_row, state_row, win, start):
    """One tracking epoch for one channel (vmapped over channels).

    win: (n_win,) pre-gathered samples beginning at stream index `start`.
    """
    (cursor, rem_code, rem_cyc, d_cyc, d_step,
     code_nco, code_error, d1_carr, d2_carr) = state_row
    carr_t, a_base, q0_cyc, init_dstep, adv_int = consts_row

    n = win.shape[0]
    i32 = jnp.arange(n, dtype=jnp.int32)

    # offset of the true epoch start inside the nominal window
    off = cursor - start
    off_f = off.astype(jnp.float32)
    bucketish = cfg.correlator == "bucket"
    if bucketish:
        # keep per-sample index tables STATIC (no traced-offset int
        # div/mod per sample) and fold `off` into scalar phase bases:
        # theta(j) = rem + j*f == (rem - off*f) + i*f with j = i - off.
        j_f = i32.astype(jnp.float32)
        k_idx = i32 // SPLIT
        r_f = (i32 % SPLIT).astype(jnp.float32)
    else:
        j32 = i32 - off                  # sample index within the epoch
        j_pos = jnp.maximum(j32, 0)
        j_f = j_pos.astype(jnp.float32)
        k_idx = j_pos // SPLIT
        r_f = (j_pos % SPLIT).astype(jnp.float32)

    # --- blksize = ceil((L - rem)/step) (tracking.m:230-233) -------------
    e_rel = d_step / jnp.float32(cfg.step_base)       # (step-base)/base
    corr = 1.0 - e_rel + e_rel * e_rel                # ~= 1/(1+e)
    resid = cfg.q0_frac - (rem_code / jnp.float32(cfg.step_base)
                           + (cfg.q0_int + cfg.q0_frac) * e_rel) * corr
    delta = jnp.ceil(resid).astype(jnp.int32)
    blksize = cfg.q0_int + delta

    mask = ((i32 >= off) & (i32 < off + blksize)).astype(jnp.float32)

    # --- local carrier (WB_tracking.m:329-346, e^{-j theta}) -------------
    rem_eff = rem_cyc - off_f * (a_base + d_cyc) if bucketish else rem_cyc
    cyc = jnp.mod(carr_t[k_idx] + rem_eff + r_f * a_base + j_f * d_cyc,
                  1.0)
    ang = (2.0 * np.pi) * cyc
    c, s = jnp.cos(ang), jnp.sin(ang)
    if cfg.complex_input:
        xr, xi = jnp.real(win), jnp.imag(win)
        i_bb = (xr * c + xi * s) * mask
        q_bb = (xi * c - xr * s) * mask
    else:
        x = win.astype(jnp.float32)
        i_bb = x * c * mask
        q_bb = -(x * s) * mask

    if bucketish:
        # Prefix sums once per epoch; each correlator then needs only
        # ~L boundary lookups instead of N per-sample gathers.
        p_iq = jnp.stack([
            jnp.concatenate([jnp.zeros(1, jnp.float32), jnp.cumsum(i_bb)]),
            jnp.concatenate([jnp.zeros(1, jnp.float32), jnp.cumsum(q_bb)]),
        ], axis=-1)                           # (n_win+1, 2)

    def correlate(table, m, ck, off_chips):
        base = rem_code + off_chips
        if not bucketish:
            idx = _code_indices(cfg, m, ck[0], ck[1], base, d_step,
                                k_idx, r_f, j_f)
            cv = table[idx + CODE_PAD].astype(jnp.float32)
            return jnp.sum(cv * i_bb), jnp.sum(cv * q_bb)

        # --- prefix-sum (bucket) correlator --------------------------------
        # Exact regrouping of sum_j bb[j]*chips[ceil(chi(j)*m)-1]: bucket k
        # spans samples j in ((k - base*m)/sm, (k+1 - base*m)/sm], so its
        # contribution is a difference of prefix sums at the boundary.
        lm = cfg.code_length * m
        inv0 = 1.0 / (cfg.step_base * m)          # host f64
        inv0_int = int(np.floor(inv0))
        inv0_frac = float(inv0 - inv0_int)
        smm = jnp.float32(cfg.step_base * m) + d_step * m
        inv = 1.0 / smm
        dinv = inv - jnp.float32(inv0_int) - jnp.float32(inv0_frac)
        k_i = jnp.arange(-CODE_PAD, lm + CODE_PAD + 1, dtype=jnp.int32)
        k_f = k_i.astype(jnp.float32)
        frac_part = k_f * jnp.float32(inv0_frac) + k_f * dinv \
            - (base * m) * inv
        j_k = k_i * inv0_int + jnp.floor(frac_part).astype(jnp.int32) + 1
        # window-domain boundary; past off+blk the (masked) prefix is
        # constant, so clipping to the last stored entry is exact
        iw = jnp.clip(j_k + off, 0, p_iq.shape[0] - 1)
        g = p_iq[iw]                              # (lm + 2*CODE_PAD + 1, 2)
        b_iq = g[1:] - g[:-1]                     # (lm + 2*CODE_PAD, 2)
        cv = table.astype(jnp.float32)            # extended chips
        # full f32: the boundary differences of ~1e4-1e5 prefix sums must
        # not be rounded to TF32 on GPUs that default to it
        corr = jnp.dot(cv, b_iq, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        return corr[0], corr[1]

    ck_d = tables["ck_data"]
    spc = jnp.float32(cfg.spacing)
    out = {}
    taps = [("d", tables["data"], cfg.m_data, ck_d)]
    if cfg.use_pilot:
        taps.append(("p11", tables["pilot11"], cfg.m_data, ck_d))
    if cfg.wideband:
        taps.append(("p61", tables["pilot61"], cfg.m_p61, tables["ck_p61"]))
    for name, tab, m, ck in taps:
        # "split" runs the BOC(6,1) bank at its own narrow spacing —
        # inside the +-1/23-chip ACF main peak (config.dll_spacing_boc61)
        fspc = jnp.float32(cfg.spacing61) \
            if (name == "p61" and cfg.wb_code_blend == "split") else spc
        out[f"{name}_ie"], out[f"{name}_qe"] = correlate(tab, m, ck, -fspc)
        out[f"{name}_ip"], out[f"{name}_qp"] = correlate(tab, m, ck, 0.0)
        out[f"{name}_il"], out[f"{name}_ql"] = correlate(tab, m, ck, fspc)

    # --- discriminators ---------------------------------------------------
    inv2pi = 1.0 / (2.0 * np.pi)

    def eml(ie, qe, il, ql):
        e = jnp.sqrt(ie * ie + qe * qe)
        l = jnp.sqrt(il * il + ql * ql)
        return (e - l) / (e + l)

    carr_d = jnp.arctan(out["d_qp"] / out["d_ip"]) * inv2pi
    code_d = eml(out["d_ie"], out["d_qe"], out["d_il"], out["d_ql"])
    if cfg.signal == Signal.B1C:
        code_d = code_d * (1.0 - cfg.spacing)  # WB_tracking.m:409-410

    if not cfg.use_pilot:
        carr_err, code_err = carr_d, code_d
    elif cfg.signal == Signal.B2A:
        # pilot pi/2 ahead of data; rotate back (tracking.m:341-353)
        carr_p = jnp.arctan(-out["p11_ip"] / out["p11_qp"]) * inv2pi
        code_p = eml(out["p11_ie"], out["p11_qe"], out["p11_il"], out["p11_ql"])
        carr_err = 0.5 * (carr_d + carr_p)
        code_err = 0.5 * (code_d + code_p)
    elif not cfg.wideband:
        # B1C narrowband 11/29 power weighting (NB_tracking.m:353-384)
        carr_p = jnp.arctan(-out["p11_ip"] / out["p11_qp"]) * inv2pi
        code_p = eml(out["p11_ie"], out["p11_qe"], out["p11_il"],
                     out["p11_ql"]) * (1.0 - cfg.spacing)
        carr_err = (carr_d * 11.0 + carr_p * 29.0) / 40.0
        code_err = (code_d * 11.0 + code_p * 29.0) / 40.0
    else:
        # B1C wideband QMBOC composite pilot (WB_tracking.m:374-396,414-419)
        for x in ("e", "p", "l"):
            out[f"p_i{x}"] = -W61 * out[f"p61_i{x}"] + W11 * out[f"p11_q{x}"]
            out[f"p_q{x}"] = -W61 * out[f"p61_q{x}"] - W11 * out[f"p11_i{x}"]
        carr_p = jnp.arctan(out["p_qp"] / out["p_ip"]) * inv2pi
        carr_err = (carr_d + 3.0 * carr_p) / 4.0
        if cfg.wb_code_blend == "nb":
            # data + BOC(1,1)-pilot 11/29 code DLL (the NB blend) with
            # the composite pilot retained for the carrier loop above:
            # the composite-envelope E-L equilibrium is Doppler-
            # dependent by up to ~1 sample (BOC(6,1) oscillatory ACF at
            # 0.06-chip spacing; measured on synthesized truth — see
            # Settings.wb_code_blend)
            code_p11 = eml(out["p11_ie"], out["p11_qe"], out["p11_il"],
                           out["p11_ql"]) * (1.0 - cfg.spacing)
            code_err = (code_d * 11.0 + code_p11 * 29.0) / 40.0
        elif cfg.wb_code_blend == "split":
            # Per-component envelope discriminators, slope-normalized
            # then blended 0.3/0.7: the BOC(6,1) bank runs at its own
            # narrow spacing (its +-0.06 taps sit past the ACF sign
            # reversal — a false equilibrium, measured +-6.4 m) and its
            # ~12x-steeper main peak carries most of the code-loop
            # weight; BOC(1,1) keeps the pull-in range.  No composite
            # cross term, so no Doppler-dependent bias (measured: the
            # composite blend swings -1.1..+1.2 m over +-4 kHz).
            # eml slope = -R'(d)/R(d): BOC(1,1) 3/(1-3d); BOC(6,1)
            # 23/(1-23*d61) inside |tau| < 1/23 chip.
            d61 = cfg.spacing61
            g61 = 3.0 * (1.0 - cfg.spacing) * (1.0 - 23.0 * d61) \
                / (23.0 * (1.0 - 3.0 * cfg.spacing))
            code_p11 = eml(out["p11_ie"], out["p11_qe"], out["p11_il"],
                           out["p11_ql"]) * (1.0 - cfg.spacing)
            code_p61 = eml(out["p61_ie"], out["p61_qe"], out["p61_il"],
                           out["p61_ql"]) * g61
            code_p = 0.3 * code_p11 + 0.7 * code_p61
            f = cfg.dll_factor
            code_err = code_d * f + code_p * (1.0 - f)
        elif cfg.wb_code_blend == "dotprod":
            # Coherent normalized dot-product discriminator on the
            # composite correlators: D = ((E-L) . P) / |P|^2 — linear in
            # the early-late difference, so the |.| envelope's cross-term
            # rectification never enters
            dp_num = (out["p_ie"] - out["p_il"]) * out["p_ip"] \
                + (out["p_qe"] - out["p_ql"]) * out["p_qp"]
            dp_den = out["p_ip"] ** 2 + out["p_qp"] ** 2
            code_p = 0.25 * dp_num / dp_den * (1.0 - cfg.spacing)
            f = cfg.dll_factor
            code_err = code_d * f + code_p * (1.0 - f)
        else:
            code_p = eml(out["p_ie"], out["p_qe"], out["p_il"],
                         out["p_ql"]) * (1.0 - cfg.spacing)
            f = cfg.dll_factor
            code_err = code_d * f + code_p * (1.0 - f)

    # --- loop filters (tracking.m:355-389) -------------------------------
    d2_new = d2_carr + carr_err * cfg.pf3
    d1_new = d2_new + carr_err * cfg.pf2 + d1_carr
    carr_nco = d1_new + carr_err * cfg.pf1
    d_cyc_new = carr_nco / jnp.float32(cfg.fs)

    code_nco_new = code_nco + (cfg.tau2 / cfg.tau1) * (code_err - code_error) \
        + code_err * (cfg.int_time / cfg.tau1)
    d_step_new = init_dstep - code_nco_new / jnp.float32(cfg.fs)

    # --- phase remainders (tracking.m:156-164, 297-305) ------------------
    delta_f = delta.astype(jnp.float32)
    blk_f = blksize.astype(jnp.float32)
    rem_cyc_new = jnp.mod(
        rem_cyc + q0_cyc + delta_f * a_base + blk_f * d_cyc, 1.0
    )
    q0_step_minus_l = jnp.float32(cfg.q0_int * cfg.step_base - cfg.code_length)
    rem_code_new = rem_code + q0_step_minus_l \
        + delta_f * jnp.float32(cfg.step_base) \
        + blk_f * d_step

    new_state = (cursor + blksize, rem_code_new, rem_cyc_new, d_cyc_new,
                 d_step_new, code_nco_new, code_err, d1_new, d2_new)

    out.update(
        carr_err=carr_err, code_err=code_err,
        carr_nco=carr_nco, code_nco=code_nco_new,
        d_cyc=d_cyc, d_step=d_step,
        rem_code_phase=rem_code, rem_carr_cyc=rem_cyc,
        blksize=blksize,
    )
    return new_state, out


@functools.partial(jax.jit, static_argnames=("cfg",))
def track_block(
    cfg: TrackConfig,
    block: jnp.ndarray,          # (B,) int8 (real) or complex64
    data_tables: jnp.ndarray,    # (C, L*m_data) int8
    pilot11_tables: jnp.ndarray,  # (C, L*m_data) int8 (unused if data-only)
    pilot61_tables: jnp.ndarray,  # (C, L*12) int8 (unused unless WB)
    ck_data_int: jnp.ndarray,    # (k_max,) int32
    ck_data_frac: jnp.ndarray,   # (k_max,) f32
    ck_p61_int: jnp.ndarray,
    ck_p61_frac: jnp.ndarray,
    consts: ChannelConsts,
    state: ChannelState,
):
    """Run cfg.epochs_per_block epochs for all channels; returns
    (new_state, outputs dict of (W, C) arrays)."""
    W = cfg.epochs_per_block
    n_win = window_length(cfg)

    cursor0 = jnp.asarray(state.cursor, jnp.int32)             # (C,)
    adv_int = jnp.asarray(consts.adv_int, jnp.int32)           # (C,)
    e_idx = jnp.arange(W, dtype=jnp.int32)
    starts = cursor0[None, :] + e_idx[:, None] * adv_int[None, :] \
        - START_GUARD                                           # (W, C)
    # 128-align the window starts (the off/phase folding absorbs the
    # shift exactly) so the pre-gather slices whole rows of the reshaped
    # block
    starts = jnp.maximum((starts >> 7) << 7, 0)

    # pre-gather all epoch windows with static-shape slices (outside the
    # sequential scan); tail pad so the row slice never clamps
    pad = (-block.shape[0]) % 128 + n_win
    b2 = jnp.pad(block, (0, pad)).reshape(-1, 128)
    windows = jax.vmap(jax.vmap(
        lambda s0: jax.lax.dynamic_slice(
            b2, (s0 >> 7, 0), (n_win // 128, 128)).reshape(n_win)
    ))(starts)                                                  # (W, C, n_win)

    def step(carry, xs):
        win_row, start_row = xs

        def one_channel(st_row, dtab, p11tab, p61tab, c_row, w, s0):
            tables = {
                "data": dtab,
                "pilot11": p11tab,
                "pilot61": p61tab,
                "ck_data": (ck_data_int, ck_data_frac),
                "ck_p61": (ck_p61_int, ck_p61_frac),
            }
            return _epoch(cfg, tables, c_row, st_row, w, s0)

        new_state, out = jax.vmap(one_channel)(
            carry, data_tables, pilot11_tables, pilot61_tables,
            tuple(consts)[:5], win_row, start_row)
        # pack all outputs into ONE scan leaf (one stacked output per step)
        names = sorted(out.keys())
        packed = jnp.stack([out[k].astype(jnp.float32) for k in names])
        return new_state, packed

    init = tuple(jnp.asarray(x) for x in state)
    final, packed = jax.lax.scan(step, init, (windows, starts))  # (W, F, C)
    names = output_names(cfg)
    outs = {k: packed[:, i, :] for i, k in enumerate(names)}
    return ChannelState(*final), outs


def output_names(cfg: TrackConfig) -> list[str]:
    """Sorted per-epoch output keys emitted by _epoch for this config."""
    names = [f"d_{c}{t}" for c in ("i", "q") for t in ("e", "p", "l")]
    if cfg.use_pilot:
        names += [f"p11_{c}{t}" for c in ("i", "q") for t in ("e", "p", "l")]
    if cfg.wideband:
        names += [f"p61_{c}{t}" for c in ("i", "q") for t in ("e", "p", "l")]
        names += [f"p_{c}{t}" for c in ("i", "q") for t in ("e", "p", "l")]
    names += ["carr_err", "code_err", "carr_nco", "code_nco",
              "d_cyc", "d_step", "rem_code_phase", "rem_carr_cyc", "blksize"]
    return sorted(names)
