"""Host-side tracking driver: feeds signal blocks to the device scan and
assembles per-epoch results.

Replaces the reference's per-channel sequential file re-reading
(`tracking.m:139-254`): one contiguous signal block per outer step serves
*all* channels (each channel slices at its own cursor), uploaded once to
device memory; the closed-loop state lives on device across the whole run.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from bds3_tpu.config import Settings, Signal
from bds3_tpu.signals.b1c import b1c_data_boc11, b1c_pilot_boc11, b1c_pilot_boc61
from bds3_tpu.signals.b2a import b2a_data_code, b2a_pilot_code
from bds3_tpu.track.scan import track_block
from bds3_tpu.track.state import (
    ChannelInit,
    ChannelState,
    TrackConfig,
    channel_consts,
    code_coarse_tables,
    initial_state,
    make_track_config,
)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "n_blocks", "block_len", "shift", "start0"),
)
def _track_blocks_scan(cfg, signal, data_t, p11_t, p61_t,
                       ckd_i, ckd_f, ck61_i, ck61_f, consts, state,
                       n_blocks, block_len, shift, start0):
    """Whole-run tracking as ONE compiled program: lax.scan over signal
    blocks, each step running cfg.epochs_per_block epochs (the inner
    track_block).  Returns (final ChannelState, (F, n_blocks*W, C) outs).

    The reference streams the file one code period at a time per channel
    (`tracking.m:237-254`); here the device walks the resident capture
    itself — the host issues a single dispatch for the entire run."""
    from bds3_tpu.track.scan import output_names

    names = output_names(cfg)

    def body(carry, _):
        st, s_off = carry
        block = jax.lax.dynamic_slice(signal, (s_off,), (block_len,))
        new_state, outs = track_block(
            cfg, block, data_t, p11_t, p61_t,
            ckd_i, ckd_f, ck61_i, ck61_f, consts, st,
        )
        packed = jnp.stack([outs[k].astype(jnp.float32) for k in names])
        new_state = new_state._replace(cursor=new_state.cursor - shift)
        return (new_state, s_off + shift), packed

    (fin, _), stacked = jax.lax.scan(
        body, (state, jnp.int32(start0)), None, length=n_blocks
    )                                               # (n_blocks, F, W, C)
    nb, F, W, C = stacked.shape
    out = jnp.moveaxis(stacked, 1, 0).reshape(F, nb * W, C)
    return fin, out


class LazyOutputs:
    """Mapping view over the packed (F, E, C) device array: each name is
    sliced (one device dispatch) only when first read.  In lazy
    (download=False) throughput runs only the names the caller touches
    cost a dispatch and a transfer."""

    def __init__(self, stacked_dev, names, n_epochs):
        self._stacked = stacked_dev
        self._idx = {k: i for i, k in enumerate(names)}
        self._n = n_epochs
        self._cache = {}

    def __getitem__(self, k):
        if k not in self._cache:
            self._cache[k] = self._stacked[self._idx[k]][: self._n].T
        return self._cache[k]

    def __contains__(self, k):
        return k in self._idx

    def __iter__(self):
        return iter(self._idx)

    def __len__(self):
        return len(self._idx)

    def keys(self):
        return self._idx.keys()

    def block_until_ready(self):
        """Wait for the device computation WITHOUT downloading: a sync
        point for throughput timing."""
        import jax

        jax.block_until_ready(self._stacked)
        return self

    def realize(self) -> dict:
        """Download the packed array ONCE and return plain numpy (C, E)
        arrays.  Use before host-side analysis loops: per-channel
        indexing of the lazy device slices costs a device dispatch and a
        transfer per access."""
        stacked = np.asarray(self._stacked)
        return {k: np.ascontiguousarray(stacked[i][: self._n].T)
                for k, i in self._idx.items()}

    def items(self):
        return ((k, self[k]) for k in self._idx)


@dataclasses.dataclass
class TrackResults:
    """Per-channel, per-epoch tracking archives (the reference's
    trackResults struct, tracking.m:45-96)."""

    prns: np.ndarray               # (C,)
    acquired_freq: np.ndarray      # (C,) f64
    n_epochs: int
    outputs: dict                  # name -> (C, E) f32 arrays
    absolute_sample: np.ndarray    # (C, E) int64: sample index of epoch END
    carr_freq: np.ndarray          # (C, E) f64 absolute NCO frequency
    code_freq: np.ndarray          # (C, E) f64 absolute code frequency
    int_time: float
    settings: Settings = None
    correlator: str = ""           # which correlator path actually ran

    def prompt(self, name: str) -> np.ndarray:
        return self.outputs[name]


def channel_code_tables(cfg: TrackConfig, inits: list[ChannelInit]):
    """(C, L*m + 2*CODE_PAD) circularly-padded chip tables per channel."""
    from bds3_tpu.track.scan import CODE_PAD

    def ext(arr):
        return np.concatenate(
            [arr[..., -CODE_PAD:], arr, arr[..., :CODE_PAD]], axis=-1
        )

    if cfg.signal == Signal.B2A:
        data = ext(np.stack([b2a_data_code(c.prn) for c in inits]))
        p11 = ext(np.stack([b2a_pilot_code(c.prn) for c in inits]))
        p61 = np.zeros((len(inits), 1), np.int8)
    else:
        data = ext(np.stack([b1c_data_boc11(c.prn) for c in inits]))
        p11 = ext(np.stack([b1c_pilot_boc11(c.prn) for c in inits]))
        if cfg.wideband:
            p61 = ext(np.stack([b1c_pilot_boc61(c.prn) for c in inits]))
        else:
            p61 = np.zeros((len(inits), 1), np.int8)
    return data, p11, p61


def track(
    signal: np.ndarray,
    settings: Settings,
    inits: list[ChannelInit],
    n_epochs: int | None = None,
    epochs_per_block: int = 100,
    correlator: str = "auto",
    download: bool = True,
    sync_each_block: bool = False,
    deadline_s: float | None = None,
    transport: str = "none",
) -> TrackResults:
    """Track all channels for n_epochs integration periods.

    signal: full IF capture, int8/float32 (real) or complex64.  Pass a
    device-resident jax.Array to skip the per-block host->device upload
    (blocks are sliced on-device).
    correlator: "auto" resolves to state.AUTO_CORRELATOR (the variant
    measured fastest within tolerance, docs/PERF.md); "gather"
    (per-sample reference semantics) and "bucket" (prefix-sum
    regrouping) force a path.
    download: when False, TrackResults carries lazy device arrays (no
    device->host transfer) — use for throughput runs / pipelining; call
    np.asarray on the fields (or rerun with download=True) to realize.
    sync_each_block: block on each tracking block's state before
    uploading the next — bounds host memory to ~one in-flight block
    when streaming multi-GB captures whose uploads outrun the device.
    Costs pipelining, so leave False unless IO-bound.
    deadline_s: wall-clock budget for the block loop; when exceeded the
    run returns the epochs tracked so far (partial results, same as a
    short read).  Only effective with sync_each_block=True (async
    dispatch otherwise outruns the clock).
    transport: "int4" packs each host block to 4 bits before upload and
    unpacks on device (io/transport.py — half the host->device bytes).
    Only applies to real int8 host blocks on the per-block path.
    """
    import time as _time

    _t0 = _time.time()
    import jax

    complex_input = np.iscomplexobj(signal)
    # the scan path pre-gathers (W, C, n_win) windows; complex64 samples
    # take 8 bytes each, so complex blocks are capped at 64 epochs
    # (~1 GB at the reference rate)
    if complex_input:
        epochs_per_block = min(epochs_per_block, 64)
    cfg = make_track_config(settings, complex_input, epochs_per_block,
                            correlator)
    if n_epochs is None:
        n_epochs = settings.int_epochs

    C = len(inits)
    consts = channel_consts(cfg, inits, settings)
    data_t, p11_t, p61_t = channel_code_tables(cfg, inits)
    ckd_i, ckd_f = code_coarse_tables(cfg, cfg.m_data)
    if cfg.m_p61:
        ck61_i, ck61_f = code_coarse_tables(cfg, cfg.m_p61)
    else:
        ck61_i, ck61_f = ckd_i, ckd_f

    cursors0 = np.array([c.code_phase for c in inits], dtype=np.int64)
    s0 = int(cursors0.min())
    state = initial_state(cfg, inits, consts, cursors0 - s0)

    data_t = jnp.asarray(data_t)
    p11_t = jnp.asarray(p11_t)
    p61_t = jnp.asarray(p61_t)
    ckd_i, ckd_f = jnp.asarray(ckd_i), jnp.asarray(ckd_f)
    ck61_i, ck61_f = jnp.asarray(ck61_i), jnp.asarray(ck61_f)

    W = cfg.epochs_per_block
    per_epoch_max = cfg.q0_int + 3
    # Fixed block length across every call: a varying length would retrace
    # and recompile the scan each block.  Channel cursor spread is bounded
    # by one code period plus slow differential drift; margins below absorb
    # ~50 s of code-Doppler drift (~1 sample/epoch worst case).
    # includes the pre-gathered window extent (scan.window_length)
    block_len = int(cursors0.max() - s0) + W * per_epoch_max + cfg.n_max \
        + 2 * cfg.q0_int + 4 * per_epoch_max + W + 64
    # Analytic per-block shift (NO device->host sync in the loop: a
    # readback would stall the dispatch pipeline every block).
    # Expected epoch advance per channel = L/(step_base + init_dstep);
    # shift by the slowest channel minus a drift guard.
    exp_adv = cfg.code_length / (cfg.step_base + consts.init_dstep.astype(np.float64))
    # guard 0.1 samples/epoch >> true drift of the tracked code rate vs the
    # acquisition-aided estimate (~1e-3 samples/epoch + satellite dynamics)
    shift = max(int(np.floor(W * (exp_adv.min() - 0.1))), 0)

    # ---- block schedule (host-only arithmetic; NO device sync) ----------
    total = len(signal)
    spread0 = int(cursors0.max() - s0)
    starts = []
    done = 0
    while done < n_epochs:
        # conservative bound on current max cursor without a device sync
        worst = spread0 + int(
            (done // W) * (W * (exp_adv.max() - exp_adv.min()) + 0.1 * W + 2)
        )
        if worst - spread0 > 2 * cfg.q0_int:
            raise RuntimeError(
                "channel cursor spread outgrew the block margin; use a "
                "larger epochs_per_block or re-anchor (very long run)"
            )
        if s0 + worst + W * per_epoch_max + cfg.n_max > total:
            break  # out of data: return partial results (tracking.m:250-254)
        starts.append(s0)
        done += W
        s0 += shift
    if not starts:
        raise ValueError("not enough signal for a single tracking block")
    n_blocks = len(starts)

    # ---- fast path: one lax.scan over blocks = ONE device dispatch ------
    # When the capture is device-resident the whole multi-block run
    # compiles into a single program: no per-block host orchestration
    # (block slicing/stacking dispatches).
    use_scan = (
        isinstance(signal, jax.Array)
        and signal.dtype in (jnp.int8, jnp.float32, jnp.complex64)
        and total + block_len < 2**31   # int32 offsets inside the scan
    )
    from bds3_tpu.track.scan import output_names

    names = output_names(cfg)
    if use_scan:
        tail_need = starts[-1] + block_len - total
        sig_dev = jnp.pad(signal, (0, tail_need)) if tail_need > 0 else signal
        state_dev = ChannelState(*(jnp.asarray(x) for x in state))
        _, stacked_dev = _track_blocks_scan(
            cfg, sig_dev, data_t, p11_t, p61_t,
            ckd_i, ckd_f, ck61_i, ck61_f, consts, state_dev,
            n_blocks, block_len, shift, int(starts[0]),
        )
    else:
        out_chunks = []   # device arrays, downloaded once at the end
        _pending = None   # previous block's state sync handle
        for s_cur in starts:
            block = signal[s_cur : s_cur + block_len]
            if len(block) < block_len:
                pad = block_len - len(block)
                if isinstance(block, jax.Array):
                    block = jnp.pad(block, (0, pad))
                else:
                    block = np.concatenate(
                        [block, np.zeros(pad, block.dtype)]
                    )
            if not complex_input and block.dtype != np.int8:
                block = block.astype(np.float32)
            if transport in ("int4", "int2") \
                    and not isinstance(block, jax.Array) \
                    and block.dtype == np.int8:
                from bds3_tpu.io import transport as _tx

                pack = _tx.pack_int4 if transport == "int4" else _tx.pack_int2
                unpack = (_tx.unpack_int4 if transport == "int4"
                          else _tx.unpack_int2)
                block = unpack(jnp.asarray(pack(block)), block_len)
            new_state, outs = track_block(
                cfg, jnp.asarray(block), data_t, p11_t, p61_t,
                ckd_i, ckd_f, ck61_i, ck61_f, consts, state,
            )
            # pack (W, C) outputs into one (F, W, C) device array; blksize
            # is < 2^24 so float32 stacking is exact
            out_chunks.append(jnp.stack(
                [outs[k].astype(jnp.float32) for k in names]
            ))
            state = new_state._replace(cursor=new_state.cursor - shift)
            if sync_each_block:
                # one-block lookahead: sync the PREVIOUS block's state so
                # the next block's host read + pack + upload overlap this
                # block's device compute, while in-flight host staging
                # stays bounded to ~2 blocks
                if _pending is not None:
                    jax.block_until_ready(_pending)
                _pending = state.cursor
            if deadline_s is not None and _time.time() - _t0 > deadline_s:
                break
        if sync_each_block and _pending is not None:
            jax.block_until_ready(_pending)
        stacked_dev = jnp.concatenate(out_chunks, axis=1)

    # stacked_dev: (F, E, C)
    base = np.array([c.acquired_freq for c in inits], dtype=np.float64)
    if not download:
        # lazy mode: outputs stay on device (throughput runs, pipelining);
        # the f64 derived fields need host numpy, so they are omitted
        n_eff = min(n_epochs, int(stacked_dev.shape[1]))
        return TrackResults(
            prns=np.array([c.prn for c in inits]),
            acquired_freq=base,
            n_epochs=n_eff,
            outputs=LazyOutputs(stacked_dev, names, n_eff),
            absolute_sample=None, carr_freq=None, code_freq=None,
            int_time=settings.int_time,
            settings=settings,
            correlator=cfg.correlator,
        )

    # single packed download for the whole run
    stacked = np.asarray(stacked_dev)
    outputs = {
        k: np.ascontiguousarray(stacked[i][:n_epochs].T)
        for i, k in enumerate(names)
    }  # (C, E)
    E = outputs["d_ip"].shape[1]

    # absolute end-sample of each epoch: initial code-start position plus
    # the cumulative consumed samples (s0+cursor is shift-invariant)
    blks = stacked[names.index("blksize")][:E].astype(np.int64)  # (E, C)
    absolute_sample = np.ascontiguousarray(
        (cursors0[None, :] + np.cumsum(blks, axis=0)).T
    )

    carr_freq = base[:, None] + outputs["d_cyc"].astype(np.float64) * cfg.fs
    code_freq = settings.code_freq_basis \
        + outputs["d_step"].astype(np.float64) * cfg.fs
    return TrackResults(
        prns=np.array([c.prn for c in inits]),
        acquired_freq=base,
        n_epochs=E,
        outputs=outputs,
        absolute_sample=absolute_sample,
        carr_freq=carr_freq,
        code_freq=code_freq,
        int_time=settings.int_time,
        settings=settings,
        correlator=cfg.correlator,
    )
