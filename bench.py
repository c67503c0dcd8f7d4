"""Benchmark harness (BASELINE.md configs) on a GPU.

Prints the headline JSON line (12-channel B2a closed-loop tracking
real-time factor at the reference dataset rate, 99.375 Msps — BASELINE
config 3) with a `detail` dict carrying every other measured config and
execution evidence: backend, device kind, correlator per stage, compile
seconds, per-pass walls.  It refuses to run without a GPU.

Robustness contract: the headline JSON line is re-emitted after EVERY
completed config, an atexit + SIGTERM hook emits once more on any exit,
and every stage is gated on a wall-clock budget (BENCH_BUDGET_S, default
540 s) so one slow stage can never starve the artifact.  The LAST JSON
line on stdout is always the most complete state.  Stage order:
headline first, IO-bound streaming last.

Baseline context (BASELINE.md): the reference MATLAB receiver publishes
no numbers; its own UI shows multi-minute waitbars per channel for this
workload (well below 1x real time, single-threaded float64 CPU), so
vs_baseline reports our real-time factor against a 1.0x envelope.
"""
import atexit
import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from bds3_tpu.utils.jax_setup import enable_compilation_cache

enable_compilation_cache()

REPO = os.path.dirname(os.path.abspath(__file__))
SECONDS = 2.2
CHANNELS = 12
T_START = time.time()
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "540"))
DETAIL = {"configs": {}, "degraded": False, "notes": [], "skipped": []}
_HEADLINE = {"value": None}
_EMITTED_FINAL = [False]

B2A_SATS = [(5, 1650.0, 4100.0), (12, -2480.0, 8123.0),
            (19, 700.0, 55.0), (30, -310.0, 9000.0)]
B1C_SATS = [(7, 1230.0, 512.0), (21, -2875.0, 7300.0),
            (30, 460.0, 3100.0), (44, -1040.0, 9755.0)]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def remaining() -> float:
    return BUDGET_S - (time.time() - T_START)


def emit():
    """Print the (current) headline JSON line to stdout, flushed.

    Called after every config so a timeout/kill can never zero out the
    round artifact again; the last line printed is the most complete."""
    DETAIL["elapsed_s"] = round(time.time() - T_START, 1)
    print(json.dumps({
        "metric": "b2a_12ch_tracking_realtime_factor",
        "value": _HEADLINE["value"],
        "unit": "x_realtime_99.375Msps",
        "vs_baseline": _HEADLINE["value"],
        "detail": DETAIL,
    }), flush=True)


def _emit_final(*_args):
    if not _EMITTED_FINAL[0]:
        _EMITTED_FINAL[0] = True
        DETAIL["notes"].append("emitted by exit hook")
        emit()
    if _args:            # invoked as a signal handler: exit now
        os._exit(124)


atexit.register(_emit_final)
signal.signal(signal.SIGTERM, _emit_final)


def gate(name: str, est_s: float) -> bool:
    """Stage gate: run only if the budget has room for the estimate."""
    if remaining() >= est_s:
        return True
    log(f"[bench] SKIP {name}: est {est_s:.0f}s > {remaining():.0f}s left")
    DETAIL["skipped"].append({"config": name, "est_s": est_s,
                              "remaining_s": round(remaining(), 1)})
    return False


def get_capture(s, sats, cache_name, n_ms, amplitude=0.65):
    from bds3_tpu.io import SatParams, synthesize_if

    cache = os.path.join(REPO, cache_name)
    n = int(n_ms * 1e-3 * s.sampling_freq)
    if os.path.exists(cache):
        sig = np.load(cache, mmap_mode="r")
        if sig.shape[0] == n:
            return sig
    sat_params = [
        SatParams(prn=p, doppler_hz=fd, code_phase_chips=cp,
                  amplitude=amplitude)
        for p, fd, cp in sats
    ]
    t0 = time.time()
    sig = synthesize_if(s, sat_params, n_ms=n_ms, noise_std=2.0, seed=11)
    log(f"[bench] synthesized {cache_name}: {sig.nbytes/1e6:.0f} MB "
        f"in {time.time()-t0:.0f}s")
    np.save(cache, sig)
    return sig


def make_inits(s, sats, n_channels):
    from bds3_tpu.track.state import ChannelInit

    inits = []
    for i in range(n_channels):
        prn, fd, cp = sats[i % len(sats)]
        code_rate = s.code_freq_basis * (1 + fd / s.carr_freq_basis)
        chi0 = cp % s.code_length
        start = ((s.code_length - chi0) % s.code_length) / code_rate
        inits.append(ChannelInit(
            prn=prn, acquired_freq=s.intermediate_freq + fd,
            code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0,
        ))
    return inits


def bench_tracking(name, s, sig_dev, inits, n_epochs, epochs_per_block,
                   passes):
    """Closed-loop tracking throughput; returns realtime factor."""
    from bds3_tpu.track.driver import track

    t0 = time.time()
    res = track(sig_dev, s, inits, n_epochs=n_epochs,
                epochs_per_block=epochs_per_block, download=False)
    res.outputs.block_until_ready()   # force compile+run
    compile_s = time.time() - t0
    ran = res.correlator
    log(f"[bench] {name}: correlator={ran} warmup+compile {compile_s:.1f}s")

    walls = []
    for _ in range(passes):
        t0 = time.time()
        res = track(sig_dev, s, inits, n_epochs=n_epochs,
                    epochs_per_block=epochs_per_block, download=False)
        # device-side sync: a download is not tracking work
        res.outputs.block_until_ready()
        walls.append(time.time() - t0)
    # lock evidence: the repo's own VSM C/N0 + NBP/NBD PLL lock detector
    # (observe/cn0.py, Calc_CNo_PLD.m parity) — not a prompt-power
    # heuristic.  Computed outside the timed passes, on ONE bulk
    # download.
    import dataclasses as _dc

    from bds3_tpu.observe.cn0 import channel_health

    if hasattr(res.outputs, "realize"):
        res = _dc.replace(res, outputs=res.outputs.realize())
    health = channel_health(res)
    locked = sum(h["lock_ok"] for h in health)
    cn0s = [round(h["cn0_db"], 1) for h in health]
    plls = [round(h["pll_lock"], 2) for h in health]
    best = min(walls)
    tracked_s = res.n_epochs * s.int_time
    rt = tracked_s / best
    n_ch = len(inits)
    log(f"[bench] {name}: {tracked_s:.2f}s x {n_ch}ch in {best:.2f}s best "
        f"(walls {[round(w, 2) for w in walls]}) -> {rt:.2f}x realtime "
        f"({rt * s.sampling_freq * n_ch / 1e9:.2f} G corr-samples/s); "
        f"locked {locked}/{n_ch} (C/N0 {min(cn0s):.1f}-{max(cn0s):.1f} "
        f"dB-Hz, PLL lock >= {min(plls):.2f})")
    DETAIL["configs"][name] = {
        "realtime_factor": round(rt, 3),
        "ms_per_epoch": round(best / res.n_epochs * 1e3, 4),
        "corr_gsamples_per_s": round(rt * s.sampling_freq * n_ch / 1e9, 2),
        "correlator": ran,
        "compile_s": round(compile_s, 1),
        "pass_walls_s": [round(w, 2) for w in walls],
        "channels": n_ch,
        "epochs": res.n_epochs,
        "locked": locked,
        "cn0_db": cn0s,
        "pll_lock": plls,
    }
    return rt


def bench_acquisition(name, s, sig, n_prns, warm_pass=True):
    """Cold-start PCPS acquisition wall time over n_prns satellites.

    warm_pass=False reports the compile+first wall only (budget-tight
    runs; the cold number still bounds the warm one)."""
    from bds3_tpu.acquire import acquire
    from bds3_tpu.receiver import acquisition_signal_length

    prns = tuple(range(1, n_prns + 1))
    win = np.asarray(sig[: acquisition_signal_length(s)])
    t0 = time.time()
    res = acquire(win, s, prns)
    compile_s = time.time() - t0
    if warm_pass:
        t0 = time.time()
        res = acquire(win, s, prns)
        wall = time.time() - t0
    else:
        wall = compile_s
    ndet = int(res.detected.sum())
    log(f"[bench] {name}: {n_prns} PRNs in {wall:.2f}s"
        f"{' warm' if warm_pass else ' COLD(incl compile)'} "
        f"(compile+first {compile_s:.1f}s), detected {ndet}")
    DETAIL["configs"][name] = {
        "prns": n_prns,
        "wall_s": round(wall, 2),
        "warm": bool(warm_pass),
        "prn_per_s": round(n_prns / wall, 1),
        "compile_s": round(compile_s, 1),
        "detected": ndet,
    }


# Boulder, CO in ECEF [m] (same truth as tests/test_e2e_pvt.py)
RX_TRUTH = np.array([-1288398.0, -4721697.0, 4078625.0])


def _score_receiver(name, s, res, walls, fs, err_gate_m=None):
    n_ch = len(res.channels)
    processed = res.track.n_epochs * s.int_time if res.track else 0.0
    corr = res.track.correlator if res.track else "none"
    fixes, err_med = 0, float("nan")
    if res.nav is not None:
        ok = np.isfinite(res.nav.x)
        fixes = int(ok.sum())
        err = np.sqrt((res.nav.x[ok] - RX_TRUTH[0]) ** 2
                      + (res.nav.y[ok] - RX_TRUTH[1]) ** 2
                      + (res.nav.z[ok] - RX_TRUTH[2]) ** 2)
        err_med = float(np.median(err)) if fixes else float("nan")
    rt_warm = processed / walls["warm"] if "warm" in walls else float("nan")
    log(f"[bench] {name}: acq+track({n_ch}ch)+decode+pvt on "
        f"{processed:.0f}s streamed scenario: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in walls.items())
        + f" ({rt_warm:.2f}x rt warm, correlator={corr}); "
        f"{fixes} fixes, median 3D err {err_med:.2f} m")
    DETAIL["configs"][name] = {
        "fs_msps": round(fs / 1e6, 3),
        "tracked_s": round(processed, 2),
        **{f"wall_s_{k}": round(v, 1) for k, v in walls.items()},
        "realtime_factor_warm": round(rt_warm, 3),
        "channels": n_ch,
        "correlator": corr,
        "fixes": fixes,
        "median_3d_err_m": round(err_med, 3) if np.isfinite(err_med) else None,
        "timings_warm": {k: round(v, 2) for k, v in res.timings.items()
                         if isinstance(v, (int, float))},
    }
    # accuracy gate: a regression past the north-star tolerance fails the
    # artifact loudly (degraded), not just drifts a number (VERDICT r4 #8)
    if err_gate_m is not None and not (err_med < err_gate_m):
        DETAIL["degraded"] = True
        DETAIL["notes"].append(
            f"{name}: median 3D err {err_med:.2f} m exceeds the"
            f" {err_gate_m:.1f} m gate")


def bench_full_receiver(cold_and_warm=True):
    """BASELINE config 4 (B2a): the complete pipeline producing a REAL
    fix — geometry-consistent 20 s scenario capture (decodable B-CNAV2
    MT10/11/30 set per SV, B2a pilot secondary on) streamed from disk ->
    acquisition -> tracking -> decode -> pseudoranges -> PVT,
    scored against the known receiver position (postProcessing.m:60-169
    role).

    Runs at 24.84375 Msps (a realistic front-end rate; host-side
    scenario synthesis at the full 99.375 Msps costs ~20 min).  The
    headline tracking configs stay at the 99.375 Msps reference rate."""
    from bds3_tpu.config import b2a_settings
    from bds3_tpu.io.scenario import make_scenario, synthesize_scenario
    from bds3_tpu.io.stream import StreamingCapture
    from bds3_tpu.receiver import run_receiver

    fs = 99.375e6 / 4
    s = b2a_settings(
        sampling_freq=fs, intermediate_freq=fs / 4, ms_to_process=20_000,
        use_tropo_corr=False, acq_satellite_list=tuple(range(1, 9)),
        num_channels=6,
    )
    path = os.path.join(REPO, ".bench_scenario4.bin")
    n = int(s.ms_to_process * 1e-3 * fs)
    sc = make_scenario(s, RX_TRUTH, n_sats=6, seed=3)
    if not (os.path.exists(path) and os.path.getsize(path) == n):
        t0 = time.time()
        sig = synthesize_scenario(sc, noise_std=2.0, amplitude=0.7, seed=1)
        sig.tofile(path)
        log(f"[bench] synthesized scenario capture {sig.nbytes/1e6:.0f} MB "
            f"in {time.time()-t0:.0f}s")
        del sig

    walls = {}
    res = None
    labels = ("cold", "warm") if cold_and_warm else ("warm",)
    for label in labels:
        cap = StreamingCapture(path)
        t0 = time.time()
        res = run_receiver(cap, s, epochs_per_block=2000, verbose=False)
        walls[label] = time.time() - t0
    _score_receiver("full_receiver_b2a", s, res, walls, fs, err_gate_m=1.0)

    # pilot-secondary frame sync on the tracked channels (ICD Weil-100
    # overlay; capability the reference lacks — observe/secondary.py)
    try:
        from bds3_tpu.observe.secondary import b2a_pilot_secondary_sync

        syncs = [b2a_pilot_secondary_sync(res.track, ch)
                 for ch in range(len(res.channels))]
        DETAIL["configs"]["full_receiver_b2a"]["pilot_secondary_sync"] = {
            "locked": sum(x["metric"] > 2.0 for x in syncs),
            "min_metric": round(min(x["metric"] for x in syncs), 2),
            "min_aligned": round(
                min(x["aligned_fraction"] for x in syncs), 3),
        }
    except Exception as e:
        DETAIL["notes"].append(f"pilot_secondary_sync failed: {e!r}")


def bench_full_receiver_b1c():
    """BASELINE config 4 (B1C): scenario -> acquisition -> WIDEBAND
    QMBOC tracking (18 correlators incl. the BOC(6,1) bank) -> B-CNAV1
    BCH/de-interleave/CRC decode -> PVT (`BDS-3_B1C/postProcessing.m:
    105-159` role).  26 s covers one full 18 s B-CNAV1 frame + margin.

    33.125 Msps: the BOC(6,1) pilot's upper sideband (IF + 6.14 MHz =
    14.4 MHz) must sit inside Nyquist — at fs/4=24.8 Msps it aliases
    and biases the WB weighted DLL by ~5 m (measured; the NB mode on
    the same 24.8 Msps scenario fixes at 0.5 m)."""
    from bds3_tpu.config import b1c_settings
    from bds3_tpu.io.scenario import make_scenario, synthesize_scenario
    from bds3_tpu.io.stream import StreamingCapture
    from bds3_tpu.receiver import run_receiver

    fs = 99.375e6 / 3
    s = b1c_settings(
        sampling_freq=fs, intermediate_freq=fs / 4, ms_to_process=26_000,
        use_tropo_corr=False, acq_satellite_list=tuple(range(1, 7)),
        num_channels=5,
        # Slope-normalized per-component WB code DLL with the BOC(6,1)
        # bank at its own narrow spacing: unbiased across +-5 kHz
        # Doppler AND lower code noise than both the reference's
        # composite blend (-1.9 m bias / 0.92 m sd at 47 dB-Hz) and the
        # round-4 "nb" sidestep — see Settings.wb_code_blend
        wb_code_blend="split",
    )
    path = os.path.join(REPO, ".bench_scenario_b1c33.bin")
    n = int(s.ms_to_process * 1e-3 * fs)
    sc = make_scenario(s, RX_TRUTH, n_sats=5, sow_base=3600.0 * 3, seed=5)
    if not (os.path.exists(path) and os.path.getsize(path) == n):
        t0 = time.time()
        sig = synthesize_scenario(sc, noise_std=2.0, amplitude=1.3, seed=2)
        sig.tofile(path)
        log(f"[bench] synthesized B1C scenario {sig.nbytes/1e6:.0f} MB "
            f"in {time.time()-t0:.0f}s")
        del sig

    walls = {}
    res = None
    for label in ("cold", "warm"):
        cap = StreamingCapture(path)
        t0 = time.time()
        res = run_receiver(cap, s, epochs_per_block=500, verbose=False)
        walls[label] = time.time() - t0
    _score_receiver("full_receiver_b1c", s, res, walls, fs, err_gate_m=2.0)


def bench_streaming(s):
    """Capture-scale streaming: a 49 s / ~4.9 GB int8 file at the
    reference dataset rate (README.md:135-141 envelope), 12 channels,
    streamed through StreamingCapture (native pread + lookahead) with
    bounded host memory — never resident in host or device memory at
    once.  A wall-clock deadline keeps the stage inside the budget."""
    import resource

    import jax.numpy as jnp

    from bds3_tpu.io import SatParams, synthesize_if
    from bds3_tpu.io.stream import StreamingCapture
    from bds3_tpu.observe.cn0 import channel_health
    from bds3_tpu.track.driver import track

    path = os.path.join(REPO, ".bench_stream49.bin")
    n = int(49.0 * s.sampling_freq)
    if not (os.path.exists(path) and os.path.getsize(path) == n):
        t0 = time.time()
        sats = [SatParams(prn=p, doppler_hz=fd, code_phase_chips=cp,
                          amplitude=0.65) for p, fd, cp in B2A_SATS]
        with open(path, "wb") as f:
            chunk_ms = 500.0
            done = 0
            while done < n:
                ms = min(chunk_ms, (n - done) / s.sampling_freq * 1e3)
                seg = synthesize_if(s, sats, n_ms=ms, noise_std=2.0,
                                    seed=100 + done,
                                    start_sample=done)
                f.write(seg.tobytes())
                done += len(seg)
        log(f"[bench] synthesized 49 s capture ({n/1e9:.2f} GB) "
            f"in {time.time()-t0:.0f}s")

    deadline = max(20.0, remaining() - 30.0)
    log(f"[bench] streaming_49s: tracking up to 48.5s with a "
        f"{deadline:.0f}s wall deadline")

    rss0_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    cap = StreamingCapture(path)
    inits = make_inits(s, B2A_SATS, 12)
    t0 = time.time()
    # 4 s blocks: the per-block host orchestration (pread + upload
    # dispatches) has a fixed cost per block, so longer blocks cut its
    # share; in-flight staging stays bounded to two blocks by the
    # lookahead sync
    res = track(cap, s, inits, n_epochs=48_500, epochs_per_block=4000,
                download=False, sync_each_block=True, deadline_s=deadline)
    np.asarray(res.outputs["d_ip"][:, -200:])
    wall = time.time() - t0
    tracked = res.n_epochs * s.int_time
    rt = tracked / wall
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    import dataclasses as _dc

    if hasattr(res.outputs, "realize"):
        res = _dc.replace(res, outputs=res.outputs.realize())
    health = channel_health(res)
    locked = sum(h["lock_ok"] for h in health)
    log(f"[bench] streaming_49s: {tracked:.1f}s x 12ch streamed from "
        f"{n/1e9:.2f} GB file in {wall:.1f}s ({rt:.2f}x rt sustained); "
        f"peak RSS {rss_gb:.1f} GB (pre-phase {rss0_gb:.1f}); "
        f"locked {locked}/12")
    DETAIL["configs"]["streaming_49s"] = {
        "capture_gb": round(n / 1e9, 2),
        "tracked_s": round(tracked, 1),
        "wall_s": round(wall, 1),
        "realtime_factor_sustained": round(rt, 3),
        "peak_rss_gb": round(rss_gb, 2),
        "pre_phase_peak_rss_gb": round(rss0_gb, 2),
        "channels": 12,
        "correlator": res.correlator,
        "locked": locked,
        "cn0_db": [round(h["cn0_db"], 1) for h in health],
    }


def _stage(name, est_s, fn):
    """Run one bench stage under the budget gate; always emit after."""
    if not gate(name, est_s):
        return
    log(f"[bench] >> {name} (elapsed {time.time()-T_START:.0f}s)")
    try:
        fn()
    except Exception as e:
        log(f"[bench] {name} failed: {e!r}")
        DETAIL["notes"].append(f"{name} failed: {type(e).__name__}: {e}")
    emit()


def main():
    import jax

    from bds3_tpu.config import TrackMode, b1c_settings, b2a_settings

    dev = jax.devices()[0]
    DETAIL["backend"] = dev.platform
    DETAIL["device"] = str(dev)
    DETAIL["device_kind"] = getattr(dev, "device_kind", "?")
    DETAIL["platform"] = dev.platform
    DETAIL["budget_s"] = BUDGET_S
    log(f"[bench] device={dev} platform={dev.platform} "
        f"budget={BUDGET_S:.0f}s")
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")

    import jax.numpy as jnp

    # ---- config 3 (headline): 12-channel B2a tracking ------------------
    s2 = b2a_settings()
    sig2 = get_capture(s2, B2A_SATS, ".bench_capture.npy", SECONDS * 1e3)
    sig2_dev = jnp.asarray(sig2)
    inits2 = make_inits(s2, B2A_SATS, CHANNELS)
    _HEADLINE["value"] = round(bench_tracking(
        "tracking_b2a_12ch", s2, sig2_dev, inits2,
        n_epochs=2000, epochs_per_block=2000, passes=6), 3)
    emit()

    # ---- config 1: B2a cold-start acquisition ---------------------------
    _stage("acquisition_b2a", 40,
           lambda: bench_acquisition("acquisition_b2a", s2, sig2, 63))

    # ---- config 2: B1C tracking at the reference dataset rate ----------
    # the capture is synthesized with the full QMBOC pilot (wideband
    # settings = the true on-air signal); NB mode then tracks its
    # BOC(1,1) components exactly as NB_tracking.m does.
    s1 = b1c_settings(sampling_freq=99.375e6, intermediate_freq=14.58e6)
    s1nb = b1c_settings(sampling_freq=99.375e6, intermediate_freq=14.58e6,
                        track_mode=TrackMode.NARROWBAND)
    sig1 = None
    if gate("tracking_b1c", 120):
        try:
            # amplitude 0.22 ~= 47 dB-Hz: realistic on-air level.  At
            # the old 0.65 (~57 dB-Hz) the 10 ms-coherent GLRT floor is
            # Weil CROSS-correlations of the 4 strong satellites
            # (metric ~11 > the 7.5 threshold on every absent PRN);
            # the reference's threshold assumes on-air signal levels.
            sig1 = get_capture(s1, B1C_SATS, ".bench_capture_b1c47.npy",
                               6200.0, amplitude=0.22)
            # upload ONLY the tracked span: 300 epochs x 10 ms needs
            # ~304 MB of the 616 MB capture
            n_ep1 = 300
            need = int((n_ep1 + 4) * s1.samples_per_code)
            sig1_dev = jnp.asarray(np.asarray(sig1[:need]))
            inits1 = make_inits(s1, B1C_SATS, CHANNELS)
            bench_tracking("tracking_b1c_12ch_nb", s1nb, sig1_dev, inits1,
                           n_epochs=n_ep1, epochs_per_block=150, passes=3)
            emit()
            # wideband QMBOC (18 correlators incl. the BOC(6,1) bank)
            bench_tracking("tracking_b1c_12ch_wb", s1, sig1_dev, inits1,
                           n_epochs=n_ep1, epochs_per_block=150, passes=3)
            del sig1_dev
        except Exception as e:
            log(f"[bench] B1C tracking bench failed: {e!r}")
            DETAIL["notes"].append(f"tracking_b1c failed: {type(e).__name__}")
        emit()

    # ---- config 5 (single-chip aggregate): 48-channel B2a ---------------
    # the north-star metric is aggregate correlated samples/s per card;
    # one card tracks 4x the reference's channel load
    def _run48():
        inits48 = make_inits(s2, B2A_SATS, 48)
        bench_tracking("tracking_b2a_48ch", s2, sig2_dev, inits48,
                       n_epochs=2000, epochs_per_block=2000, passes=3)

    _stage("tracking_b2a_48ch", 45, _run48)

    # ---- low-C/N0 config: 12-channel tracking at 40 dB-Hz ---------------
    # the regime the lock detectors and thresholds exist for (VERDICT r4
    # item 3); capture synthesized at the calibrated amplitude
    # (io.amplitude_for_cn0; tests/test_lowcn0.py pins the estimator)
    def _run40db():
        from bds3_tpu.io import amplitude_for_cn0

        amp40 = amplitude_for_cn0(s2, 40.0, 2.0)
        sig40 = get_capture(s2, B2A_SATS, ".bench_capture40.npy",
                            SECONDS * 1e3, amplitude=amp40)
        inits40 = make_inits(s2, B2A_SATS, CHANNELS)
        bench_tracking("tracking_b2a_12ch_40db", s2, jnp.asarray(sig40),
                       inits40, n_epochs=2000, epochs_per_block=2000,
                       passes=2)
        cfg40 = DETAIL["configs"].get("tracking_b2a_12ch_40db", {})
        if cfg40 and cfg40.get("locked", 0) < CHANNELS:
            DETAIL["degraded"] = True
            DETAIL["notes"].append(
                f"tracking_b2a_12ch_40db: only {cfg40.get('locked')}"
                f"/{CHANNELS} locked at 40 dB-Hz")

    _stage("tracking_b2a_12ch_40db", 50, _run40db)

    # ---- config 4: full receivers with real decoded fixes ---------------
    _stage("full_receiver_b2a", 60,
           lambda: bench_full_receiver(cold_and_warm=remaining() > 150))

    _stage("full_receiver_b1c", 75, bench_full_receiver_b1c)

    # ---- config 2 (acquisition): B1C 63-PRN GLRT cold start -------------
    # 201 Doppler bins x 10 ms coherent at the published dataset rate
    # (BDS-3_B1C/acquisition.m:131-235 envelope)
    if sig1 is not None:
        # preset default since round 5: device-side bandpass-decimate
        # (acquisition.m:52-124's own strategy, run as one XLA FFT-conv +
        # gather instead of host filtfilt): ~6x faster, same detections
        _stage("acquisition_b1c_resampled", 25,
               lambda: bench_acquisition("acquisition_b1c_resampled", s1,
                                         sig1, 63,
                                         warm_pass=remaining() > 60))

        # full-grid parity configuration (the reference ships
        # resamplingflag = 0, initSettings.m:102)
        import dataclasses as _dc

        s1f = _dc.replace(s1, resampling=False)
        _stage("acquisition_b1c", 35,
               lambda: bench_acquisition("acquisition_b1c", s1f, sig1, 63,
                                         warm_pass=remaining() > 120))

    # ---- capture-scale streaming LAST (IO-bound, budget-capped) ---------
    _stage("streaming_49s", 60, lambda: bench_streaming(s2))

    _EMITTED_FINAL[0] = True     # the normal final emit
    emit()


if __name__ == "__main__":
    main()
