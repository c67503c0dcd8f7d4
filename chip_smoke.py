"""Smoke run of the receiver on a GPU: proves the main path runs on the card.

    python chip_smoke.py           # one card: the phases below
    python chip_smoke.py --four    # four cards: the sharded paths only

One process drives every phase; any failed phase raises, and the script
exits non-zero without printing the final JSON line.  It refuses to run
without a GPU (a CPU number is never a device number).

Phases (one card):
  device        platform, device kind, JAX version, XLA_FLAGS, compile
                cache, and the card's name and power limit (nvidia-smi).
  track_b2a     B2a at 99.375 Msps (IF 13.55 MHz), 12 channels, 2000
                epochs, device-resident seeded capture: the default
                correlator timed, and the prefix-sum "bucket" correlator
                checked against the per-sample "gather" reference.
  track_b1c_wb  B1C wideband QMBOC at 99.375 Msps: 18 correlators incl.
                the BOC(6,1) bank, wb_code_blend="split", 12 channels,
                150 epochs, same comparison.
  acquire       63-PRN B2a acquisition on the track_b2a capture and
                63-PRN B1C acquisition with the preset (device
                decimator); exact detections, code phase and Doppler
                within one search bin of truth.
  receiver_b2a  run_receiver(IFDataFile.open(path), s) on a geometry-
                consistent 20 s, 6-satellite scenario; median 3D error
                <= 1 m.  This is the one cut in width: it runs at fs/4
                (24.84375 Msps) because host scenario synthesis at the
                full 99.375 Msps takes several times longer.

Phases (--four, a flat 4-device mesh; each compared with one card):
  fanout_b2a    48 channels of B2a at 99.375 Msps sharded 4 ways with
                shard_map; outputs bit-equal to one card running the
                same four 12-channel groups (one 48-wide vmap reorders
                the f32 reductions, so it is reported, not required
                equal).
  doppler_acq   Doppler-bin-sharded coarse acquisition; winners equal.
  timeshard     time-sharded tracking with loop-state handoff vs the
                sequential run, to the tolerances below.

Correlator tolerances (tests/test_correlator_equiv.py uses the same on
the CPU): integer epoch geometry (blksize,
absolute_sample) exactly equal over the first 30 (B2a) or 10 (B1C)
epochs; E/P/L correlators within 5e-2 of the mean magnitude of their
complex correlator (I and Q together) and
carr_freq within 0.25 Hz over the same horizon; every channel locked
(observe.cn0.channel_health).  Summation order differs between the two
correlators, so the closed loops wander apart at the discriminator-noise
level; that is why the horizon is bounded.

Each phase prints one line with its compile seconds (cold wall minus
warm wall), warm wall seconds, peak_bytes_in_use and the card.  These
are evidence that the path ran, not benchmark metrics.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

B2A_SATS = [(5, 1650.0, 4100.0), (12, -2480.0, 8123.0),
            (19, 700.0, 55.0), (30, -310.0, 9000.0)]
B1C_SATS = [(7, 1230.0, 512.0), (21, -2875.0, 7300.0),
            (30, 460.0, 3100.0), (44, -1040.0, 9755.0)]
RX_TRUTH = np.array([-1288398.0, -4721697.0, 4078625.0])   # Boulder, ECEF

CORR_ATOL = 5e-2          # of the mean correlator magnitude
CARR_FREQ_ATOL_HZ = 0.25
GEOMETRY_EPOCHS = {"b2a": 30, "b1c": 10}
CORR_KEYS = ("d_ip", "d_qp", "d_ie", "d_il", "p11_ip", "p11_qp")
WB_KEYS = ("p61_ip", "p61_qp", "p61_ie", "p61_il", "p_ip", "p_qp")


class SmokeError(RuntimeError):
    """A phase did not meet its check."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def card_identity() -> str:
    """`name, power.limit` of the first card, read by nvidia-smi in a
    child process (which never touches JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def report(phase: str, card: str, cold_s: float, warm_s: float, **extra):
    fields = " ".join(f"{k}={v}" for k, v in extra.items())
    print(f"[{phase}] ok compile_s={cold_s - warm_s:.3f} warm_s={warm_s:.3f} "
          f"peak_bytes_in_use={peak_bytes()} card=\"{card}\" {fields}",
          flush=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def make_inits(s, sats, n_channels):
    """Channel assignment from the synthesis truth (cycled over sats)."""
    from bds3_tpu.track.state import ChannelInit

    inits = []
    for i in range(n_channels):
        prn, fd, cp = sats[i % len(sats)]
        code_rate = s.code_freq_basis * (1 + fd / s.carr_freq_basis)
        chi0 = cp % s.code_length
        start = ((s.code_length - chi0) % s.code_length) / code_rate
        inits.append(ChannelInit(
            prn=prn, acquired_freq=s.intermediate_freq + fd,
            code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0))
    return inits


def synth(s, sats, n_ms, amplitude, seed=11):
    from bds3_tpu.io import SatParams, synthesize_if

    params = [SatParams(prn=p, doppler_hz=fd, code_phase_chips=cp,
                        amplitude=amplitude) for p, fd, cp in sats]
    return synthesize_if(s, params, n_ms=n_ms, noise_std=2.0, seed=seed,
                         workers=os.cpu_count() or 1)


def compare_tracks(ref, test, n_geom: int, keys) -> dict:
    """Raise unless `test` matches `ref` to the correlator tolerances over
    the first n_geom epochs; returns the worst deviations."""
    g = slice(0, n_geom)
    check(np.array_equal(ref.outputs["blksize"][:, g],
                         test.outputs["blksize"][:, g]),
          "blksize differs within the geometry horizon")
    check(np.array_equal(ref.absolute_sample[:, g],
                         test.absolute_sample[:, g]),
          "absolute_sample differs within the geometry horizon")
    worst = 0.0
    for k in keys:
        a, b = ref.outputs[k][:, g], test.outputs[k][:, g]
        # scale: the mean magnitude of the complex correlator this
        # component belongs to (a locked Q arm alone is noise-sized)
        bank, arm = k.rsplit("_", 1)
        mag = np.hypot(ref.outputs[f"{bank}_i{arm[1]}"][:, g],
                       ref.outputs[f"{bank}_q{arm[1]}"][:, g]).mean()
        dev = float(np.max(np.abs(b - a)) / (mag + 1.0))
        check(dev <= CORR_ATOL, f"{k}: deviation {dev:.4f} > {CORR_ATOL}")
        worst = max(worst, dev)
    dcarr = float(np.max(np.abs(test.carr_freq[:, g] - ref.carr_freq[:, g])))
    check(dcarr <= CARR_FREQ_ATOL_HZ, f"carr_freq differs by {dcarr:.3f} Hz")
    return {"max_corr_dev": round(worst, 5), "max_carr_dev_hz": round(dcarr, 4)}


def locked(trk) -> int:
    from bds3_tpu.observe.cn0 import channel_health

    return sum(h["lock_ok"] for h in channel_health(trk))


def phase_track(name, card, s, sig, sats, n_channels, n_epochs,
                epochs_per_block, n_geom, keys):
    """Default correlator (cold, then warm), and "bucket" checked against
    the per-sample "gather" reference, on one device-resident capture."""
    import jax
    import jax.numpy as jnp

    from bds3_tpu.track.driver import track
    from bds3_tpu.track.state import CORRELATORS

    inits = make_inits(s, sats, n_channels)
    sig_dev = jax.block_until_ready(jnp.asarray(sig))

    def run(correlator):
        return track(sig_dev, s, inits, n_epochs=n_epochs,
                     epochs_per_block=epochs_per_block, correlator=correlator)

    res, cold = timed(lambda: run("auto"))
    res, warm = timed(lambda: run("auto"))
    check(res.n_epochs == n_epochs, f"tracked {res.n_epochs}/{n_epochs}")
    runs = {c: res if c == res.correlator else run(c) for c in CORRELATORS}
    dev = compare_tracks(runs["gather"], runs["bucket"], n_geom, keys)
    n_lock = {c: locked(r) for c, r in runs.items()}
    check(all(n == n_channels for n in n_lock.values()),
          f"locked {n_lock} of {n_channels}")
    report(name, card, cold, warm, correlator=res.correlator,
           channels=n_channels, epochs=n_epochs,
           ms_per_epoch=round(warm / n_epochs * 1e3, 4),
           locked=f"{n_lock[res.correlator]}/{n_channels}",
           bucket_vs_gather=dev)
    del sig_dev


def check_acquisition(s, acq, sats, fs_ratio: float = 1.0) -> dict:
    """Exact detections; code phase and Doppler within one search bin."""
    from bds3_tpu.acquire.pcps import make_acq_config

    want = sorted(p for p, _, _ in sats)
    got = sorted(int(p) for p in acq.detected_prns())
    check(got == want, f"detected {got}, synthesized {want}")
    spc = s.samples_per_code
    # one (decimated) code-phase bin, plus half a bin for the truth's
    # position between bins
    code_tol = 1.5 * fs_ratio
    freq_tol = make_acq_config(s).freq_step
    worst_code = worst_freq = 0.0
    for prn, fd, cp in sats:
        i = list(acq.prns).index(prn)
        code_rate = s.code_freq_basis * (1 + fd / s.carr_freq_basis)
        chi0 = cp % s.code_length
        truth = ((s.code_length - chi0) % s.code_length) / code_rate \
            * s.sampling_freq
        err = (acq.code_phase[i] - truth) % spc
        err = min(err, spc - err)
        ferr = abs(acq.carr_freq[i] - (s.intermediate_freq + fd))
        check(err <= code_tol, f"PRN {prn}: code phase off {err:.1f} samples")
        check(ferr <= freq_tol, f"PRN {prn}: Doppler off {ferr:.1f} Hz")
        worst_code, worst_freq = max(worst_code, err), max(worst_freq, ferr)
    return {"detected": got, "max_code_err_samples": round(worst_code, 2),
            "max_doppler_err_hz": round(worst_freq, 2)}


def phase_acquire(name, card, s, sig, sats, n_prns):
    from bds3_tpu.acquire import acquire
    from bds3_tpu.receiver import acquisition_signal_length

    prns = tuple(range(1, n_prns + 1))
    win = np.asarray(sig[: acquisition_signal_length(s)])
    acq, cold = timed(lambda: acquire(win, s, prns))
    acq, warm = timed(lambda: acquire(win, s, prns))
    ratio = 1.0
    if s.resampling and s.sampling_freq > s.resampling_threshold:
        from bds3_tpu.acquire.resample import plan_resample

        plan = plan_resample(s)
        ratio = plan.old_fs / plan.new_fs
    info = check_acquisition(s, acq, sats, ratio)
    report(name, card, cold, warm, prns=n_prns, **info)


def phase_receiver(name, card, s, n_sats, workers, tmpdir,
                   err_limit_m=1.0):
    """Scenario capture -> file -> run_receiver, as the CLI drives it."""
    from bds3_tpu.io.ifdata import IFDataFile
    from bds3_tpu.io.scenario import make_scenario, synthesize_scenario
    from bds3_tpu.receiver import run_receiver

    sc = make_scenario(s, RX_TRUTH, n_sats=n_sats, seed=3)
    path = os.path.join(tmpdir, "scenario.bin")
    synthesize_scenario(sc, noise_std=2.0, amplitude=0.7, seed=1,
                        workers=workers).tofile(path)
    res, cold = timed(lambda: run_receiver(IFDataFile.open(path), s))
    res, warm = timed(lambda: run_receiver(IFDataFile.open(path), s,
                                           verbose=False))
    check(res.nav is not None, "no navigation solution")
    ok = np.isfinite(res.nav.x)
    check(ok.any(), "no finite fix")
    err = np.sqrt((res.nav.x[ok] - RX_TRUTH[0]) ** 2
                  + (res.nav.y[ok] - RX_TRUTH[1]) ** 2
                  + (res.nav.z[ok] - RX_TRUTH[2]) ** 2)
    med = float(np.median(err))
    check(med <= err_limit_m, f"median 3D error {med:.3f} m > {err_limit_m}")
    report(name, card, cold, warm, fs_msps=round(s.sampling_freq / 1e6, 5),
           channels=len(res.channels), fixes=int(ok.sum()),
           median_3d_err_m=round(med, 4), correlator=res.track.correlator,
           track_s=round(res.timings["track_s"], 3))


def phase_fanout(name, card, s, sig, n_channels, epochs, n_dev):
    """Channel fan-out over n_dev devices vs the same block on one."""
    import jax
    import jax.numpy as jnp

    from bds3_tpu.parallel.mesh import make_mesh
    from bds3_tpu.parallel.sharded import shard_map_track_block
    from bds3_tpu.track.driver import channel_code_tables
    from bds3_tpu.track.scan import track_block
    from bds3_tpu.track.state import (
        channel_consts, code_coarse_tables, initial_state, make_track_config)

    cfg = make_track_config(s, epochs_per_block=epochs)
    inits = make_inits(s, B2A_SATS, n_channels)
    consts = channel_consts(cfg, inits, s)
    data_t, p11_t, p61_t = channel_code_tables(cfg, inits)
    cki, ckf = code_coarse_tables(cfg, cfg.m_data)
    cursors = np.array([c.code_phase for c in inits])
    state = initial_state(cfg, inits, consts, cursors)
    n_block = int(cursors.max()) + epochs * (cfg.q0_int + 3) + cfg.n_max
    check(len(sig) >= n_block, "capture too short for the fan-out block")
    args = (jnp.asarray(sig[:n_block]), jnp.asarray(data_t),
            jnp.asarray(p11_t), jnp.asarray(p61_t), jnp.asarray(cki),
            jnp.asarray(ckf), jnp.asarray(cki), jnp.asarray(ckf),
            consts, state)
    mesh = make_mesh(n_dev, ("channel",))
    per = n_channels // n_dev

    def group(g):
        """The args of channels [g*per, (g+1)*per): one device's share."""
        sl = lambda x: jnp.asarray(x)[g * per:(g + 1) * per]  # noqa: E731
        blk, dt, p11, p61, ci, cf, c2i, c2f, cn, st = args
        return (blk, sl(dt), sl(p11), sl(p61), ci, cf, c2i, c2f,
                type(cn)(*map(sl, cn)), type(st)(*map(sl, st)))

    one_mesh = make_mesh(1, ("channel",))

    def one():
        """The same work on one device: each device's channel group,
        through the same shard_map program on a one-device mesh."""
        outs = [shard_map_track_block(one_mesh, cfg, *group(g))[1]
                for g in range(n_dev)]
        return jax.block_until_ready(
            {k: jnp.concatenate([o[k] for o in outs], axis=1)
             for k in outs[0]})

    def wide():
        return jax.block_until_ready(track_block(cfg, *args)[1])

    def many():
        return jax.block_until_ready(
            shard_map_track_block(mesh, cfg, *args)[1])

    def max_dev(a, b):
        return max(float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k])))
                         / (np.abs(np.asarray(b[k])).mean() + 1.0))
                   for k in b)

    out1, _ = timed(one)
    _, warm1 = timed(one)
    outw = wide()
    outn, cold = timed(many)
    _, warm = timed(many)
    differ = [k for k in out1
              if not np.array_equal(np.asarray(out1[k]), np.asarray(outn[k]))]
    check(not differ, f"sharded outputs {differ} differ from one device "
          f"(max relative deviation {max_dev(outn, out1):.2e})")
    # one vmap over all channels changes the lane width, and with it
    # XLA's reduction order: equal to float tolerance, not bitwise
    wide_dev = max_dev(outw, out1)
    report(name, card, cold, warm, devices=n_dev, channels=n_channels,
           epochs=epochs, one_device_warm_s=round(warm1, 4),
           bit_equal=True, one_wide_vmap_max_dev=f"{wide_dev:.2e}")


def phase_doppler_acq(name, card, s, sig, n_prns, n_dev):
    """Doppler-bin-sharded coarse search vs one device on the same grid."""
    import jax
    import jax.numpy as jnp

    from bds3_tpu.acquire.pcps import (
        AcqConfig, acq_code_tables, coarse_search, make_acq_config)
    from bds3_tpu.parallel.mesh import make_mesh
    from bds3_tpu.parallel.sharded import doppler_sharded_coarse_search
    from bds3_tpu.utils.phase import phase_tables

    cfg = make_acq_config(s)
    d8, p8 = acq_code_tables(s, np.arange(1, n_prns + 1))
    n_bc = -(-cfg.n_bins // cfg.bin_chunk)
    per_dev = -(-n_bc // n_dev) * cfg.bin_chunk
    freqs = cfg.freq_base + cfg.freq_step * np.arange(n_dev * per_dev)
    a_b, c1_b = (jnp.asarray(x) for x in phase_tables(freqs, cfg.fs))
    full = AcqConfig(**{**cfg.__dict__, "n_bins": n_dev * per_dev})
    args = (jnp.asarray(np.asarray(sig[: cfg.n_fft])), jnp.asarray(d8),
            jnp.asarray(p8), a_b, c1_b)
    mesh = make_mesh(n_dev, ("channel",))
    one = jax.block_until_ready(coarse_search(*args, full))
    many, cold = timed(lambda: jax.block_until_ready(
        doppler_sharded_coarse_search(mesh, *args, cfg)))
    _, warm = timed(lambda: jax.block_until_ready(
        doppler_sharded_coarse_search(mesh, *args, cfg)))
    for label, a, b in zip(("bin", "phase"), one[1:], many[1:]):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"winning {label} differs from one device")
    rel = float(np.max(np.abs(np.asarray(many[0]) / np.asarray(one[0]) - 1)))
    check(rel <= 1e-5, f"peak values differ by {rel:.2e}")
    report(name, card, cold, warm, devices=n_dev, prns=n_prns,
           bins=n_dev * per_dev, max_peak_rel_dev=f"{rel:.2e}")


def phase_timeshard(name, card, s, sig, n_channels, n_epochs, n_dev,
                    n_geom):
    """Time-sharded tracking with state handoff vs the sequential run."""
    from types import SimpleNamespace

    from bds3_tpu.parallel.mesh import make_mesh
    from bds3_tpu.parallel.timeshard_track import time_sharded_track
    from bds3_tpu.track.driver import track

    inits = make_inits(s, B2A_SATS, n_channels)
    mesh = make_mesh(n_dev, ("time",))
    ref = track(sig, s, inits, n_epochs=n_epochs,
                epochs_per_block=n_epochs // n_dev)

    def run():
        return time_sharded_track(mesh, sig, s, inits, n_epochs,
                                  n_groups=n_dev)

    out, cold = timed(run)
    out, warm = timed(run)
    base = np.array([c.acquired_freq for c in inits])
    blks = out["blksize"].astype(np.int64)
    cursors0 = np.array([c.code_phase for c in inits], dtype=np.int64)
    test = SimpleNamespace(
        outputs=out,
        absolute_sample=cursors0[:, None] + np.cumsum(blks, axis=1),
        carr_freq=base[:, None] + out["d_cyc"].astype(np.float64)
        * s.sampling_freq)
    dev = compare_tracks(ref, test, n_geom, CORR_KEYS)
    report(name, card, cold, warm, devices=n_dev, channels=n_channels,
           epochs=n_epochs, **dev)


def device_phase(n_devices: int) -> str:
    import jax

    from bds3_tpu.utils.jax_setup import enable_compilation_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeError(f"no GPU: JAX found {devs[0].platform!r} devices")
    cache = enable_compilation_cache()
    check(len(devs) >= n_devices,
          f"{len(devs)} GPU(s), this run needs {n_devices}")
    card = card_identity()
    print(f"[device] platform={devs[0].platform} kind=\"{devs[0].device_kind}\""
          f" count={len(devs)} jax={jax.__version__}"
          f" XLA_FLAGS=\"{os.environ.get('XLA_FLAGS', '')}\""
          f" compile_cache={cache}", flush=True)
    print(card, flush=True)
    return card


def run_one_card(card: str) -> None:
    from bds3_tpu.config import TrackMode, b1c_settings, b2a_settings

    workers = os.cpu_count() or 1
    s2 = b2a_settings()
    sig2 = synth(s2, B2A_SATS, 2200.0, amplitude=0.65)
    phase_track("track_b2a", card, s2, sig2, B2A_SATS, 12, 2000, 2000,
                GEOMETRY_EPOCHS["b2a"], CORR_KEYS)

    s1 = b1c_settings(sampling_freq=99.375e6, intermediate_freq=14.58e6,
                      track_mode=TrackMode.WIDEBAND, wb_code_blend="split")
    sig1 = synth(s1, B1C_SATS, 1600.0, amplitude=0.22)
    phase_track("track_b1c_wb", card, s1, sig1, B1C_SATS, 12, 150, 150,
                GEOMETRY_EPOCHS["b1c"], CORR_KEYS + WB_KEYS)

    phase_acquire("acquire_b2a", card, s2, sig2, B2A_SATS, 63)
    phase_acquire("acquire_b1c", card, s1, sig1, B1C_SATS, 63)
    del sig1, sig2

    fs = 99.375e6 / 4
    sr = b2a_settings(sampling_freq=fs, intermediate_freq=fs / 4,
                      ms_to_process=20_000, use_tropo_corr=False,
                      acq_satellite_list=tuple(range(1, 9)), num_channels=6)
    with tempfile.TemporaryDirectory() as tmp:
        phase_receiver("receiver_b2a", card, sr, 6, workers, tmp)


def run_four_cards(card: str) -> None:
    """Every sharded phase runs; the run fails if any of them failed."""
    from bds3_tpu.config import b2a_settings

    s = b2a_settings()
    sig = synth(s, B2A_SATS, 460.0, amplitude=0.65)
    failed = []
    for phase in (
            lambda: phase_fanout("fanout_b2a", card, s, sig, 48, 200, 4),
            lambda: phase_doppler_acq("doppler_acq", card, s, sig, 63, 4),
            lambda: phase_timeshard("timeshard", card, s, sig, 12, 400, 4,
                                    GEOMETRY_EPOCHS["b2a"])):
        try:
            phase()
        except SmokeError as e:
            print(f"[four] FAILED: {e}", flush=True)
            failed.append(str(e))
    check(not failed, "; ".join(failed))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths on four cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    n_dev = 4 if args.four else 1
    try:
        card = device_phase(n_dev)
        if args.four:
            run_four_cards(card)
        else:
            run_one_card(card)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    import jax

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
