"""Top-level receiver pipeline: acquisition -> tracking -> nav decode ->
PVT.

The equivalent of the reference's `postProcessing.m` drivers
(`BDS-3_B2a/postProcessing.m:60-169`, `BDS-3_B1C/postProcessing.m`):
one entry point shared by both signals, checkpointing between stages,
returning a structured result object instead of workspace globals.
"""
from __future__ import annotations

import dataclasses
import pickle
import time

import numpy as np

from bds3_tpu.acquire import AcqResults, acquire
from bds3_tpu.acquire.pcps import make_acq_config
from bds3_tpu.config import FileType, Settings, Signal
from bds3_tpu.io.ifdata import IFDataFile
from bds3_tpu.pvt.solver import NavSolutions, post_navigation
from bds3_tpu.track.driver import TrackResults, track
from bds3_tpu.track.state import ChannelInit, assign_channels


@dataclasses.dataclass
class ReceiverResults:
    settings: Settings
    acq: AcqResults
    channels: list[ChannelInit]
    track: TrackResults | None
    nav: NavSolutions | None
    timings: dict
    # per-channel C/N0 + PLL-lock summary (observe.cn0.channel_health);
    # the reference computes these live every CNoInterval epochs
    # (tracking.m:409-434) — here they gate the status report (PVT stays
    # decode-gated for parity with postNavigation.m:83-104)
    health: list[dict] = dataclasses.field(default_factory=list)


def acquisition_signal_length(s: Settings) -> int:
    """Samples needed by the acquisition stage (coarse FFT window + fine
    window, cf. postProcessing.m acq reads).  With resampling active the
    requirement is mapped back to the original rate (+ filter margin)."""
    if s.resampling and s.sampling_freq > s.resampling_threshold:
        from bds3_tpu.acquire.resample import plan_resample

        plan = plan_resample(s)
        s_low = dataclasses.replace(
            s, sampling_freq=plan.new_fs, intermediate_freq=plan.new_if,
            resampling=False)
        need_low = acquisition_signal_length(s_low)
        return int(np.ceil((need_low + 2) * plan.old_fs / plan.new_fs)) \
            + 3 * 701
    cfg = make_acq_config(s)
    return cfg.n_fft + max(cfg.fine_noncoh, 1) * cfg.samples_per_code \
        + cfg.samples_per_code


def resident_by_default(signal) -> bool:
    """Whether `run_receiver(device_resident="auto")` uploads the capture
    up front: real int8 captures below the scan path's int32 offset
    bound.  Decided by the capture alone, the same on every backend."""
    return (
        not np.iscomplexobj(signal)
        and np.dtype(getattr(signal, "dtype", np.float32)) == np.int8
        and len(signal) < 2**31 - 2**28
    )


def run_receiver(
    signal: np.ndarray | IFDataFile,
    settings: Settings,
    n_epochs: int | None = None,
    epochs_per_block: int = 200,
    checkpoint_path: str | None = None,
    prns=None,
    acq_results: AcqResults | None = None,
    verbose: bool = True,
    device_resident: bool | str = "auto",
    transport: str = "none",
) -> ReceiverResults:
    """Full cold-start pipeline on an IF capture.

    Pass `acq_results` to reuse a previous acquisition (the reference's
    settings.skipAcquisition workflow, postProcessing.m:81-85).

    device_resident: upload the whole capture to device memory up front
    so tracking runs as ONE compiled lax.scan dispatch (track/driver.py's
    scan path) instead of per-block host-orchestrated uploads.  "auto"
    decides on the capture alone (`resident_by_default`): real int8
    captures that fit the scan path's int32 indexing go resident,
    anything else streams per block.
    transport: "int4" ships the capture 4-bit packed (half the
    host->device bytes; io/transport.py) — only used when the capture is
    uploaded up front.
    """
    timings = {}
    if isinstance(signal, IFDataFile):
        if signal.file_type == FileType.IQ8:
            raw = signal.data
            signal = raw[:, 0].astype(np.float32) + 1j * raw[:, 1].astype(np.float32)
        else:
            signal = signal.data

    import jax

    if device_resident == "auto":
        device_resident = resident_by_default(signal)

    t0 = time.time()
    if acq_results is not None:
        acq = acq_results
    else:
        # acquisition reads its window from the HOST source even on the
        # device-resident path: its pipeline mixes host numpy stages
        # (GLRT noise power, argmax of the fine scores) with device FFTs
        acq = acquire(signal[: acquisition_signal_length(settings)],
                      settings, prns)
    timings["acquire_s"] = time.time() - t0

    if device_resident and not isinstance(signal, jax.Array):
        from bds3_tpu.io.transport import upload_capture

        t_up = time.time()
        signal = upload_capture(signal, packing=transport)
        timings["upload_s"] = time.time() - t_up
        if verbose:
            print(f"[upload] capture -> device in "
                  f"{timings['upload_s']:.2f}s (transport={transport})")
    if verbose:
        det = ", ".join(
            f"{p}({m:.1f})" for p, m in
            zip(acq.prns[acq.detected], acq.peak_metric[acq.detected])
        )
        print(f"[acquire] {timings['acquire_s']:.2f}s detected: ({det})")

    channels = assign_channels(acq, settings)
    if not channels:
        return ReceiverResults(settings, acq, [], None, None, timings)
    if verbose:
        from bds3_tpu.observe.tables import channel_init_table

        print(channel_init_table(channels))

    if n_epochs is None:
        n_epochs = settings.int_epochs
    t0 = time.time()
    # if the capture was not uploaded up front (too large, complex or
    # not int8), the per-block streaming path applies the packed
    # transport itself
    trk = track(signal, settings, channels, n_epochs=n_epochs,
                epochs_per_block=min(epochs_per_block, n_epochs),
                transport="none" if isinstance(signal, jax.Array)
                else transport)
    timings["track_s"] = time.time() - t0
    ms_tracked = trk.n_epochs * settings.int_time * 1e3
    timings["track_realtime_factor"] = ms_tracked / 1e3 / timings["track_s"]
    if verbose:
        print(f"[track] {timings['track_s']:.2f}s for {ms_tracked:.0f} ms x "
              f"{len(channels)} channels "
              f"({timings['track_realtime_factor']:.2f}x realtime)")

    from bds3_tpu.observe.cn0 import channel_health

    health = channel_health(trk)
    if verbose:
        for h in health:
            flag = "" if h["lock_ok"] else "  ** LOW LOCK **"
            print(f"[health] PRN {h['prn']:2d}: C/N0 {h['cn0_db']:5.1f} dB-Hz"
                  f"  PLL lock {h['pll_lock']:+.2f}{flag}")

    if checkpoint_path:
        # checkpoint between tracking and PVT (postProcessing.m:133-135)
        with open(checkpoint_path, "wb") as f:
            pickle.dump({"settings": settings, "acq": acq,
                         "channels": channels, "track": trk}, f)

    t0 = time.time()
    nav = post_navigation(trk, settings)
    timings["pvt_s"] = time.time() - t0
    if verbose:
        if nav is None:
            print("[pvt] no solution (insufficient decoded satellites)")
        else:
            ok = np.isfinite(nav.x)
            print(f"[pvt] {ok.sum()}/{len(nav.x)} fixes in "
                  f"{timings['pvt_s']:.2f}s")
    return ReceiverResults(settings, acq, channels, trk, nav, timings,
                           health=health)


def resume_from_checkpoint(path: str) -> ReceiverResults:
    """Re-run PVT from a tracking checkpoint (the reference's
    trackingResults.mat workflow)."""
    with open(path, "rb") as f:
        st = pickle.load(f)
    nav = post_navigation(st["track"], st["settings"])
    return ReceiverResults(st["settings"], st["acq"], st["channels"],
                           st["track"], nav, {})
