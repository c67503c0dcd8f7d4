"""Capture a jax.profiler trace of the tracking hot path, and reduce a
trace to device busy/idle time and the top device operations.

The aux-subsystem counterpart of the reference's tic/toc hooks
(`BDS-3_B1C/postProcessing.m:104-112`).

    python tools/profile_trace.py [outdir] [seconds]

traces one warm 12-channel B2a tracking run at the reference rate on a
GPU and prints the reduction as JSON.  Open the trace itself with TensorBoard's
profile plugin or ui.perfetto.dev.  `reduce_trace` is what
benchmarks/correlator_variants.py reports.
"""
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

WINDOW = "bds3_window"   # TraceAnnotation name of the measured window


def _union_ns(intervals) -> float:
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def reduce_trace(trace_dir: str, device_prefix: str = "/device:GPU",
                 top: int = 15) -> dict:
    """Device busy time, idle share and top operations of the newest
    trace under trace_dir.

    Busy is the union of the event intervals on the device plane's
    stream lines (kernels and copies).  The idle share is 1 - busy over
    the `bds3_window` annotation when the trace has one, else over the
    device's first-to-last event span.  Top operations sum event
    durations by name on the "XLA Ops" line (stream events otherwise)."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = ProfileData.from_file(paths[-1])
    window = None
    busy_iv, op_events, line_names = [], [], {}
    host_device = device_prefix.startswith("/host")   # CPU backend
    for plane in data.planes:
        for line in plane.lines:
            evs = [(ev.name, ev.start_ns, ev.end_ns) for ev in line.events]
            if plane.name.startswith("/host"):
                window = next(((s, e) for n, s, e in evs if n == WINDOW),
                              window)
            if not plane.name.startswith(device_prefix):
                continue
            line_names.setdefault(plane.name, []).append(line.name)
            if line.name == "XLA Ops":
                op_events += evs
            elif "Stream" in line.name or (
                    host_device and line.name.startswith("tf_XLA")):
                busy_iv += [(s, e) for _, s, e in evs]
    if not busy_iv:
        raise ValueError(f"no device events on planes {device_prefix}*")
    if not op_events:
        op_events = []
        for plane in data.planes:
            if plane.name.startswith(device_prefix):
                for line in plane.lines:
                    op_events += [(ev.name, ev.start_ns, ev.end_ns)
                                  for ev in line.events]
    busy = _union_ns(busy_iv)
    span = (min(s for s, _ in busy_iv), max(e for _, e in busy_iv))
    win = window if window is not None else span
    win_ns = win[1] - win[0]
    in_win = _union_ns([(max(s, win[0]), min(e, win[1]))
                        for s, e in busy_iv if e > win[0] and s < win[1]])
    by_name = {}
    for name, s, e in op_events:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (e - s), n + 1)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "trace": paths[-1],
        "device_lines": line_names,
        "window_from": "annotation" if window is not None else "device span",
        "window_ms": win_ns / 1e6,
        "busy_ms": in_win / 1e6,
        "idle_share": 1.0 - in_win / win_ns if win_ns > 0 else None,
        "device_busy_total_ms": busy / 1e6,
        "top_ops": [{"name": k, "total_ms": v[0] / 1e6, "count": v[1]}
                    for k, v in ops],
    }


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        "perf_out", "trace_b2a")
    seconds = float(sys.argv[2]) if len(sys.argv) > 2 else 0.2

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform!r}")

    from bds3_tpu.config import b2a_settings
    from bds3_tpu.io import SatParams, synthesize_if
    from bds3_tpu.track.driver import track
    from bds3_tpu.track.state import ChannelInit

    s = b2a_settings()
    n_ms = seconds * 1e3
    sats = [SatParams(prn=p, doppler_hz=fd, code_phase_chips=cp,
                      amplitude=0.65)
            for p, fd, cp in [(5, 1650.0, 4100.0), (19, 700.0, 55.0)]]
    sig_dev = jnp.asarray(synthesize_if(s, sats, n_ms=n_ms, noise_std=2.0,
                                        seed=1))
    inits = [ChannelInit(prn=5, acquired_freq=s.intermediate_freq + 1650.0,
                         code_phase=0, peak_metric=2.0)] * 12
    n_ep = int(n_ms) - 2

    def run():
        res = track(sig_dev, s, inits, n_epochs=n_ep, epochs_per_block=n_ep,
                    download=False)
        res.outputs.block_until_ready()
        return res

    run()                                  # compile outside the trace
    with jax.profiler.trace(outdir):
        with jax.profiler.TraceAnnotation(WINDOW):
            t0 = time.perf_counter()
            res = run()
            wall = time.perf_counter() - t0
    print(json.dumps({"epochs": n_ep, "channels": 12,
                      "correlator": res.correlator, "wall_s": wall,
                      "device_kind": dev.device_kind,
                      **reduce_trace(outdir)}, indent=1))


if __name__ == "__main__":
    main()
