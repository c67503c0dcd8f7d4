"""Time the tracking correlators on the current device.

    python benchmarks/correlator_variants.py [--out DIR] [--passes N]

Correlators: "gather" (per-sample reference semantics) and "bucket"
(prefix sums with a native gather of the boundary rows).  A third
variant, bucket with tiled one-hot matmul boundary lookups at HIGHEST
precision, was measured once and removed (17x and 75x slower than
"bucket" on an H100; docs/PERF.md).

Sizes: B2a, 12 channels, 99.375 Msps, 2000 epochs; B1C wideband
("split"), 12 channels, 99.375 Msps, 150 epochs.  For each: compile
seconds, warm walls (device-resident capture, no download, ends in
block_until_ready), a profiler trace of one warm pass reduced by
tools/profile_trace.reduce_trace (idle share, top device ops), and the
chip_smoke correlator tolerances against "gather".  Writes
<out>/correlator_variants.json; traces go to <out>/traces/.  Refuses to
run without a GPU.
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "perf_out"))
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from bds3_tpu.config import TrackMode, b1c_settings, b2a_settings
    from bds3_tpu.track.driver import track
    from bds3_tpu.track.state import CORRELATORS
    from bds3_tpu.utils.jax_setup import enable_compilation_cache
    from profile_trace import WINDOW, reduce_trace

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform!r}")
    enable_compilation_cache()
    card = cs.card_identity()
    s2 = b2a_settings()
    s1 = b1c_settings(sampling_freq=99.375e6, intermediate_freq=14.58e6,
                      track_mode=TrackMode.WIDEBAND, wb_code_blend="split")
    sizes = [("b2a_12ch", s2, cs.B2A_SATS, 2200.0, 0.65, 2000,
              cs.GEOMETRY_EPOCHS["b2a"], cs.CORR_KEYS),
             ("b1c_wb_12ch", s1, cs.B1C_SATS, 1600.0, 0.22, 150,
              cs.GEOMETRY_EPOCHS["b1c"], cs.CORR_KEYS + cs.WB_KEYS)]
    report = {"device_kind": dev.device_kind, "card": card,
              "jax": jax.__version__, "sizes": {}}
    for name, s, sats, n_ms, amp, n_ep, n_geom, keys in sizes:
        sig_dev = jnp.asarray(cs.synth(s, sats, n_ms, amp))
        inits = cs.make_inits(s, sats, 12)
        results, rows = {}, {}
        for variant in CORRELATORS:
            def run(download=False):
                res = track(sig_dev, s, inits, n_epochs=n_ep,
                            epochs_per_block=n_ep, correlator=variant,
                            download=download)
                if not download:
                    res.outputs.block_until_ready()
                return res

            t0 = time.perf_counter()
            results[variant] = run(download=True)
            cold = time.perf_counter() - t0
            walls = []
            for _ in range(args.passes):
                t0 = time.perf_counter()
                run()
                walls.append(time.perf_counter() - t0)
            tdir = os.path.join(args.out, "traces", f"{name}_{variant}")
            with jax.profiler.trace(tdir):
                with jax.profiler.TraceAnnotation(WINDOW):
                    run()
            tr = reduce_trace(tdir)
            rows[variant] = {
                "cold_s": cold, "warm_walls_s": walls,
                "ms_per_epoch": min(walls) / n_ep * 1e3,
                "idle_share": tr["idle_share"], "trace_window_ms":
                tr["window_ms"], "busy_ms": tr["busy_ms"],
                "top_ops": tr["top_ops"][:8]}
            print(f"[{name}] {variant}: {rows[variant]['ms_per_epoch']:.4f} "
                  f"ms/epoch (walls {[round(w, 4) for w in walls]}), idle "
                  f"{tr['idle_share']}, card \"{card}\"", flush=True)
        for variant, row in rows.items():
            try:
                row["vs_gather"] = cs.compare_tracks(
                    results["gather"], results[variant], n_geom, keys)
                row["within_tolerance"] = True
            except cs.SmokeError as e:
                row["vs_gather"], row["within_tolerance"] = str(e), False
            row["locked"] = cs.locked(results[variant])
        report["sizes"][name] = {"epochs": n_ep, "channels": 12,
                                 "variants": rows}
        del sig_dev, results
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "correlator_variants.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    summary = {n: {v: (round(r["ms_per_epoch"], 4), r["within_tolerance"])
                   for v, r in d["variants"].items()}
               for n, d in report["sizes"].items()}
    print(json.dumps({"card": card, "ms_per_epoch_ok": summary}))


if __name__ == "__main__":
    main()
