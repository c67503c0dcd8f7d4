"""Capture-scale streaming ingest proof: track 12 channels through a 4.9 GB
on-disk capture (the reference's dataset envelope: 49 s at 99.375 Msps,
README.md:135-141) WITHOUT holding the capture in host or device memory.

The capture is built once by exact tiling: with doppler = 0 an integer
number of carrier cycles (IF * 1 s) and code periods (1000) complete in
exactly one second (99 375 000 samples), so a 1 s synthesized block
tiles into an arbitrarily long phase-continuous capture.  Tracking then
streams it through StreamingCapture (native pread + lookahead thread)
in ~200 MB blocks while the tracking scan walks each block on-device.

Usage: python tools/streaming_demo.py [seconds=49]
Prints total wall, realtime factor, and per-channel lock state.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CAPTURE = "/tmp/bds3_big_capture.bin"


def build_capture(s, seconds: int) -> str:
    from bds3_tpu.io import SatParams, synthesize_if

    n_tile = int(s.sampling_freq)          # exactly 1 s
    total = seconds * n_tile
    if os.path.exists(CAPTURE) and os.path.getsize(CAPTURE) == total:
        return CAPTURE
    sats = [
        SatParams(prn=p, doppler_hz=0.0, code_phase_chips=cp, amplitude=0.65)
        for p, cp in ((5, 4100.0), (12, 8123.0), (19, 55.0), (30, 9000.0))
    ]
    t0 = time.time()
    tile = np.asarray(
        synthesize_if(s, sats, n_ms=1000.0, noise_std=2.0, seed=11),
        dtype=np.int8)
    assert len(tile) == n_tile, (len(tile), n_tile)
    print(f"[stream] synthesized 1 s tile in {time.time() - t0:.0f}s; "
          f"tiling to {total / 1e9:.2f} GB ...", flush=True)
    with open(CAPTURE, "wb") as f:
        for _ in range(seconds):
            tile.tofile(f)
    return CAPTURE


def main():
    seconds = int(sys.argv[1]) if len(sys.argv) > 1 else 49

    from bds3_tpu.config import b2a_settings
    from bds3_tpu.io.stream import StreamingCapture
    from bds3_tpu.track.driver import track
    from bds3_tpu.track.state import ChannelInit
    from bds3_tpu.utils.jax_setup import enable_compilation_cache

    enable_compilation_cache()
    s = b2a_settings()
    path = build_capture(s, seconds)
    cap = StreamingCapture(path)
    print(f"[stream] capture {len(cap) / 1e9:.2f} GB at {path}", flush=True)

    base = [(5, 4100.0), (12, 8123.0), (19, 55.0), (30, 9000.0)]
    inits = []
    for i in range(12):
        prn, cp = base[i % 4]
        chi0 = cp % s.code_length
        start = ((s.code_length - chi0) % s.code_length) / s.code_freq_basis
        inits.append(ChannelInit(
            prn=prn, acquired_freq=s.intermediate_freq,
            code_phase=int(round(start * s.sampling_freq)),
            peak_metric=2.0))

    W = 2000
    n_epochs = (seconds - 1) * 1000        # leave block-tail margin
    t0 = time.time()
    res = track(cap, s, inits, n_epochs=n_epochs, epochs_per_block=W,
                download=False)
    ip = np.asarray(res.outputs["d_ip"][:, -400:])
    qp = np.asarray(res.outputs["d_qp"][:, -400:])
    wall = time.time() - t0
    locked = int((np.abs(ip).mean(axis=1) > 4 * np.abs(qp).mean(axis=1)).sum())
    tracked = res.n_epochs * s.int_time
    print(f"[stream] correlator={res.correlator}: {tracked:.1f}s x 12ch "
          f"from disk in {wall:.1f}s -> {tracked / wall:.2f}x realtime "
          f"(incl. compile + IO), locked {locked}/12", flush=True)
    assert locked >= 10, "lost lock on streamed capture"
    print("STREAMING DEMO PASS")


if __name__ == "__main__":
    main()
