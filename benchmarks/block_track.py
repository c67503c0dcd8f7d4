"""Time one track_block call (B2a, 12 channels, full rate) on the device."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from bds3_tpu.config import b2a_settings
from bds3_tpu.track.driver import channel_code_tables
from bds3_tpu.track.scan import track_block
from bds3_tpu.track.state import (
    ChannelInit, channel_consts, code_coarse_tables, initial_state,
    make_track_config,
)


def main():
    W = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    C = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    corr = sys.argv[3] if len(sys.argv) > 3 else "auto"
    s = b2a_settings()
    cfg = make_track_config(s, epochs_per_block=W, correlator=corr)
    inits = [ChannelInit(prn=1 + i % 30, acquired_freq=s.intermediate_freq + 50.0 * i,
                         code_phase=137 * i, peak_metric=2.0) for i in range(C)]
    consts = channel_consts(cfg, inits, s)
    data_t, p11_t, p61_t = channel_code_tables(cfg, inits)
    cki, ckf = code_coarse_tables(cfg, cfg.m_data)
    cursors = np.array([c.code_phase for c in inits])
    state = initial_state(cfg, inits, consts, cursors)
    n_block = int(cursors.max()) + W * (cfg.q0_int + 4) + cfg.n_max + 4 * cfg.q0_int
    rng = np.random.default_rng(0)
    block = rng.integers(-30, 30, n_block).astype(np.int8)

    args = (cfg, jax.numpy.asarray(block), jax.numpy.asarray(data_t),
            jax.numpy.asarray(p11_t), jax.numpy.asarray(p61_t),
            jax.numpy.asarray(cki), jax.numpy.asarray(ckf),
            jax.numpy.asarray(cki), jax.numpy.asarray(ckf), consts, state)

    import jax.numpy as jnp

    def force():
        st, outs = track_block(*args)
        return float(np.asarray(jnp.sum(outs["d_ip"])))

    t0 = time.time()
    force()
    print(f"compile+first: {time.time()-t0:.2f}s")
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        force()
    dt = (time.time() - t0) / reps
    ms_signal = W * s.int_time * 1e3
    print(f"[{cfg.correlator}] steady: {dt:.3f}s for {W} epochs x {C}ch "
          f"-> {dt/W*1e3:.2f} ms/epoch, {ms_signal/1e3/dt:.2f}x realtime")


if __name__ == "__main__":
    main()
