"""Multi-process worker for the distributed tracking test/demo.

Each process owns a slice of a global mesh (CPU Gloo backend for the
test; the identical code path runs across GPU hosts).  The
reference has no multi-host anything — this is the new framework's
first-class axis (SURVEY.md §2.5).  Two modes:

  channel  — channel-fan-out tracking on a global ("channel",) mesh
             (the domain's data parallelism; sharded.sharded_track_block)
  time     — time-sharded closed-loop tracking with loop-state handoff
             via ppermute across process boundaries
             (parallel/timeshard_track.time_sharded_track)

Usage (one process per rank):
  python tools/multihost_worker.py <rank> <nproc> <port> <mode> <out.npz>

Every rank computes the same global result (outputs are replicated /
gathered); rank 0 writes it to <out.npz> for the parent to compare
against a single-process reference run.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    rank, nproc, port, mode, out_path = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5])
    n_local = int(os.environ.get("MH_LOCAL_DEVICES", "2"))

    import jax

    jax.config.update("jax_platforms", "cpu")
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_local}")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc, process_id=rank)

    import numpy as np

    from bds3_tpu.acquire import acquire
    from bds3_tpu.config import b2a_settings
    from bds3_tpu.io import SatParams, synthesize_if
    from bds3_tpu.track.state import assign_channels

    n_dev = len(jax.devices())
    assert n_dev == nproc * n_local, (n_dev, nproc, n_local)

    # identical deterministic scenario on every rank
    s = b2a_settings(
        sampling_freq=16e6, intermediate_freq=4e6,
        acq_satellite_list=(7, 19), num_channels=4,
    )
    sats = [
        SatParams(prn=7, doppler_hz=-1830.0, code_phase_chips=700.0,
                  amplitude=0.9, carrier_phase=0.1),
        SatParams(prn=19, doppler_hz=950.0, code_phase_chips=4100.0,
                  amplitude=0.9, carrier_phase=0.6),
    ]
    sig = synthesize_if(s, sats, n_ms=260.0, noise_std=1.5, seed=9)
    acq = acquire(sig, s)
    chans = assign_channels(acq, s)
    assert len(chans) == 2
    chans = chans + [type(c)(**c.__dict__) for c in chans]  # 4 channels

    if mode == "channel":
        outs = _channel_mode(s, sig, chans, n_dev)
    elif mode == "time":
        outs = _time_mode(s, sig, chans, n_dev)
    else:
        raise SystemExit(f"unknown mode {mode}")

    if rank == 0:
        np.savez(out_path, **outs)
    # all ranks must stay alive until rank 0 has written (barrier via a
    # trivial global psum)
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from bds3_tpu.parallel.multihost import global_channel_mesh

    mesh = global_channel_mesh("sync")
    jax.jit(jax.shard_map(lambda a: jax.lax.psum(a, "sync"), mesh=mesh,
                          in_specs=P("sync"), out_specs=P()))(
        jnp.ones((n_dev, 1), jnp.float32)).block_until_ready()
    print(f"[rank {rank}] {mode} mode OK", flush=True)


def _channel_mode(s, sig, chans, n_dev):
    """Channel fan-out over the global mesh: one channel per device."""
    import numpy as np

    from bds3_tpu.parallel.multihost import global_channel_mesh
    from bds3_tpu.parallel.sharded import sharded_track_block
    from bds3_tpu.track.driver import channel_code_tables
    from bds3_tpu.track.state import (
        channel_consts, code_coarse_tables, initial_state,
        make_track_config,
    )

    mesh = global_channel_mesh("channel")
    W = 40
    cfg = make_track_config(s, complex_input=False, epochs_per_block=W)
    consts = channel_consts(cfg, chans, s)
    data_t, p11_t, p61_t = channel_code_tables(cfg, chans)
    ckd_i, ckd_f = code_coarse_tables(cfg, cfg.m_data)
    cursors = np.array([c.code_phase for c in chans])
    state = initial_state(cfg, chans, consts, cursors)
    n_block = int(cursors.max()) + W * (cfg.q0_int + 3) + cfg.n_max
    block = np.asarray(sig[:n_block], dtype=np.float32)
    _, outs = sharded_track_block(
        mesh, cfg, block, data_t, p11_t, p61_t,
        ckd_i, ckd_f, ckd_i, ckd_f, consts, state)
    from jax.experimental import multihost_utils

    return {k: np.asarray(multihost_utils.process_allgather(v, tiled=True))
            for k, v in outs.items()}


def _time_mode(s, sig, chans, n_dev):
    """Time-sharded tracking: loop-state ppermute handoff crosses the
    process boundary (Gloo here; the cluster network across hosts)."""
    import numpy as np

    from bds3_tpu.parallel.mesh import make_mesh
    from bds3_tpu.parallel.timeshard_track import time_sharded_track

    mesh = make_mesh(n_dev, ("time",))
    n_epochs = 40 * n_dev
    outs = time_sharded_track(mesh, sig, s, chans, n_epochs, n_groups=2)
    return {k: np.asarray(v) for k, v in outs.items()}


if __name__ == "__main__":
    main()
