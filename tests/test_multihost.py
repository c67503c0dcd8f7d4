"""Real multi-process `jax.distributed` runs (2 processes x 2 CPU
devices, Gloo collectives) must reproduce the single-process 4-device
result for both distributed tracking modes:

  channel — channel fan-out over a global ("channel",) mesh
            (parallel/sharded.sharded_track_block)
  time    — time-sharded closed-loop tracking whose ppermute loop-state
            handoff crosses the process boundary
            (parallel/timeshard_track.time_sharded_track)

The reference is a single MATLAB process; multi-host is a first-class
new-framework axis (SURVEY.md §2.5).  Process-spanning collectives ride
the cluster network across hosts; Gloo stands in here exactly as the
8-device CPU mesh stands in for the cards of one host.
"""
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from bds3_tpu.acquire import acquire
from bds3_tpu.config import b2a_settings
from bds3_tpu.io import SatParams, synthesize_if
from bds3_tpu.track.state import assign_channels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(mode: str) -> dict:
    """Run 2 ranks x 2 devices; return rank 0's gathered outputs."""
    port = _free_port()
    out = os.path.join(tempfile.mkdtemp(), f"mh_{mode}.npz")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "MH_LOCAL_DEVICES": "2", "XLA_FLAGS": ""}
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(r), "2", str(port), mode, out],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    assert os.path.exists(out), f"rank 0 wrote nothing:\n{logs[0]}"
    return dict(np.load(out))


def _scenario():
    """Must match tools/multihost_worker.py exactly."""
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
    chans = chans + [type(c)(**c.__dict__) for c in chans]
    return s, sig, chans


class TestMultiProcess:
    def test_channel_fanout_2proc(self):
        """2-process channel-sharded tracking == local 4-device run."""
        import jax

        from bds3_tpu.parallel.mesh import make_mesh
        from bds3_tpu.parallel.sharded import sharded_track_block
        from bds3_tpu.track.driver import channel_code_tables
        from bds3_tpu.track.state import (
            channel_consts, code_coarse_tables, initial_state,
            make_track_config,
        )

        got = _launch("channel")

        s, sig, chans = _scenario()
        mesh = make_mesh(4, ("channel",))
        W = 40
        cfg = make_track_config(s, complex_input=False, epochs_per_block=W)
        consts = channel_consts(cfg, chans, s)
        data_t, p11_t, p61_t = channel_code_tables(cfg, chans)
        ckd_i, ckd_f = code_coarse_tables(cfg, cfg.m_data)
        cursors = np.array([c.code_phase for c in chans])
        state = initial_state(cfg, chans, consts, cursors)
        n_block = int(cursors.max()) + W * (cfg.q0_int + 3) + cfg.n_max
        block = np.asarray(sig[:n_block], dtype=np.float32)
        _, ref = sharded_track_block(
            mesh, cfg, block, data_t, p11_t, p61_t,
            ckd_i, ckd_f, ckd_i, ckd_f, consts, state)
        jax.block_until_ready(ref["d_ip"])

        for k in ("d_ip", "d_qp", "carr_err", "code_err", "blksize"):
            np.testing.assert_allclose(
                got[k], np.asarray(ref[k]), rtol=1e-6, atol=1e-4,
                err_msg=k)

    def test_timeshard_handoff_2proc(self):
        """2-process time-sharded tracking (state handoff over the
        process boundary) == local 4-device time-sharded run."""
        from bds3_tpu.parallel.mesh import make_mesh
        from bds3_tpu.parallel.timeshard_track import time_sharded_track

        got = _launch("time")

        s, sig, chans = _scenario()
        mesh = make_mesh(4, ("time",))
        ref = time_sharded_track(mesh, sig, s, chans, 160, n_groups=2)

        for k in ("d_ip", "d_qp", "carr_err", "code_err", "blksize"):
            np.testing.assert_allclose(
                got[k], ref[k], rtol=1e-6, atol=1e-4, err_msg=k)


class TestLauncher:
    def test_local_backend_rendezvous(self, tmp_path):
        """tools/launch_multihost.py local: env-var plumbing must let an
        argument-free multihost.initialize() rendezvous a 2-process
        global mesh (the same contract the slurm backend relies on)."""
        sys.path.insert(0, os.path.join(REPO, "tools"))
        from launch_multihost import launch_local

        prog = (
            "import os, jax, sys\n"
            "sys.path.insert(0, os.environ['BDS3_REPO'])\n"
            "from bds3_tpu.parallel.multihost import initialize, "
            "global_channel_mesh\n"
            "initialize()\n"
            "mesh = global_channel_mesh()\n"
            "assert mesh.devices.size == 4, mesh.devices\n"
            "open(os.path.join(os.environ['MH_OUT'], "
            "f\"rank{jax.process_index()}\"), 'w').write('ok')\n"
        )
        rc = launch_local(
            2, [sys.executable, "-c", prog], local_devices=2,
            env_extra={"BDS3_REPO": REPO, "MH_OUT": str(tmp_path)})
        assert rc == 0
        assert (tmp_path / "rank0").exists() and (tmp_path / "rank1").exists()

    def test_slurm_and_pod_emission(self):
        sys.path.insert(0, os.path.join(REPO, "tools"))
        from launch_multihost import emit_slurm

        script = emit_slurm(4, ["python", "run.py"])
        assert "--nodes=4" in script
        assert "JAX_PROCESS_ID" in script and "SLURM_PROCID" in script
