"""Time-sharded tracking (loop-state handoff over a "time" mesh axis)
must reproduce the single-device sequential run (SURVEY.md section 2.5:
the domain's sequence-parallelism equivalent; reference semantics
preserved: NCO carry across blocks, `tracking.m:156-164,230-233`)."""
import jax
import numpy as np
import pytest

from bds3_tpu.acquire import acquire
from bds3_tpu.config import b2a_settings
from bds3_tpu.io import SatParams, synthesize_if
from bds3_tpu.parallel.mesh import make_mesh
from bds3_tpu.parallel.timeshard_track import time_sharded_track
from bds3_tpu.track.driver import track
from bds3_tpu.track.state import assign_channels


def _setup(n_ms=420.0):
    s = b2a_settings(
        sampling_freq=20e6,
        intermediate_freq=5e6,
        acq_satellite_list=(7, 19),
        num_channels=4,
    )
    sats = [
        SatParams(prn=7, doppler_hz=-1830.0, code_phase_chips=700.0,
                  amplitude=0.9, carrier_phase=0.1),
        SatParams(prn=19, doppler_hz=950.0, code_phase_chips=4100.0,
                  amplitude=0.9, carrier_phase=0.6),
    ]
    sig = synthesize_if(s, sats, n_ms=n_ms, noise_std=1.5, seed=9)
    acq = acquire(sig, s)
    chans = assign_channels(acq, s)
    assert len(chans) == 2
    # 4 channels (2 groups of 2) from the 2 acquired sats
    chans = chans + [type(c)(**c.__dict__) for c in chans]
    return s, sig, chans


class TestTimeShardedTracking:
    @pytest.mark.parametrize("correlator", ["bucket", "gather"])
    def test_four_shards_equal_sequential(self, correlator):
        s, sig, chans = _setup()
        n_dev = 4
        n_epochs = 320                      # 80 epochs per time shard
        mesh = make_mesh(n_dev, ("time",))

        ref = track(np.asarray(sig), s, chans, n_epochs=n_epochs,
                    epochs_per_block=n_epochs // n_dev,
                    correlator=correlator)
        out = time_sharded_track(mesh, sig, s, chans, n_epochs,
                                 n_groups=2, correlator=correlator)

        for k in ("d_ip", "d_qp", "carr_err", "code_err", "blksize"):
            np.testing.assert_allclose(
                out[k], ref.outputs[k], rtol=3e-5, atol=3e-4, err_msg=k)

    def test_eight_shards_exact(self):
        """Same per-group vmap width as the reference run -> the handoff
        arithmetic is identical to the sequential driver's block rebase,
        so the match is exact (measured 0.0 rel diff)."""
        s, sig, chans = _setup(n_ms=500.0)
        n_dev = 8
        n_epochs = 400
        mesh = make_mesh(n_dev, ("time",))
        ref = track(np.asarray(sig), s, chans, n_epochs=n_epochs,
                    epochs_per_block=n_epochs // n_dev)
        out = time_sharded_track(mesh, sig, s, chans, n_epochs,
                                 n_groups=2)
        np.testing.assert_allclose(out["d_ip"], ref.outputs["d_ip"],
                                   rtol=0, atol=0)
        np.testing.assert_array_equal(out["blksize"], ref.outputs["blksize"])

    def test_eight_shards_single_channel_groups(self):
        """Cg=1 changes the vmapped lane width, which changes XLA's f32
        reduction order; the closed loop amplifies the last-bit noise
        over 400 epochs.  The trajectory must stay equivalent (<1%
        correlator deviation) even though it is not bitwise equal."""
        s, sig, chans = _setup(n_ms=500.0)
        mesh = make_mesh(8, ("time",))
        ref = track(np.asarray(sig), s, chans, n_epochs=400,
                    epochs_per_block=50)
        out = time_sharded_track(mesh, sig, s, chans, 400, n_groups=4)
        r = np.abs(out["d_ip"] - ref.outputs["d_ip"]) \
            / np.maximum(np.abs(ref.outputs["d_ip"]), 1.0)
        assert r.max() < 0.01, r.max()

    @pytest.mark.parametrize("correlator", ["bucket", "gather"])
    def test_2d_mesh_time_by_channel(self, correlator):
        """2-D ("time", "channel") mesh: loop-state handoff ring x
        channel fan-out composes; equals the sequential run."""
        s, sig, chans = _setup()
        mesh = make_mesh(8, ("time", "channel"), shape=(4, 2))
        ref = track(np.asarray(sig), s, chans, n_epochs=320,
                    epochs_per_block=80, correlator=correlator)
        out = time_sharded_track(mesh, sig, s, chans, 320, n_groups=2,
                                 channel_axis="channel",
                                 correlator=correlator)
        # channel sharding changes the vmap lane width (Cg 2 -> 1),
        # which changes XLA's f32 reduction order; the closed loop
        # amplifies last-bit noise (same criterion as
        # test_eight_shards_single_channel_groups).
        # d_qp is PLL-nulled (noise-scale), so only the prompt in-phase
        # trajectory is compared (as in the Cg=1 test above)
        r = np.abs(out["d_ip"] - ref.outputs["d_ip"]) \
            / np.maximum(np.abs(ref.outputs["d_ip"]), 1.0)
        assert r.max() < 0.01, r.max()
        # blksize may differ by +-1 sample where last-bit trajectory
        # noise flips a ceil (same reason the correlators are not
        # bitwise); it must never drift
        db = out["blksize"] - ref.outputs["blksize"]
        assert np.abs(db).max() <= 1.0, np.abs(db).max()
