"""Checks that need a CUDA device: the prefix-sum correlator against the
per-sample reference at the reference rate, and the device decimator
against host scipy.  They skip without a card; run them there with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_bucket_matches_gather_on_gpu(gpu_device):
    import jax.numpy as jnp

    import chip_smoke as cs
    from bds3_tpu.config import b2a_settings
    from bds3_tpu.track.driver import track
    from bds3_tpu.track.state import CORRELATORS

    s = b2a_settings()                       # 99.375 Msps
    sig = jnp.asarray(cs.synth(s, cs.B2A_SATS, 70.0, amplitude=0.65))
    inits = cs.make_inits(s, cs.B2A_SATS, 4)
    res = {c: track(sig, s, inits, n_epochs=60, epochs_per_block=60,
                    correlator=c) for c in CORRELATORS}
    cs.compare_tracks(res["gather"], res["bucket"], 30, cs.CORR_KEYS)


def test_device_decimator_matches_host_on_gpu(gpu_device):
    from bds3_tpu.acquire.resample import (
        plan_resample, resample_signal, resample_signal_device)
    from bds3_tpu.config import b1c_settings

    s = b1c_settings(sampling_freq=99.375e6, intermediate_freq=14.58e6)
    plan = plan_resample(s)
    sig = np.random.default_rng(5).integers(-30, 30, 2_000_000).astype(
        np.int8)
    host = resample_signal(sig, s, plan)
    dev = np.asarray(resample_signal_device(sig, s, plan))
    guard = int(3 * 701 * plan.new_fs / plan.old_fs) + 4
    h, d = host[guard:-guard], dev[guard:-guard]
    scale = np.abs(h).mean() + 1e-9
    np.testing.assert_allclose(d / scale, h / scale, atol=5e-3)
