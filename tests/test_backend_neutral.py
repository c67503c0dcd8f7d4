"""One path for every backend: choices the receiver makes without asking
which device it runs on, the precision it states for its contractions,
and where it keeps its compile cache."""
import pathlib

import jax
import numpy as np
import pytest

from bds3_tpu.track.state import AUTO_CORRELATOR, resolve_correlator

PKG = pathlib.Path(__file__).resolve().parents[1] / "bds3_tpu"


class TestSingleRule:
    def test_auto_resolves_without_platform(self, monkeypatch):
        def no_platform(*a, **k):
            raise AssertionError("correlator choice read the platform")

        monkeypatch.setattr(jax, "devices", no_platform)
        monkeypatch.setattr(jax, "default_backend", no_platform)
        assert resolve_correlator("auto") == AUTO_CORRELATOR
        assert resolve_correlator("gather") == "gather"
        with pytest.raises(ValueError):
            resolve_correlator("fused")

    def test_no_backend_forks_in_package(self):
        """No module decides a path by the backend it runs on."""
        for path in PKG.rglob("*.py"):
            src = path.read_text()
            for needle in ("default_backend(", ".platform ==",
                           "pallas", "interpret="):
                assert needle not in src, f"{path.name}: {needle}"


class TestResidency:
    class _Huge:
        dtype = np.dtype(np.int8)

        def __len__(self):
            return 2 ** 31

    @pytest.mark.parametrize("capture,expect", [
        (np.zeros(1000, np.int8), True),
        (np.zeros(1000, np.complex64), False),
        (np.zeros(1000, np.float32), False),
        (_Huge(), False),
    ], ids=["int8", "complex", "float32", "beyond_int32"])
    def test_auto_decided_by_capture(self, capture, expect):
        from bds3_tpu.receiver import resident_by_default

        assert resident_by_default(capture) is expect


def test_decimator_takes_device_path(monkeypatch):
    """Resampled acquisition uses the device decimator on every backend;
    the host scipy path stays a test reference only."""
    import bds3_tpu.acquire.resample as rs
    from bds3_tpu.acquire import acquire
    from bds3_tpu.config import b1c_settings
    from bds3_tpu.io import SatParams, synthesize_if

    calls = []
    device = rs.resample_signal_device

    def spy(*a, **k):
        calls.append(1)
        return device(*a, **k)

    def host(*a, **k):
        raise AssertionError("host decimator used")

    monkeypatch.setattr(rs, "resample_signal_device", spy)
    monkeypatch.setattr(rs, "resample_signal", host)
    s = b1c_settings(
        sampling_freq=40e6, intermediate_freq=10e6,
        acq_coh_ms=3, acq_step=1000 / 3 / 2, acq_search_band=2000.0,
        acq_satellite_list=(19,), resampling=True,
        resampling_threshold=15e6,
    )
    sat = SatParams(prn=19, doppler_hz=850.0, code_phase_chips=4000.0,
                    amplitude=1.2)
    sig = synthesize_if(s, [sat], n_ms=25.0, noise_std=1.5, seed=8)
    res = acquire(sig, s)
    assert calls and res.detected[0]


@pytest.mark.parametrize("env", ["set", "unset"])
def test_compilation_cache_dir(env, monkeypatch, tmp_path):
    from bds3_tpu.utils.jax_setup import compilation_cache_dir

    if env == "set":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compilation_cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compilation_cache_dir() == str(PKG.parent / ".xla_cache")


def _dot_precisions(jaxpr) -> list:
    """precision params of every dot_general, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    out += _dot_precisions(sub)
    return out


def _track_block_jaxpr():
    import functools

    from bds3_tpu.config import b2a_settings
    from bds3_tpu.track.driver import channel_code_tables
    from bds3_tpu.track.scan import track_block
    from bds3_tpu.track.state import (
        ChannelInit, channel_consts, code_coarse_tables, initial_state,
        make_track_config)

    s = b2a_settings(sampling_freq=4e6, intermediate_freq=1e6)
    cfg = make_track_config(s, epochs_per_block=2, correlator="bucket")
    inits = [ChannelInit(prn=1, acquired_freq=1e6, code_phase=0,
                         peak_metric=2.0)]
    consts = channel_consts(cfg, inits, s)
    d, p11, p61 = channel_code_tables(cfg, inits)
    cki, ckf = code_coarse_tables(cfg, cfg.m_data)
    state = initial_state(cfg, inits, consts, np.zeros(1))
    block = np.zeros(3 * cfg.n_win, np.int8)
    fn = functools.partial(track_block.__wrapped__, cfg)
    return jax.make_jaxpr(fn)(block, d, p11, p61, cki, ckf, cki, ckf,
                              consts, state)


def _fine_search_jaxpr():
    import functools

    from bds3_tpu.acquire.pcps import fine_search, make_acq_config
    from bds3_tpu.config import b2a_settings

    s = b2a_settings(sampling_freq=4e6, intermediate_freq=1e6)
    cfg = make_acq_config(s)
    n = cfg.fine_noncoh * cfg.samples_per_code
    fn = functools.partial(fine_search.__wrapped__, cfg=cfg)
    z = np.zeros(2, np.float32)
    return jax.make_jaxpr(fn)(
        np.zeros(4 * n, np.float32), np.zeros((2, n), np.int8),
        np.zeros((2, n), np.int8), np.zeros(2, np.int32), z, z,
        np.zeros(3, np.float32), np.zeros(3, np.float32))


@pytest.mark.parametrize("build", [_track_block_jaxpr, _fine_search_jaxpr],
                         ids=["track_epoch_dot", "fine_search_einsum"])
def test_hot_path_contractions_are_highest(build):
    """f32 contractions state HIGHEST precision, so a GPU that defaults
    to TF32 keeps full f32 there."""
    precs = _dot_precisions(build().jaxpr)
    assert precs, "no dot_general traced"
    highest = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and all(x == highest for x in p), precs
