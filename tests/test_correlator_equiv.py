"""The prefix-sum (bucket) correlator is an exact regrouping of the
per-sample gather correlator; verify both paths agree over real tracking
runs, in every signal configuration the receiver tracks, and that the
default correlator locks absolutely onto the synthesized truth.

The two index computations round a few chip-boundary samples
differently in f32, so closed-loop trajectories stay in the same lock
but wiggle at the discriminator-noise level: equivalence is asserted
with chip_smoke's tolerances (exact integer epoch geometry, correlators
within 5e-2 of their mean magnitude, carrier within 0.25 Hz) over a
bounded horizon.
"""
import numpy as np
import pytest

import chip_smoke as cs
from bds3_tpu.config import FileType, TrackMode, b1c_settings, b2a_settings
from bds3_tpu.io import SatParams, synthesize_if
from bds3_tpu.track.driver import track
from bds3_tpu.track.state import ChannelInit


def _init_for(s, sat):
    code_rate = s.code_freq_basis * (1 + sat.doppler_hz / s.carr_freq_basis)
    chi0 = sat.code_phase_chips % s.code_length
    start = ((s.code_length - chi0) % s.code_length) / code_rate
    return ChannelInit(
        prn=sat.prn, acquired_freq=s.intermediate_freq + sat.doppler_hz,
        code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0)


TWO_SATS = [SatParams(prn=19, doppler_hz=777.0, code_phase_chips=123.0,
                      amplitude=0.9),
            SatParams(prn=20, doppler_hz=-1200.0, code_phase_chips=5000.0,
                      amplitude=0.7)]
B1C_SATS = [SatParams(prn=7, doppler_hz=430.0, code_phase_chips=212.0,
                      amplitude=0.9),
            SatParams(prn=30, doppler_hz=-2100.0, code_phase_chips=8000.0,
                      amplitude=0.8)]
WB_KEYS = cs.CORR_KEYS + cs.WB_KEYS

# (settings, sats, n_ms, n_epochs, compared keys, complex IQ)
CONFIGS = {
    "b2a_data_pilot": (
        lambda: b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6),
        TWO_SATS, 60.0, 30, cs.CORR_KEYS, False),
    "b2a_complex_iq": (
        lambda: b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                             file_type=FileType.IQ8),
        TWO_SATS, 60.0, 30, cs.CORR_KEYS, True),
    "b1c_narrowband": (
        lambda: b1c_settings(sampling_freq=6e6, intermediate_freq=1.5e6,
                             track_mode=TrackMode.NARROWBAND),
        B1C_SATS, 120.0, 8, cs.CORR_KEYS, False),
    "b1c_wb_composite": (
        lambda: b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6,
                             track_mode=TrackMode.WIDEBAND),
        B1C_SATS, 60.0, 4, WB_KEYS, False),
    "b1c_wb_split": (
        lambda: b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6,
                             track_mode=TrackMode.WIDEBAND,
                             wb_code_blend="split"),
        B1C_SATS[:1], 60.0, 4, WB_KEYS, False),
    "b1c_wb_nb_blend": (
        lambda: b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6,
                             track_mode=TrackMode.WIDEBAND,
                             wb_code_blend="nb"),
        B1C_SATS[:1], 60.0, 4, WB_KEYS, False),
}


class TestCorrelatorEquivalence:
    def test_bucket_matches_gather(self):
        s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6)
        sat = SatParams(prn=19, doppler_hz=777.0, code_phase_chips=123.0,
                        amplitude=0.9)
        sig = synthesize_if(s, [sat], n_ms=150.0, noise_std=1.0, seed=6)
        init = _init_for(s, sat)
        res = {corr: track(sig, s, [init], n_epochs=100, epochs_per_block=50,
                           correlator=corr)
               for corr in ("bucket", "gather")}
        for k in ("d_ip", "d_qp", "d_ie", "d_il", "p11_ip", "p11_qp"):
            a = res["bucket"].outputs[k][0]
            b = res["gather"].outputs[k][0]
            scale = np.abs(b).mean() + 1.0
            # ~1% agreement: the two index computations round a few
            # chip-boundary samples differently in f32, and the closed
            # loop compounds the tiny phase differences over epochs
            np.testing.assert_allclose(a / scale, b / scale, atol=2e-2,
                                       err_msg=k)
        np.testing.assert_allclose(
            res["bucket"].carr_freq[0], res["gather"].carr_freq[0], atol=0.05
        )

    @pytest.mark.parametrize("config", sorted(CONFIGS))
    def test_bucket_matches_gather_config(self, config):
        make, sats, n_ms, n_ep, keys, iq = CONFIGS[config]
        s = make()
        raw = synthesize_if(s, sats, n_ms=n_ms, noise_std=1.0, seed=12)
        sig = (raw[:, 0].astype(np.float32)
               + 1j * raw[:, 1].astype(np.float32)).astype(np.complex64) \
            if iq else raw
        inits = [_init_for(s, sat) for sat in sats]
        res = {c: track(sig, s, inits, n_epochs=n_ep, epochs_per_block=n_ep,
                        correlator=c) for c in ("bucket", "gather")}
        assert res["bucket"].correlator == "bucket"
        assert res["gather"].correlator == "gather"
        cs.compare_tracks(res["gather"], res["bucket"], n_ep, keys)

    def test_absolute_lock(self):
        """The default correlator converges on the synthesized truth."""
        s = b2a_settings(sampling_freq=8e6, intermediate_freq=2e6)
        sat = SatParams(prn=7, doppler_hz=-950.0, code_phase_chips=42.0,
                        amplitude=0.8)
        sig = synthesize_if(s, [sat], n_ms=160.0, noise_std=1.0, seed=3)
        res = track(sig, s, [_init_for(s, sat)], n_epochs=150,
                    epochs_per_block=50)
        ip = res.outputs["d_ip"][0][-50:]
        qp = res.outputs["d_qp"][0][-50:]
        assert np.abs(ip).mean() > 4 * np.abs(qp).mean(), "not phase locked"
        # PLL noise jitter at Bn=20 Hz in this C/N0 is ~1 Hz RMS
        truth = s.intermediate_freq + sat.doppler_hz
        assert abs(res.carr_freq[0][-20:].mean() - truth) < 2.0
        # code lock: early/late balance converging (the DLL is Bn=2 Hz,
        # time constant ~80 ms, so it is still settling at 150 epochs)
        e = np.hypot(res.outputs["d_ie"][0], res.outputs["d_qe"][0])
        l = np.hypot(res.outputs["d_il"][0], res.outputs["d_ql"][0])
        eml = np.abs((e - l) / (e + l))
        assert eml[-30:].mean() < 0.15
        assert eml[-30:].mean() < eml[40:70].mean()
