"""chip_smoke.py: it refuses the CPU and a checkout without the package,
and its phase helpers pass at tiny widths here (on the card they run at
the reference rate)."""
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs
from bds3_tpu.config import TrackMode, b1c_settings, b2a_settings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=300, env=env, cwd=cwd)


def test_exits_nonzero_on_cpu():
    out = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_exits_nonzero_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture(scope="module")
def b2a():
    s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6)
    return s, cs.synth(s, cs.B2A_SATS, 460.0, amplitude=0.65)


def test_phase_track_b2a(b2a, capsys):
    s, sig = b2a
    cs.phase_track("track_b2a", "cpu", s, sig[: int(0.33 * s.sampling_freq)],
                   cs.B2A_SATS, 4, 300, 300, cs.GEOMETRY_EPOCHS["b2a"],
                   cs.CORR_KEYS)
    assert "[track_b2a] ok" in capsys.readouterr().out


def test_phase_track_b1c_wideband(capsys):
    s = b1c_settings(sampling_freq=20e6, intermediate_freq=5e6,
                     track_mode=TrackMode.WIDEBAND, wb_code_blend="split")
    sig = cs.synth(s, cs.B1C_SATS, 1100.0, amplitude=0.6)
    cs.phase_track("track_b1c_wb", "cpu", s, sig, cs.B1C_SATS, 4, 100, 100,
                   cs.GEOMETRY_EPOCHS["b1c"], cs.CORR_KEYS + cs.WB_KEYS)
    assert "[track_b1c_wb] ok" in capsys.readouterr().out


def test_phase_acquire(b2a, capsys):
    s, sig = b2a
    cs.phase_acquire("acquire_b2a", "cpu", s, sig, cs.B2A_SATS, 32)
    assert "detected=[5, 12, 19, 30]" in capsys.readouterr().out


def test_acquisition_check_rejects_a_miss(b2a):
    from bds3_tpu.acquire import acquire

    s, sig = b2a
    acq = acquire(np.asarray(sig[:400_000]), s, (5, 12, 19, 30, 31))
    with pytest.raises(cs.SmokeError):
        cs.check_acquisition(s, acq, cs.B2A_SATS + [(31, 0.0, 0.0)])


def test_compare_tracks_rejects_geometry_change():
    out = {f"{b}_{c}{t}": np.ones((2, 5)) for b in ("d", "p11")
           for c in "iq" for t in "epl"}
    out["blksize"] = np.full((2, 5), 100.0)
    ref = SimpleNamespace(outputs=out, absolute_sample=np.ones((2, 5)),
                          carr_freq=np.zeros((2, 5)))
    bad = dict(out, blksize=out["blksize"] + np.eye(2, 5))
    test = SimpleNamespace(outputs=bad, absolute_sample=np.ones((2, 5)),
                           carr_freq=np.zeros((2, 5)))
    cs.compare_tracks(ref, ref, 5, cs.CORR_KEYS)
    with pytest.raises(cs.SmokeError, match="blksize"):
        cs.compare_tracks(ref, test, 5, cs.CORR_KEYS)


@pytest.mark.parametrize("phase", ["fanout", "doppler_acq", "timeshard"])
def test_four_device_phases(b2a, phase, capsys):
    s, sig = b2a
    if phase == "fanout":
        cs.phase_fanout(phase, "cpu", s, sig, 8, 50, 4)
    elif phase == "doppler_acq":
        cs.phase_doppler_acq(phase, "cpu", s, sig, 16, 4)
    else:
        cs.phase_timeshard(phase, "cpu", s, sig, 8, 400, 4,
                           cs.GEOMETRY_EPOCHS["b2a"])
    assert f"[{phase}] ok" in capsys.readouterr().out
