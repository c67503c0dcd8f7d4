"""CLI smoke test (the reference init.m workflow end to end)."""
import os
import subprocess
import sys

import numpy as np
import pytest

from bds3_tpu.config import b2a_settings
from bds3_tpu.io import SatParams, synthesize_if

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCLI:
    def test_probe_and_track(self, tmp_path):
        s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6)
        sat = SatParams(prn=19, doppler_hz=500.0, code_phase_chips=100.0,
                        amplitude=0.9)
        sig = synthesize_if(s, [sat], n_ms=120.0, noise_std=1.5, seed=3)
        path = tmp_path / "cap.bin"
        sig.tofile(path)

        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
        out = subprocess.run(
            [sys.executable, "-m", "bds3_tpu", "--signal", "b2a",
             "--file", str(path), "--fs", "10e6", "--if-freq", "2.5e6",
             "--prns", "19,7", "--ms", "100", "--probe",
             "--checkpoint", str(tmp_path / "ck.pkl")],
            capture_output=True, text=True, timeout=400, env=env, cwd=REPO,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        assert "probe:" in out.stdout
        assert "[acquire]" in out.stdout and "19" in out.stdout
        assert "[track]" in out.stdout
        assert (tmp_path / "ck.pkl").exists()

    def test_transport_and_ldpc_flags(self, tmp_path):
        """--transport int4 --ldpc run the same pipeline (the capture is
        packed for its upload; ldpc_decode threads to the decoders)."""
        s = b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6)
        sat = SatParams(prn=19, doppler_hz=500.0, code_phase_chips=100.0,
                        amplitude=0.9)
        sig = synthesize_if(s, [sat], n_ms=120.0, noise_std=1.5, seed=3)
        path = tmp_path / "cap.bin"
        sig.tofile(path)

        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
        out = subprocess.run(
            [sys.executable, "-m", "bds3_tpu", "--signal", "b2a",
             "--file", str(path), "--fs", "10e6", "--if-freq", "2.5e6",
             "--prns", "19", "--ms", "100",
             "--transport", "int4", "--ldpc"],
            capture_output=True, text=True, timeout=400, env=env, cwd=REPO,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        assert "[track]" in out.stdout
