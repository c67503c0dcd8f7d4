"""bds3_tpu — BDS-3 B1C/B2a software-defined GNSS receiver in JAX.

A ground-up JAX/XLA redesign with the capabilities of the reference
MATLAB receiver (lyf8118/BDS-3-B1C-B2a-SDR-receiver): FFT cold-start
acquisition, multi-channel closed-loop code/carrier tracking, B-CNAV1/2
navigation-message decoding, pseudoranges, and least-squares PVT — run
on one GPU or sharded across several.
"""
__version__ = "0.1.0"

from bds3_tpu.config import (  # noqa: F401
    FileType,
    Settings,
    Signal,
    TrackMode,
    b1c_settings,
    b2a_settings,
)
