"""tools/profile_trace.reduce_trace on a small trace recorded here: the
reduction every tracking measurement reports (busy, idle share, top
operations)."""
import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from profile_trace import WINDOW, reduce_trace  # noqa: E402


def test_reduce_recorded_trace(tmp_path):
    f = jax.jit(lambda x: jnp.cumsum(x @ x, axis=1))
    x = jnp.ones((256, 256))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        with jax.profiler.TraceAnnotation(WINDOW):
            f(x).block_until_ready()
    r = reduce_trace(str(tmp_path), "/host:CPU")
    assert r["window_from"] == "annotation"
    assert 0 < r["busy_ms"] <= r["window_ms"]
    assert 0.0 <= r["idle_share"] < 1.0
    assert r["top_ops"] and all(o["total_ms"] >= 0 for o in r["top_ops"])
