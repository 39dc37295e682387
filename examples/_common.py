"""Shared helpers for the example drivers (mirrors the plotting cells the
reference repeats in every examples/*.ipynb notebook)."""

import json
import os
import sys
import time

import numpy as np

# make `python examples/foo.py` work from anywhere: the package lives one
# level up from this file
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

# examples re-run often; cache the XLA compiles so a second run starts warm
from light_transport_tpu.core.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                       "examples")


def save_image(img, name: str, gamma: float = 1.0) -> str:
    """Clip/gamma and write a PNG; returns the path."""
    os.makedirs(OUT_DIR, exist_ok=True)
    arr = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    if gamma != 1.0:
        arr = arr ** (1.0 / gamma)
    path = os.path.join(OUT_DIR, name)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(path, arr)
    except Exception:  # matplotlib optional: fall back to raw npy
        path = path.rsplit(".", 1)[0] + ".npy"
        np.save(path, arr)
    return path


def report(name: str, seconds: float, **extra):
    """One-line machine-readable summary, like the notebooks' timing cells."""
    print(json.dumps({"example": name, "seconds": round(seconds, 3), **extra}))


class timer:
    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *a):
        self.seconds = time.time() - self.t0


def timed_twice(fn):
    """Run ``fn`` twice: returns (result, jit_seconds, steady_seconds).

    The reference notebooks report both "w/ JIT" and steady-state timings
    (ray-tracing.ipynb cells 12/14); the steady number is the meaningful
    one for render-speed claims.  ``fn`` must block on its result (e.g.
    convert it with ``np.asarray``) for the times to cover the device work.
    """
    t0 = time.time()
    fn()
    t_jit = time.time() - t0
    t0 = time.time()
    result = fn()
    return result, t_jit, time.time() - t0
