"""Layered participating-medium table (MCML-style).

The reference intended volumetric transport — it defines the
Henyey-Greenstein phase function (src/medium_samples.py:14-16), a ``Medium``
enum (src/constants.py:17-24), and an empty ``photon_tracing.py`` — but never
wired any of it up.  This module is the completed capability: a stack of
horizontal slabs, each with absorption mu_a, scattering mu_s, anisotropy g,
refractive index n, and thickness, bounded by ambient media above/below.

Layer layout (z increases downward, photons launched at z=0):

    z0=0 ── layer 0 ── z1 ── layer 1 ── ... ── zL (or infinity)

Arrays are tiny and replicate to every device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from light_transport_tpu.core import struct

from light_transport_tpu.core.config import MediumConfig


@struct.dataclass
class LayeredMedium:
    mu_a: np.ndarray  # (L,)
    mu_s: np.ndarray  # (L,)
    mu_t: np.ndarray  # (L,) = mu_a + mu_s
    g: np.ndarray  # (L,)
    n: np.ndarray  # (L,)
    z_top: np.ndarray  # (L,) upper boundary depth of each layer
    z_bot: np.ndarray  # (L,) lower boundary depth (inf for semi-infinite)
    n_above: np.ndarray  # () ambient index above z=0
    n_below: np.ndarray  # () ambient index below the last layer

    @staticmethod
    def build(layers: Sequence[MediumConfig], n_above: float = 1.0,
              n_below: float = 1.0, dtype=np.float32) -> "LayeredMedium":
        import jax.numpy as jnp

        mu_a = np.asarray([l.mu_a for l in layers], dtype=dtype)
        mu_s = np.asarray([l.mu_s for l in layers], dtype=dtype)
        g = np.asarray([l.g for l in layers], dtype=dtype)
        n = np.asarray([l.n for l in layers], dtype=dtype)
        thick = np.asarray([l.thickness for l in layers], dtype=np.float64)
        z = np.concatenate([[0.0], np.cumsum(thick)])
        return LayeredMedium(
            mu_a=jnp.asarray(mu_a),
            mu_s=jnp.asarray(mu_s),
            mu_t=jnp.asarray(mu_a + mu_s),
            g=jnp.asarray(g),
            n=jnp.asarray(n),
            z_top=jnp.asarray(z[:-1].astype(dtype)),
            z_bot=jnp.asarray(z[1:].astype(dtype)),
            n_above=jnp.asarray(n_above, dtype=dtype),
            n_below=jnp.asarray(n_below, dtype=dtype),
        )

    @property
    def num_layers(self) -> int:
        return self.mu_a.shape[0]
