"""Detector tallies for the photon engine.

The reference has no tally subsystem (its only detector is the camera image
buffer, src/scene.py:66); this implements the MCML-style detectors the
BASELINE configs require: radial diffuse reflectance/transmittance, an (r, z)
absorption/fluence grid, a 3-D cartesian fluence volume, and specular
reflectance — all accumulated by masked scatter-adds from the whole lane
population at once.

Event counters (photons launched, scatter steps) are EXACT at any scale via
a two-word float32 representation: ``count = hi * COUNTER_BASE + lo`` with
both words integer-valued f32.  A single f32 loses integer exactness above
2^24 (~1.7e7) — a 1e8-photon run would drop launches at the ppm level (the
round-1 full-scale artifact recorded 99,999,952 of 1e8).  JAX runs with
64-bit types disabled by default, so the counter is carried as (2,) f32 with an explicit carry; capacity is
2^24 * 2^16 = 2^40 (~1.1e12 events), and psum over up to ~256 devices keeps
both words exact.

The scalar weight totals (absorbed, specular) are compensated two-word
sums: ``total = hi + lo`` where ``lo`` collects the rounding error of every
add into ``hi`` (TwoSum).  A plain f32 running sum swamps once the total
dwarfs one superstep's increment: at 1e9 full_scale photons the absorbed
total (~7e8, ulp 64) took ~2e3 per superstep, and the energy closure
drifted by 1.1e-3.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from light_transport_tpu.core import struct

from light_transport_tpu.core.config import PhotonRunConfig

# counter two-word base: lo in [0, COUNTER_BASE), hi counts COUNTER_BASE units
COUNTER_BASE = float(2 ** 16)


def counter_zero(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.zeros((2,), dtype)


def counter_add(c: jnp.ndarray, inc) -> jnp.ndarray:
    """Add an integer-valued f32 increment (< 2^23) exactly.

    lo stays < COUNTER_BASE after normalization, so lo + inc < 2^24 is
    exact; the carry into hi is exact while hi < 2^24.
    """
    lo = c[1] + inc
    carry = jnp.floor(lo / COUNTER_BASE)
    return jnp.stack([c[0] + carry, lo - carry * COUNTER_BASE])


def counter_from_sum(vals: jnp.ndarray) -> jnp.ndarray:
    """Exact counter from per-tile integer-valued f32 partials.

    Each partial may be up to 2^24; a direct f32 sum of ~128 of them
    rounds.  Split each into (hi, lo) words and sum the words as int32 —
    exact to 2^31, so the count stays exact past the ~256-partial point
    where an f32 lo-word sum (256 x 2^16 = 2^24) would start rounding
    (advisor r3; reachable at >= 2M lanes).  The carry keeps the returned
    lo word < 2^16, preserving every counter invariant downstream.
    """
    hi = jnp.floor(vals / COUNTER_BASE)
    lo = vals - hi * COUNTER_BASE
    lo_sum = jnp.sum(lo.astype(jnp.int32))
    hi_sum = jnp.sum(hi.astype(jnp.int32))
    base = jnp.int32(COUNTER_BASE)
    carry = lo_sum // base
    return jnp.stack([(hi_sum + carry).astype(jnp.float32),
                      (lo_sum - carry * base).astype(jnp.float32)])


def counter_merge(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    lo = a[1] + b[1]
    carry = jnp.floor(lo / COUNTER_BASE)
    return jnp.stack([a[0] + b[0] + carry, lo - carry * COUNTER_BASE])


def counter_value(c) -> float:
    """Exact host-side value (float64 holds integers to 2^53)."""
    c = np.asarray(c, np.float64)
    return float(c[0] * COUNTER_BASE + c[1])


def wsum_add(c: jnp.ndarray, x) -> jnp.ndarray:
    """Add ``x`` to the compensated sum ``c = (hi, lo)``: TwoSum moves the
    exact rounding error of ``hi + x`` into ``lo``."""
    hi = c[0] + x
    x_part = hi - c[0]
    err = (c[0] - (hi - x_part)) + (x - x_part)
    return jnp.stack([hi, c[1] + err])


def wsum_merge(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return wsum_add(jnp.stack([a[0], a[1] + b[1]]), b[0])


def wsum_value(c) -> float:
    c = np.asarray(c, np.float64)
    return float(c[0] + c[1])


@struct.dataclass
class PhotonTallies:
    """Raw (unnormalized) accumulated photon weight.

    Normalization follows MCML conventions: divide by photons launched
    (and cell volume for fluence).  The last radial bin is an overflow bin.
    """

    refl_r: jnp.ndarray  # (nr,) diffuse reflectance weight by exit radius
    trans_r: jnp.ndarray  # (nr,) transmittance weight by exit radius
    absorb_rz: jnp.ndarray  # (nr, nz) absorbed weight
    specular: jnp.ndarray  # (2,) compensated sum: specular weight at launch
    launched: jnp.ndarray  # (2,) exact hi/lo counter: photons launched
    steps: jnp.ndarray  # (2,) exact hi/lo counter: lane events processed
    # cartesian exit-detector image over the top surface (BASELINE config 5);
    # (nx, nx), or (1, 1) when disabled
    detector_xy: jnp.ndarray
    # 3-D cartesian absorbed-weight volume (BASELINE config 5's "3D fluence
    # volume"); (vol_nx, vol_ny, vol_nz), or (1, 1, 1) when disabled
    absorb_xyz: jnp.ndarray
    # compensated absorbed-weight total: the (r,z) grid loses tiny dw
    # increments to f32 swamping in hot cells (adding ~1e-6 to ~1e3), so
    # energy accounting uses this (2,) hi/lo sum instead
    absorbed: jnp.ndarray

    @staticmethod
    def zeros(cfg: PhotonRunConfig, dtype=jnp.float32) -> "PhotonTallies":
        nx = max(cfg.detector_nx, 1)
        vshape = (max(cfg.vol_nx, 1), max(cfg.vol_ny, 1), max(cfg.vol_nz, 1))
        return PhotonTallies(
            refl_r=jnp.zeros((cfg.nr,), dtype),
            trans_r=jnp.zeros((cfg.nr,), dtype),
            absorb_rz=jnp.zeros((cfg.nr, cfg.nz), dtype),
            specular=jnp.zeros((2,), dtype),
            launched=counter_zero(dtype),
            steps=counter_zero(dtype),
            detector_xy=jnp.zeros((nx, nx), dtype),
            absorb_xyz=jnp.zeros(vshape, dtype),
            absorbed=jnp.zeros((2,), dtype),
        )

    def merge(self, other: "PhotonTallies") -> "PhotonTallies":
        """Combine two tally sets (the two-word counters and sums merge
        word-aware, everything else adds)."""
        return PhotonTallies(
            refl_r=self.refl_r + other.refl_r,
            trans_r=self.trans_r + other.trans_r,
            absorb_rz=self.absorb_rz + other.absorb_rz,
            specular=wsum_merge(self.specular, other.specular),
            launched=counter_merge(self.launched, other.launched),
            steps=counter_merge(self.steps, other.steps),
            detector_xy=self.detector_xy + other.detector_xy,
            absorb_xyz=self.absorb_xyz + other.absorb_xyz,
            absorbed=wsum_merge(self.absorbed, other.absorbed),
        )

    # --- exact counter views -------------------------------------------------

    @property
    def n_launched(self) -> float:
        return counter_value(self.launched)

    @property
    def n_steps(self) -> float:
        return counter_value(self.steps)

    @property
    def absorbed_weight(self) -> float:
        return wsum_value(self.absorbed)

    # --- normalized views (host-side convenience) ---------------------------

    def total_reflectance(self) -> float:
        """Diffuse reflectance R_d per launched photon."""
        return float(self.refl_r.sum()) / max(self.n_launched, 1.0)

    def total_transmittance(self) -> float:
        return float(self.trans_r.sum()) / max(self.n_launched, 1.0)

    def total_absorption(self) -> float:
        return self.absorbed_weight / max(self.n_launched, 1.0)

    def total_absorption_grid(self) -> float:
        """Grid-summed absorption (subject to f32 swamping in hot cells;
        kept for cross-checking the spatial tally)."""
        return float(self.absorb_rz.sum()) / max(self.n_launched, 1.0)

    def specular_reflectance(self) -> float:
        return wsum_value(self.specular) / max(self.n_launched, 1.0)

    def energy_total(self) -> float:
        """R_sp + R_d + A + T — should be ~1 (exactly 1 in expectation)."""
        return (
            self.specular_reflectance()
            + self.total_reflectance()
            + self.total_absorption()
            + self.total_transmittance()
        )

    def fluence_rz(self, cfg: PhotonRunConfig, mu_a_grid=None) -> np.ndarray:
        """Fluence phi(r, z) = A_rz / (dV * N * mu_a)  [1/cm^2 per photon].

        ``mu_a_grid``: (nz,) absorption coefficient per depth bin (defaults
        to None -> returns A_rz / (dV * N), the absorbed energy density).
        """
        ir = np.arange(cfg.nr)
        # annular cell volume: 2 pi (ir + 0.5) dr^2 dz
        dv = 2.0 * np.pi * (ir + 0.5) * cfg.dr**2 * cfg.dz
        a = np.asarray(self.absorb_rz, np.float64)
        n = max(self.n_launched, 1.0)
        dens = a / (dv[:, None] * n)
        if mu_a_grid is not None:
            dens = dens / np.maximum(np.asarray(mu_a_grid)[None, :], 1e-12)
        return dens

    def fluence_xyz(self, cfg: PhotonRunConfig, mu_a: float = None) -> np.ndarray:
        """3-D fluence phi(x, y, z) = A_xyz / (dV * N * mu_a) [1/cm^2/photon]
        (absorbed energy density when ``mu_a`` is None)."""
        dv = cfg.vol_dx * cfg.vol_dy * cfg.vol_dz
        n = max(self.n_launched, 1.0)
        dens = np.asarray(self.absorb_xyz, np.float64) / (dv * n)
        if mu_a is not None:
            dens = dens / max(mu_a, 1e-12)
        return dens

    def reflectance_r(self, cfg: PhotonRunConfig) -> np.ndarray:
        """R_d(r) per unit area [1/cm^2]."""
        ir = np.arange(cfg.nr)
        da = 2.0 * np.pi * (ir + 0.5) * cfg.dr**2
        n = max(self.n_launched, 1.0)
        return np.asarray(self.refl_r, np.float64) / (da * n)
