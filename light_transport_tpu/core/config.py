"""Typed configuration objects.

The reference has no config system — parameters live as notebook literals,
Streamlit widget values, and constructor defaults (SURVEY.md §5).  Here every
run is described by plain dataclasses that are hashable (usable as static
jit args) and overridable from the CLI.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Camera-render settings.

    Mirrors the reference ``Scene`` constructor surface
    (src/scene.py:54-73): width/height, max_depth, f_distance, spp; screen
    bounds derive from the aspect ratio exactly as there (:61-64).
    """

    width: int = 150
    height: int = 150
    spp: int = 12
    max_depth: int = 4
    f_distance: float = 5.0
    # Russian roulette starts after this bounce (reference: bounce > 3 in the
    # flagship tracer, src/path_tracing.py:148; > 5 in fix1).
    rr_start: int = 3
    rr_floor: float = 0.05
    # 'first_hit': emission only added at bounce 0 (flagship tracer :59);
    # 'always': emission at every bounce (path_tracing_fix1.py:45-46);
    # 'nee': emission at bounce 0 / after specular or medium-scatter chains
    # only (the estimator-correct rule; see path_tracer._bounce);
    # 'mis': like 'nee' but BSDF-sampled light hits from diffuse vertices
    # are kept and combined with the NEE term by the power heuristic —
    # lower variance on small/bright lights at equal spp (PERF.md A/B);
    # requires nee_mode='one'.
    emission_mode: str = "first_hit"
    # 'one': one shadow ray to a random area-weighted light point per
    # diffuse bounce (cast_one_shadow_ray, src/light_samples.py:35-61);
    # 'all': one shadow ray per light triangle at a fixed per-row point,
    # area-weighted quadrature (the legacy all-lights estimator,
    # cast_all_shadow_rays, src/light_samples.py:119-143 — its random
    # pre-drawn sample list becomes deterministic centroids here).
    nee_mode: str = "one"
    # 'opaque': any occluder blocks the shadow ray (the reference's
    # cast_one_shadow_ray rule, src/light_samples.py:44-52);
    # 'transmittance': transmissive occluders attenuate by straight-line
    # spectral Beer-Lambert of their interior extinction instead of
    # blocking (colored-glass shadows; ops/dispatch.scene_transmittance).
    shadow_mode: str = "opaque"
    # 'stochastic': at a transmissive hit, sample reflect-vs-refract with
    # the Schlick probability, weight 1 (the flagship tracer's rule,
    # src/path_tracing.py:126-141); 'split': deterministically follow BOTH
    # branches with their Fresnel weights — the reference's recursive-PT
    # estimator (src/render.py:121-153) — via a per-lane deferred-branch
    # stack (path_tracer.trace_paths_split).  Lower variance on glass at
    # equal spp; costs extra supersteps for the deferred branches.
    fresnel_mode: str = "stochastic"
    # 'uniform': threefry pseudo-random tensors — the reference's pre-drawn
    # ``scene.rand_0/rand_1`` contract (src/scene.py:68-71);
    # 'sobol': padded Owen-scrambled Sobol' points in the SAME tensors
    # (ops/qmc.py) — every 2-D decision (AA jitter, BSDF hemisphere, light
    # surface point, ...) becomes a (0,2)-sequence, cutting pixel variance
    # on smooth integrands at equal spp (power-of-two spp stratifies best).
    sampler: str = "uniform"
    # Host-driven multi-level tail compaction for the plain path
    # integrator (path_tracer.trace_paths_compact): between bounce
    # segments, live lanes are squeezed to the front and the lane width
    # halves while occupancy allows — per-lane radiance (and thus the
    # image) is unchanged to ~1 ulp, steady time drops on deep-depth
    # configs (fix1-scale numbers in PERF.md).  Off by default: the
    # compacted tracer is host-driven, so it cannot run under an outer
    # jit or shard_map and produces no TraceRecord (CV/detector renders
    # ignore the flag).
    compact_tail: bool = False
    # Thin-lens depth of field (extension; the reference camera is a pure
    # pinhole, src/path_tracing.py:263-287).  aperture = lens radius in
    # world units (0 = pinhole, bitwise-identical to the reference model);
    # focus_distance = axial distance from the camera to the plane in
    # perfect focus (<=0 focuses on the screen plane at f_distance).
    # Supported by the path/adaptive/cv integrators; whitted (one
    # deterministic ray per pixel) and bdpt (pinhole camera importance)
    # reject aperture > 0 at the API.
    aperture: float = 0.0
    focus_distance: float = 0.0
    seed: int = 0

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def screen_bounds(self) -> Tuple[float, float, float, float]:
        """(left, right, top, bottom) — reference src/scene.py:61-64."""
        ar = self.aspect_ratio
        return (-1.0, 1.0, 1.0 / ar, -1.0 / ar)


@dataclasses.dataclass(frozen=True)
class MediumConfig:
    """One homogeneous layer of a participating medium (MCML convention).

    mu_a, mu_s in 1/cm; g = Henyey-Greenstein anisotropy; n = refractive
    index.  The reference only gestures at this (``henyey_greenstein``,
    src/medium_samples.py:14-16, never called); we implement the full layered
    photon-transport capability it stubbed out.
    """

    mu_a: float = 0.1
    mu_s: float = 10.0
    g: float = 0.9
    n: float = 1.0
    thickness: float = float("inf")  # cm


@dataclasses.dataclass(frozen=True)
class PhotonRunConfig:
    """Photon Monte Carlo run settings (BASELINE.json configs 1-3, 5)."""

    n_photons: int = 100_000
    # supersteps per while-loop round in simulate_photons: the termination
    # check (all photons done) runs between rounds only.  16 keeps XLA
    # compile time low while amortizing loop sync overhead.
    steps_per_batch: int = 16
    weight_threshold: float = 1e-4
    rr_survive: float = 0.1  # MCML roulette survival probability
    # fluence grid (r, z) in cm
    nr: int = 64
    nz: int = 64
    dr: float = 0.01
    dz: float = 0.01
    # optional cartesian exit-detector image above the surface (BASELINE
    # config 5's "512x512 detector image"); 0 disables it
    detector_nx: int = 0
    detector_extent: float = 1.0  # half-extent in cm
    # optional 3-D cartesian absorption/fluence volume (BASELINE config 5's
    # "3D fluence volume"); 0 disables it.  x/y centered on the beam axis,
    # z from the surface down; out-of-volume deposits clip into edge cells
    # (same convention as the (r, z) grid's overflow bins).
    vol_nx: int = 0
    vol_ny: int = 0
    vol_nz: int = 0
    vol_dx: float = 0.01
    vol_dy: float = 0.01
    vol_dz: float = 0.01
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Device-mesh description for sharded runs.

    Only data parallelism is semantically required for MC transport
    (SURVEY.md §2): photon/pixel batches shard over ``batch``; the scene,
    BVH and medium tables replicate per device; tallies psum over the mesh.
    """

    batch_axis: str = "batch"
    n_devices: Optional[int] = None  # None = all available
