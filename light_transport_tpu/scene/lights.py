"""Area-light table and sampling.

The reference pre-draws ~2000 fixed sample points on the two light triangles
and a shadow ray picks one uniformly (``generate_area_light_samples`` /
``cast_one_shadow_ray``, src/light_samples.py:17-61).  Here the light
table stores the emitting triangles themselves and each NEE shadow ray draws
a fresh barycentric point — the same estimator (pdf = 1/total_area) without
the frozen-point-set bias, and with two reference bugs fixed (documented):

- reference samples only tri_1's surface for *both* list entries
  (``l2`` is built from ``tp1``, src/light_samples.py:29);
- reference picks among sample points uniformly even if triangle areas
  differ; we area-weight the triangle pick so the point density is uniform
  over the union surface.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from light_transport_tpu.core import struct

from light_transport_tpu.core import math as lm
from light_transport_tpu.scene.geometry import TriangleMesh
from light_transport_tpu.scene.material import MaterialTable


@struct.dataclass
class LightTable:
    """SoA table of emitting triangles (one row per light triangle)."""

    v0: np.ndarray  # (L, 3)
    e1: np.ndarray  # (L, 3)
    e2: np.ndarray  # (L, 3)
    normal: np.ndarray  # (L, 3)
    area: np.ndarray  # (L,)
    radiance: np.ndarray  # (L, 3) = emission * emission_color of the light
    # mat (one radiance for NEE and hit scoring — see Material.emission_color)
    cdf: np.ndarray  # (L,) area-weighted pick CDF (inclusive upper edges)
    total_area: np.ndarray  # () scalar
    mat_id: np.ndarray  # (L,) int32 material row of each light triangle

    @staticmethod
    def build(mesh: TriangleMesh, materials: MaterialTable, dtype=np.float32) -> "LightTable":
        h = mesh.host_arrays()
        h_v0, h_e1, h_e2 = h[0], h[1], h[2]
        h_normal, h_mat, is_light = h[4], h[5], h[6]
        idx = np.nonzero(is_light)[0]
        if idx.size == 0:
            # Degenerate 1-row table with zero radiance so shapes stay static.
            z3 = jnp.zeros((1, 3), dtype=dtype)
            return LightTable(
                v0=z3, e1=z3, e2=z3,
                normal=jnp.asarray([[0.0, 0.0, 1.0]], dtype=dtype),
                area=jnp.zeros((1,), dtype=dtype),
                radiance=z3,
                cdf=jnp.ones((1,), dtype=dtype),
                total_area=jnp.asarray(0.0, dtype=dtype),
                mat_id=jnp.zeros((1,), jnp.int32),
            )
        e1 = h_e1.astype(np.float64)[idx]
        e2 = h_e2.astype(np.float64)[idx]
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        mat = h_mat[idx]
        radiance = np.asarray(materials.emission_rgb, np.float64)[mat]
        cdf = np.cumsum(area) / area.sum()
        return LightTable(
            v0=jnp.asarray(h_v0[idx].astype(dtype)),
            e1=jnp.asarray(e1.astype(dtype)),
            e2=jnp.asarray(e2.astype(dtype)),
            normal=jnp.asarray(h_normal[idx].astype(dtype)),
            area=jnp.asarray(area.astype(dtype)),
            radiance=jnp.asarray(radiance.astype(dtype)),
            cdf=jnp.asarray(cdf.astype(dtype)),
            total_area=jnp.asarray(area.sum(), dtype=dtype),
            mat_id=jnp.asarray(mat.astype(np.int32)),
        )

    @property
    def num(self) -> int:
        return self.area.shape[0]


@struct.dataclass
class PointLightTable:
    """SoA table of point (delta) light sources.

    The reference GUI's 'Point' light option builds ``Light(source=pos,
    material)`` rows (app.py:152-158) that its integrators shade toward
    directly; this repo previously only emulated them with tiny emissive
    quads (models/presets.hard_shadow_scene).  A true delta light has no
    geometry: the path tracer adds a deterministic direct term
    ``f(wi) * I * cos(theta) / r^2 * V`` per light (no pdf — the light
    cannot be BSDF-sampled, so NEE is the only strategy and the MIS
    weight is 1), Whitted Phong-shades toward the position with the
    table's light colors (the reference reads them off the light's
    material, src/render_old.py:70-134), and bdpt walks light subpaths
    from the table (integrators/bdpt.generate_light_subpaths_point;
    mixed area+point scenes pick the origin family per lane,
    generate_light_subpaths_mixed).
    """

    position: np.ndarray  # (P, 3)
    intensity: np.ndarray  # (P, 3) radiant intensity I [power/sr]
    # Whitted Phong light colors (reference light material Color rows)
    ambient: np.ndarray  # (P, 3)
    diffuse: np.ndarray  # (P, 3)
    specular: np.ndarray  # (P, 3)

    @staticmethod
    def build(positions, intensities, ambient=None, diffuse=None,
              specular=None, dtype=np.float32) -> "PointLightTable":
        pos = np.atleast_2d(np.asarray(positions, dtype=dtype))
        inten = np.broadcast_to(
            np.atleast_2d(np.asarray(intensities, dtype=dtype)), pos.shape)
        ones = np.ones_like(pos)

        def norm3(x, default):
            if x is None:
                return default
            return np.broadcast_to(
                np.atleast_2d(np.asarray(x, dtype=dtype)), pos.shape)

        return PointLightTable(
            position=jnp.asarray(pos),
            intensity=jnp.asarray(np.ascontiguousarray(inten)),
            ambient=jnp.asarray(norm3(ambient, ones)),
            diffuse=jnp.asarray(norm3(diffuse, ones)),
            specular=jnp.asarray(norm3(specular, ones)),
        )

    @property
    def num(self) -> int:
        return self.position.shape[0]


def sample_light_points(lights: LightTable, u_pick, u0, u1):
    """Sample points uniformly over the union of light surfaces.

    Batched over leading dims of the uniforms.  Returns
    ``(point (..., 3), normal (..., 3), radiance (..., 3), pdf_area (...))``.

    Barycentric mapping matches the reference's sqrt warp
    (src/light_samples.py:25): p = v0*(1-sqrt(a)) + v1*sqrt(a)(1-b) +
    v2*b*sqrt(a) — the standard uniform-triangle sample.
    """
    # Area-weighted triangle pick via CDF inversion.
    li = jnp.searchsorted(lights.cdf, u_pick, side="left")
    li = jnp.clip(li, 0, lights.num - 1)
    v0 = lights.v0[li]
    e1 = lights.e1[li]
    e2 = lights.e2[li]
    sa = jnp.sqrt(u0)
    b1 = sa * (1.0 - u1)
    b2 = u1 * sa
    point = v0 + jnp.expand_dims(b1, -1) * e1 + jnp.expand_dims(b2, -1) * e2
    normal = lights.normal[li]
    radiance = lights.radiance[li]
    pdf_area = 1.0 / jnp.maximum(lights.total_area, 1e-30)
    pdf_area = jnp.broadcast_to(pdf_area, u_pick.shape)
    return point, normal, radiance, pdf_area


def geometry_term(shade_point, shade_normal, light_point, light_normal):
    """|cos(theta) * cos(phi)| / r^2 and the unit shadow-ray direction.

    Physics contract: reference ``cast_one_shadow_ray``
    (src/light_samples.py:56-59).
    """
    to_light = light_point - shade_point
    dist2 = jnp.maximum(lm.dot(to_light, to_light), 1e-20)
    dist = jnp.sqrt(dist2)
    wi = to_light / jnp.expand_dims(dist, -1)
    cos_theta = lm.dot(shade_normal, wi)
    cos_phi = lm.dot(light_normal, -wi)
    g = jnp.abs(cos_theta * cos_phi) / dist2
    return g, wi, dist
