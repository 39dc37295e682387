"""Scene container — a pure pytree of device arrays.

The reference ``Scene`` jitclass (src/scene.py:30-73) mixes configuration
(width, height, max_depth), derived state (screen bounds), the image buffer,
and the full pre-drawn RNG tensors, and integrators mutate it in place.
Here the Scene is an immutable pytree of geometry/material/light tables plus
the camera; render settings live in :class:`RenderConfig` (static) and all
RNG flows through explicit keys/uniform tensors — functional purity removes
the reference's benign-data-race hazard class (SURVEY.md §5).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np
from light_transport_tpu.core import struct

from light_transport_tpu.scene.geometry import TriangleMesh
from light_transport_tpu.scene.lights import LightTable
from light_transport_tpu.scene.material import MaterialTable


@struct.dataclass
class Scene:
    mesh: TriangleMesh
    materials: MaterialTable
    lights: LightTable
    camera: np.ndarray  # (3,) pinhole position
    bvh: Optional["BVH"] = None  # set by with_bvh(); None = brute force
    # optional analytic sphere/plane primitives (reference Sphere/Plane,
    # src/primitives.py:41-66, made renderable — scene/analytic.py)
    analytic: Optional["AnalyticPrims"] = None
    # optional point (delta) lights — the reference GUI's 'Point' source
    # (app.py:152-158) as a first-class table instead of a tiny emissive
    # quad; see scene/lights.PointLightTable and with_point_lights()
    point_lights: Optional["PointLightTable"] = None
    # static flag: route ALL triangle queries through the watertight
    # PBRT-style test (ops/intersect.intersect_rays_watertight) — the
    # reference flagship's convention (pc_triangle_intersect for every hit,
    # src/intersects.py:267-445 via src/utils.py:52-68).  Opt-in here
    # because the robust-MT default + inflated BVH bounds already covers
    # crack-freeness for the bundled scenes at better throughput
    # (README §Deviations 9); set it for crack-sensitive geometry.
    watertight: bool = struct.field(static=True, default=False)

    @staticmethod
    def build(mesh: TriangleMesh, materials: MaterialTable, camera,
              dtype=np.float32, analytic=None) -> "Scene":
        return Scene(
            mesh=mesh,
            materials=materials,
            lights=LightTable.build(mesh, materials, dtype=dtype),
            camera=jnp.asarray(np.asarray(camera, dtype=dtype)),
            analytic=analytic,
        )

    def with_bvh(self, max_leaf: int = 4) -> "Scene":
        """Attach a BVH (host build; reorders the mesh and rebuilds the
        light table over the reordered triangle indices)."""
        from light_transport_tpu.accel import bvh as bvh_mod

        bvh, ordered = bvh_mod.build(self.mesh, max_leaf=max_leaf)
        return Scene(
            mesh=ordered,
            materials=self.materials,
            # keep the scene's dtype (a float64 scene must not silently
            # get a float32 light table)
            lights=LightTable.build(ordered, self.materials,
                                    dtype=self.camera.dtype),
            camera=self.camera,
            bvh=bvh,
            analytic=self.analytic,
            point_lights=self.point_lights,
            watertight=self.watertight,
        )

    def with_point_lights(self, positions, intensities, **phong) -> "Scene":
        """Attach point (delta) light sources (reference GUI 'Point'
        option, app.py:152-158).  ``positions``/``intensities`` are
        (P, 3)-broadcastable; ``**phong`` forwards the optional Whitted
        light colors (ambient/diffuse/specular) to
        :class:`~light_transport_tpu.scene.lights.PointLightTable`."""
        from light_transport_tpu.scene.lights import PointLightTable

        return self.replace(
            point_lights=PointLightTable.build(
                positions, intensities, dtype=self.camera.dtype, **phong))

    def with_watertight(self, on: bool = True) -> "Scene":
        """Select the watertight triangle test for every scene query (the
        reference flagship's robustness path); see the field docstring."""
        return self.replace(watertight=on)
