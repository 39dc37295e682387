"""Renderable analytic primitives: spheres and planes.

The reference defines ``Sphere``/``Plane`` jitclasses
(src/primitives.py:41-66) with scalar intersection kernels
(src/intersects.py:11-42,142-162) but its canonical pipeline never renders
them — scenes are triangle lists.  Here they are first-class renderables:
an SoA table on the Scene, merged with the triangle hit in
ops/dispatch.scene_intersect, surfaced to every integrator through
``surface_attrs``.

Scope (documented): analytic primitives cannot be emitters (NEE samples
area-light *triangles* only) and do not appear in per-triangle surface
detectors; they carry materials and shade/reflect/refract like any surface.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np
from light_transport_tpu.core import struct

from light_transport_tpu.core import math as lm

KIND_TRI = 0
KIND_SPHERE = 1
KIND_PLANE = 2


@struct.dataclass
class AnalyticPrims:
    """SoA tables of analytic primitives (device-resident, replicated)."""

    sph_center: jnp.ndarray  # (S, 3)
    sph_radius: jnp.ndarray  # (S,)
    sph_mat: jnp.ndarray  # (S,) int32 material row
    pl_point: jnp.ndarray  # (P, 3)
    pl_normal: jnp.ndarray  # (P, 3) unit
    pl_mat: jnp.ndarray  # (P,) int32

    @staticmethod
    def build(
        spheres: Sequence[Tuple] = (),
        planes: Sequence[Tuple] = (),
        dtype=np.float32,
    ) -> "AnalyticPrims":
        """``spheres``: (center, radius, mat_id) triples; ``planes``:
        (point, normal, mat_id) triples (normals normalized here, matching
        the reference Plane's stored unit normal, src/primitives.py:55-66).
        """
        sc = np.asarray([s[0] for s in spheres], dtype).reshape(-1, 3)
        sr = np.asarray([s[1] for s in spheres], dtype).reshape(-1)
        sm = np.asarray([s[2] for s in spheres], np.int32).reshape(-1)
        pp = np.asarray([p[0] for p in planes], dtype).reshape(-1, 3)
        pn = np.asarray([p[1] for p in planes], dtype).reshape(-1, 3)
        if len(planes):
            pn = pn / np.linalg.norm(pn, axis=-1, keepdims=True)
        pm = np.asarray([p[2] for p in planes], np.int32).reshape(-1)
        return AnalyticPrims(
            sph_center=jnp.asarray(sc), sph_radius=jnp.asarray(sr),
            sph_mat=jnp.asarray(sm), pl_point=jnp.asarray(pp),
            pl_normal=jnp.asarray(pn), pl_mat=jnp.asarray(pm),
        )

    @property
    def num_spheres(self) -> int:
        return self.sph_radius.shape[0]

    @property
    def num_planes(self) -> int:
        return self.pl_mat.shape[0]

    @property
    def num(self) -> int:
        return self.num_spheres + self.num_planes


def intersect_analytic(prims: AnalyticPrims, origins, directions):
    """Nearest analytic hit per ray.

    Returns ``(t (N,), kind (N,), idx (N,))`` with t=+inf / kind=KIND_TRI on
    miss.  Kernels: ops/intersect.sphere_intersect / plane_intersect
    (contracts: src/intersects.py:11-42,142-162).
    """
    from light_transport_tpu.ops.intersect import (
        plane_intersect,
        sphere_intersect,
    )

    n = origins.shape[0]
    best_t = jnp.full((n,), jnp.inf, origins.dtype)
    best_kind = jnp.zeros((n,), jnp.int32)
    best_idx = jnp.zeros((n,), jnp.int32)
    for i in range(prims.num_spheres):
        t = sphere_intersect(origins, directions, prims.sph_center[i],
                             prims.sph_radius[i])
        closer = t < best_t
        best_t = jnp.where(closer, t, best_t)
        best_kind = jnp.where(closer, KIND_SPHERE, best_kind)
        best_idx = jnp.where(closer, i, best_idx)
    for i in range(prims.num_planes):
        t = plane_intersect(origins, directions, prims.pl_point[i],
                            prims.pl_normal[i])
        closer = t < best_t
        best_t = jnp.where(closer, t, best_t)
        best_kind = jnp.where(closer, KIND_PLANE, best_kind)
        best_idx = jnp.where(closer, i, best_idx)
    return best_t, best_kind, best_idx


def surface_attrs(scene, hit, hit_p):
    """Resolve (geometric normal, mat_id, is_light) at a hit, transparently
    covering triangles and analytic primitives.

    ``hit_p``: (N, 3) hit positions (needed for the sphere normal).
    Analytic primitives are never lights (NEE samples light triangles).
    """
    mesh = scene.mesh
    tri = jnp.maximum(hit.tri, 0)
    normal = mesh.normal[tri]
    mat_id = mesh.mat_id[tri]
    is_light = mesh.is_light[tri]
    prims = getattr(scene, "analytic", None)
    kind = getattr(hit, "kind", None)
    if prims is None or kind is None or prims.num == 0:
        return normal, mat_id, is_light
    idx = jnp.maximum(hit.prim, 0)
    if prims.num_spheres:
        si = jnp.clip(idx, 0, prims.num_spheres - 1)
        s_norm = lm.normalize(hit_p - prims.sph_center[si])
        is_s = (kind == KIND_SPHERE)[:, None]
        normal = jnp.where(is_s, s_norm, normal)
        mat_id = jnp.where(kind == KIND_SPHERE, prims.sph_mat[si], mat_id)
    if prims.num_planes:
        pi = jnp.clip(idx, 0, prims.num_planes - 1)
        is_p = (kind == KIND_PLANE)[:, None]
        normal = jnp.where(is_p, prims.pl_normal[pi], normal)
        mat_id = jnp.where(kind == KIND_PLANE, prims.pl_mat[pi], mat_id)
    is_light = is_light & (kind == KIND_TRI)
    return normal, mat_id, is_light
