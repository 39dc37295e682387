"""Triangle-soup scene geometry as SoA arrays.

Replaces the reference's per-triangle jitclasses (``Triangle`` /
``PreComputedTriangle``, src/primitives.py:17-38,99-173) with flat
``(T, 3)``-shaped arrays: one device-resident tensor per attribute, every kernel
broadcast over the whole soup.  We precompute edges and normals exactly as
``PreComputedTriangle.__init__`` does (src/primitives.py:108-112) but skip
its 12-float Wald transform — batched Möller–Trumbore vectorizes better
(SURVEY.md §7 layer 2).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from light_transport_tpu.core import struct

# host-side copies of mesh arrays keyed by the device buffer of v0; bounded
# FIFO so long sessions don't accumulate (scenes are few and small)
_HOST_CACHE = {}
_HOST_CACHE_MAX = 16


def _host_cache_key(mesh):
    try:
        return id(mesh.v0)
    except Exception:  # pragma: no cover
        return None


def _host_cache_get(mesh):
    entry = _HOST_CACHE.get(_host_cache_key(mesh))
    if entry is None:
        return None
    ref, arrs = entry
    return arrs if ref is mesh.v0 else None


def _host_cache_put(mesh, arrs):
    key = _host_cache_key(mesh)
    if key is None:
        return
    if len(_HOST_CACHE) >= _HOST_CACHE_MAX:
        _HOST_CACHE.pop(next(iter(_HOST_CACHE)))
    # hold the device array itself so the id stays valid
    _HOST_CACHE[key] = (mesh.v0, tuple(np.asarray(a) for a in arrs))


@struct.dataclass
class TriangleMesh:
    """SoA triangle soup.

    All arrays share leading dim T (triangle count).  ``mat_id`` indexes a
    :class:`~light_transport_tpu.scene.material.MaterialTable`.
    """

    v0: np.ndarray  # (T, 3) first vertex
    e1: np.ndarray  # (T, 3) v1 - v0
    e2: np.ndarray  # (T, 3) v2 - v0
    normal: np.ndarray  # (T, 3) unit geometric normal = norm(e1 x e2)
    centroid: np.ndarray  # (T, 3)
    mat_id: np.ndarray  # (T,) int32
    is_light: np.ndarray  # (T,) bool

    @staticmethod
    def build(
        vertices: np.ndarray,
        mat_id: np.ndarray,
        is_light: Optional[np.ndarray] = None,
        dtype=np.float32,
    ) -> "TriangleMesh":
        """Build from ``(T, 3, 3)`` vertex array (tri, corner, xyz)."""
        vertices = np.asarray(vertices, dtype=np.float64)
        assert vertices.ndim == 3 and vertices.shape[1:] == (3, 3), vertices.shape
        t = vertices.shape[0]
        v0 = vertices[:, 0]
        e1 = vertices[:, 1] - v0
        e2 = vertices[:, 2] - v0
        n = np.cross(e1, e2)
        nlen = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.maximum(nlen, 1e-30)
        centroid = vertices.mean(axis=1)
        if is_light is None:
            is_light = np.zeros((t,), dtype=bool)
        import jax.numpy as jnp

        mesh = TriangleMesh(
            v0=jnp.asarray(v0.astype(dtype)),
            e1=jnp.asarray(e1.astype(dtype)),
            e2=jnp.asarray(e2.astype(dtype)),
            normal=jnp.asarray(n.astype(dtype)),
            centroid=jnp.asarray(centroid.astype(dtype)),
            mat_id=jnp.asarray(np.asarray(mat_id, dtype=np.int32)),
            is_light=jnp.asarray(np.asarray(is_light, dtype=bool)),
        )
        _host_cache_put(
            mesh,
            (v0.astype(dtype), e1.astype(dtype), e2.astype(dtype),
             centroid.astype(dtype), n.astype(dtype),
             np.asarray(mat_id, np.int32), np.asarray(is_light, bool)),
        )
        return mesh

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    def host_arrays(self):
        """Host numpy copies of (v0, e1, e2, centroid, normal, mat_id,
        is_light) — served from the build-time cache when available so
        host-side consumers (BVH build, light-table extraction) skip the
        device-to-host copy."""
        cached = _host_cache_get(self)
        if cached is not None:
            return cached
        arrs = tuple(
            np.asarray(getattr(self, f))
            for f in ("v0", "e1", "e2", "centroid", "normal", "mat_id",
                      "is_light")
        )
        _host_cache_put(self, arrs)
        return arrs

    def translated(self, offset) -> "TriangleMesh":
        """New mesh shifted by ``offset`` (host-side scene composition —
        the reference moves objects via pyvista transforms before
        triangulating, e.g. LTS.ipynb cell 11)."""
        v0, e1, e2, centroid, normal, mat_id, is_light = self.host_arrays()
        off = np.asarray(offset, v0.dtype)
        tris = np.stack([v0 + off, v0 + off + e1, v0 + off + e2], axis=1)
        return TriangleMesh.build(tris, mat_id, is_light, dtype=v0.dtype)

    def scaled(self, factor, origin=(0.0, 0.0, 0.0)) -> "TriangleMesh":
        """New mesh scaled about ``origin`` (uniform or per-axis)."""
        v0, e1, e2, centroid, normal, mat_id, is_light = self.host_arrays()
        f = np.broadcast_to(np.asarray(factor, v0.dtype), (3,))
        org = np.asarray(origin, v0.dtype)
        a = (v0 - org) * f + org
        tris = np.stack([a, a + e1 * f, a + e2 * f], axis=1)
        return TriangleMesh.build(tris, mat_id, is_light, dtype=v0.dtype)

    def vertices(self) -> np.ndarray:
        """Recover the (T, 3, 3) vertex array (host-side use: BVH build, IO)."""
        v0, e1, e2 = self.host_arrays()[:3]
        v0 = v0.astype(np.float64)
        return np.stack([v0, v0 + e1.astype(np.float64),
                         v0 + e2.astype(np.float64)], axis=1)

    def area(self) -> np.ndarray:
        """Per-triangle area = |e1 x e2| / 2."""
        e1, e2 = self.host_arrays()[1:3]
        n = np.cross(e1.astype(np.float64), e2.astype(np.float64))
        return 0.5 * np.linalg.norm(n, axis=-1)


def quad_triangles(a, b, c, d) -> np.ndarray:
    """Split quad (a,b,c,d) into two triangles (a,b,c), (a,c,d).

    Matches pyvista ``Rectangle(...).triangulate()`` as used throughout the
    reference's procedural builders (src/cornell_box.py:22-26 etc.).
    """
    a, b, c, d = (np.asarray(p, dtype=np.float64) for p in (a, b, c, d))
    return np.stack([np.stack([a, b, c]), np.stack([a, c, d])])


def uv_sphere_triangles(center=(0.0, 0.0, 0.0), radius=1.0,
                        n_theta=16, n_phi=32) -> np.ndarray:
    """Vectorized UV-sphere triangulation — (T, 3, 3) float64.

    Same band/quad layout as scene/cornell.sphere_triangles (pole quads
    keep only their non-degenerate half) but built with numpy broadcasting:
    the per-quad python loop there takes minutes at million-triangle
    tessellations.
    """
    center = np.asarray(center, np.float64)
    th = np.linspace(0.0, np.pi, n_theta + 1)
    ph = np.linspace(0.0, 2 * np.pi, n_phi, endpoint=False)
    pts = np.stack(
        [np.sin(th)[:, None] * np.cos(ph)[None, :],
         np.cos(th)[:, None] * np.ones_like(ph)[None, :],
         np.sin(th)[:, None] * np.sin(ph)[None, :]], axis=-1)
    pts = center + radius * pts
    roll = np.roll(np.arange(n_phi), -1)
    a = pts[:-1, :]
    b = pts[:-1, roll]
    c = pts[1:, roll]
    d = pts[1:, :]
    upper = np.stack([a, b, c], axis=2)[1:].reshape(-1, 3, 3)
    lower = np.stack([a, c, d], axis=2)[:-1].reshape(-1, 3, 3)
    return np.concatenate([upper, lower])


def concat_meshes(meshes: Sequence[TriangleMesh]) -> TriangleMesh:
    import jax.numpy as jnp

    out = TriangleMesh(
        v0=jnp.concatenate([m.v0 for m in meshes]),
        e1=jnp.concatenate([m.e1 for m in meshes]),
        e2=jnp.concatenate([m.e2 for m in meshes]),
        normal=jnp.concatenate([m.normal for m in meshes]),
        centroid=jnp.concatenate([m.centroid for m in meshes]),
        mat_id=jnp.concatenate([m.mat_id for m in meshes]),
        is_light=jnp.concatenate([m.is_light for m in meshes]),
    )
    parts = [m.host_arrays() for m in meshes]
    _host_cache_put(
        out,
        tuple(np.concatenate([p[k] for p in parts]) for k in range(7)),
    )
    return out
