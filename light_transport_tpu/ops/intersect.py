"""Batched ray-primitive intersection kernels.

Array replacement for the reference's scalar kernels
(src/intersects.py): every test here is a branchless masked op over an
``(N_rays, N_tris)`` tile, so the whole ray population and triangle soup is
processed by fused elementwise code — no per-ray control flow, no candidate
lists.

- :func:`intersect_rays` — nearest hit via masked Möller–Trumbore
  (physics contract: ``triangle_intersect``, src/intersects.py:46-104)
- :func:`occluded` — any-hit visibility for NEE shadow rays
  (contract: ``cast_one_shadow_ray``'s distance test, src/light_samples.py:53)
- :func:`sphere_intersect` / :func:`plane_intersect` / :func:`aabb_intersect`
  — parity with src/intersects.py:11-42,142-162,165-175.

For big meshes, rays are processed in chunks (``ray_chunk``) so the
``(N, T)`` intermediate stays within device memory; the BVH path in
``accel/`` bounds T per ray instead.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from light_transport_tpu.core import math as lm
from light_transport_tpu.scene.geometry import TriangleMesh

# |det| below this is treated as ray-parallel-to-triangle (reference uses
# 1e-7 in float64, src/intersects.py:56; float32 needs a scale-aware guard —
# the mask on u/v/t already rejects garbage from near-zero dets).
DET_EPS = 1e-12
# Minimum hit distance (reference: t > 1e-7, src/intersects.py:101).
T_EPS = 1e-5


class Hit(NamedTuple):
    """SoA hit record for a ray batch.

    ``kind``/``prim`` are populated only when the scene carries analytic
    primitives (scene/analytic.py): kind 0 = triangle (``tri`` indexes the
    mesh), 1 = sphere, 2 = plane (``prim`` indexes the analytic table;
    ``tri`` is -1).  None = all-triangle scene."""

    t: jnp.ndarray  # (N,) hit distance; +inf on miss
    tri: jnp.ndarray  # (N,) int32 triangle index; -1 on miss
    valid: jnp.ndarray  # (N,) bool
    kind: jnp.ndarray = None  # (N,) int32 primitive kind, or None
    prim: jnp.ndarray = None  # (N,) int32 analytic-table index, or None


def _mt_tile(o, d, v0, e1, e2, t_min, t_max):
    """Möller–Trumbore on an (N, T) tile. Returns (t (N,T), valid (N,T))."""
    # (N, 1, 3) x (1, T, 3)
    d_b = d[:, None, :]
    pvec = lm.cross(d_b, e2[None, :, :])  # (N, T, 3)
    det = jnp.sum(e1[None, :, :] * pvec, axis=-1)  # (N, T)
    inv_det = jnp.where(jnp.abs(det) > DET_EPS, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvec = o[:, None, :] - v0[None, :, :]  # (N, T, 3)
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = lm.cross(tvec, e1[None, :, :])  # (N, T, 3)
    v = jnp.sum(d_b * qvec, axis=-1) * inv_det
    t = jnp.sum(e2[None, :, :] * qvec, axis=-1) * inv_det
    valid = (
        (jnp.abs(det) > DET_EPS)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min[:, None])
        & (t < t_max[:, None])
    )
    return t, valid


def _broadcast_t(x, n, dtype):
    x = jnp.asarray(x, dtype=dtype)
    return jnp.broadcast_to(x, (n,))


def intersect_rays(
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    mesh: TriangleMesh,
    t_min=T_EPS,
    t_max=jnp.inf,
    ray_chunk: Optional[int] = None,
) -> Hit:
    """Nearest-hit intersection of a ray batch against the full soup.

    ``origins``/``directions``: (N, 3). Returns a :class:`Hit`.
    """
    n = origins.shape[0]
    dtype = origins.dtype
    t_min = _broadcast_t(t_min, n, dtype)
    t_max = _broadcast_t(t_max, n, dtype)

    def run(o, d, tmin, tmax):
        t, valid = _mt_tile(o, d, mesh.v0, mesh.e1, mesh.e2, tmin, tmax)
        t_masked = jnp.where(valid, t, jnp.inf)
        tri = jnp.argmin(t_masked, axis=-1).astype(jnp.int32)
        t_best = jnp.take_along_axis(t_masked, tri[:, None], axis=-1)[:, 0]
        ok = jnp.isfinite(t_best)
        return Hit(
            t=t_best,
            tri=jnp.where(ok, tri, -1),
            valid=ok,
        )

    if ray_chunk is None or n <= ray_chunk:
        return run(origins, directions, t_min, t_max)

    # Chunk over rays to bound the (chunk, T) intermediate; pad the tail
    # with dead rays (t_max = 0 rejects everything).
    o_p, d_p, tn_p, tx_p, total = _pad_rays(
        origins, directions, t_min, t_max, ray_chunk
    )
    hits = jax.lax.map(
        lambda args: run(*args),
        (
            o_p.reshape(-1, ray_chunk, 3),
            d_p.reshape(-1, ray_chunk, 3),
            tn_p.reshape(-1, ray_chunk),
            tx_p.reshape(-1, ray_chunk),
        ),
    )
    return Hit(
        t=hits.t.reshape(total)[:n],
        tri=hits.tri.reshape(total)[:n],
        valid=hits.valid.reshape(total)[:n],
    )


def _pad_rays(origins, directions, t_min, t_max, chunk):
    n = origins.shape[0]
    total = ((n + chunk - 1) // chunk) * chunk
    pad = total - n
    if pad:
        origins = jnp.concatenate([origins, jnp.zeros((pad, 3), origins.dtype)])
        dz = jnp.zeros((pad, 3), directions.dtype).at[:, 2].set(1.0)
        directions = jnp.concatenate([directions, dz])
        t_min = jnp.concatenate([t_min, jnp.zeros((pad,), t_min.dtype)])
        t_max = jnp.concatenate([t_max, jnp.zeros((pad,), t_max.dtype)])
    return origins, directions, t_min, t_max, total


def occluded(
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    mesh: TriangleMesh,
    max_dist: jnp.ndarray,
    t_min=T_EPS,
    ray_chunk: Optional[int] = None,
) -> jnp.ndarray:
    """Any-hit test: True where something blocks the segment before
    ``max_dist``.  Matches the reference visibility rule
    ``min_distance >= |shadow_ray| - EPSILON`` (src/light_samples.py:53) with
    the epsilon folded into ``max_dist`` by the caller.
    """
    n = origins.shape[0]
    dtype = origins.dtype
    t_min = _broadcast_t(t_min, n, dtype)
    max_dist = _broadcast_t(max_dist, n, dtype)

    def run(o, d, tmin, tmax):
        _, valid = _mt_tile(o, d, mesh.v0, mesh.e1, mesh.e2, tmin, tmax)
        return jnp.any(valid, axis=-1)

    if ray_chunk is None or n <= ray_chunk:
        return run(origins, directions, t_min, max_dist)
    o_p, d_p, tn_p, tx_p, total = _pad_rays(
        origins, directions, t_min, max_dist, ray_chunk
    )
    res = jax.lax.map(
        lambda args: run(*args),
        (
            o_p.reshape(-1, ray_chunk, 3),
            d_p.reshape(-1, ray_chunk, 3),
            tn_p.reshape(-1, ray_chunk),
            tx_p.reshape(-1, ray_chunk),
        ),
    )
    return res.reshape(total)[:n]


def sphere_intersect(origins, directions, center, radius):
    """Batched ray-sphere test (contract: src/intersects.py:11-42).

    Returns nearest positive t, +inf on miss.
    """
    oc = origins - jnp.asarray(center)
    b = 2.0 * lm.dot(directions, oc)
    c = lm.dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-b - sq) / 2.0
    t2 = (-b + sq) / 2.0
    t_near = jnp.minimum(t1, t2)
    t_far = jnp.maximum(t1, t2)
    t = jnp.where(t_near > T_EPS, t_near, t_far)
    return jnp.where((disc > 0.0) & (t > T_EPS), t, jnp.inf)


def plane_intersect(origins, directions, point, normal):
    """Batched ray-plane test (contract: src/intersects.py:142-162)."""
    point = jnp.asarray(point)
    normal = jnp.asarray(normal)
    denom = lm.dot(directions, normal)
    safe = jnp.where(jnp.abs(denom) > 1e-6, denom, 1.0)
    t = lm.dot(point - origins, normal) / safe
    return jnp.where((jnp.abs(denom) > 1e-6) & (t > T_EPS), t, jnp.inf)


def aabb_intersect(origins, directions, box_min, box_max, t_max=jnp.inf):
    """Batched slab test (contract: src/intersects.py:165-196).

    Returns (hit mask, t_near, t_far).
    """
    # guard zero components: plain 1/0 = inf breaks when an origin
    # coordinate sits exactly on a slab plane (0 * inf = NaN propagates
    # through min/max and reports a false miss on axis-parallel rays)
    inv_d = 1.0 / jnp.where(jnp.abs(directions) < 1e-20,
                            jnp.where(directions < 0, -1e-20, 1e-20),
                            directions)
    t1 = (jnp.asarray(box_min) - origins) * inv_d
    t2 = (jnp.asarray(box_max) - origins) * inv_d
    t_near = jnp.max(jnp.minimum(t1, t2), axis=-1)
    t_far = jnp.min(jnp.maximum(t1, t2), axis=-1)
    t_near = jnp.maximum(t_near, 0.0)
    t_far = jnp.minimum(t_far, t_max)
    return t_near <= t_far, t_near, t_far


# ---------------------------------------------------------------------------
# Watertight triangle intersection (contract: pc_triangle_intersect,
# src/intersects.py:267-445 — PBRT 3.9.x "Watertight Ray-Triangle
# Intersection").  The reference runs it scalar-per-candidate in float64; here
# the translate/permute/shear transform is batched over an (N, T) tile with
# the per-ray permutation applied via take_along_axis, so the whole test is
# branchless elementwise code.  Deviation: the reference re-evaluates
# exactly-zero edge functions in float64 (src/intersects.py:316-329); this
# program runs float32 throughout, so zero edge functions are accepted as on-edge hits — watertightness (shared
# edges/vertices never fall through) still holds because adjacent triangles
# evaluate the shared edge with the same rounded products, just negated.
# ---------------------------------------------------------------------------

_F32_EPS_HALF = float(jnp.finfo(jnp.float32).eps) / 2.0


def _gamma(n: int) -> float:
    """PBRT's conservative float-error bound (src/intersects.py:228-235)."""
    return n * _F32_EPS_HALF / (1.0 - n * _F32_EPS_HALF)


def _wt_tile(o, d, v0, v1, v2, t_min, t_max):
    """Watertight test on an (N, T) tile -> (t, b0, b1, b2, valid)."""
    # per-ray axis permutation: kz = argmax |d|, (kx, ky) cyclic
    kz = jnp.argmax(jnp.abs(d), axis=-1)  # (N,)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3

    def pick(vec, k):
        # vec (N, 3) or (N, T, 3); k (N,) -> component along per-ray axis
        if vec.ndim == 2:
            return jnp.take_along_axis(vec, k[:, None], axis=-1)[:, 0]
        return jnp.take_along_axis(
            vec, k[:, None, None].repeat(vec.shape[1], 1), axis=-1
        )[..., 0]

    dx, dy, dz = pick(d, kx), pick(d, ky), pick(d, kz)  # (N,)
    # shear so the ray maps to +z (src/intersects.py:301-311)
    sx = -dx / dz
    sy = -dy / dz
    sz = 1.0 / dz

    # translate to ray origin, permute, shear x/y (z sheared after the tests)
    def xyz(p):
        q = p[None, :, :] - o[:, None, :]  # (N, T, 3)
        px, py, pz = pick(q, kx), pick(q, ky), pick(q, kz)
        return (px + sx[:, None] * pz, py + sy[:, None] * pz, pz)

    x0, y0, z0 = xyz(v0)
    x1, y1, z1 = xyz(v1)
    x2, y2, z2 = xyz(v2)

    # 2D edge functions (src/intersects.py:316-329)
    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1

    same_sign = ~(((e0 < 0) | (e1 < 0) | (e2 < 0))
                  & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    ok = same_sign & (det != 0.0)

    z0s, z1s, z2s = sz[:, None] * z0, sz[:, None] * z1, sz[:, None] * z2
    t_scaled = e0 * z0s + e1 * z1s + e2 * z2s
    # sign-consistent distance-window test on the scaled t
    # (src/intersects.py:334-345)
    neg = det < 0
    ok &= jnp.where(
        neg,
        (t_scaled <= t_min[:, None] * det) & (t_scaled > t_max[:, None] * det),
        (t_scaled >= t_min[:, None] * det) & (t_scaled < t_max[:, None] * det),
    )

    inv_det = jnp.where(det != 0.0, 1.0 / jnp.where(det == 0.0, 1.0, det), 0.0)
    t = t_scaled * inv_det
    b0, b1, b2 = e0 * inv_det, e1 * inv_det, e2 * inv_det

    # conservative scaled-t error bound: reject hits closer than the
    # accumulated rounding error (src/intersects.py:349-382)
    max_zt = jnp.maximum(jnp.maximum(jnp.abs(z0s), jnp.abs(z1s)),
                         jnp.abs(z2s))
    max_xt = jnp.maximum(jnp.maximum(jnp.abs(x0), jnp.abs(x1)), jnp.abs(x2))
    max_yt = jnp.maximum(jnp.maximum(jnp.abs(y0), jnp.abs(y1)), jnp.abs(y2))
    delta_z = _gamma(3) * max_zt
    delta_x = _gamma(5) * (max_xt + max_zt)
    delta_y = _gamma(5) * (max_yt + max_zt)
    delta_e = 2.0 * (_gamma(2) * max_xt * max_yt
                     + delta_y * max_xt + delta_x * max_yt)
    max_e = jnp.maximum(jnp.maximum(jnp.abs(e0), jnp.abs(e1)), jnp.abs(e2))
    delta_t = 3.0 * (_gamma(3) * max_e * max_zt + delta_e * max_zt
                     + delta_z * max_e) * jnp.abs(inv_det)
    ok &= t > delta_t
    return t, b0, b1, b2, ok


def intersect_rays_watertight(
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    mesh: TriangleMesh,
    t_min=T_EPS,
    t_max=jnp.inf,
    ray_chunk: Optional[int] = None,
) -> Hit:
    """Nearest-hit via the watertight transform: rays crossing a shared
    edge/vertex of adjacent triangles are guaranteed to hit at least one of
    them (classic Möller–Trumbore can round them into a crack).  Slower than
    :func:`intersect_rays` (the permutation gathers don't fuse as tightly),
    so it is an opt-in for crack-sensitive geometry."""
    n = origins.shape[0]
    dtype = origins.dtype
    t_min = _broadcast_t(t_min, n, dtype)
    t_max = _broadcast_t(t_max, n, dtype)
    v0 = jnp.asarray(mesh.v0)
    v1 = v0 + jnp.asarray(mesh.e1)
    v2 = v0 + jnp.asarray(mesh.e2)

    def run(o, d, tmin, tmax):
        t, _, _, _, valid = _wt_tile(o, d, v0, v1, v2, tmin, tmax)
        t_masked = jnp.where(valid, t, jnp.inf)
        tri = jnp.argmin(t_masked, axis=-1).astype(jnp.int32)
        t_best = jnp.take_along_axis(t_masked, tri[:, None], axis=-1)[:, 0]
        ok = jnp.isfinite(t_best)
        return Hit(t=t_best, tri=jnp.where(ok, tri, -1), valid=ok)

    if ray_chunk is None or n <= ray_chunk:
        return run(origins, directions, t_min, t_max)
    o_p, d_p, tn_p, tx_p, total = _pad_rays(
        origins, directions, t_min, t_max, ray_chunk
    )
    hits = jax.lax.map(
        lambda args: run(*args),
        (o_p.reshape(-1, ray_chunk, 3), d_p.reshape(-1, ray_chunk, 3),
         tn_p.reshape(-1, ray_chunk), tx_p.reshape(-1, ray_chunk)),
    )
    return Hit(t=hits.t.reshape(total)[:n],
               tri=hits.tri.reshape(total)[:n],
               valid=hits.valid.reshape(total)[:n])


def occluded_watertight(
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    mesh: TriangleMesh,
    max_dist: jnp.ndarray,
    t_min=T_EPS,
    ray_chunk: Optional[int] = None,
) -> jnp.ndarray:
    """Any-hit visibility via the watertight test (the robustness pair of
    :func:`occluded`, same contract) — shadow rays grazing shared edges
    cannot slip through a crack and report false light leaks."""
    n = origins.shape[0]
    dtype = origins.dtype
    t_min = _broadcast_t(t_min, n, dtype)
    max_dist = _broadcast_t(max_dist, n, dtype)
    v0 = jnp.asarray(mesh.v0)
    v1 = v0 + jnp.asarray(mesh.e1)
    v2 = v0 + jnp.asarray(mesh.e2)

    def run(o, d, tmin, tmax):
        _, _, _, _, valid = _wt_tile(o, d, v0, v1, v2, tmin, tmax)
        return jnp.any(valid, axis=-1)

    if ray_chunk is None or n <= ray_chunk:
        return run(origins, directions, t_min, max_dist)
    o_p, d_p, tn_p, tx_p, total = _pad_rays(
        origins, directions, t_min, max_dist, ray_chunk
    )
    res = jax.lax.map(
        lambda args: run(*args),
        (o_p.reshape(-1, ray_chunk, 3), d_p.reshape(-1, ray_chunk, 3),
         tn_p.reshape(-1, ray_chunk), tx_p.reshape(-1, ray_chunk)),
    )
    return res.reshape(total)[:n]
