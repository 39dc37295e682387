"""Intersector dispatch: pick the intersection routine per scene.

Selection is static per scene (known at trace time):

- ``scene.watertight``: the watertight brute force (robustness mode);
- ``scene.bvh`` present: the roped stackless BVH walk (accel/bvh.py);
- otherwise: the masked Möller–Trumbore brute force (ops/intersect.py),
  optionally chunked over rays by ``ray_chunk``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from light_transport_tpu.accel import bvh as bvh_mod
from light_transport_tpu.ops import intersect
from light_transport_tpu.scene.scene import Scene


def scene_intersect(scene: Scene, origins, directions,
                    ray_chunk: Optional[int] = None, active=None):
    """Nearest-hit against the scene; returns Hit (gradients stopped).

    ``active``: optional (N,) bool — lanes the caller will ignore anyway
    (dead paths in a lockstep superstep).  Inactive lanes get an empty ray
    interval (t_max = -inf), so the BVH walk retires them on its first
    iteration; they report no hit.  Callers already mask results with their
    own alive state."""
    n = origins.shape[0]
    # intersection is treated as non-differentiable everywhere (see
    # path_tracer._bounce)
    origins = jax.lax.stop_gradient(origins)
    directions = jax.lax.stop_gradient(directions)
    t_max = jnp.full((n,), jnp.inf, origins.dtype) if active is None \
        else jnp.where(active, jnp.inf, -jnp.inf).astype(origins.dtype)
    if scene.watertight:
        # Scene.with_watertight(): every hit goes through the PBRT-style
        # watertight transform — the reference flagship's convention
        # (pc_triangle_intersect for all hits, src/intersects.py:267-445
        # via src/utils.py:52-68).  Brute force (no BVH reorder): a
        # robustness mode, not a throughput mode.
        hit = intersect.intersect_rays_watertight(
            origins, directions, scene.mesh, t_max=t_max,
            ray_chunk=ray_chunk)
    elif scene.bvh is not None:
        hit = _chunked_bvh(
            lambda o, d, tm: bvh_mod.intersect_bvh(o, d, scene.mesh,
                                                   scene.bvh, t_max=tm),
            origins, directions, t_max,
        )
    else:
        hit = intersect.intersect_rays(origins, directions, scene.mesh,
                                       t_max=t_max, ray_chunk=ray_chunk)
    hit = _merge_analytic(scene, hit, origins, directions)
    return jax.tree.map(jax.lax.stop_gradient, hit)


def _merge_analytic(scene: Scene, hit, origins, directions):
    """Fold the nearest analytic sphere/plane hit (scene/analytic.py) into
    the triangle hit record."""
    prims = getattr(scene, "analytic", None)
    if prims is None or prims.num == 0:
        return hit
    from light_transport_tpu.scene.analytic import (
        KIND_TRI,
        intersect_analytic,
    )

    t_a, kind_a, idx_a = intersect_analytic(
        prims, jax.lax.stop_gradient(origins),
        jax.lax.stop_gradient(directions))
    tri_t = jnp.where(hit.valid, hit.t, jnp.inf)
    a_wins = t_a < tri_t
    return intersect.Hit(
        t=jnp.where(a_wins, t_a, hit.t),
        tri=jnp.where(a_wins, -1, hit.tri),
        valid=hit.valid | a_wins,
        kind=jnp.where(a_wins, kind_a, KIND_TRI),
        prim=jnp.where(a_wins, idx_a, 0),
    )


# Above this lane count the BVH walk runs as a lax.map over chunks, which
# bounds its scratch memory.  Chunks cost time: on an H100 the 1.6M-lane
# 123k-triangle render (models/presets.soft_shadow_scene) took 0.47 s with
# 2^18-lane chunks and 0.13 s as one walk, whose peak was 0.74 GB of
# device memory (PERF.md, PR 1).  So every batch up to 2^24 lanes is one
# walk; chunking only guards batches past that.
BVH_LANE_CHUNK = 1 << 24


def _chunked_bvh(fn, origins, directions, *extras):
    """Pad to a BVH_LANE_CHUNK multiple and lax.map ``fn`` over chunks.

    ``extras`` are additional per-ray (N, ...) arrays (zero-padded; the
    pad rays get direction [0,0,1] so aabb_intersect never divides by 0)."""
    n = origins.shape[0]
    if n <= BVH_LANE_CHUNK:
        return fn(origins, directions, *extras)
    pad = (-n) % BVH_LANE_CHUNK
    if pad:
        origins = jnp.concatenate(
            [origins, jnp.zeros((pad, 3), origins.dtype)])
        dz = jnp.zeros((pad, 3), directions.dtype).at[:, 2].set(1.0)
        directions = jnp.concatenate([directions, dz])
        extras = tuple(
            jnp.concatenate([e, jnp.zeros((pad,) + e.shape[1:], e.dtype)])
            for e in extras)
    total = origins.shape[0]
    out = jax.lax.map(
        lambda args: fn(*args),
        tuple(x.reshape((-1, BVH_LANE_CHUNK) + x.shape[1:])
              for x in (origins, directions) + extras),
    )
    return jax.tree.map(lambda x: x.reshape(total, *x.shape[2:])[:n], out)


def scene_occluded(scene: Scene, origins, directions, max_dist,
                   ray_chunk: Optional[int] = None, active=None):
    """Any-hit visibility against the scene.

    ``active``: optional (N,) bool — inactive lanes report unoccluded."""
    n = origins.shape[0]
    origins = jax.lax.stop_gradient(origins)
    directions = jax.lax.stop_gradient(directions)
    md = jnp.broadcast_to(
        jnp.asarray(jax.lax.stop_gradient(max_dist), origins.dtype), (n,))
    if active is not None:
        md = jnp.where(active, md, 0.0)  # empty interval: no hit
    if scene.watertight:
        occ = intersect.occluded_watertight(
            origins, directions, scene.mesh, md, ray_chunk=ray_chunk)
    elif scene.bvh is not None:
        occ = _chunked_bvh(
            lambda o, d, m: bvh_mod.occluded_bvh(o, d, scene.mesh,
                                                 scene.bvh, m),
            origins, directions, md,
        )
    else:
        occ = intersect.occluded(origins, directions, scene.mesh, md,
                                 ray_chunk=ray_chunk)
    prims = getattr(scene, "analytic", None)
    if prims is not None and prims.num > 0:
        from light_transport_tpu.scene.analytic import intersect_analytic

        t_a, _, _ = intersect_analytic(
            prims, jax.lax.stop_gradient(origins),
            jax.lax.stop_gradient(directions))
        a_occ = t_a < max_dist
        if active is not None:
            # honor the contract: inactive lanes report unoccluded (the
            # triangle paths already skip them via their -inf max_dist)
            a_occ = a_occ & active
        occ = occ | a_occ
    return jax.lax.stop_gradient(occ)


def scene_transmittance(scene: Scene, origins, directions, max_dist,
                        ray_chunk: Optional[int] = None, active=None,
                        max_hits: int = 3):
    """Spectral straight-line transmittance along shadow segments.

    Marches up to ``max_hits`` nearest-hit segments: any non-transmissive
    surface blocks (transmittance 0); each transmissive interface crossing
    is tracked by face orientation, and interior spans attenuate by
    Beer-Lambert ``exp(-(sigma_a + sigma_s) * len)`` of the exited
    material — the unscattered direct term; in-scattered light re-enters
    the estimator through the tracer's analog medium-scatter chains with
    ``emit_ok`` crediting.  Completes the reference's Medium stubs
    (src/constants.py:17-24) for shadow rays; the reference's own
    ``cast_one_shadow_ray`` (src/light_samples.py:35-61) blocks on any hit.

    Approximations (documented in README §Deviations): the segment is not
    refracted (a bent shadow path cannot reach the sampled light point),
    interface Fresnel loss is ignored, and nested transmissive media
    attribute each span to the material exited.  Segments still marching
    after ``max_hits`` crossings are closed out with one any-hit query:
    a clear tail keeps the accumulated attenuation, anything ahead —
    opaque or transmissive — blocks (conservatively dark for stacks of
    more than ``max_hits`` interfaces, never light-leaking past an
    uncounted opaque occluder).

    Returns (N, 3) transmittance in [0, 1].
    """
    from light_transport_tpu.scene.analytic import surface_attrs
    from light_transport_tpu.scene.material import BSDF_TRANSMISSIVE

    eps = 1e-4
    n = origins.shape[0]
    dtype = origins.dtype
    mats = scene.materials
    md = jnp.broadcast_to(jnp.asarray(max_dist, dtype), (n,))
    marching = jnp.ones((n,), bool) if active is None else active

    def body(carry, _):
        cur_o, remaining, trans, marching, pend_sig = carry
        hit = scene_intersect(scene, cur_o, directions, ray_chunk=ray_chunk,
                              active=marching)
        hit_in = hit.valid & (hit.t < remaining) & marching
        # march ends here with no in-range surface: if the lane entered a
        # transmissive object it never exited, the sampled light point lies
        # *inside* it, and the closing span is interior — attenuate by the
        # carried extinction (zero when the lane is in free space), which
        # keeps the estimator symmetric with the exit-attributed spans below
        end_now = marching & ~hit_in
        trans = jnp.where(
            end_now[:, None],
            trans * jnp.exp(-pend_sig * remaining[:, None]), trans)
        hit_p = cur_o + directions * hit.t[:, None]
        n_geo, mat_id, _ = surface_attrs(scene, hit, hit_p)
        is_trans = mats.bsdf[mat_id] == BSDF_TRANSMISSIVE
        blocked = hit_in & ~is_trans
        trans = jnp.where(blocked[:, None], 0.0, trans)
        # a backface crossing exits the hit object: the span just marched
        # was its interior — attenuate by its extinction
        cos_d = jnp.sum(n_geo * directions, axis=-1)
        exiting = hit_in & is_trans & (cos_d > 0.0)
        entering = hit_in & is_trans & (cos_d <= 0.0)
        sig_t = mats.sigma_a[mat_id] + mats.sigma_s[mat_id][:, None]
        att = jnp.exp(-sig_t * hit.t[:, None])
        trans = jnp.where(exiting[:, None], trans * att, trans)
        pend_sig = jnp.where(
            hit_in[:, None],
            jnp.where(entering[:, None], sig_t, 0.0), pend_sig)
        step = hit.t + eps
        cur_o = jnp.where(hit_in[:, None], hit_p + eps * directions, cur_o)
        remaining = jnp.where(hit_in, remaining - step, remaining)
        marching = hit_in & is_trans
        return (cur_o, remaining, trans, marching, pend_sig), None

    trans0 = jnp.ones((n, 3), dtype)
    pend0 = jnp.zeros((n, 3), dtype)
    (cur_o, remaining, trans, marching, pend_sig), _ = jax.lax.scan(
        body, (origins, md, trans0, marching, pend0), None, length=max_hits)
    # conservative close-out: a lane still marching after max_hits
    # transmissive crossings may have unexamined surfaces — including
    # opaque blockers — before the light.  One any-hit query decides:
    # anything ahead blocks.  This biases >max_hits-interface stacks dark
    # instead of leaking full direct light past an uncounted occluder.
    still = marching & (remaining > 0.0)
    occ_tail = scene_occluded(scene, cur_o, directions, remaining,
                              ray_chunk=ray_chunk, active=still)
    trans = jnp.where((still & occ_tail)[:, None], 0.0, trans)
    # a clear tail that ends inside an entered-but-not-exited medium still
    # attenuates over the remaining interior span
    trans = jnp.where(
        (still & ~occ_tail)[:, None],
        trans * jnp.exp(-pend_sig * remaining[:, None]), trans)
    return jax.lax.stop_gradient(trans)
