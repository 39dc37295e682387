"""Whitted-style ray tracer — the reference's legacy baseline.

Physics contract: ``render_old.trace_ray`` (src/render_old.py:70-198):
per-hit Phong shading (ambient + diffuse + specular) against every light
with a shadow test (:96-133), Fresnel- or mirror-weighted reflection
recursion (:140-164), refraction recursion (:167-184), and an optional
hemisphere-sampled indirect-diffuse term (:186-194).

Array shape: the recursion tree is *statically unrolled* — at each
depth every lane spawns a reflection branch and a refraction branch as new
full-width batched trace calls with accumulated weights (2^depth total
intersect sweeps; the reference runs depth<=3 on toy scenes, so the tree is
tiny), and the 10-sample indirect-diffuse loop becomes ``indirect_samples``
cosine draws at the primary hit.  No per-ray recursion, no Python objects.

Deviations (documented):
- proper Schlick ``(1-|cos|)^5`` (the reference takes cos of a cosine,
  src/render_old.py:155);
- area lights are shaded at per-row fixed sample points (triangle centroid)
  instead of the reference's pre-drawn random point list — same estimator
  class, deterministic;
- the indirect-diffuse term defaults to the primary hit only; the
  reference's full recursion (10^depth rays, src/render_old.py:186-194)
  is available as ``render_whitted(..., indirect_mode="full")`` through
  the weighted ray queue (single-sample GI children below the primary —
  same expectation; A/B image delta in PERF.md).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from light_transport_tpu.core import math as lm
from light_transport_tpu.core.config import RenderConfig
from light_transport_tpu.ops import intersect, sampling
from light_transport_tpu.scene.scene import Scene


def _hit(scene: Scene, o, d, ray_chunk, active=None):
    from light_transport_tpu.ops.dispatch import scene_intersect

    return scene_intersect(scene, o, d, ray_chunk=ray_chunk, active=active)


def _occluded(scene: Scene, o, d, dist, ray_chunk, active=None):
    from light_transport_tpu.ops.dispatch import scene_occluded

    return scene_occluded(scene, o, d, dist, ray_chunk=ray_chunk,
                          active=active)


def _light_points(scene: Scene):
    """One fixed shading point per light row (triangle centroid)."""
    lights = scene.lights
    return lights.v0 + (lights.e1 + lights.e2) / 3.0


def trace_whitted(
    scene: Scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    depth: int,
    ray_chunk: Optional[int] = None,
    active=None,
    hit=None,
) -> jnp.ndarray:
    """Shade a ray batch Whitted-style; returns (N, 3) color.

    ``active``: lanes whose color the caller will actually use — dead or
    zero-weight recursion branches are culled inside dispatch (their color
    is already masked to 0 by the weights below).  ``hit``: optional
    precomputed nearest-hit record for (o, d) so a caller that already
    intersected the batch (e.g. to share it with the indirect-diffuse
    term) doesn't pay the sweep twice."""
    if hit is None:
        hit = _hit(scene, o, d, ray_chunk, active=active)
    (color, hit_ok, hp, n_s, shifted, refl_coef, transmission,
     t_dir, tir, _) = _shade_local(scene, o, d, hit, ray_chunk, active)

    if depth > 0:
        # reflection branch (:157-164)
        r_dir = lm.reflect(d, n_s)
        r_col = trace_whitted(scene, shifted, r_dir, depth - 1, ray_chunk,
                              active=hit_ok)
        color = color + jnp.where(
            hit_ok[:, None], refl_coef[:, None] * r_col, 0.0
        )

        # refraction branch (:167-184)
        t_o = hp - 1e-3 * n_s  # :178 (-0.001 offset)
        t_active = hit_ok & ~tir & (transmission > 0)
        t_col = trace_whitted(scene, t_o, t_dir, depth - 1, ray_chunk,
                              active=t_active)
        t_w = jnp.where(t_active, (1.0 - refl_coef) * transmission, 0.0)
        color = color + t_w[:, None] * t_col

    return color


def _shade_local(scene, o, d, hit, ray_chunk, active):
    """Phong-shade one traced ray batch; returns (color, geometry info
    needed for spawning reflection/refraction children)."""
    mats = scene.materials
    n = o.shape[0]
    hit_ok = hit.valid if active is None else hit.valid & active
    hp = o + d * hit.t[:, None]
    from light_transport_tpu.scene.analytic import surface_attrs

    n_geo, mat_id, _ = surface_attrs(scene, hit, hp)
    inside = lm.dot(n_geo, d) > 0.0
    n_s = jnp.where(inside[:, None], -n_geo, n_geo)
    shifted = hp + 1e-4 * n_s

    lp = _light_points(scene)
    l_amb = mats.ambient[scene.lights.mat_id]
    l_dif = mats.diffuse[scene.lights.mat_id]
    l_spec = mats.specular[scene.lights.mat_id]
    o_amb = mats.ambient[mat_id]
    o_dif = mats.diffuse[mat_id]
    o_spec = mats.specular[mat_id]
    shin = mats.shininess[mat_id]

    color = jnp.zeros((n, 3), o.dtype)
    num_l = lp.shape[0]
    plt_ = scene.point_lights
    if plt_ is not None:
        # with point lights present a degenerate zero-radiance area table
        # (scenes with no emissive triangles) must not shade — weight each
        # area row by whether it actually emits.  Point-light-free scenes
        # keep the legacy static path below bit-identically.
        row_w = [jnp.any(scene.lights.radiance[li] > 0).astype(o.dtype)
                 for li in range(num_l)]
    else:
        row_w = None

    def phong_row(l_pos, amb_i, dif_i, spec_i):
        """One Phong-shaded light row toward position ``l_pos`` — the
        reference's per-light ambient+diffuse+specular with a shadow test
        (src/render_old.py:70-134)."""
        to_l = l_pos - shifted
        dist = lm.norm(to_l)
        wi = to_l / jnp.maximum(dist, 1e-20)[:, None]
        shadowed = _occluded(scene, shifted, wi, dist * (1 - 1e-3),
                             ray_chunk, active=hit_ok)
        illum = o_amb * amb_i
        ndotl = jnp.maximum(lm.dot(wi, n_s), 0.0)
        diffuse = o_dif * dif_i * ndotl[:, None]
        to_cam = lm.normalize(scene.camera - hp)
        h = lm.normalize(wi + to_cam)
        ndoth = jnp.maximum(lm.dot(n_s, h), 0.0)
        spec = o_spec * spec_i * (ndoth ** (shin / 4.0))[:, None]
        lit = illum + diffuse + spec
        return jnp.where(shadowed[:, None], illum, lit)

    for li in range(num_l):
        row = phong_row(lp[li], l_amb[li], l_dif[li], l_spec[li])
        color = color + (row if row_w is None else row_w[li] * row)
    if plt_ is None:
        color = color / max(num_l, 1)
    else:
        # point (delta) lights: Phong rows toward the positions with the
        # table's light colors (reference GUI 'Point' source,
        # app.py:152-158; colors come off the light material there)
        for li in range(plt_.num):
            pos = jnp.broadcast_to(plt_.position[li], shifted.shape)
            color = color + phong_row(pos, plt_.ambient[li],
                                      plt_.diffuse[li], plt_.specular[li])
        denom = sum(row_w) + plt_.num
        color = color / jnp.maximum(denom, 1.0)
    color = jnp.where(hit_ok[:, None], color, 0.0)

    is_mirror = mats.bsdf[mat_id] == 1
    ior = mats.ior[mat_id]
    n1 = jnp.where(inside, ior, 1.0)
    n2 = jnp.where(inside, 1.0, ior)
    r0 = sampling.schlick_r0(n1, n2)
    cos_i = jnp.abs(lm.dot(d, n_s))
    fresnel_r = sampling.schlick_reflectance(r0, cos_i)
    refl_coef = jnp.where(is_mirror, mats.reflection[mat_id], fresnel_r)
    transmission = mats.transmission[mat_id]
    eta = n1 / n2
    t_dir, tir = lm.refract(d, n_s, eta)
    return (color, hit_ok, hp, n_s, shifted, refl_coef, transmission,
            t_dir, tir, o_dif)


def trace_whitted_queue(
    scene: Scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    depth: int,
    ray_chunk: Optional[int] = None,
    weight_cutoff: float = 1e-3,
    max_iters: Optional[int] = None,
    indirect_samples: int = 0,
    key: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """Deep-recursion Whitted: iterative weighted ray queue.

    ``trace_whitted`` statically unrolls the reflect/refract tree — 2^depth
    trace sweeps, unusable past depth ~5.  Here each lane follows one
    branch at a time and pushes the other (with its accumulated RGB
    weight) onto a per-lane stack of static depth; sub-``weight_cutoff``
    (luminance) branches are dropped.  One host-driven superstep per tree
    node on the heaviest-weight-first path: the jitted step compiles ONCE,
    and total iterations are bounded by the number of significant tree
    nodes, not 2^depth.

    ``indirect_samples`` > 0 adds the reference's recursive
    hemisphere-sampled indirect-diffuse term at EVERY tree node
    (src/render_old.py:186-194 recurses it — 10^depth rays there): the
    primary node spawns ``indirect_samples`` weighted GI children
    (``o_dif * cos * 0.1 / k`` each, the reference's estimator) and every
    deeper node one single-sample child — an unbiased estimator of the
    same nested expectation whose deep levels the weight cutoff prunes
    (each level multiplies the weight by ~0.1*albedo*cos).  This closes
    the round-3 deviation "indirect at the primary hit only".

    Same physics as ``trace_whitted`` per node; images differ only by the
    dropped sub-cutoff subtrees (<= cutoff in radiance).
    """
    from light_transport_tpu.ops import lanestack

    n = o.shape[0]
    dtype = o.dtype
    gi = int(indirect_samples)
    if gi and key is None:
        key = jax.random.key(0)
    # one deferred reflect/refract branch per level, plus the GI children
    # (k at the primary node, one per deeper node)
    S = depth + 1 + (gi + depth if gi else 0)

    color = jnp.zeros((n, 3), dtype)
    cur = (o, d, jnp.ones((n, 3), dtype),
           jnp.full((n,), depth, jnp.int32), jnp.ones((n,), bool))
    stack = lanestack.zeros(
        (o, d, jnp.zeros((n, 3), dtype), jnp.zeros((n,), jnp.int32)), S)
    top = jnp.zeros((n,), jnp.int32)
    # a lane shades one tree node per superstep; the any_act early break
    # ends typical runs far sooner (the weight cutoff prunes the tree)
    iters = max_iters if max_iters is not None else \
        2 ** (depth + 1) - 1 + gi * (2 * depth + 1)
    for it in range(iters):
        k_gi = 0 if not gi else (gi if it == 0 else 1)
        k_step = jax.random.fold_in(key, it) if gi else None
        color, cur, stack, top, any_act = _queue_step(
            scene, color, cur, stack, top, ray_chunk, weight_cutoff, S,
            k_gi, k_step)
        if not bool(any_act):
            break
    return color


@partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _queue_step(scene, color, cur, stack, top, ray_chunk, weight_cutoff, S,
                k_gi=0, key=None):
    """One queue superstep (module-level jit: repeated renders at the same
    shapes/settings reuse the compiled executable instead of recompiling
    the whole intersector pipeline per trace_whitted_queue call).

    ``k_gi`` (static): hemisphere-sampled indirect-diffuse children to
    push at this step's nodes (the full-depth GI option)."""
    from light_transport_tpu.ops import lanestack

    cur_o, cur_d, cur_w, cur_dep, cur_act = cur
    n = cur_o.shape[0]
    hit = _hit(scene, cur_o, cur_d, ray_chunk, active=cur_act)
    (local, hit_ok, hp, n_s, shifted, refl_coef, transmission,
     t_dir, tir, o_dif) = _shade_local(scene, cur_o, cur_d, hit, ray_chunk,
                                       cur_act)
    color = color + cur_w * local

    can_recurse = hit_ok & (cur_dep > 0)
    w_refl = jnp.where(can_recurse[:, None], cur_w * refl_coef[:, None],
                       0.0)
    w_refr = jnp.where((can_recurse & ~tir & (transmission > 0))[:, None],
                       cur_w * ((1.0 - refl_coef) * transmission)[:, None],
                       0.0)
    refl_sig = lm.luminance(w_refl) > weight_cutoff
    refr_sig = lm.luminance(w_refr) > weight_cutoff

    r_dir = lm.reflect(cur_d, n_s)
    t_o = hp - 1e-3 * n_s

    # indirect-diffuse children (reference :186-194 incl. the 0.1 factor):
    # pushed onto the stack like any deferred branch; the cutoff prunes
    # deep GI chains whose weight has decayed to insignificance
    for s in range(k_gi):
        u = jax.random.uniform(jax.random.fold_in(key, s), (n, 2),
                               cur_o.dtype)
        gdir, _ = sampling.uniform_hemisphere(n_s, u[:, 0], u[:, 1])
        cosg = jnp.maximum(lm.dot(gdir, n_s), 0.0)
        w_gi = cur_w * o_dif * (cosg * 0.1 / k_gi)[:, None]
        push_gi = can_recurse & (lm.luminance(w_gi) > weight_cutoff)
        stack, top = lanestack.push(
            stack, top, push_gi,
            (hp + 1e-4 * n_s, gdir, w_gi, cur_dep - 1), S)

    # follow the heavier branch, push the other if also significant
    refl_first = lm.luminance(w_refl) >= lm.luminance(w_refr)
    both = refl_sig & refr_sig
    push_refr = both & refl_first
    push_refl = both & ~refl_first
    stack, top = lanestack.push(stack, top, push_refr,
                                (t_o, t_dir, w_refr, cur_dep - 1), S)
    stack, top = lanestack.push(stack, top, push_refl,
                                (shifted, r_dir, w_refl, cur_dep - 1),
                                S)

    take_refl = refl_sig & (refl_first | ~refr_sig)
    take_refr = refr_sig & ~take_refl
    has_child = take_refl | take_refr
    nxt_o = jnp.where(take_refl[:, None], shifted, t_o)
    nxt_d = jnp.where(take_refl[:, None], r_dir, t_dir)
    nxt_w = jnp.where(take_refl[:, None], w_refl, w_refr)

    # lanes without a child pop their deferred branch (if any)
    can_pop = ~has_child & (top > 0)
    p_o, p_d, p_w, p_dep = lanestack.peek(stack, top, S)
    top = top - can_pop.astype(jnp.int32)

    new_o = jnp.where(has_child[:, None], nxt_o, p_o)
    new_d = jnp.where(has_child[:, None], nxt_d, p_d)
    new_w = jnp.where(has_child[:, None], nxt_w, p_w)
    new_dep = jnp.where(has_child, cur_dep - 1, p_dep)
    new_act = has_child | can_pop
    any_act = jnp.any(new_act)
    return color, (new_o, new_d, new_w, new_dep, new_act), \
        stack, top, any_act


def render_whitted(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    ray_chunk: Optional[int] = None,
    indirect_samples: int = 0,
    indirect_mode: str = "primary",
):
    """Whitted render (reference ``render_old.render_scene``,
    src/render_old.py:202-221): one primary ray per pixel, clip to [0,1].

    Depth <= 4 runs the statically unrolled tree fully jitted (one
    dispatch, bit-stable vs earlier rounds); deeper renders switch to the
    host-driven weighted ray queue (:func:`trace_whitted_queue`) whose
    cost scales with significant tree nodes instead of 2^depth.

    ``indirect_samples`` > 0 adds the reference's hemisphere-sampled
    indirect-diffuse estimate.  ``indirect_mode``: "primary" takes it at
    the primary hit only (the round-3 deviation — numerically tiny on the
    bundled scenes, A/B in PERF.md); "full" recurses it at every tree
    node exactly as src/render_old.py:186-194 does, via the weighted ray
    queue (GI children at every node, single-sample below the primary —
    an unbiased estimator of the same nested expectation).
    """
    if indirect_mode not in ("primary", "full"):
        raise ValueError(f"indirect_mode={indirect_mode!r}")
    if indirect_mode == "full" and indirect_samples > 0:
        from light_transport_tpu.integrators.path_tracer import camera_rays
        import dataclasses

        n = cfg.height * cfg.width
        cfg1 = dataclasses.replace(cfg, spp=1)
        u_aa = jnp.zeros((n, 2), scene.camera.dtype)
        o, d = camera_rays(scene, cfg1, u_aa)
        color = trace_whitted_queue(scene, o, d, cfg.max_depth, ray_chunk,
                                    indirect_samples=indirect_samples,
                                    key=key)
        return jnp.clip(color.reshape(cfg.height, cfg.width, 3), 0.0, 1.0)
    if cfg.max_depth > 4:
        from light_transport_tpu.integrators.path_tracer import camera_rays
        import dataclasses

        n = cfg.height * cfg.width
        cfg1 = dataclasses.replace(cfg, spp=1)
        u_aa = jnp.zeros((n, 2), scene.camera.dtype)
        o, d = camera_rays(scene, cfg1, u_aa)
        color = trace_whitted_queue(scene, o, d, cfg.max_depth, ray_chunk)
        if indirect_samples > 0:
            # same hemisphere-sampled indirect-diffuse term as the
            # unrolled path, with the queue tracer for the (deep)
            # secondary bounces — previously dropped silently here
            color = color + _indirect_diffuse(
                scene, o, d, key, indirect_samples,
                lambda oo, dd: trace_whitted_queue(
                    scene, oo, dd, cfg.max_depth - 1, ray_chunk),
                ray_chunk)
        return jnp.clip(color.reshape(cfg.height, cfg.width, 3), 0.0, 1.0)
    return _render_whitted_unrolled(scene, cfg, key, ray_chunk,
                                    indirect_samples)


def _indirect_diffuse(scene, o, d, key, indirect_samples, trace_fn,
                      ray_chunk, hit=None):
    """Reference render_old's 10-sample hemisphere indirect-diffuse term
    at the primary hit (src/render_old.py:186-194, incl. the 0.1 factor),
    parameterized over the secondary tracer so the unrolled and queue
    paths share it.  ``hit``: optional precomputed primary-hit record —
    the callers already intersect the same rays, so passing it avoids a
    redundant full-scene sweep."""
    from light_transport_tpu.scene.analytic import surface_attrs

    n = o.shape[0]
    if hit is None:
        hit = _hit(scene, o, d, ray_chunk)
    hp = o + d * hit.t[:, None]
    n_geo, mat_id, _ = surface_attrs(scene, hit, hp)
    n_s = jnp.where((lm.dot(n_geo, d) > 0)[:, None], -n_geo, n_geo)
    o_dif = scene.materials.diffuse[mat_id]
    acc = jnp.zeros((n, 3), o.dtype)
    for s in range(indirect_samples):
        u = jax.random.uniform(jax.random.fold_in(key, s), (n, 2))
        gdir, _ = sampling.uniform_hemisphere(n_s, u[:, 0], u[:, 1])
        cos = jnp.maximum(lm.dot(gdir, n_s), 0.0)
        raw = trace_fn(hp + 1e-4 * n_s, gdir)
        acc = acc + o_dif * raw * cos[:, None] * 0.1  # :193 (0.1 factor)
    return jnp.where(hit.valid[:, None], acc / indirect_samples, 0.0)


@partial(jax.jit, static_argnums=(1, 3, 4))
def _render_whitted_unrolled(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    ray_chunk: Optional[int] = None,
    indirect_samples: int = 0,
):
    from light_transport_tpu.integrators.path_tracer import camera_rays

    n = cfg.height * cfg.width
    # one ray per pixel: reuse camera_rays with spp folded to 1, no jitter
    import dataclasses

    cfg1 = dataclasses.replace(cfg, spp=1)
    u_aa = jnp.zeros((n, 2), scene.camera.dtype)
    o, d = camera_rays(scene, cfg1, u_aa)
    hit0 = _hit(scene, o, d, ray_chunk)
    color = trace_whitted(scene, o, d, cfg.max_depth, ray_chunk, hit=hit0)

    # the reference adds the hemisphere term only when depth > 0
    # (src/render_old.py:186 'if depth > 0')
    if indirect_samples > 0 and cfg.max_depth > 0:
        color = color + _indirect_diffuse(
            scene, o, d, key, indirect_samples,
            lambda oo, dd: trace_whitted(scene, oo, dd,
                                         cfg.max_depth - 1,
                                         ray_chunk),
            ray_chunk, hit=hit0)

    img = jnp.clip(color.reshape(cfg.height, cfg.width, 3), 0.0, 1.0)
    return img
