"""Bidirectional path tracing with multiple importance sampling.

The reference ships BDPT as an unfinished module (src/bdpt.py — undefined
symbols at :293,:295,:430, a Vertex constructor its callers can't use, and
no notebook ever produced a render; SURVEY.md §0).  This module *completes*
the capability it sketched, as array programs:

- camera and light subpaths are random walks stored in **static-shape SoA
  vertex arrays** ``(lanes, max_len, ...)`` with validity masks (the
  reference's ``generate_camera_subpaths`` / ``generate_light_subpaths``,
  src/bdpt.py:182-213,257-268, built per-ray Python lists);
- every connection strategy (s light vertices, t camera vertices) is a
  masked batched op over all lanes at once (``connect_paths``,
  src/bdpt.py:369-435);
- MIS uses the balance heuristic over forward/reverse area densities with
  the standard remap(0->1) delta handling (``get_mis_weight``,
  src/bdpt.py:298-359 attempted the same recursion per-ray).

Scope notes (documented):
- with ``light_tracing=False`` the t=1 strategies (light tracing splatted
  straight onto the film) are not sampled and are correspondingly excluded
  from every MIS denominator, so the sampled strategies' weights still
  partition unity (unbiased) in either mode;
- depth-cap contract: at equal ``max_depth`` the estimator targets exactly
  the path tracer's transport — paths with up to max_depth+1 surface
  vertices where the deepest ones are reachable only through NEE at a
  diffuse light-adjacent vertex.  At the cap the s'=0 alternative (camera
  walk hits the light) is excluded from MIS denominators (unreachable:
  the walk holds max_depth vertices), and cap paths whose light-adjacent
  vertex is specular are excluded from the light-side strategies
  (PT-unreachable transport; raise max_depth to include it);
- subpath walks do not Russian-roulette (depth is statically bounded);
- point (delta) lights are first-class: point-only scenes walk light
  subpaths from the delta table (uniform pick, isotropic emission), s=1
  connects every camera vertex to every light deterministically, s=0
  strategies do not exist, and the MIS partition carries the three
  delta-origin asymmetries through
  ``light_side_mis(origin_delta=, nee_pick_ratio=)`` and the
  1/P-weighted ``pt_rev`` (partition of unity proven in
  tests/test_pointlights.py).  MIXED area+point scenes run both
  families in one render: the light walk picks its origin family per
  lane with a power-proportional probability (``_light_family``), both
  s=1 blocks execute, and every MIS density carries the family-pick
  factor — exact because a path's light endpoint determines its family,
  so the two partitions never share strategies (additivity and
  mixed-partition tests in tests/test_pointlights.py).  With light
  tracing on, bdpt renders
  delta-light caustics (point -> specular chain -> diffuse -> camera)
  the path tracer structurally cannot sample at ANY depth — a delta
  light cannot be BSDF-hit and NEE does not cross glass — so on
  specular scenes bdpt is strictly MORE complete than PT under point
  lighting (the splat takes MIS weight 1: every alternative junction
  holds a delta vertex; measured +5% image mean on the glass-cone
  Cornell at max_depth=4, tests/test_pointlights.py caustics test);
- subpath segments inside transmissive objects attenuate by Beer-Lambert
  of the carried interior sigma_a (the PathState convention, one-level
  nesting), so absorbing-media scenes estimate the same transport as the
  path tracer (tests/test_bdpt.py absorbing-glass parity).  In-scattering
  (sigma_s > 0) remains out of scope — BDPT samples no medium vertices;
  use the path tracer for scattering media.  Connection segments use
  binary visibility, matching PT's "opaque" NEE rule;
- emitted radiance is ``Material.emission * emission_color`` on both
  subpath ends, the same value NEE and the path tracer read (the reference
  mixes an ``emission`` scalar at hits with ``emission * diffuse`` for
  NEE, src/path_tracing.py:60 vs src/light_samples.py:55).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from light_transport_tpu.core import math as lm
from light_transport_tpu.core.config import RenderConfig
from light_transport_tpu.ops import intersect, sampling
from light_transport_tpu.scene.lights import sample_light_points
from light_transport_tpu.scene.material import (
    BSDF_DIFFUSE,
    BSDF_GLOSSY,
    BSDF_MIRROR,
    BSDF_TRANSMISSIVE,
)
from light_transport_tpu.scene.scene import Scene

INV_PI = lm.INV_PI


class Vertices(NamedTuple):
    """SoA subpath vertex storage (the reference's per-ray ``Vertex``
    jitclass, src/vertex.py:9-38, flattened into (N, L, ...) arrays)."""

    pos: jnp.ndarray  # (N, L, 3)
    ns: jnp.ndarray  # (N, L, 3) shading normal, oriented against arrival
    diffuse: jnp.ndarray  # (N, L, 3) BSDF albedo (kd)
    beta: jnp.ndarray  # (N, L, 3) throughput up to and including this vertex
    pdf_fwd: jnp.ndarray  # (N, L) forward area density of this vertex
    pdf_rev: jnp.ndarray  # (N, L) reverse area density
    valid: jnp.ndarray  # (N, L)
    is_light: jnp.ndarray  # (N, L)
    is_delta: jnp.ndarray  # (N, L) specular (mirror/transmissive) vertex
    emit: jnp.ndarray  # (N, L, 3) emitted radiance if on a light
    # glossy (modified Phong) support: ks, exponent, and the unit incoming
    # propagation direction at arrival (the Phong lobe axis is
    # reflect(win, ns)); ks == 0 rows degenerate exactly to diffuse
    spec: jnp.ndarray  # (N, L, 3)
    shin: jnp.ndarray  # (N, L)
    win: jnp.ndarray  # (N, L, 3)


def _hit(scene, o, d, ray_chunk, active=None):
    from light_transport_tpu.ops.dispatch import scene_intersect

    return scene_intersect(scene, o, d, ray_chunk=ray_chunk, active=active)


def _occluded(scene, o, d, dist, ray_chunk, active=None):
    from light_transport_tpu.ops.dispatch import scene_occluded

    return scene_occluded(scene, o, d, dist, ray_chunk=ray_chunk,
                          active=active)


def _to_area(pdf_solid, from_pos, to_pos, to_ns):
    """Solid-angle -> area density (``convert_density``,
    src/bdpt.py:271-278)."""
    v = to_pos - from_pos
    d2 = jnp.maximum(lm.dot(v, v), 1e-20)
    w = v / jnp.sqrt(d2)[..., None]
    return pdf_solid * jnp.abs(lm.dot(to_ns, w)) / d2


def random_walk(
    scene: Scene,
    origins: jnp.ndarray,  # (N, 3)
    directions: jnp.ndarray,  # (N, 3)
    beta0: jnp.ndarray,  # (N, 3) initial throughput
    pdf_dir0: jnp.ndarray,  # (N,) solid-angle pdf of the initial direction
    uniforms: jnp.ndarray,  # (N, L, >=2)
    max_len: int,
    ray_chunk: Optional[int],
) -> Vertices:
    """Shared camera/light subpath walker (reference ``random_walk``,
    src/bdpt.py:17-147) as a statically unrolled masked loop."""
    mesh = scene.mesh
    mats = scene.materials
    n = origins.shape[0]
    eps = lm.EPSILON

    fields = {
        "pos": jnp.zeros((n, max_len, 3)),
        "ns": jnp.zeros((n, max_len, 3)),
        "diffuse": jnp.zeros((n, max_len, 3)),
        "beta": jnp.zeros((n, max_len, 3)),
        "pdf_fwd": jnp.zeros((n, max_len)),
        "pdf_rev": jnp.zeros((n, max_len)),
        "valid": jnp.zeros((n, max_len), bool),
        "is_light": jnp.zeros((n, max_len), bool),
        "is_delta": jnp.zeros((n, max_len), bool),
        "emit": jnp.zeros((n, max_len, 3)),
        "spec": jnp.zeros((n, max_len, 3)),
        "shin": jnp.zeros((n, max_len)),
        "win": jnp.zeros((n, max_len, 3)),
    }

    o, d = origins, directions
    beta = beta0
    pdf_dir = pdf_dir0  # solid-angle pdf of the ray we're about to trace
    alive = jnp.ones((n,), bool)
    prev_pos = origins
    prev_ns = jnp.zeros((n, 3))
    have_prev = jnp.zeros((n,), bool)
    # carried interior absorption (the PathState med_sig_a convention,
    # one-level outer memory): subpath segments inside transmissive
    # objects attenuate by Beer-Lambert, so BDPT estimates the same
    # transport as the path tracer on absorbing-media scenes.
    # In-scattering (sigma_s) stays out of scope — BDPT has no
    # medium-vertex strategies; use the path tracer for scattering media.
    sig_a = jnp.zeros((n, 3))
    out_sig_a = jnp.zeros((n, 3))

    for step in range(max_len):
        hit = _hit(scene, o, d, ray_chunk, active=alive)
        ok = alive & hit.valid
        hp = o + d * hit.t[:, None]
        # Beer-Lambert along the segment just traversed (deterministic
        # throughput weight: sampling densities — and thus every MIS
        # weight — are unchanged)
        beta = beta * jnp.where(
            ok[:, None], jnp.exp(-sig_a * hit.t[:, None]), 1.0)
        from light_transport_tpu.scene.analytic import surface_attrs

        n_geo, mat_id, hit_is_light = surface_attrs(scene, hit, hp)
        inside = lm.dot(n_geo, d) > 0.0
        ns = jnp.where(inside[:, None], -n_geo, n_geo)
        bsdf = mats.bsdf[mat_id]
        is_delta = (bsdf == BSDF_MIRROR) | (bsdf == BSDF_TRANSMISSIVE)
        is_diffuse = bsdf == BSDF_DIFFUSE
        is_glossy = bsdf == BSDF_GLOSSY
        is_light = hit_is_light & ok
        emit = mats.emission_rgb[mat_id]
        kd = mats.diffuse[mat_id]
        ks = mats.specular[mat_id]
        shin_v = mats.shininess[mat_id]

        pdf_fwd = _to_area(pdf_dir, o, hp, ns)

        fields["pos"] = fields["pos"].at[:, step].set(jnp.where(ok[:, None], hp, 0.0))
        fields["ns"] = fields["ns"].at[:, step].set(jnp.where(ok[:, None], ns, 0.0))
        fields["diffuse"] = fields["diffuse"].at[:, step].set(
            jnp.where(ok[:, None], mats.diffuse[mat_id], 0.0)
        )
        fields["beta"] = fields["beta"].at[:, step].set(
            jnp.where(ok[:, None], beta, 0.0)
        )
        fields["pdf_fwd"] = fields["pdf_fwd"].at[:, step].set(
            jnp.where(ok, pdf_fwd, 0.0)
        )
        fields["valid"] = fields["valid"].at[:, step].set(ok)
        fields["is_light"] = fields["is_light"].at[:, step].set(is_light)
        fields["is_delta"] = fields["is_delta"].at[:, step].set(is_delta & ok)
        fields["emit"] = fields["emit"].at[:, step].set(
            jnp.where(is_light[:, None], emit, 0.0)
        )
        fields["spec"] = fields["spec"].at[:, step].set(
            jnp.where((ok & is_glossy)[:, None], ks, 0.0)
        )
        fields["shin"] = fields["shin"].at[:, step].set(
            jnp.where(ok, shin_v, 0.0)
        )
        fields["win"] = fields["win"].at[:, step].set(
            jnp.where(ok[:, None], d, 0.0)
        )

        if step == max_len - 1:
            break

        u = uniforms[:, step]
        # --- sample continuation (PT BSDF logic, src/path_tracing.py:68-141)
        d_dir, d_pdf = sampling.cosine_weighted_hemisphere(ns, u[..., 0], u[..., 1])
        m_dir = lm.reflect(d, ns)
        ior = mats.ior[mat_id]
        n1 = jnp.where(inside, ior, 1.0)
        n2 = jnp.where(inside, 1.0, ior)
        refl_p = sampling.schlick_reflectance(
            sampling.schlick_r0(n1, n2), -lm.dot(d, ns)
        )
        t_dir, tir = lm.refract(d, ns, n1 / n2)
        refract_now = (bsdf == BSDF_TRANSMISSIVE) & ~tir & (u[..., 0] > refl_p)
        spec_dir = jnp.where(refract_now[:, None], t_dir, m_dir)

        # glossy: rescaled-u0 lobe mix, exactly the PT _bounce rule (the
        # ks recorded above is zeroed for non-glossy vertices, so kd-only
        # rows reduce to the cosine sampler)
        ks_w = jnp.where(is_glossy[:, None], ks, 0.0)
        q_spec = sampling.glossy_mix(kd, ks_w)
        pick_spec = u[..., 0] < q_spec
        u0r = jnp.clip(jnp.where(
            pick_spec, u[..., 0] / jnp.maximum(q_spec, 1e-12),
            (u[..., 0] - q_spec) / jnp.maximum(1.0 - q_spec, 1e-12)),
            0.0, 1.0)
        gd_dir, _ = sampling.cosine_weighted_hemisphere(ns, u0r, u[..., 1])
        gs_dir = sampling.sample_phong_lobe(m_dir, shin_v, u0r, u[..., 1])
        g_dir = jnp.where(pick_spec[:, None], gs_dir, gd_dir)
        g_pdf = sampling.glossy_pdf(kd, ks_w, shin_v, ns, m_dir, g_dir)
        g_ok = (g_pdf > 0.0) & (lm.dot(g_dir, ns) > 0.0)
        g_f = sampling.glossy_f(kd, ks_w, shin_v, m_dir, g_dir)

        new_dir = jnp.where(
            is_diffuse[:, None], d_dir,
            jnp.where(is_glossy[:, None], g_dir, spec_dir))
        scatter = is_diffuse | is_glossy
        new_o = jnp.where(
            refract_now[:, None], hp - eps * ns,
            jnp.where(scatter[:, None], hp + eps * new_dir, hp + eps * ns),
        )

        # reverse pdf of the *previous* vertex: density of re-generating it
        # from here (diffuse |cos|/pi; glossy: the mixed lobe with the
        # REVERSED incoming -new_dir; delta -> 0, remapped to 1 in MIS)
        to_prev = prev_pos - hp
        dprev = jnp.sqrt(jnp.maximum(lm.dot(to_prev, to_prev), 1e-20))
        w_prev = to_prev / dprev[:, None]
        rev_solid = jnp.where(
            is_diffuse, jnp.abs(lm.dot(ns, w_prev)) * INV_PI,
            jnp.where(
                is_glossy,
                _lobe_pdf_solid(kd, ks_w, shin_v, ns, -new_dir, w_prev),
                0.0),
        )
        rev_area = rev_solid * jnp.abs(lm.dot(prev_ns, w_prev)) / (dprev * dprev)
        if step > 0:
            fields["pdf_rev"] = fields["pdf_rev"].at[:, step - 1].set(
                jnp.where(ok & have_prev, rev_area, 0.0)
            )

        cos_o = jnp.abs(lm.dot(new_dir, ns))
        pdf_ok = d_pdf > 0.0
        scale = jnp.where(
            is_diffuse[:, None],
            mats.diffuse[mat_id] * INV_PI
            * (cos_o / jnp.where(pdf_ok, d_pdf, 1.0))[:, None],
            jnp.where(
                is_glossy[:, None],
                g_f * jnp.where(
                    g_ok, cos_o / jnp.where(g_ok, g_pdf, 1.0),
                    0.0)[:, None],
                1.0),  # delta: f/pdf == 1 for mirror; Fresnel split below
        )
        beta = beta * jnp.where(ok[:, None], scale, 1.0)
        alive = ok & (is_diffuse & pdf_ok | is_glossy & g_ok | is_delta)

        # carried-medium update: a followed refraction crosses the
        # interface (entering from outside / exiting from inside)
        entering = ok & refract_now & ~inside
        exiting = ok & refract_now & inside
        new_sig = jnp.where(
            entering[:, None], mats.sigma_a[mat_id],
            jnp.where(exiting[:, None], out_sig_a, sig_a))
        out_sig_a = jnp.where(
            entering[:, None], sig_a,
            jnp.where(exiting[:, None], 0.0, out_sig_a))
        sig_a = new_sig

        prev_pos, prev_ns, have_prev = hp, ns, ok
        o, d = new_o, new_dir
        # true forward sampling density (delta pdf -> 0/remap)
        pdf_dir = jnp.where(is_diffuse, d_pdf,
                            jnp.where(is_glossy, g_pdf, 0.0))

    return Vertices(**fields)


def generate_camera_subpaths(scene, cfg, origins, directions, uniforms,
                             ray_chunk=None):
    """Camera-side walk (src/bdpt.py:182-213).  The first surface vertex's
    forward density is the true camera importance-sampling density (needed
    by the t'=1 terms in the MIS weights)."""
    n = origins.shape[0]
    beta0 = jnp.ones((n, 3))
    pdf0 = _camera_pdf_dir(scene, cfg, directions)
    return random_walk(scene, origins, directions, beta0, pdf0, uniforms,
                       cfg.max_depth, ray_chunk)


def generate_light_subpaths(scene, cfg, key, n, uniforms, ray_chunk=None):
    """Light-side walk (src/bdpt.py:257-268 + broken ``sample_light``,
    src/light_samples.py:89-116, done right): area-weighted light point,
    cosine-weighted emission direction."""
    k1, k2, k3 = jax.random.split(key, 3)
    u_pick = jax.random.uniform(k1, (n,))
    u_a = jax.random.uniform(k2, (n, 2))
    u_d = jax.random.uniform(k3, (n, 2))
    return _light_subpaths_area(scene, cfg, u_pick, u_a, u_d, uniforms,
                                ray_chunk)


def _light_subpaths_area(scene, cfg, u_pick, u_a, u_d, uniforms,
                         ray_chunk=None):
    """:func:`generate_light_subpaths` body on pre-drawn origin uniforms
    (the sharded render draws all lanes at global width, then shards)."""
    lp, ln, lrad, pdf_pos = sample_light_points(
        scene.lights, u_pick, u_a[:, 0], u_a[:, 1]
    )
    d0, pdf_dir = sampling.cosine_weighted_hemisphere(ln, u_d[:, 0], u_d[:, 1])
    cos0 = jnp.abs(lm.dot(d0, ln))
    safe = jnp.maximum(pdf_pos * pdf_dir, 1e-12)
    beta0 = lrad * (cos0 / safe)[:, None]
    o0 = lp + lm.EPSILON * d0
    verts = random_walk(scene, o0, d0, beta0, pdf_dir, uniforms,
                        cfg.max_depth, ray_chunk)
    light0 = dict(pos=lp, ns=ln, emit=lrad, pdf_pos=pdf_pos)
    return verts, light0


def generate_light_subpaths_point(scene, cfg, key, n, uniforms,
                                  ray_chunk=None):
    """Light-side walk from a point (delta) light table: pick one of the
    ``P`` lights uniformly, emit isotropically (uniform sphere,
    pdf = 1/4pi), so ``beta0 = I * P * 4pi``.  The origin is a delta
    position: it carries no area density and no normal (``l0['ns']`` is
    the emission direction, used only as an arbitrary unit vector —
    every consumer gates it out through ``origin_delta``)."""
    k1, k2 = jax.random.split(key, 2)
    u_pick = jax.random.uniform(k1, (n,))
    u_d = jax.random.uniform(k2, (n, 2))
    return _light_subpaths_point(scene, cfg, u_pick, u_d, uniforms,
                                 ray_chunk)


def _light_subpaths_point(scene, cfg, u_pick, u_d, uniforms, ray_chunk=None):
    """:func:`generate_light_subpaths_point` body on pre-drawn uniforms."""
    plt_ = scene.point_lights
    p_count = plt_.num
    n = u_pick.shape[0]
    idx = jnp.clip((u_pick * p_count).astype(jnp.int32), 0, p_count - 1)
    lp = plt_.position[idx]
    inten = plt_.intensity[idx]
    # uniform sphere direction
    z = 1.0 - 2.0 * u_d[:, 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u_d[:, 1]
    d0 = jnp.stack([r * jnp.cos(phi), z, r * jnp.sin(phi)], -1)
    pdf_dir = jnp.full((n,), 1.0 / (4.0 * jnp.pi))
    pick_p = 1.0 / p_count
    beta0 = inten / (pick_p * pdf_dir)[:, None]
    o0 = lp + lm.EPSILON * d0
    verts = random_walk(scene, o0, d0, beta0, pdf_dir, uniforms,
                        cfg.max_depth, ray_chunk)
    light0 = dict(pos=lp, ns=d0, emit=inten, pdf_pos=jnp.full((n,), pick_p))
    return verts, light0


def generate_light_subpaths_mixed(scene, cfg, key, n, uniforms, q_point,
                                  ray_chunk=None):
    """Light-side walk for MIXED area+point scenes: each lane first picks
    an origin FAMILY (point with probability ``q_point``, else area), then
    samples that family's origin exactly like the single-family generators.
    ``beta0`` divides by the full pick density including the family factor
    (``q_point * 1/P * 1/4pi`` / ``q_area * 1/A * cos/pi``), so the s>=2
    and t=1 estimators stay unbiased lane-wise.  Returns
    ``(verts, l0, pick_point)`` — the per-lane family mask feeds the MIS
    densities (``origin_delta``, per-lane ``pdf_area_light`` and
    ``nee_pick_ratio``).  Both families' origins are one masked select
    before ONE shared walk: SoA lockstep, no per-family dispatch."""
    k_f, k1, k2, k3 = jax.random.split(key, 4)
    u_f = jax.random.uniform(k_f, (n,))
    u_pick = jax.random.uniform(k1, (n,))
    u_a = jax.random.uniform(k2, (n, 2))
    u_d = jax.random.uniform(k3, (n, 2))
    return _light_subpaths_mixed(scene, cfg, u_f, u_pick, u_a, u_d,
                                 uniforms, q_point, ray_chunk)


def _light_subpaths_mixed(scene, cfg, u_f, u_pick, u_a, u_d, uniforms,
                          q_point, ray_chunk=None):
    """:func:`generate_light_subpaths_mixed` body on pre-drawn uniforms."""
    plt_ = scene.point_lights
    p_count = plt_.num
    q_area = 1.0 - q_point
    pick_point = u_f < q_point

    # area-family origin (the generate_light_subpaths sampler)
    lp_a, ln_a, lrad, pdf_pos = sample_light_points(
        scene.lights, u_pick, u_a[:, 0], u_a[:, 1]
    )
    d_a, pdf_dir_a = sampling.cosine_weighted_hemisphere(
        ln_a, u_d[:, 0], u_d[:, 1])
    cos0 = jnp.abs(lm.dot(d_a, ln_a))
    beta_a = lrad * (cos0 / jnp.maximum(
        q_area * pdf_pos * pdf_dir_a, 1e-12))[:, None]

    # point-family origin (the generate_light_subpaths_point sampler),
    # reusing u_pick for the discrete pick and u_d for the sphere direction
    idx = jnp.clip((u_pick * p_count).astype(jnp.int32), 0, p_count - 1)
    lp_p = plt_.position[idx]
    inten = plt_.intensity[idx]
    z = 1.0 - 2.0 * u_d[:, 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u_d[:, 1]
    d_p = jnp.stack([r * jnp.cos(phi), z, r * jnp.sin(phi)], -1)
    inv_4pi = 1.0 / (4.0 * jnp.pi)
    pick_p = 1.0 / p_count
    beta_p = inten / jnp.maximum(q_point * pick_p * inv_4pi, 1e-12)

    pp = pick_point[:, None]
    o0 = jnp.where(pp, lp_p + lm.EPSILON * d_p, lp_a + lm.EPSILON * d_a)
    d0 = jnp.where(pp, d_p, d_a)
    beta0 = jnp.where(pp, beta_p, beta_a)
    pdf_dir0 = jnp.where(pick_point, inv_4pi, pdf_dir_a)
    verts = random_walk(scene, o0, d0, beta0, pdf_dir0, uniforms,
                        cfg.max_depth, ray_chunk)
    light0 = dict(
        pos=jnp.where(pp, lp_p, lp_a),
        ns=jnp.where(pp, d_p, ln_a),  # arbitrary unit vec on point lanes
        emit=jnp.where(pp, inten, lrad),
        pdf_pos=jnp.where(pick_point, pick_p, pdf_pos),
    )
    return verts, light0, pick_point


def _remap(p):
    return jnp.where(p == 0.0, 1.0, p)


def _camera_pdf_dir(scene, cfg, directions):
    """Solid-angle density of the per-pixel primary-ray sampler.

    The camera samples a screen point uniformly over the pixel's jitter
    footprint (area a_samp = 1/(W*H) in screen units, matching the
    reference's rand/W, rand/H jitter) and shoots through it:
    p(w) = r_s^2 / (a_samp * cos(theta)) with r_s the camera->screen-plane
    distance along w.  Needed once t=1 (light tracing) strategies enter the
    MIS weights."""
    a_samp = (1.0 / cfg.width) * (1.0 / cfg.height)
    cos_c = jnp.maximum(jnp.abs(directions[..., 2]), 1e-6)
    r_s = jnp.abs(scene.camera[2] - cfg.f_distance) / cos_c
    return r_s * r_s / (a_samp * cos_c)


def _diffuse_pdf_area(v_ns, from_pos, to_pos, to_ns):
    """Area density of a cosine-sampled diffuse bounce scattered at
    ``from_pos`` (shading normal ``v_ns``) toward ``to_pos``.  Kept for
    light-EMISSION densities (cosine by construction); surface vertices go
    through the glossy-aware :func:`_vertex_pdf_area`."""
    w = to_pos - from_pos
    d2 = jnp.maximum(lm.dot(w, w), 1e-20)
    wn = w / jnp.sqrt(d2)[..., None]
    return _to_area(jnp.abs(lm.dot(v_ns, wn)) * INV_PI, from_pos, to_pos,
                    to_ns)


def _lobe_pdf_solid(kd, ks, shin, ns, win, wn):
    """MIS density model of the surface sampler: the |cos|/pi cosine model
    (what ``_diffuse_pdf_area`` always used) mixed with the true Phong
    lobe about ``reflect(win, ns)`` by the luminance lobe weight.  ks == 0
    reduces bitwise to the old cosine model, so diffuse scenes are
    unchanged.  Every strategy's hypothetical density uses THIS function,
    which keeps the balance-heuristic weights a partition of unity
    (unbiasedness needs consistency, not exactness, in the weights)."""
    q = sampling.glossy_mix(kd, ks)
    p_diff = jnp.abs(lm.dot(ns, wn)) * INV_PI
    m = lm.reflect(win, ns)
    return (1.0 - q) * p_diff + q * sampling.phong_pdf(m, wn, shin)


def _vertex_pdf_area(v: Vertices, k: int, to_pos, to_ns, w_in=None):
    """Area density of walk vertex ``k`` scattering toward ``to_pos``.

    ``w_in`` overrides the recorded incoming direction for HYPOTHETICAL
    reversed strategies (e.g. "cam[j] scattering backward given incoming
    from the light"): pass the unit propagation direction INTO the
    vertex."""
    win = v.win[:, k] if w_in is None else w_in
    w = to_pos - v.pos[:, k]
    d2 = jnp.maximum(lm.dot(w, w), 1e-20)
    wn = w / jnp.sqrt(d2)[..., None]
    solid = _lobe_pdf_solid(v.diffuse[:, k], v.spec[:, k], v.shin[:, k],
                            v.ns[:, k], win, wn)
    return _to_area(solid, v.pos[:, k], to_pos, to_ns)


def _vertex_f(v: Vertices, k: int, w_out):
    """BSDF value at walk vertex ``k`` toward unit ``w_out``: kd/pi plus
    the modified-Phong specular lobe (exactly kd/pi when ks == 0)."""
    m = lm.reflect(v.win[:, k], v.ns[:, k])
    return sampling.glossy_f(v.diffuse[:, k], v.spec[:, k], v.shin[:, k],
                             m, w_out)


def cam_side_mis(cam: Vertices, j: int, pt_rev, ptm_rev,
                 light_tracing: bool, s1_ratio=None):
    """Balance-heuristic denominator terms from camera-side alternative
    strategies: ``sum_i ri`` where ``ri = prod p_rev/p_fwd`` down the camera
    subpath from the junction vertex ``j`` (PBRT's camera-side recursion;
    reference attempt: ``get_mis_weight``, src/bdpt.py:298-359).

    ``pt_rev``/``ptm_rev`` override the reverse densities at vertices ``j``
    and ``j-1`` (they depend on the sampled junction).  With
    ``light_tracing`` the recursion extends to the first surface vertex
    (the t'=1 alternative).

    ``s1_ratio`` multiplies the ``i == j`` TERM only (the cumulative
    product ``ri`` — which deeper terms extend — is untouched).  Mixed
    area+point scenes need it in the s=0 block: there the i==j alternative
    is s'=1 NEE (density 1/A) while every deeper alternative is a light
    walk whose origin density carries the family-pick factor
    (``pt_rev = q_area/A``), so the s'=1 term is restored with
    ``s1_ratio = 1/q_area``.  ``None`` keeps the single-density behavior
    (pure-area scenes: NEE and the walk share 1/A)."""
    n = cam.pos.shape[0]
    ri = jnp.ones((n,))
    total = jnp.zeros((n,))
    stop = -1 if light_tracing else 0
    for i in range(j, stop, -1):
        rev = pt_rev if i == j else (
            ptm_rev if i == j - 1 else cam.pdf_rev[:, i])
        ri = ri * _remap(rev) / _remap(cam.pdf_fwd[:, i])
        term = ri * s1_ratio if (i == j and s1_ratio is not None) else ri
        if i == 0:
            # t'=1: the camera vertex is non-delta (film sampling)
            not_delta = ~cam.is_delta[:, 0]
        else:
            not_delta = ~cam.is_delta[:, i] & ~cam.is_delta[:, i - 1]
        total = total + jnp.where(not_delta & cam.valid[:, i], term, 0.0)
    return total


def light_side_mis(lv: Vertices, l0: dict, pdf_area_light, end: int,
                   qs_rev, qsm_rev, skip_s0: bool = False,
                   origin_delta: bool = False, nee_pick_ratio: float = 1.0):
    """Balance-heuristic denominator terms from light-side alternative
    strategies.

    ``end`` is the PBRT light index of the junction vertex (index 0 = the
    origin point on the light, index k>=1 = walk vertex k-1); the sampled
    strategy has s = end+1 light vertices, and the loop enumerates
    s' = end .. 0.  ``qs_rev``/``qsm_rev`` override pdf_rev at indices
    ``end`` and ``end-1``.

    ``skip_s0`` excludes the s'=0 term (camera walk hits the light): for
    paths at the depth cap that alternative would need a camera walk of
    max_depth+1 vertices, which ``random_walk`` never produces, so it is
    never sampled and must not enter the partition.

    ``origin_delta`` marks a point (delta) light origin: the s'=0 term
    leaves the partition (a camera walk cannot hit a delta position), and
    the origin's reverse density is 0/remap (it cannot be re-generated by
    scattering).  It may be a per-lane bool array — mixed area+point
    scenes pick the walk's origin family per lane.  ``nee_pick_ratio``
    scales the s'=1 (NEE) term only: it is the ratio of NEE's light-choice
    density to the light walk's origin density (for the deterministic
    all-lights NEE sum over P point lights the walk picks with
    ``q_point/P`` while NEE evaluates each with density 1, so the ratio is
    ``P/q_point``; area lights sample 1/A on both sides but the walk adds
    the family factor, ratio ``1/q_area``; single-family scenes have
    ``q = 1``).  ``pdf_area_light`` is the walk's TRUE origin density
    including any family-pick factor (per-lane in mixed mode) — it enters
    only the s'=0 term's denominator."""
    n = lv.pos.shape[0]
    od = jnp.broadcast_to(jnp.asarray(origin_delta, bool), (n,))
    ri = jnp.ones((n,))
    total = jnp.zeros((n,))
    for k in range(end, -1, -1):
        if k == end:
            rev = qs_rev
        elif k == end - 1:
            rev = qsm_rev
        elif k == 0:
            # rev density of the light origin: walk vertex 0 scattering
            # back toward it (delta vertex or delta origin -> 0/remap: a
            # delta position has zero scatter-to density).  This branch
            # fires only for end >= 2, so the reversed walk reaches lv[0]
            # traveling from lv[1] (glossy lobe needs the incoming
            # direction)
            diff0 = ~lv.is_delta[:, 0]
            v01 = lv.pos[:, 0] - lv.pos[:, 1]
            w01 = v01 / jnp.sqrt(
                jnp.maximum(lm.dot(v01, v01), 1e-20))[..., None]
            rev = jnp.where(
                diff0 & ~od,
                _vertex_pdf_area(lv, 0, l0["pos"], l0["ns"], w_in=w01),
                0.0,
            )
        else:
            rev = lv.pdf_rev[:, k - 1]
        fwd = (
            jnp.broadcast_to(jnp.asarray(pdf_area_light), (n,))
            if k == 0 else lv.pdf_fwd[:, k - 1]
        )
        ri = ri * _remap(rev) / _remap(fwd)
        if k == 0 and skip_s0:
            continue
        d_k = jnp.zeros((n,), bool) if k == 0 else lv.is_delta[:, k - 1]
        d_km = jnp.zeros((n,), bool) if k <= 1 else lv.is_delta[:, k - 2]
        term = ri * nee_pick_ratio if k == 1 else ri
        if k == 0:
            # a camera walk cannot hit a delta position — the s'=0 term
            # leaves the partition on delta-origin lanes
            term = jnp.where(od, 0.0, term)
        total = total + jnp.where(~d_k & ~d_km, term, 0.0)
    return total


from functools import partial


def _light_family(scene: Scene):
    """Host-side static decision of the light-origin family for a BDPT
    render: ``("area", 0.0)``, ``("point", 1.0)``, or ``("mixed", q_point)``.

    Mixed scenes pick the light walk's origin family per lane with
    probability ``q_point``, set power-proportionally (point power
    = 4pi * sum|I|; area power = pi * sum(radiance * area), the Lambertian
    emitter integral) and clamped to [0.05, 0.95] so neither family
    starves.  Host-side (not traced) because the mode shapes the compiled
    program — which strategy blocks exist — and ``render_bdpt`` is a
    process-level entry that always sees concrete scenes."""
    if scene.point_lights is None:
        return "area", 0.0
    import numpy as np

    rad = np.asarray(scene.lights.radiance, np.float64)
    area = np.asarray(scene.lights.area, np.float64)
    inten = np.asarray(scene.point_lights.intensity, np.float64)
    area_power = float(np.pi * (rad * area[:, None]).sum())
    point_power = float(4.0 * np.pi * inten.sum())
    if area_power <= 0.0:
        return "point", 1.0
    if point_power <= 0.0:
        return "area", 0.0
    q = point_power / (point_power + area_power)
    return "mixed", float(np.clip(q, 0.05, 0.95))


def render_bdpt(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    ray_chunk: Optional[int] = None,
    light_tracing: bool = True,
):
    """Full BDPT render (reference ``render_scene``, src/bdpt.py:442-479).

    ``light_tracing`` enables the t=1 strategies: light-subpath vertices
    connect straight to the camera and splat onto the film through the
    pixel-footprint importance function; the MIS weights of every other
    strategy then include the t'=1 alternative (the camera-side recursion
    extends to the first surface vertex).

    Light-origin families: pure-area and pure-point scenes run their
    single-family estimators; scenes carrying BOTH an emissive-triangle
    table and a PointLightTable run the mixed estimator — the light walk
    picks a family per lane (:func:`_light_family` sets the probability),
    both s=1 blocks execute, and every MIS density carries the family-pick
    factor (see :func:`light_side_mis`).  The decision is made host-side,
    so call this with concrete (non-traced) scenes."""
    mode, q_point = _light_family(scene)
    return _render_bdpt(scene, cfg, key, ray_chunk, light_tracing, mode,
                        jnp.asarray(q_point, jnp.float32))


def _bdpt_lane_uniforms(scene, cfg, key, mode):
    """Draw every per-lane random input of a BDPT render at GLOBAL width:
    camera rays, walk uniforms, NEE uniforms, and the mode's light-origin
    uniforms, plus a ``mask`` of live lanes (the sharded render pads to a
    device multiple and gates film splats on it).  The key-split sequence
    matches the single-device render exactly, so sharded lanes are
    bitwise-identical to unsharded ones."""
    from light_transport_tpu.integrators.path_tracer import camera_rays

    n = cfg.height * cfg.width * cfg.spp
    k_aa, k_cu, k_lu, k_ls, k_nee = jax.random.split(key, 5)
    u_aa = jax.random.uniform(k_aa, (n, 2), dtype=scene.camera.dtype)
    origins, directions = camera_rays(scene, cfg, u_aa)
    lanes = dict(
        o=origins,
        d=directions,
        cam_u=jax.random.uniform(k_cu, (n, cfg.max_depth, 2)),
        light_u=jax.random.uniform(k_lu, (n, cfg.max_depth, 2)),
        ul=jax.random.uniform(k_nee, (n, cfg.max_depth, 3)),
        mask=jnp.ones((n,), bool),
    )
    if mode == "point":
        k1, k2 = jax.random.split(k_ls, 2)
        lanes["lu_pick"] = jax.random.uniform(k1, (n,))
        lanes["lu_d"] = jax.random.uniform(k2, (n, 2))
    elif mode == "area":
        k1, k2, k3 = jax.random.split(k_ls, 3)
        lanes["lu_pick"] = jax.random.uniform(k1, (n,))
        lanes["lu_a"] = jax.random.uniform(k2, (n, 2))
        lanes["lu_d"] = jax.random.uniform(k3, (n, 2))
    else:  # mixed
        k_f, k1, k2, k3 = jax.random.split(k_ls, 4)
        lanes["lu_f"] = jax.random.uniform(k_f, (n,))
        lanes["lu_pick"] = jax.random.uniform(k1, (n,))
        lanes["lu_a"] = jax.random.uniform(k2, (n, 2))
        lanes["lu_d"] = jax.random.uniform(k3, (n, 2))
    return lanes


def _bdpt_assemble(cfg, radiance, splat):
    """Film assembly: per-pixel sample mean plus the (1/N-paths)-weighted
    light-tracing splat plane."""
    n = cfg.height * cfg.width * cfg.spp
    samples = jnp.moveaxis(
        radiance.reshape(cfg.spp, cfg.height, cfg.width, 3), 0, 2
    )
    image = jnp.mean(samples, axis=2)
    image = image + splat.reshape(cfg.height, cfg.width, 3) / n
    return jnp.clip(image, 0.0, 1.0)


@partial(jax.jit, static_argnums=(1, 3, 4, 5))
def _render_bdpt(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    ray_chunk: Optional[int],
    light_tracing: bool,
    mode: str,
    q_point: jax.Array,
):
    lanes = _bdpt_lane_uniforms(scene, cfg, key, mode)
    radiance, splat = _bdpt_body(scene, cfg, lanes, ray_chunk,
                                 light_tracing, mode, q_point)
    return _bdpt_assemble(cfg, radiance, splat)


def _bdpt_body(scene, cfg, lanes, ray_chunk, light_tracing, mode, q_point):
    """Per-lane BDPT estimator over a lane bundle from
    :func:`_bdpt_lane_uniforms` (possibly a shard of it): returns the
    per-lane radiance ``(n, 3)`` and the film splat plane ``(H*W, 3)``.
    ``lanes['mask']`` gates splat contributions — False lanes are padding
    in the sharded render (their radiance rows are sliced away by the
    caller, but a splat would land on the shared film, so it is masked
    here)."""
    n = lanes["o"].shape[0]
    lane_mask = lanes["mask"]
    cam = generate_camera_subpaths(scene, cfg, lanes["o"], lanes["d"],
                                   lanes["cam_u"], ray_chunk)
    # Light-origin family (static): "area" and "point" are the
    # single-family estimators; "mixed" picks the walk's family per lane
    # and threads the pick probability through every density.  A delta
    # origin has no s=0 strategy, a 0/remap reverse density, and an
    # all-lights NEE whose discrete density differs from the walk's pick —
    # the three asymmetries flow through light_side_mis's origin_delta /
    # nee_pick_ratio / pdf_area_light arguments (per-lane arrays in mixed
    # mode).
    has_area = mode != "point"
    has_point = mode != "area"
    pick_point = None
    q_area = 1.0 - q_point
    if mode == "point":
        lv, l0 = _light_subpaths_point(scene, cfg, lanes["lu_pick"],
                                       lanes["lu_d"], lanes["light_u"],
                                       ray_chunk)
        p_count = scene.point_lights.num
        # the discrete light-pick probability plays the origin-density role
        # the area measure 1/A plays for area lights (fwd at k==0)
        pdf_area_light = 1.0 / p_count
        nee_ratio = float(p_count)
        origin_delta = True
    elif mode == "area":
        lv, l0 = _light_subpaths_area(scene, cfg, lanes["lu_pick"],
                                      lanes["lu_a"], lanes["lu_d"],
                                      lanes["light_u"], ray_chunk)
        total_area = jnp.maximum(scene.lights.total_area, 1e-12)
        pdf_area_light = 1.0 / total_area
        inv_area = pdf_area_light
        nee_ratio = 1.0
        origin_delta = False
    else:  # mixed
        lv, l0, pick_point = _light_subpaths_mixed(
            scene, cfg, lanes["lu_f"], lanes["lu_pick"], lanes["lu_a"],
            lanes["lu_d"], lanes["light_u"], q_point, ray_chunk)
        p_count = scene.point_lights.num
        inv_area = 1.0 / jnp.maximum(scene.lights.total_area, 1e-12)
        pdf_area_light = jnp.where(
            pick_point, q_point / p_count, q_area * inv_area)
        nee_ratio = jnp.where(
            pick_point, p_count / q_point, 1.0 / q_area)
        origin_delta = pick_point

    radiance = jnp.zeros((n, 3))
    max_d = cfg.max_depth

    # ---- s = 0: camera path hits the light ---------------------------------
    # (a camera walk cannot hit a delta position — the strategy exists only
    # for area-family paths; point/mixed delta lanes are excluded through
    # origin_delta)
    for j in range(max_d if has_area else 0):
        hit_light = cam.valid[:, j] & cam.is_light[:, j]
        contrib = cam.beta[:, j] * cam.emit[:, j]
        # MIS: alternatives are s'>=1 strategies for the same path.
        # pt (= cam[j]) rev density: the light WALK's origin density
        # (q_area/A in mixed mode; the i==j term is s'=1 NEE at 1/A, so
        # s1_ratio=1/q_area restores it)
        # ptMinus rev density: light emission pdf toward cam[j-1]
        if j == 0:
            w = jnp.ones((n,))  # only strategy for a directly seen light
        else:
            ptm_rev = _diffuse_pdf_area(
                cam.ns[:, j], cam.pos[:, j], cam.pos[:, j - 1],
                cam.ns[:, j - 1],
            )  # cosine emission: same |cos|/pi shape
            if mode == "mixed":
                denom_cam = cam_side_mis(cam, j, q_area * inv_area, ptm_rev,
                                         light_tracing,
                                         s1_ratio=1.0 / q_area)
            else:
                denom_cam = cam_side_mis(cam, j, pdf_area_light, ptm_rev,
                                         light_tracing)
            w = 1.0 / (1.0 + denom_cam)
        radiance = radiance + jnp.where(
            hit_light[:, None], contrib * w[:, None], 0.0
        )

    # ---- s = 1 (delta): deterministic connection to every point light ------
    if has_point:
        inv_4pi = 1.0 / (4.0 * jnp.pi)
        plt_ = scene.point_lights
        p_count = scene.point_lights.num
        fam_p = q_point if mode == "mixed" else 1.0
        for j in range(max_d):
            ok0 = cam.valid[:, j] & ~cam.is_delta[:, j]
            cp = cam.pos[:, j]
            cns = cam.ns[:, j]
            for li in range(p_count):
                lp = jnp.broadcast_to(plt_.position[li], cp.shape)
                to_l = lp - cp
                d2 = jnp.maximum(lm.dot(to_l, to_l), 1e-20)
                dist = jnp.sqrt(d2)
                wi = to_l / dist[:, None]
                cos_c = jnp.abs(lm.dot(cns, wi))
                f_cam = _vertex_f(cam, j, wi)
                contrib = cam.beta[:, j] * f_cam * plt_.intensity[li] \
                    * (cos_c / d2)[:, None]
                blocked = _occluded(scene, cp + lm.EPSILON * cns, wi,
                                    dist * (1 - 1e-3), ray_chunk, active=ok0)
                ok = ok0 & ~blocked
                # MIS: the only alternatives are camera-side (s' >= 2 light
                # walks; s'=0 does not exist).  pt_rev = the light walk's
                # density of generating cam[j]: family pick x uniform pick
                # (fam_p/P — NEE evaluates each light with density 1, so
                # the ratio stays in pt_rev) x isotropic emission 1/4pi
                # -> area at cam[j]
                pt_rev = (fam_p / p_count) * inv_4pi * cos_c / d2
                if j > 0:
                    ptm_rev = _vertex_pdf_area(cam, j, cam.pos[:, j - 1],
                                               cam.ns[:, j - 1], w_in=-wi)
                else:
                    ptm_rev = jnp.zeros((n,))
                denom_cam = cam_side_mis(cam, j, pt_rev, ptm_rev,
                                         light_tracing)
                w = 1.0 / (1.0 + denom_cam)
                radiance = radiance + jnp.where(
                    ok[:, None], contrib * w[:, None], 0.0
                )

    # ---- s = 1: connect camera vertex to a fresh light sample --------------
    ul = lanes["ul"]
    for j in range(max_d if has_area else 0):
        ok = cam.valid[:, j] & ~cam.is_delta[:, j]
        lp, ln, lrad, pdf_pos = sample_light_points(
            scene.lights, ul[:, j, 0], ul[:, j, 1], ul[:, j, 2]
        )
        cp = cam.pos[:, j]
        cns = cam.ns[:, j]
        to_l = lp - cp
        d2 = jnp.maximum(lm.dot(to_l, to_l), 1e-20)
        dist = jnp.sqrt(d2)
        wi = to_l / dist[:, None]
        cos_c = lm.dot(cns, wi)
        cos_l = lm.dot(ln, -wi)
        g = jnp.abs(cos_c * cos_l) / d2
        f_cam = _vertex_f(cam, j, wi)
        contrib = cam.beta[:, j] * f_cam * lrad * (g / pdf_pos)[:, None]
        blocked = _occluded(scene, cp + lm.EPSILON * cns, wi,
                            dist * (1 - 1e-3), ray_chunk, active=ok)
        ok = ok & ~blocked & (jnp.abs(cos_l) > 1e-7)

        # MIS
        # qs (sampled light vertex) rev: density of cam[j] scattering toward
        # the light point, area measure at the light
        qs_rev = _vertex_pdf_area(cam, j, lp, ln)
        # pt (= cam[j]) rev: light emitting toward it (cosine emission)
        pt_rev = _diffuse_pdf_area(ln, lp, cp, cns)
        # ptMinus rev: cam[j] scattering backward given incoming from light
        # (hypothetical reversed walk: propagation into cam[j] is -wi)
        if j > 0:
            ptm_rev = _vertex_pdf_area(cam, j, cam.pos[:, j - 1],
                                       cam.ns[:, j - 1], w_in=-wi)
        else:
            ptm_rev = jnp.zeros((n,))
        denom_cam = cam_side_mis(cam, j, pt_rev, ptm_rev, light_tracing)
        if mode == "mixed":
            # every camera-side alternative here is an s'>=2 light walk,
            # whose origin density carries the family factor q_area the
            # sampled NEE strategy lacks (pt_rev holds emission density
            # only — the 1/A position densities cancel, q_area does not)
            denom_cam = q_area * denom_cam
        # light side: the only alternative is s'=0 (camera walk continues
        # into the light), ri = remap(qs_rev)/remap(pdf_pos) — but at
        # j = max_d-1 that walk would need max_d+1 vertices, which
        # random_walk never produces, so the term leaves the partition
        if j == max_d - 1:
            denom_light = jnp.zeros((n,))
        else:
            denom_light = _remap(qs_rev) / _remap(pdf_pos)
        w = 1.0 / (1.0 + denom_cam + denom_light)
        radiance = radiance + jnp.where(
            ok[:, None], contrib * w[:, None], 0.0
        )

    # ---- s >= 2: connect camera vertex j with light vertex i ---------------
    for i in range(max_d):  # light walk vertex index (s = i + 2 incl. origin)
        for j in range(max_d):
            # total surface-vertex count (i+1 light walk + j+1 camera walk)
            # capped at max_depth, matching the path tracer's deepest
            # NEE-covered transport path
            if (i + 1) + (j + 1) > max_d:
                continue
            ok = (
                cam.valid[:, j] & ~cam.is_delta[:, j]
                & lv.valid[:, i] & ~lv.is_delta[:, i]
            )
            if (i + 1) + (j + 1) == max_d and i > 0:
                # depth-cap coverage contract: at the cap the path has
                # max_d+1 surface vertices, which the path tracer reaches
                # only via NEE at a *diffuse* light-adjacent vertex; paths
                # whose light-adjacent vertex lv[0] is specular are outside
                # the equal-depth transport both integrators target, so
                # they are excluded here (not re-weighted) to keep
                # PT<->BDPT parity exact at any max_depth
                ok = ok & ~lv.is_delta[:, 0]
            cp, cns = cam.pos[:, j], cam.ns[:, j]
            lp_, lns = lv.pos[:, i], lv.ns[:, i]
            to_l = lp_ - cp
            d2 = jnp.maximum(lm.dot(to_l, to_l), 1e-20)
            dist = jnp.sqrt(d2)
            wi = to_l / dist[:, None]
            g = jnp.abs(lm.dot(cns, wi) * lm.dot(lns, -wi)) / d2
            f_cam = _vertex_f(cam, j, wi)
            f_light = _vertex_f(lv, i, -wi)
            contrib = (
                cam.beta[:, j] * f_cam * f_light * lv.beta[:, i]
                * g[:, None]
            )
            blocked = _occluded(scene, cp + lm.EPSILON * cns, wi,
                                dist * (1 - 1e-3), ray_chunk, active=ok)
            ok = ok & ~blocked

            # junction rev densities (hypothetical incoming directions:
            # the reversed walk reaches cam[j] traveling -wi, and the
            # reversed-camera walk reaches lv[i] traveling +wi)
            pt_rev = _vertex_pdf_area(lv, i, cp, cns)
            qs_rev = _vertex_pdf_area(cam, j, lp_, lns)
            if j > 0:
                ptm_rev = _vertex_pdf_area(cam, j, cam.pos[:, j - 1],
                                           cam.ns[:, j - 1], w_in=-wi)
            else:
                ptm_rev = jnp.zeros((n,))
            if i > 0:
                qsm_rev = _vertex_pdf_area(lv, i, lv.pos[:, i - 1],
                                           lv.ns[:, i - 1], w_in=wi)
            elif mode == "point":
                # a delta origin cannot be re-generated by scattering
                qsm_rev = jnp.zeros((n,))
            elif mode == "area":
                qsm_rev = _vertex_pdf_area(lv, i, l0["pos"], l0["ns"],
                                           w_in=wi)
            else:  # mixed: per-lane family (delta lanes -> 0/remap)
                qsm_rev = jnp.where(
                    pick_point, 0.0,
                    _vertex_pdf_area(lv, i, l0["pos"], l0["ns"], w_in=wi))

            denom_cam = cam_side_mis(cam, j, pt_rev, ptm_rev, light_tracing)
            # at the cap ((i+1)+(j+1) == max_d) the s'=0 alternative would
            # need a camera walk of max_d+1 vertices — never sampled
            denom_light = light_side_mis(
                lv, l0, pdf_area_light, i + 1, qs_rev, qsm_rev,
                skip_s0=(i + 1) + (j + 1) == max_d,
                origin_delta=origin_delta, nee_pick_ratio=nee_ratio)
            w = 1.0 / (1.0 + denom_cam + denom_light)
            radiance = radiance + jnp.where(
                ok[:, None], contrib * w[:, None], 0.0
            )

    # ---- t = 1: light tracing — splat light vertices onto the film --------
    splat = jnp.zeros((cfg.height * cfg.width, 3))
    if light_tracing:
        left, right, top, bottom = cfg.screen_bounds
        step_x = (right - left) / (cfg.width - 1)
        step_y = (top - bottom) / (cfg.height - 1)
        a_samp = (1.0 / cfg.width) * (1.0 / cfg.height)
        cam_pos = scene.camera
        for i in range(max_d):
            ok = lv.valid[:, i] & ~lv.is_delta[:, i] & lane_mask
            if i == max_d - 1 and i > 0:
                # same depth-cap coverage contract as the s>=2 block: at
                # i = max_d-1 the splat path has max_d+1 surface vertices
                # and is inside the equal-depth transport only when the
                # light-adjacent vertex is diffuse (NEE-representable)
                ok = ok & ~lv.is_delta[:, 0]
            p_pos = lv.pos[:, i]
            p_ns = lv.ns[:, i]
            to_c = cam_pos - p_pos
            r2 = jnp.maximum(lm.dot(to_c, to_c), 1e-20)
            dist = jnp.sqrt(r2)
            w_dir = to_c / dist[:, None]  # P -> camera
            dir_cp = -w_dir  # camera -> P
            # screen-plane mapping: S = cam + a * dir_cp with S_z = f
            dz = dir_cp[:, 2]
            ok = ok & (dz < -1e-6)  # P must be on the viewing side
            a = (cfg.f_distance - cam_pos[2]) / jnp.where(dz == 0, 1.0, dz)
            sx = cam_pos[0] + a * dir_cp[:, 0]
            sy = cam_pos[1] + a * dir_cp[:, 1]
            # pixel footprint [x_j, x_j + 1/W] x [y_i, y_i + 1/H]
            jx = jnp.floor((sx - left) / step_x).astype(jnp.int32)
            in_x = (sx >= left + jx * step_x) & (
                sx <= left + jx * step_x + 1.0 / cfg.width
            )
            iy = jnp.ceil((top - sy) / step_y).astype(jnp.int32)
            y_i = top - iy * step_y
            in_y = (sy >= y_i) & (sy <= y_i + 1.0 / cfg.height)
            ok = ok & in_x & in_y & (jx >= 0) & (jx < cfg.width) \
                & (iy >= 0) & (iy < cfg.height)
            pix = jnp.clip(iy, 0, cfg.height - 1) * cfg.width + jnp.clip(
                jx, 0, cfg.width - 1
            )

            cos_c = jnp.maximum(jnp.abs(dz), 1e-6)
            r_s = jnp.abs(cam_pos[2] - cfg.f_distance) / cos_c
            we = r_s * r_s / (a_samp * cos_c)  # importance, solid-angle
            cos_p = jnp.abs(lm.dot(p_ns, w_dir))
            f_p = _vertex_f(lv, i, w_dir)
            contrib = lv.beta[:, i] * f_p * ((cos_p / r2) * we)[:, None]

            blocked = _occluded(scene, p_pos + lm.EPSILON * w_dir, w_dir,
                                dist * (1 - 1e-3), ray_chunk, active=ok)
            ok = ok & ~blocked

            # MIS: junction rev densities — the camera generating P, and P
            # scattering backward along the light chain
            qs_rev = we * cos_p / r2  # camera area density at P
            # hypothetical reversed (camera-side) walk reaches P traveling
            # camera -> P, i.e. along -w_dir
            if i > 0:
                qsm_rev = _vertex_pdf_area(lv, i, lv.pos[:, i - 1],
                                           lv.ns[:, i - 1], w_in=-w_dir)
            elif mode == "point":
                # a delta origin cannot be re-generated by scattering
                qsm_rev = jnp.zeros((n,))
            elif mode == "area":
                qsm_rev = _vertex_pdf_area(lv, i, l0["pos"], l0["ns"],
                                           w_in=-w_dir)
            else:  # mixed: per-lane family (delta lanes -> 0/remap)
                qsm_rev = jnp.where(
                    pick_point, 0.0,
                    _vertex_pdf_area(lv, i, l0["pos"], l0["ns"],
                                     w_in=-w_dir))
            # at i = max_d-1 the splat path has max_d+1 surface vertices;
            # the s'=0 alternative is unreachable for the camera walk
            denom = light_side_mis(lv, l0, pdf_area_light, i + 1, qs_rev,
                                   qsm_rev, skip_s0=i == max_d - 1,
                                   origin_delta=origin_delta,
                                   nee_pick_ratio=nee_ratio)
            w_mis = 1.0 / (1.0 + denom)

            add = jnp.where(ok[:, None], contrib * w_mis[:, None], 0.0)
            splat = splat.at[pix].add(add)

    # light-tracing estimator: (1/N_light_paths) * sum of splats, with N
    # the GLOBAL path count — applied in _bdpt_assemble
    return radiance, splat
