"""Flagship integrator: iterative path tracing with next-event estimation.

Array rebuild of the reference's canonical pipeline
(``src/path_tracing.py:24-159`` / ``path_tracing_fix1.py:18-136``): instead
of one Python ``while`` loop per path, the *entire lane population*
(H*W*spp paths) advances one bounce per superstep under a ``lax.scan`` with
a boolean alive mask — the vectorized form of the reference's
``bounce_record`` masking (src/scene.py:72).  BSDF selection is a branchless
3-way select on the material's integer BSDF code, replacing the if/elif
chain at src/path_tracing.py:68-145.

A path is a pure function of its uniform tensor (the property the
reference engineers via pre-drawn ``scene.rand_0/1``, src/scene.py:68-71),
which makes the control-variates log-pdf gradients *exact* via jax.grad
(see integrators/control_variates.py) instead of finite differences.

Physics contract per bounce (reference lines cited inline):
  hit -> emission at first hit -> orient normal -> BSDF:
    diffuse: NEE shadow ray + cosine-weighted bounce
    mirror:  reflect
    transmissive: Schlick-probability reflect/refract with TIR
  -> Russian roulette after ``rr_start`` bounces.

Documented deviations (all deliberate, SURVEY.md §7 hard-part 5):
- proper Schlick ``(1-|cos|)^5`` instead of the reference's
  ``(1-cos(cos_theta))^5`` (src/path_tracing.py:121);
- independent uniforms for BSDF / light pick / RR instead of reusing
  ``rand_0`` for all three (src/path_tracing.py:132,150);
- light points sampled over *both* light triangles area-weighted (the
  reference samples only tri_1's surface: src/light_samples.py:29);
- cosine sampling done purely in the shading frame (the reference mixes
  world and local z, src/utils.py:144-152).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from light_transport_tpu.core import math as lm
from light_transport_tpu.core import rng
from light_transport_tpu.core.config import RenderConfig
from light_transport_tpu.ops import intersect
from light_transport_tpu.ops import sampling
from light_transport_tpu.scene.lights import geometry_term, sample_light_points
from light_transport_tpu.scene.material import (
    BSDF_DIFFUSE,
    BSDF_GLOSSY,
    BSDF_MIRROR,
    BSDF_TRANSMISSIVE,
)
from light_transport_tpu.scene.scene import Scene


class PathState(NamedTuple):
    """SoA per-lane path state carried across bounce supersteps."""

    origin: jnp.ndarray  # (N, 3)
    direction: jnp.ndarray  # (N, 3)
    throughput: jnp.ndarray  # (N, 3)
    radiance: jnp.ndarray  # (N, 3)
    alive: jnp.ndarray  # (N,) bool
    # NEE bookkeeping ("nee" emission mode): True when a light hit at this
    # bounce could NOT have been sampled by a shadow ray — at bounce 0, or
    # when every vertex since the last diffuse one was specular / a medium
    # scatter.  Avoids both the double counting of "always" and the
    # specular-chain energy loss of "first_hit".
    emit_ok: jnp.ndarray  # (N,) bool
    # Solid-angle pdf of the direction sampled at the previous vertex IF
    # that vertex was diffuse (0 otherwise) — the BSDF-side density the
    # power heuristic needs when emission_mode="mis" scores a
    # BSDF-sampled light hit (anchor: the per-strategy pdf bookkeeping of
    # src/bdpt.py:298-359, collapsed to the one NEE<->BSDF pair).
    prev_pdf: jnp.ndarray  # (N,)
    # Carried interior medium: the (sigma_a, sigma_s, g) of the medium the
    # ray currently travels through, updated on refraction entry/exit, plus
    # a one-level outer memory so exiting a nested object restores the
    # enclosing medium (glass containing liquid/ice — exact to one nesting
    # level, the README-documented approximation beyond that).  Segment
    # attenuation and in-scattering read THESE, not the hit face's
    # material, so spans that end on another object's front face attenuate
    # correctly (previously only backface-terminated spans did).
    med_sig_a: jnp.ndarray  # (N, 3)
    med_sig_s: jnp.ndarray  # (N,)
    med_g: jnp.ndarray  # (N,)
    out_sig_a: jnp.ndarray  # (N, 3)
    out_sig_s: jnp.ndarray  # (N,)
    out_g: jnp.ndarray  # (N,)

    @staticmethod
    def initial(origins, directions):
        """Fresh camera-lane state: full throughput, vacuum medium."""
        n = origins.shape[0]
        dtype = origins.dtype
        z = jnp.zeros((n,), dtype)
        return PathState(
            origin=origins,
            direction=directions,
            throughput=jnp.ones((n, 3), dtype),
            radiance=jnp.zeros((n, 3), dtype),
            alive=jnp.ones((n,), bool),
            emit_ok=jnp.ones((n,), bool),
            prev_pdf=z,
            med_sig_a=jnp.zeros((n, 3), dtype),
            med_sig_s=z,
            med_g=z,
            out_sig_a=jnp.zeros((n, 3), dtype),
            out_sig_s=z,
            out_g=z,
        )


class TraceRecord(NamedTuple):
    """Per-bounce telemetry (the reference's ``record_log_pdf`` /
    ``bounce_record`` / direct-indirect lists, src/path_tracing.py:27-30)."""

    log_pdf: jnp.ndarray  # (N, depth) log of BSDF pdf at diffuse bounces
    alive: jnp.ndarray  # (N, depth) lane alive at bounce b
    direct: jnp.ndarray  # (N, depth, 3) NEE contribution at bounce b
    tri: jnp.ndarray  # (N, depth) int32 triangle hit at bounce b (-1 miss)
    incident: jnp.ndarray  # (N, depth) luminance of throughput at arrival


def surface_detector_tally(record: TraceRecord, num_triangles: int):
    """Per-surface detectors (BASELINE config 4): accumulate incident path
    power (throughput luminance at arrival) per triangle.

    Returns ``(energy (T,), hits (T,))`` — scatter-add over the whole
    trace record.
    """
    tri = record.tri.reshape(-1)
    ok = tri >= 0
    idx = jnp.maximum(tri, 0)
    w = jnp.where(ok, record.incident.reshape(-1), 0.0)
    energy = jnp.zeros((num_triangles,), w.dtype).at[idx].add(w)
    hits = jnp.zeros((num_triangles,), jnp.int32).at[idx].add(
        ok.astype(jnp.int32)
    )
    return energy, hits


def _bounce(
    scene: Scene,
    cfg: RenderConfig,
    state: PathState,
    u: jnp.ndarray,  # (N, NUM_U) this bounce's uniforms
    bounce: jnp.ndarray,  # () or (N,) int32 bounce index
    ray_chunk: Optional[int],
    split_ok: Optional[jnp.ndarray] = None,  # (N,) bool: deterministic
    # both-branch Fresnel allowed for this lane (fresnel_mode="split");
    # None = stochastic branch selection everywhere (the flagship rule)
):
    mesh = scene.mesh
    mats = scene.materials
    n_lanes = state.origin.shape[0]
    eps = lm.EPSILON

    # Routine chosen per scene (ops/dispatch.py); gradients
    # are stopped at the hit — intersection is a discrete event whose
    # derivative w.r.t. the path uniforms is zero almost everywhere, and
    # stopping it keeps jax.grad of the log-pdf records (the CV pipeline)
    # from reverse-differentiating traversal while_loops.
    from light_transport_tpu.ops.dispatch import scene_intersect

    hit = scene_intersect(scene, state.origin, state.direction,
                          ray_chunk=ray_chunk, active=state.alive)
    hit_ok = hit.valid & state.alive
    hit_p = state.origin + state.direction * hit.t[:, None]
    hit_p = jnp.where(hit_ok[:, None], hit_p, 0.0)

    from light_transport_tpu.scene.analytic import surface_attrs

    n_geo, mat_id, is_light = surface_attrs(scene, hit, hit_p)
    cos_in = lm.dot(n_geo, state.direction)
    inside = cos_in > 0.0
    # orient the shading normal against the incoming ray
    # (src/path_tracing.py:62-65)
    n_s = jnp.where(inside[:, None], -n_geo, n_geo)

    bsdf = mats.bsdf[mat_id]
    diffuse_rgb = mats.diffuse[mat_id]
    ior = mats.ior[mat_id]

    # --- interior participating medium ------------------------------------
    # The segment [origin, event] traverses the CARRIED medium (PathState
    # med_*, set on refraction entry / cleared on exit below): Beer-Lambert
    # absorption applies along it, and if the medium scatters (sigma_s > 0)
    # an in-scatter event may preempt the surface interaction.  Free flight
    # is sampled against sigma_s alone (analog scattering), so the
    # scattering transmittance cancels its own pdf exactly and absorption
    # remains as a throughput weight — standard unbiased spectral-
    # absorption estimator.  Carrying the medium (instead of inferring it
    # from backface hits) makes spans that end on a nested object's front
    # face attenuate correctly.  (Completes the capability the reference
    # stubbed with its Medium enum, src/constants.py:17-24, and unused HG,
    # src/medium_samples.py:14-16.)
    sig_a = state.med_sig_a  # (N, 3)
    sig_s = state.med_sig_s
    med_g = state.med_g
    in_medium = hit_ok & jnp.any(sig_a + sig_s[:, None] > 0.0, axis=-1)
    has_scat = hit_ok & (sig_s > 0.0)
    safe_ss = jnp.where(has_scat, sig_s, 1.0)
    d_scat = -jnp.log1p(-u[:, rng.U_MED]) / safe_ss
    scatter_evt = has_scat & (d_scat < hit.t)
    seg_len = jnp.where(in_medium,
                        jnp.where(scatter_evt, d_scat, hit.t), 0.0)
    atten = jnp.exp(-sig_a * seg_len[:, None])
    tp_arr = state.throughput * atten  # throughput at this bounce's event

    hg_cos = sampling.sample_henyey_greenstein(med_g, u[:, rng.U_BSDF0])
    hg_dir = sampling.scatter_direction(state.direction, hg_cos,
                                        u[:, rng.U_BSDF1])
    scat_o = state.origin + state.direction * d_scat[:, None]

    # --- emission (src/path_tracing.py:59-60: bounce 0 only; fix1 :45:
    # always; "nee": the estimator-correct rule — emission counts only when
    # NEE could not have sampled this light hit, i.e. at bounce 0 or after
    # an unbroken specular/medium-scatter chain.  "first_hit" reproduces the
    # reference flagship, which structurally drops light seen through
    # specular chains; "always" reproduces fix1, which double-counts
    # BSDF-sampled light hits that NEE also scored.)
    if cfg.emission_mode == "first_hit":
        add_emit = hit_ok & is_light & (bounce == 0)
    elif cfg.emission_mode == "nee":
        add_emit = hit_ok & is_light & state.emit_ok
    elif cfg.emission_mode == "mis":
        # power-heuristic NEE<->BSDF combination:
        # instead of the binary emit_ok partition, a BSDF-sampled light
        # hit from a diffuse vertex scores with weight
        # p_bsdf^2 / (p_bsdf^2 + p_nee^2) — the NEE side below carries
        # the complementary weight, so each light path is counted exactly
        # once in expectation with the canonical variance-optimal split.
        # Specular/medium chains (emit_ok) keep weight 1: NEE cannot
        # sample them, so there is no competing strategy.
        add_emit = hit_ok & is_light & (state.emit_ok
                                        | (state.prev_pdf > 0.0))
    else:
        add_emit = hit_ok & is_light
    add_emit = add_emit & ~scatter_evt
    emit_w = 1.0
    if cfg.emission_mode == "mis":
        # NEE's solid-angle density toward the point actually hit:
        # (1/total_area) * r^2 / |cos phi|; |cos_in| IS the light-side
        # cosine (cos_in = dot(n_geo, direction) at the hit surface)
        inv_area = 1.0 / jnp.maximum(scene.lights.total_area, 1e-30)
        p_nee_hit = inv_area * hit.t * hit.t / jnp.maximum(
            jnp.abs(cos_in), 1e-12)
        p_b = state.prev_pdf
        w_bsdf = p_b * p_b / jnp.maximum(
            p_b * p_b + p_nee_hit * p_nee_hit, 1e-30)
        emit_w = jnp.where(state.emit_ok, 1.0, w_bsdf)[:, None]
    # emitted radiance = emission * emission_color — the SAME value the
    # NEE side reads (scene/lights.py LightTable.radiance); the reference
    # scores the bare scalar at hits but a diffuse-tinted product through
    # NEE (src/path_tracing.py:60 vs src/light_samples.py:55), splitting
    # one light into two radiances (README §Deviations)
    radiance = state.radiance + jnp.where(
        add_emit[:, None], mats.emission_rgb[mat_id] * tp_arr * emit_w, 0.0
    )

    # --- diffuse branch: NEE + cosine bounce -------------------------------
    from light_transport_tpu.ops.dispatch import (
        scene_occluded,
        scene_transmittance,
    )

    shadow_o = hit_p + eps * n_s
    f_diffuse = diffuse_rgb * lm.INV_PI
    # glossy (modified Phong) surface attributes; the mirror direction of
    # the incoming ray about the shading normal is both the mirror-branch
    # direction below and the Phong lobe axis
    spec_rgb = mats.specular[mat_id]
    shin = mats.shininess[mat_id]
    is_glossy = bsdf == BSDF_GLOSSY
    m_dir = lm.reflect(state.direction, n_s)
    # only lanes whose NEE contribution survives the `shade` mask below
    # need real shadow rays; the rest are culled inside dispatch
    nee_active = hit_ok & ((bsdf == BSDF_DIFFUSE) | is_glossy) \
        & ~scatter_evt
    if cfg.nee_mode == "all":
        # legacy all-lights estimator (cast_all_shadow_rays,
        # src/light_samples.py:119-143): one shadow ray per light triangle
        # at its centroid, contributions area-weighted (exact quadrature
        # over the table instead of the reference's averaged random list)
        lt_ = scene.lights
        lp_rows = lt_.v0 + (lt_.e1 + lt_.e2) / 3.0
        direct = jnp.zeros_like(f_diffuse)
        for li in range(lt_.area.shape[0]):
            lp_i = jnp.broadcast_to(lp_rows[li], shadow_o.shape)
            ln_i = jnp.broadcast_to(lt_.normal[li], shadow_o.shape)
            g_i, wi_i, dist_i = geometry_term(shadow_o, n_s, lp_i, ln_i)
            f_i = jnp.where(
                is_glossy[:, None],
                sampling.glossy_f(diffuse_rgb, spec_rgb, shin, m_dir, wi_i),
                f_diffuse)
            contrib = lt_.radiance[li] * f_i \
                * (g_i * lt_.area[li])[:, None]
            if cfg.shadow_mode == "transmittance":
                contrib = contrib * scene_transmittance(
                    scene, shadow_o, wi_i, dist_i * (1.0 - 1e-3),
                    ray_chunk=ray_chunk, active=nee_active)
            else:
                blk = scene_occluded(scene, shadow_o, wi_i,
                                     dist_i * (1.0 - 1e-3),
                                     ray_chunk=ray_chunk,
                                     active=nee_active)
                contrib = jnp.where(blk[:, None], 0.0, contrib)
            direct = direct + contrib
    else:
        lp, ln, lrad, pdf_area = sample_light_points(
            scene.lights, u[:, rng.U_PICK], u[:, rng.U_LIGHT0],
            u[:, rng.U_LIGHT1]
        )
        g_term, wi, dist = geometry_term(shadow_o, n_s, lp, ln)
        # contract: src/light_samples.py:55-59 — L * f * G / pdf_area;
        # glossy vertices evaluate the full modified-Phong f toward the
        # sampled light point
        f_view = jnp.where(
            is_glossy[:, None],
            sampling.glossy_f(diffuse_rgb, spec_rgb, shin, m_dir, wi),
            f_diffuse)
        direct = lrad * f_view \
            * (g_term / jnp.maximum(pdf_area, 1e-30))[:, None]
        if cfg.emission_mode == "mis":
            # the NEE side of the power heuristic: compete against the
            # BSDF sampling density of the same direction (cosine for
            # diffuse, the mixed cosine+Phong lobe for glossy)
            cos_phi_l = jnp.abs(lm.dot(ln, -wi))
            p_nee_sa = pdf_area * dist * dist / jnp.maximum(cos_phi_l,
                                                            1e-12)
            p_b_hyp = jnp.where(
                is_glossy,
                sampling.glossy_pdf(diffuse_rgb, spec_rgb, shin, n_s,
                                    m_dir, wi),
                jnp.maximum(lm.dot(wi, n_s), 0.0) * lm.INV_PI)
            w_nee = p_nee_sa * p_nee_sa / jnp.maximum(
                p_nee_sa * p_nee_sa + p_b_hyp * p_b_hyp, 1e-30)
            direct = direct * w_nee[:, None]
        if cfg.shadow_mode == "transmittance":
            # media-aware visibility: transmissive occluders attenuate by
            # their interior Beer-Lambert extinction instead of blocking
            trans = scene_transmittance(scene, shadow_o, wi,
                                        dist * (1.0 - 1e-3),
                                        ray_chunk=ray_chunk,
                                        active=nee_active)
            direct = direct * trans
        else:
            blocked = scene_occluded(scene, shadow_o, wi,
                                     dist * (1.0 - 1e-3),
                                     ray_chunk=ray_chunk, active=nee_active)
            direct = jnp.where(blocked[:, None], 0.0, direct)

    if scene.point_lights is not None:
        # --- point (delta) lights: deterministic direct term ---------------
        # f(wi) * I * cos(theta) / r^2 * V summed over the table (reference
        # GUI 'Point' source, app.py:152-158).  No sampling pdf and no MIS
        # weight: a delta light cannot be hit by BSDF sampling, so NEE is
        # the only strategy for it in every emission_mode.  Consumes NO
        # uniforms — the threefry stream of point-light-free scenes is
        # bitwise unchanged.
        plt_ = scene.point_lights
        for li in range(plt_.num):
            lp_i = jnp.broadcast_to(plt_.position[li], shadow_o.shape)
            to_l = lp_i - shadow_o
            d2 = jnp.maximum(lm.dot(to_l, to_l), 1e-20)
            dist_i = jnp.sqrt(d2)
            wi_i = to_l / dist_i[:, None]
            cos_i = jnp.maximum(lm.dot(n_s, wi_i), 0.0)
            f_i = jnp.where(
                is_glossy[:, None],
                sampling.glossy_f(diffuse_rgb, spec_rgb, shin, m_dir,
                                  wi_i),
                f_diffuse)
            contrib = plt_.intensity[li] * f_i * (cos_i / d2)[:, None]
            if cfg.shadow_mode == "transmittance":
                contrib = contrib * scene_transmittance(
                    scene, shadow_o, wi_i, dist_i * (1.0 - 1e-3),
                    ray_chunk=ray_chunk, active=nee_active)
            else:
                blk = scene_occluded(scene, shadow_o, wi_i,
                                     dist_i * (1.0 - 1e-3),
                                     ray_chunk=ray_chunk,
                                     active=nee_active)
                contrib = jnp.where(blk[:, None], 0.0, contrib)
            direct = direct + contrib

    d_dir, d_pdf = sampling.cosine_weighted_hemisphere(
        n_s, u[:, rng.U_BSDF0], u[:, rng.U_BSDF1]
    )
    pdf_ok = d_pdf > 0.0
    cos_o = lm.dot(d_dir, n_s)
    safe_pdf = jnp.where(pdf_ok, d_pdf, 1.0)
    diffuse_tp_scale = f_diffuse * (cos_o / safe_pdf)[:, None]
    diffuse_new_o = hit_p + eps * d_dir  # src/path_tracing.py:82

    # --- glossy branch: sampled modified Phong -----------------------------
    # Lobe choice consumes NO extra uniform: u0 is split at the specular
    # probability q and rescaled to [0,1) on each side (independent of the
    # branch taken), keeping the NUM_U uniform-tensor contract — and the
    # threefry stream of every non-glossy scene — bitwise unchanged.
    # Diffuse lanes above keep the UNrescaled u0 for golden-image parity.
    q_spec = sampling.glossy_mix(diffuse_rgb, spec_rgb)
    u0 = u[:, rng.U_BSDF0]
    pick_spec = u0 < q_spec
    u0r = jnp.clip(jnp.where(
        pick_spec, u0 / jnp.maximum(q_spec, 1e-12),
        (u0 - q_spec) / jnp.maximum(1.0 - q_spec, 1e-12)), 0.0, 1.0)
    gd_dir, _ = sampling.cosine_weighted_hemisphere(
        n_s, u0r, u[:, rng.U_BSDF1])
    gs_dir = sampling.sample_phong_lobe(m_dir, shin, u0r,
                                        u[:, rng.U_BSDF1])
    g_dir = jnp.where(pick_spec[:, None], gs_dir, gd_dir)
    g_pdf = sampling.glossy_pdf(diffuse_rgb, spec_rgb, shin, n_s, m_dir,
                                g_dir)
    cos_g = lm.dot(g_dir, n_s)
    # below-horizon Phong samples terminate with zero contribution (the
    # wrong-hemisphere rule of src/utils.py:158-160, applied to the lobe)
    g_ok = (g_pdf > 0.0) & (cos_g > 0.0)
    g_f = sampling.glossy_f(diffuse_rgb, spec_rgb, shin, m_dir, g_dir)
    glossy_tp_scale = g_f * jnp.where(
        g_ok, cos_g / jnp.where(g_ok, g_pdf, 1.0), 0.0)[:, None]
    glossy_new_o = hit_p + eps * g_dir

    # --- mirror branch (src/path_tracing.py:103-106) -----------------------
    # (m_dir computed above: it doubles as the Phong lobe axis)
    mirror_new_o = hit_p + eps * n_s

    # --- transmissive branch (src/path_tracing.py:108-141) -----------------
    n1 = jnp.where(inside, ior, 1.0)
    n2 = jnp.where(inside, 1.0, ior)
    r0 = sampling.schlick_r0(n1, n2)
    cos_i = -lm.dot(state.direction, n_s)  # >= 0 after orientation
    refl_prob = sampling.schlick_reflectance(r0, cos_i)
    eta = n1 / n2
    t_dir, tir = lm.refract(state.direction, n_s, eta)
    do_refract = (~tir) & (u[:, rng.U_BSDF0] > refl_prob)
    trans_tp_scale = jnp.ones_like(refl_prob)
    if split_ok is not None:
        # deterministic both-branch Fresnel (src/render.py:121-153): the
        # lane follows the refracted branch weighted (1-R) and the caller
        # pushes the reflected branch weighted R onto its deferred stack.
        # Lanes whose stack is full (split_ok False) keep the unbiased
        # stochastic rule, so the estimator stays exact at any stack size.
        do_refract = jnp.where(split_ok, ~tir, do_refract)
        trans_tp_scale = jnp.where(split_ok & ~tir, 1.0 - refl_prob, 1.0)
    trans_dir = jnp.where(do_refract[:, None], t_dir, m_dir)
    trans_new_o = jnp.where(
        do_refract[:, None], hit_p - eps * n_s, hit_p + eps * n_s
    )

    # --- select by BSDF code (branchless) ----------------------------------
    is_diffuse = bsdf == BSDF_DIFFUSE
    is_mirror = bsdf == BSDF_MIRROR
    is_trans = bsdf == BSDF_TRANSMISSIVE
    # else: terminate (:143-145); glossy is this framework's extension
    bsdf_ok = is_diffuse | is_glossy | is_mirror | is_trans

    new_dir = jnp.where(
        is_diffuse[:, None],
        d_dir,
        jnp.where(
            is_glossy[:, None], g_dir,
            jnp.where(is_mirror[:, None], m_dir, trans_dir)),
    )
    new_o = jnp.where(
        is_diffuse[:, None],
        diffuse_new_o,
        jnp.where(
            is_glossy[:, None], glossy_new_o,
            jnp.where(is_mirror[:, None], mirror_new_o, trans_new_o)),
    )
    # in-scatter events preempt the surface interaction entirely
    new_dir = jnp.where(scatter_evt[:, None], hg_dir, new_dir)
    new_o = jnp.where(scatter_evt[:, None], scat_o, new_o)
    tp_scale = jnp.where(
        is_diffuse[:, None], diffuse_tp_scale,
        jnp.where(
            is_glossy[:, None], glossy_tp_scale,
            jnp.where(is_trans[:, None], trans_tp_scale[:, None], 1.0)),
    )

    shade = hit_ok & (is_diffuse | is_glossy) & ~scatter_evt
    direct_contrib = jnp.where(shade[:, None], tp_arr * direct, 0.0)
    radiance = radiance + direct_contrib

    new_tp = tp_arr * jnp.where((hit_ok & ~scatter_evt)[:, None],
                                tp_scale, 1.0)

    alive = state.alive & (
        scatter_evt | (hit_ok & bsdf_ok & (pdf_ok | ~is_diffuse)
                       & (g_ok | ~is_glossy))
    )

    # --- Russian roulette (src/path_tracing.py:147-155) --------------------
    # Deviation: survival keys on luminance, not the reference's green
    # channel (`1-throughput[1]`, :149) — green-keying kills red/blue-only
    # paths with probability 1 and no compensation, erasing their energy
    # (e.g. all red inter-reflection past rr_start in the Cornell box)
    rr_active = alive & (bounce > cfg.rr_start)
    r_r = jnp.maximum(cfg.rr_floor, 1.0 - lm.luminance(new_tp))
    rr_kill = rr_active & (u[:, rng.U_RR] < r_r)
    rr_scale = jnp.where(rr_active & ~rr_kill, 1.0 / (1.0 - r_r), 1.0)
    new_tp = new_tp * rr_scale[:, None]
    alive = alive & ~rr_kill

    sample_pdf_ok = jnp.where(is_glossy, g_ok, pdf_ok)
    sample_pdf = jnp.where(is_glossy, g_pdf, safe_pdf)
    log_pdf = jnp.where(shade & sample_pdf_ok,
                        jnp.log(jnp.where(shade & sample_pdf_ok,
                                          sample_pdf, 1.0)), 0.0)

    if cfg.shadow_mode == "transmittance":
        # transparent-shadow convention: the attenuated straight-line NEE
        # already approximates diffuse -> transmissive-chain -> light
        # transport, so a transmissive hit PROPAGATES the incoming
        # emit_ok instead of granting it — otherwise that direct term is
        # scored twice (once by NEE, once by the refracted chain's
        # emission credit).  Camera->glass->light (emit_ok starts True)
        # and mirror->glass->light (mirrors still block shadow rays, so
        # NEE never covers them) keep their credit.
        trans_emit = hit_ok & is_trans & state.emit_ok
    else:
        # block mode: shadow rays cannot cross glass, so the specular
        # chain is the only estimator for light behind it
        trans_emit = hit_ok & is_trans
    # --- carried-medium update: refraction crosses an interface ------------
    refracted = hit_ok & is_trans & do_refract & ~scatter_evt & state.alive
    entering = refracted & ~inside
    exiting = refracted & inside
    hit_sig_a = mats.sigma_a[mat_id]
    hit_sig_s = mats.sigma_s[mat_id]
    hit_g = mats.medium_g[mat_id]

    def sel(enter_v, exit_v, keep_v, vec=False):
        e = entering[:, None] if vec else entering
        x = exiting[:, None] if vec else exiting
        return jnp.where(e, enter_v, jnp.where(x, exit_v, keep_v))

    med_sig_a = sel(hit_sig_a, state.out_sig_a, state.med_sig_a, vec=True)
    med_sig_s = sel(hit_sig_s, state.out_sig_s, state.med_sig_s)
    new_med_g = sel(hit_g, state.out_g, state.med_g)
    # one-level outer memory: push the enclosing medium on entry, pop to
    # vacuum on exit (deeper nesting approximates — README deviation 16)
    out_sig_a = sel(state.med_sig_a, jnp.zeros_like(state.out_sig_a),
                    state.out_sig_a, vec=True)
    out_sig_s = sel(state.med_sig_s, jnp.zeros_like(state.out_sig_s),
                    state.out_sig_s)
    out_g = sel(state.med_g, jnp.zeros_like(state.out_g), state.out_g)

    new_state = PathState(
        origin=new_o,
        direction=new_dir,
        throughput=new_tp,
        radiance=radiance,
        alive=alive,
        emit_ok=scatter_evt | (hit_ok & is_mirror) | trans_emit,
        prev_pdf=jnp.where(
            hit_ok & ~scatter_evt
            & (is_diffuse & pdf_ok | is_glossy & g_ok),
            sample_pdf, 0.0),
        med_sig_a=med_sig_a,
        med_sig_s=med_sig_s,
        med_g=new_med_g,
        out_sig_a=out_sig_a,
        out_sig_s=out_sig_s,
        out_g=out_g,
    )
    reached = hit_ok & ~scatter_evt  # path actually arrived at the surface
    per_bounce = (
        log_pdf,
        hit_ok & state.alive,
        direct_contrib,
        jnp.where(reached, hit.tri, -1),
        jnp.where(reached, lm.luminance(tp_arr), 0.0),
    )
    if split_ok is None:
        return new_state, per_bounce
    # fresnel_mode="split": the reflected sibling of a followed refraction,
    # for the caller to push onto the lane's deferred-branch stack
    defer_mask = reached & is_trans & (~tir) & split_ok & state.alive
    # the reflected sibling stays on the incoming side of the interface:
    # it inherits the PRE-refraction medium state
    defer = (
        defer_mask,
        hit_p + eps * n_s,
        m_dir,
        tp_arr * refl_prob[:, None],
        state.med_sig_a, state.med_sig_s, state.med_g,
        state.out_sig_a, state.out_sig_s, state.out_g,
    )
    return new_state, per_bounce, defer


def trace_paths(
    scene: Scene,
    cfg: RenderConfig,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    uniforms: jnp.ndarray,  # (N, max_depth, NUM_U)
    ray_chunk: Optional[int] = None,
) -> Tuple[jnp.ndarray, TraceRecord]:
    """Trace a lane population to completion; pure function of ``uniforms``.

    Returns ``(radiance (N, 3), TraceRecord)``.
    """
    state = PathState.initial(origins, directions)

    def step(carry, xs):
        u_b, b = xs
        new_state, rec = _bounce(scene, cfg, carry, u_b, b, ray_chunk)
        return new_state, rec

    u_scan = jnp.moveaxis(uniforms, 1, 0)  # (depth, N, NUM_U)
    bounces = jnp.arange(cfg.max_depth, dtype=jnp.int32)
    final, recs = jax.lax.scan(step, state, (u_scan, bounces))
    record = TraceRecord(
        log_pdf=jnp.moveaxis(recs[0], 0, 1),
        alive=jnp.moveaxis(recs[1], 0, 1),
        direct=jnp.moveaxis(recs[2], 0, 1),
        tri=jnp.moveaxis(recs[3], 0, 1),
        incident=jnp.moveaxis(recs[4], 0, 1),
    )
    return final.radiance, record


@partial(jax.jit, static_argnums=(1, 4))
def _trace_segment(scene, cfg: RenderConfig, state: PathState,
                   u_seg, ray_chunk, b0):
    """Scan ``u_seg.shape[1]`` bounces starting at (traced) bounce ``b0``
    without producing TraceRecords — the compacted tracer's inner unit.
    One compiled executable per (cfg, lane width, segment length)."""
    bounces = b0 + jnp.arange(u_seg.shape[1], dtype=jnp.int32)
    u_scan = jnp.moveaxis(u_seg, 1, 0)

    def step(carry, xs):
        u_b, b = xs
        new_state, _ = _bounce(scene, cfg, carry, u_b, b, ray_chunk)
        return new_state, None

    state, _ = jax.lax.scan(step, state, (u_scan, bounces))
    return state


def trace_paths_compact(
    scene: Scene,
    cfg: RenderConfig,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    uniforms: jnp.ndarray,
    ray_chunk: Optional[int] = None,
    segment: int = 2,
    min_width: int = 1 << 13,
) -> jnp.ndarray:
    """:func:`trace_paths` with host-driven multi-level tail compaction
    (``RenderConfig.compact_tail``): radiance only, no TraceRecord.

    The full-width scan keeps every lane resident for all ``max_depth``
    supersteps even though occupancy decays fast (measured on the fix1
    config, 300x300 d8: [1, .78, .62, .51, .43, .36, .30, ~0] — PERF.md
    §tail compaction).  Here the trace runs in ``segment``-bounce jitted
    chunks; between chunks the host reads the live-lane count and, while
    it is at or below half the current width, squeezes live lanes to the
    front (stable argsort — transport/photon._compact's pattern) and
    halves the width, gathering the per-lane uniform slices and original
    lane ids along.  Each width compiles once and is reused.

    Per-lane radiance is exact: per-lane math is elementwise,
    intersection/NEE results are order-independent, and dropped lanes
    are dead (their radiance is final when flushed with ``.set``) — the
    only deltas vs
    :func:`trace_paths` are compilation-partition rounding (the segmented
    jits fuse differently than one end-to-end jit; ~1 ulp, pinned at
    atol=1e-5 in tests/test_path_tracer.py).  Not usable under an outer
    jit (host sync) — api.render dispatches it only for the plain path
    integrator.
    """
    n0 = origins.shape[0]
    state = PathState.initial(origins, directions)
    out = jnp.zeros((n0, 3), origins.dtype)
    lane_ids = jnp.arange(n0, dtype=jnp.int32)
    b = 0
    while b < cfg.max_depth:
        seg = min(segment, cfg.max_depth - b)
        state = _trace_segment(scene, cfg, state, uniforms[:, b:b + seg],
                               ray_chunk, jnp.asarray(b, jnp.int32))
        b += seg
        width = state.alive.shape[0]
        if b >= cfg.max_depth or width <= min_width:
            continue
        n_alive = int(jax.device_get(jnp.sum(state.alive)))
        new_w = width
        while new_w > min_width and n_alive <= new_w // 2:
            new_w //= 2
        if new_w < width:
            # dead lanes' radiance is final — flush everyone, survivors
            # get overwritten by later (fuller) sets of the same
            # accumulation chain, so no lane's estimate changes
            out = out.at[lane_ids].set(state.radiance)
            order = jnp.argsort(~state.alive, stable=True)[:new_w]
            state = jax.tree.map(lambda a: a[order], state)
            uniforms = uniforms[order]
            lane_ids = lane_ids[order]
    return out.at[lane_ids].set(state.radiance)


def render_image_compact(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    ray_chunk: Optional[int] = None,
    return_samples: bool = False,
    sample_offset=0,
):
    """:func:`render_image` through the tail-compacting tracer (same
    estimate to ~1 ulp; host-driven, so not jittable end-to-end)."""
    origins, directions, uniforms = _camera_lanes(scene, cfg, key,
                                                  sample_offset)
    radiance = trace_paths_compact(scene, cfg, origins, directions,
                                   uniforms, ray_chunk=ray_chunk)
    image, samples = _to_image(radiance, cfg)
    if return_samples:
        return image, samples
    return image


def trace_paths_split(
    scene: Scene,
    cfg: RenderConfig,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    uniforms: jnp.ndarray,  # (N, max_depth, NUM_U)
    ray_chunk: Optional[int] = None,
    stack_size: Optional[int] = None,
    max_iters: Optional[int] = None,
) -> jnp.ndarray:
    """Deterministic both-branch Fresnel path tracing (``fresnel_mode=
    "split"``): the reference's recursive-PT estimator, src/render.py:121-153,
    which follows BOTH the reflected and the refracted branch of every
    transmissive hit with their Fresnel weights R / (1-R) instead of
    sampling one stochastically.  Lower variance on glass at equal spp.

    Shape: same lockstep ``_bounce`` superstep as
    :func:`trace_paths`, but lanes carry a per-lane *bounce counter* and a
    static-depth deferred-branch stack (the :func:`~light_transport_tpu.
    integrators.whitted.trace_whitted_queue` pattern).  At a transmissive
    hit the lane follows refraction (weight ``1-R``) and pushes reflection
    (weight ``R``, resuming at ``bounce+1``); when a lane dies it pops.
    Lanes whose stack is full fall back to the stochastic one-branch rule,
    so the estimator is unbiased at ANY ``stack_size`` — the split only
    reduces variance.  Host-driven loop with one jitted step;
    iterations are bounded by significant tree nodes.

    A deferred branch re-reads the SAME uniform rows its sibling consumed
    at equal depth — sibling branches are correlated but each is an
    unbiased continuation, so the mean is exact (matches the reference,
    whose pre-drawn ``rand_0/1[j,i]`` are likewise shared across the
    recursion tree at a pixel, src/scene.py:68-71).

    Returns ``radiance (N, 3)`` (no TraceRecord: the CV pipeline keeps the
    stochastic tracer, whose per-bounce records stay exact-gradient pure).
    """
    n = origins.shape[0]
    dtype = origins.dtype
    depth = cfg.max_depth
    S = stack_size if stack_size is not None else min(depth, 6)
    # Hard bound on host iterations: a lane visits at most
    # sum_{k<=S} C(depth, k) tree nodes (each root-to-leaf path can carry
    # at most S deferred splits — fuller stacks fall back to one-branch
    # sampling), plus one pop iteration per push.  The loop breaks as
    # soon as no lane is alive, so this cap never truncates live work
    # (the old min(2^d+1, 8d+1) cap silently dropped still-stacked
    # branches at depth >= 6, biasing glass dark — advisor r3).
    import math

    nodes = sum(math.comb(depth, k) for k in range(min(S, depth) + 1))
    iters = max_iters or 2 * nodes + 1

    state = PathState.initial(origins, directions)
    bounce_v = jnp.zeros((n,), jnp.int32)
    from light_transport_tpu.ops import lanestack

    stack = lanestack.zeros(
        (origins, directions, jnp.zeros((n, 3), dtype),
         jnp.zeros((n, 3), dtype), jnp.zeros((n,), dtype),
         jnp.zeros((n,), dtype), jnp.zeros((n, 3), dtype),
         jnp.zeros((n,), dtype), jnp.zeros((n,), dtype), bounce_v), S)
    top = jnp.zeros((n,), jnp.int32)
    for _ in range(iters):
        state, bounce_v, stack, top, any_alive = _split_step(
            scene, cfg, uniforms, state, bounce_v, stack, top, ray_chunk, S
        )
        if not bool(any_alive):
            break
    return state.radiance


@partial(jax.jit, static_argnums=(1, 7, 8))
def _split_step(scene, cfg, uniforms, state, bounce_v, stack, top,
                ray_chunk, S):
    """One split-tracer superstep (module-level jit: repeated renders reuse
    the compiled executable, and the uniform tensor arrives as a traced
    argument instead of being baked into the executable as a constant —
    a per-call closure used to recompile every render and embed the full
    (N, depth, NUM_U) array)."""
    from light_transport_tpu.ops import lanestack

    depth = cfg.max_depth
    u = jnp.take_along_axis(
        uniforms, jnp.clip(bounce_v, 0, depth - 1)[:, None, None], axis=1
    )[:, 0, :]
    # a deferred branch starting at bounce_v+1 >= depth would be dead on
    # arrival — don't split there (the depth cutoff, as in the reference
    # recursion's depth guard)
    split_ok = (top < S) & (bounce_v + 1 < depth)
    new_state, _, defer = _bounce(scene, cfg, state, u, bounce_v,
                                  ray_chunk, split_ok=split_ok)
    (d_mask, d_o, d_d, d_tp,
     d_ma, d_ms, d_mg, d_oa, d_os, d_og) = defer
    stack, top = lanestack.push(
        stack, top, d_mask,
        (d_o, d_d, d_tp, d_ma, d_ms, d_mg, d_oa, d_os, d_og,
         bounce_v + 1), S)

    new_bounce = bounce_v + 1
    alive = new_state.alive & (new_bounce < depth)

    # dead lanes resume their most recent deferred branch
    can_pop = ~alive & (top > 0)
    (p_o, p_d, p_tp, p_ma, p_ms, p_mg, p_oa, p_os, p_og,
     p_b) = lanestack.peek(stack, top, S)
    top = top - can_pop.astype(jnp.int32)

    def pick(pop_v, keep_v, vec=False):
        c = can_pop[:, None] if vec else can_pop
        return jnp.where(c, pop_v, keep_v)

    res_state = PathState(
        origin=pick(p_o, new_state.origin, vec=True),
        direction=pick(p_d, new_state.direction, vec=True),
        throughput=pick(p_tp, new_state.throughput, vec=True),
        radiance=new_state.radiance,
        alive=alive | can_pop,
        # a popped branch leaves a specular (transmissive) vertex:
        # emission on its next hit was unreachable by NEE
        emit_ok=jnp.where(can_pop, True, new_state.emit_ok),
        prev_pdf=jnp.where(can_pop, 0.0, new_state.prev_pdf),
        med_sig_a=pick(p_ma, new_state.med_sig_a, vec=True),
        med_sig_s=pick(p_ms, new_state.med_sig_s),
        med_g=pick(p_mg, new_state.med_g),
        out_sig_a=pick(p_oa, new_state.out_sig_a, vec=True),
        out_sig_s=pick(p_os, new_state.out_sig_s),
        out_g=pick(p_og, new_state.out_g),
    )
    res_bounce = jnp.where(can_pop, p_b, new_bounce)
    return res_state, res_bounce, stack, top, \
        jnp.any(res_state.alive)


def render_image_split(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    ray_chunk: Optional[int] = None,
    sample_offset=0,
):
    """Render with ``fresnel_mode="split"`` (host-driven; see
    :func:`trace_paths_split`).  Same image contract as
    :func:`render_image`."""
    origins, directions, uniforms = _camera_lanes(scene, cfg, key,
                                                  sample_offset)
    radiance = trace_paths_split(scene, cfg, origins, directions, uniforms,
                                 ray_chunk=ray_chunk)
    return _to_image(radiance, cfg)[0]


def _camera_lanes(scene: Scene, cfg: RenderConfig, key: jax.Array,
                  sample_offset=0):
    """AA-jittered camera-ray lanes + path uniforms — the shared render
    preamble, so the lane layout and key-split convention live in exactly
    one place (render_image / render_with_detectors / render_image_split
    used to carry three drifting copies; parallel.mesh.render_sharded is
    the fourth caller, which is what makes sobol/DOF apply to sharded
    renders automatically).

    ``cfg.sampler`` selects the random-input construction: "uniform" keeps
    the reference's pre-drawn-tensor contract with threefry draws
    (src/scene.py:68-71); "sobol" fills the SAME tensors with padded
    Owen-scrambled Sobol' points (ops/qmc.py) — tracing stays a pure
    function of the tensors either way."""
    n = cfg.height * cfg.width * cfg.spp
    u_lens = None
    if cfg.sampler == "sobol":
        from light_transport_tpu.ops import qmc

        seed_bits = jax.random.bits(key, dtype=jnp.uint32)
        u_aa, uniforms = qmc.render_uniforms(
            seed_bits, cfg.height, cfg.width, cfg.spp, cfg.max_depth,
            dtype=scene.camera.dtype, sample_offset=sample_offset)
        if cfg.aperture > 0.0:
            n_pix = cfg.height * cfg.width
            pix = jnp.tile(jnp.arange(n_pix, dtype=jnp.int32), cfg.spp)
            smp = jnp.repeat(
                jnp.asarray(sample_offset, jnp.int32)
                + jnp.arange(cfg.spp, dtype=jnp.int32), n_pix)
            lx, ly = qmc.scrambled_pair(pix, smp, qmc.LENS_PAIR, seed_bits,
                                        dtype=scene.camera.dtype)
            u_lens = jnp.stack([lx, ly], axis=-1)
    elif cfg.sampler == "uniform":
        if cfg.aperture > 0.0:
            k_aa, k_u, k_lens = jax.random.split(key, 3)
            u_lens = jax.random.uniform(k_lens, (n, 2),
                                        dtype=scene.camera.dtype)
        else:
            # two-way split kept for aperture=0 so the pinhole stream (and
            # every golden image) is bitwise unchanged
            k_aa, k_u = jax.random.split(key)
        u_aa = jax.random.uniform(k_aa, (n, 2), dtype=scene.camera.dtype)
        uniforms = rng.path_uniforms(k_u, n, cfg.max_depth,
                                     dtype=scene.camera.dtype)
    else:
        raise ValueError(
            f"unknown sampler {cfg.sampler!r} (expected 'uniform' or 'sobol')")
    origins, directions = camera_rays(scene, cfg, u_aa, u_lens)
    return origins, directions, uniforms


def _to_image(radiance: jnp.ndarray, cfg: RenderConfig):
    """(N, 3) s-major lane radiance -> ((H, W, 3) clipped image,
    (H, W, spp, 3) raw samples)."""
    samples = jnp.moveaxis(
        radiance.reshape(cfg.spp, cfg.height, cfg.width, 3), 0, 2)
    return jnp.clip(jnp.mean(samples, axis=2), 0.0, 1.0), samples


def camera_rays(scene: Scene, cfg: RenderConfig, u_aa: jnp.ndarray,
                u_lens: Optional[jnp.ndarray] = None):
    """Generate camera rays for every (pixel, sample) lane.

    Geometry contract: reference render loop (src/path_tracing.py:263-287):
    pixel grid y=linspace(top,bottom,H), x=linspace(left,right,W), screen at
    z=f_distance, ray = normalize(pixel - camera), AA jitter of one pixel's
    extent.  Deviation: the reference jitters x and y with the *same* uniform
    (rand[0][0] for both, :282-283); we use two independent ones.

    ``u_aa``: (N, 2) with N = H*W*spp.  Returns (origins, dirs) each (N, 3).
    ``u_lens``: (N, 2) aperture-point uniforms when ``cfg.aperture > 0``
    (thin-lens depth of field — extension over the reference's pinhole).
    """
    # lane layout: s-major [(s, i, j)] -> reshape (spp, H, W)
    n_pix = cfg.height * cfg.width
    pixel_ids = jnp.tile(jnp.arange(n_pix, dtype=jnp.int32), cfg.spp)
    return _pixel_camera_rays(scene, cfg, pixel_ids, u_aa, u_lens)


def _pixel_camera_rays(scene: Scene, cfg: RenderConfig,
                       pixel_ids: jnp.ndarray, u_aa: jnp.ndarray,
                       u_lens: Optional[jnp.ndarray] = None):
    """Camera rays for explicit pixel ids (row-major ``i*W + j``): the
    lane-level form of :func:`camera_rays` (same linspace grid, same
    jitter rule — gathered instead of tiled, bitwise-equal values), used
    by the adaptive renderer's non-uniform lane→pixel maps."""
    left, right, top, bottom = cfg.screen_bounds
    dtype = scene.camera.dtype
    xs = jnp.linspace(left, right, cfg.width, dtype=dtype)
    ys = jnp.linspace(top, bottom, cfg.height, dtype=dtype)
    px = xs[pixel_ids % cfg.width]
    py = ys[pixel_ids // cfg.width]
    jx = u_aa[:, 0] / cfg.width
    jy = u_aa[:, 1] / cfg.height
    pixel = jnp.stack(
        [px + jx, py + jy, jnp.full_like(px, cfg.f_distance)], axis=-1
    )
    origin = jnp.broadcast_to(scene.camera, pixel.shape)
    direction = lm.normalize(pixel - origin)
    if u_lens is not None and cfg.aperture > 0.0:
        # thin lens: keep the focal-plane point of each pinhole ray fixed,
        # jitter the origin on the aperture disk (the screen plane is
        # z-normal, so the lens disk lies in xy).  focus_distance <= 0
        # focuses on the screen plane itself.
        from light_transport_tpu.ops.sampling import concentric_sample_disk

        axial = jnp.abs(jnp.asarray(cfg.f_distance, dtype)
                        - scene.camera[2])
        focus = (jnp.asarray(cfg.focus_distance, dtype)
                 if cfg.focus_distance > 0.0 else axial)
        dz = jnp.maximum(jnp.abs(direction[:, 2]), 1e-6)
        focal_pt = origin + direction * (focus / dz)[:, None]
        lx, ly = concentric_sample_disk(u_lens[:, 0], u_lens[:, 1])
        offset = cfg.aperture * jnp.stack(
            [lx, ly, jnp.zeros_like(lx)], axis=-1)
        origin = origin + offset
        direction = lm.normalize(focal_pt - origin)
    return origin, direction


@partial(jax.jit, static_argnums=(1, 3, 4))
def render_image(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    ray_chunk: Optional[int] = None,
    return_samples: bool = False,
    sample_offset=0,
):
    """Render the scene: returns ``image (H, W, 3)`` clipped to [0, 1]
    (reference: np.clip at src/path_tracing.py:305), and optionally the raw
    per-sample radiances ``(H, W, spp, 3)``.

    jitted end-to-end (cfg static) — one device dispatch per render.
    ``sample_offset`` (traced int): sobol-sampler passes cover QMC sample
    indices ``[offset, offset+spp)`` — see :func:`render_progressive`;
    ignored by the uniform sampler.
    """
    origins, directions, uniforms = _camera_lanes(scene, cfg, key,
                                                  sample_offset)
    radiance, _ = trace_paths(
        scene, cfg, origins, directions, uniforms, ray_chunk=ray_chunk
    )
    image, samples = _to_image(radiance, cfg)
    if return_samples:
        return image, samples
    return image


@partial(jax.jit, static_argnums=(1, 3))
def render_with_detectors(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    ray_chunk: Optional[int] = None,
):
    """Render + per-surface detectors (BASELINE config 4): returns
    ``(image, energy (T,), hits (T,))`` where energy/hits accumulate the
    incident path power / hit count on every triangle.

    Always uses the stochastic tracer: detectors need the TraceRecord,
    which ``fresnel_mode="split"`` deliberately does not produce
    (trace_paths_split docstring) — a split config is still rendered,
    just with the one-branch estimator."""
    origins, directions, uniforms = _camera_lanes(scene, cfg, key)
    radiance, record = trace_paths(
        scene, cfg, origins, directions, uniforms, ray_chunk=ray_chunk
    )
    energy, hits = surface_detector_tally(record, scene.mesh.num_triangles)
    image, _ = _to_image(radiance, cfg)
    return image, energy, hits


def render_progressive(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    n_passes: int = 4,
    ray_chunk: Optional[int] = None,
):
    """Progressive refinement: average ``n_passes`` renders.

    The functional form of the reference's cross-invocation accumulation
    ``image += 0.25 * clip(color)`` (src/path_tracing_fix1.py:166) — each
    pass uses a folded key, so re-running with more passes only adds
    samples.  Returns the running average image.

    With ``cfg.sampler="sobol"`` the passes instead share one key and
    advance ``sample_offset`` by ``spp`` per pass, continuing a SINGLE
    QMC point set: the k-pass average equals the one-shot k*spp render
    up to the per-pass [0,1] clip inherited from the reference's
    accumulation rule (identical points, so the O(1/n) stratification
    keeps compounding across passes — independent realizations would
    fall back to averaging k estimates of 1/spp quality; pixels whose
    single-pass mean exceeds 1 clip earlier here, exactly as in
    src/path_tracing_fix1.py:166).
    """
    # honor cfg.fresnel_mode the same way api.render does
    render_one = (render_image_split if cfg.fresnel_mode == "split"
                  else render_image)
    qmc_seq = cfg.sampler == "sobol"
    acc = None
    for p in range(n_passes):
        img = render_one(
            scene, cfg, key if qmc_seq else jax.random.fold_in(key, p),
            ray_chunk=ray_chunk,
            sample_offset=jnp.asarray(p * cfg.spp if qmc_seq else 0,
                                      jnp.int32))
        acc = img if acc is None else acc + img
    return acc / n_passes
