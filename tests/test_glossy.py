"""Glossy (modified-Phong) BSDF: sampler/pdf/f consistency and
integrator-level parity.

The capability promotes the reference's Whitted-only Phong specular term
(src/brdf.py:36-48) into a sampled, NEE/MIS-aware BSDF lobe — a deliberate
extension (the reference's path-transport BSDFs are diffuse/mirror/
transmissive only).  Test strategy follows SURVEY.md §4: golden-value
sampler tests against closed forms, MC cross-estimator parity.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from light_transport_tpu.core import math as lm
from light_transport_tpu.ops import sampling
from light_transport_tpu.scene.material import Color, Material

SHIN = 24.0
KD = (0.25, 0.25, 0.30)
KS = (0.65, 0.65, 0.60)

GLOSSY_MAT = Material(
    color=Color.of((0.0, 0.0, 0.0), KD, KS),
    shininess=SHIN, is_diffuse=False, is_glossy=True,
)


def _uniforms(n, seed=0, k=2):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.random(n).astype(np.float32)) for _ in range(k)]


def _sample_glossy(n_s, m_dir, kd, ks, shin, u0, u1):
    """The path tracer's glossy sampling rule (_bounce): lobe choice by
    rescaled u0, cosine lobe about n_s or Phong lobe about m_dir."""
    q = sampling.glossy_mix(kd, ks)
    pick_spec = u0 < q
    u0r = jnp.clip(jnp.where(
        pick_spec, u0 / jnp.maximum(q, 1e-12),
        (u0 - q) / jnp.maximum(1.0 - q, 1e-12)), 0.0, 1.0)
    gd, _ = sampling.cosine_weighted_hemisphere(n_s, u0r, u1)
    gs = sampling.sample_phong_lobe(m_dir, shin, u0r, u1)
    d = jnp.where(pick_spec[:, None], gs, gd)
    pdf = sampling.glossy_pdf(kd, ks, shin, n_s, m_dir, d)
    return d, pdf


def test_glossy_sample_chi2_normal_incidence():
    """At normal incidence the lobe axis coincides with the normal, so the
    sampled cos(theta) has the closed-form CDF
    F(c) = (1-q) c^2 + q c^(n+1) — chi-squared the histogram against it."""
    n = 1 << 16
    u0, u1 = _uniforms(n, seed=3)
    n_s = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (n, 1))
    kd = jnp.tile(jnp.asarray([KD], jnp.float32), (n, 1))
    ks = jnp.tile(jnp.asarray([KS], jnp.float32), (n, 1))
    d, _ = _sample_glossy(n_s, n_s, kd, ks, SHIN, u0, u1)
    cos = np.asarray(d[:, 2], np.float64)
    assert np.all(cos >= -1e-6)
    q = float(sampling.glossy_mix(kd[:1], ks[:1])[0])
    edges = np.linspace(0.0, 1.0, 41)
    counts, _ = np.histogram(cos, bins=edges)
    cdf = (1 - q) * edges**2 + q * edges ** (SHIN + 1.0)
    expected = np.diff(cdf) * n
    mask = expected > 10
    chi2 = np.sum((counts[mask] - expected[mask]) ** 2 / expected[mask])
    dof = mask.sum() - 1
    assert chi2 < dof + 4 * np.sqrt(2 * dof), (chi2, dof)


def test_glossy_pdf_normalizes_tilted():
    """The combined pdf integrates to 1 over the full sphere even with a
    tilted lobe axis (part of the Phong lobe dips below the horizon) —
    uniform-sphere MC of the claimed density."""
    n = 1 << 17
    rng = np.random.default_rng(7)
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    w = jnp.asarray(w, jnp.float32)
    n_s = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (n, 1))
    d_in = lm.normalize(jnp.asarray([[0.6, 0.2, -0.77]], jnp.float32))
    m = lm.reflect(jnp.tile(d_in, (n, 1)), n_s)
    kd = jnp.tile(jnp.asarray([KD], jnp.float32), (n, 1))
    ks = jnp.tile(jnp.asarray([KS], jnp.float32), (n, 1))
    pdf = np.asarray(sampling.glossy_pdf(kd, ks, SHIN, n_s, m, w),
                     np.float64)
    integral = pdf.mean() * 4.0 * np.pi
    se = pdf.std() * 4.0 * np.pi / np.sqrt(n)
    assert abs(integral - 1.0) < 4 * se + 1e-3, (integral, se)


def test_glossy_furnace_normal_incidence():
    """Directional-albedo identity: at normal incidence
    E[f cos / p] = kd + ks exactly (the Phong integral hits its full
    normalization) — the furnace-style check that sampler, pdf, and f are
    mutually consistent, per channel."""
    n = 1 << 17
    u0, u1 = _uniforms(n, seed=5)
    n_s = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (n, 1))
    kd = jnp.tile(jnp.asarray([KD], jnp.float32), (n, 1))
    ks = jnp.tile(jnp.asarray([KS], jnp.float32), (n, 1))
    d, pdf = _sample_glossy(n_s, n_s, kd, ks, SHIN, u0, u1)
    f = sampling.glossy_f(kd, ks, SHIN, n_s, d)
    cos = jnp.maximum(d[:, 2], 0.0)
    ok = pdf > 0.0
    est = np.asarray(
        jnp.where(ok[:, None], f * (cos / jnp.where(ok, pdf, 1.0))[:, None],
                  0.0), np.float64)
    mean = est.mean(axis=0)
    se = est.std(axis=0) / np.sqrt(n)
    target = np.asarray(KD, np.float64) + np.asarray(KS, np.float64)
    assert np.all(np.abs(mean - target) < 4 * se + 1e-3), (mean, target, se)


def test_glossy_energy_conservation_tilted():
    """At grazing-ish incidence part of the Phong lobe is cut by the
    horizon, so the directional albedo must be <= kd + ks (and well below
    the normal-incidence value for low exponents) — no energy creation."""
    n = 1 << 17
    u0, u1 = _uniforms(n, seed=6)
    n_s = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (n, 1))
    d_in = lm.normalize(jnp.asarray([[0.9, 0.0, -0.436]], jnp.float32))
    m = lm.reflect(jnp.tile(d_in, (n, 1)), n_s)
    kd = jnp.tile(jnp.asarray([KD], jnp.float32), (n, 1))
    ks = jnp.tile(jnp.asarray([KS], jnp.float32), (n, 1))
    d, pdf = _sample_glossy(n_s, m, kd, ks, SHIN, u0, u1)
    f = sampling.glossy_f(kd, ks, SHIN, m, d)
    cos = lm.dot(d, n_s)
    ok = (pdf > 0.0) & (cos > 0.0)  # the tracer's below-horizon rule
    est = np.asarray(
        jnp.where(ok[:, None], f * (jnp.maximum(cos, 0.0)
                                    / jnp.where(ok, pdf, 1.0))[:, None],
                  0.0), np.float64)
    mean = est.mean(axis=0)
    target = np.asarray(KD, np.float64) + np.asarray(KS, np.float64)
    assert np.all(mean <= target + 4 * est.std(axis=0) / np.sqrt(n) + 1e-3)
    assert np.all(mean > 0.1)  # and it reflects a sane amount


def _glossy_scene(**kw):
    from light_transport_tpu.scene.cornell import cornell_box_scene

    return cornell_box_scene(cone_material=GLOSSY_MAT, **kw)


def test_glossy_render_sane_and_distinct():
    """A glossy cone renders finite, in range, and visibly different from
    the all-diffuse render (the lobe is live), with a NEE direct term on
    the cone (glossy vertices cast shadow rays)."""
    from light_transport_tpu.api import render

    scene, cfg = _glossy_scene(width=24, height=24, spp=8, max_depth=3)
    cfg = dataclasses.replace(cfg, emission_mode="nee")
    img = np.asarray(render(scene, cfg, seed=0))
    assert np.all(np.isfinite(img)) and img.min() >= 0 and img.max() <= 1
    assert img.mean() > 0.05
    from light_transport_tpu.scene.cornell import cornell_box_scene

    diffuse_cone = Material(color=Color.of((0, 0, 0), KD, KS),
                            shininess=SHIN)
    scene_d, _ = cornell_box_scene(width=24, height=24, spp=8, max_depth=3,
                                   cone_material=diffuse_cone)
    img_d = np.asarray(render(scene_d, cfg, seed=0))
    assert np.abs(img - img_d).max() > 0.02  # the specular lobe shows up


def test_glossy_mis_matches_nee_mean():
    """emission_mode='mis' re-weights NEE vs BSDF light hits at glossy
    vertices; both estimators are unbiased, so the means must agree
    within MC error."""
    from light_transport_tpu.api import render

    scene, cfg = _glossy_scene(width=20, height=20, spp=24, max_depth=3)
    a = np.asarray(render(scene, dataclasses.replace(
        cfg, emission_mode="nee"), seed=1))
    b = np.asarray(render(scene, dataclasses.replace(
        cfg, emission_mode="mis"), seed=2))
    assert abs(a.mean() - b.mean()) < 0.012, (a.mean(), b.mean())


@pytest.mark.slow
def test_bdpt_glossy_parity():
    """PT and BDPT are both unbiased on the glossy-cone scene — the
    cross-estimator check that the glossy f/pdf plumbing threaded through
    every BDPT strategy (walk, connections, MIS junctions) is consistent
   ."""
    from light_transport_tpu.integrators.bdpt import render_bdpt
    from light_transport_tpu.integrators.path_tracer import render_image

    scene, cfg = _glossy_scene(width=20, height=20, spp=32, max_depth=3)
    cfg = dataclasses.replace(cfg, emission_mode="nee")
    img_pt = np.asarray(render_image(scene, cfg, jax.random.key(0)))
    img_bd = np.asarray(render_bdpt(scene, cfg, jax.random.key(1)))
    assert abs(img_pt.mean() - img_bd.mean()) < 0.012, (
        img_pt.mean(), img_bd.mean())


def test_whitted_glossy_runs():
    """Whitted shades glossy materials through its own Phong terms (the
    reference's original home for them) — must render finite/sane."""
    from light_transport_tpu.api import render

    scene, cfg = _glossy_scene(width=16, height=16, spp=1, max_depth=2)
    cfg = dataclasses.replace(cfg, spp=1)
    img = np.asarray(render(scene, cfg, seed=0, integrator="whitted"))
    assert np.all(np.isfinite(img)) and img.mean() > 0.0
