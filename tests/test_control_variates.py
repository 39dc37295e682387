import jax
import jax.numpy as jnp
import numpy as np
import pytest

from light_transport_tpu.core import rng
from light_transport_tpu.core.config import RenderConfig
from light_transport_tpu.integrators.control_variates import (
    cv_correct,
    grad_log_pdf_exact,
    grad_log_pdf_fd,
    render_cv,
)
from light_transport_tpu.integrators.path_tracer import camera_rays
from light_transport_tpu.scene.cornell import cornell_box_scene


@pytest.fixture(scope="module")
def setup():
    scene, cfg = cornell_box_scene(width=12, height=12, spp=8, max_depth=3)
    n = cfg.height * cfg.width * cfg.spp
    key = jax.random.key(0)
    k_aa, k_u = jax.random.split(key)
    u_aa = jax.random.uniform(k_aa, (n, 2))
    uniforms = rng.path_uniforms(k_u, n, cfg.max_depth)
    o, d = camera_rays(scene, cfg, u_aa)
    return scene, cfg, o, d, uniforms


@pytest.mark.slow
def test_exact_matches_fd(setup):
    """The exact score must agree with the reference's FD scheme wherever
    the FD stencil doesn't cross a path discontinuity."""
    scene, cfg, o, d, uniforms = setup
    r1, lp1, g_exact = grad_log_pdf_exact(scene, cfg, o, d, uniforms)
    r2, lp2, g_fd = grad_log_pdf_fd(scene, cfg, o, d, uniforms, step=1e-3)
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
    ge, gf = np.asarray(g_exact), np.asarray(g_fd)
    # agreement on the (vast) majority of slots; FD occasionally straddles a
    # discrete path change (RR kill, branch flip) where the true grad is a
    # delta the FD smears
    close = np.isclose(ge, gf, rtol=5e-2, atol=5e-2)
    assert close.mean() > 0.9, close.mean()


def test_exact_grad_diagonal_structure(setup):
    """The BSDF pdf at bounce b depends only on that bounce's own uniforms,
    so the score = sum over bounces of local scores; alive lanes with a
    diffuse bounce at b must have nonzero grad in slot b or b+D."""
    scene, cfg, o, d, uniforms = setup
    _, log_pdf, g = grad_log_pdf_exact(scene, cfg, o, d, uniforms)
    lp = np.asarray(log_pdf)
    gg = np.asarray(g)
    dd = cfg.max_depth
    # lanes where bounce 0 shaded diffuse (log_pdf != 0)
    lane = np.nonzero(lp[:, 0] != 0.0)[0]
    assert lane.size > 0
    nz = (np.abs(gg[lane, 0]) > 1e-7) | (np.abs(gg[lane, dd]) > 1e-7)
    assert nz.mean() > 0.95


def test_cv_correct_reduces_variance_synthetic():
    """On a synthetic problem where samples correlate with the control, the
    per-pixel solve must cut variance hard (control has zero mean)."""
    key = jax.random.key(1)
    p, s, c = 32, 64, 4
    kc, kn = jax.random.split(key)
    control = jax.random.normal(kc, (p, s, c))
    noise = 0.1 * jax.random.normal(kn, (p, s, 3))
    beta = jnp.asarray([[1.0, -2.0, 0.5, 0.0], [0.0, 1.0, 1.0, -1.0],
                        [2.0, 0.0, 0.0, 1.0]])
    samples = 5.0 + jnp.einsum("psc,rc->psr", control, beta) + noise
    corrected, singular = cv_correct(samples, control)
    v_before = float(jnp.var(samples, axis=1).mean())
    v_after = float(jnp.var(corrected, axis=1).mean())
    assert v_after < 0.05 * v_before, (v_before, v_after)
    # the control has zero *expectation*, so the corrected estimate is
    # unbiased and its per-pixel mean lands much closer to the true mean
    # (5.0) than the raw sample mean does
    err_raw = np.abs(np.asarray(samples.mean(axis=1)) - 5.0)
    err_cv = np.abs(np.asarray(corrected.mean(axis=1)) - 5.0)
    assert err_cv.mean() < 0.2 * err_raw.mean(), (err_raw.mean(), err_cv.mean())
    assert not bool(singular.any())


def test_cv_correct_singular_fallback():
    # constant control -> singular covariance; pixel falls back to raw
    samples = jnp.ones((4, 8, 3)) * jnp.arange(8.0)[None, :, None]
    control = jnp.zeros((4, 8, 2))
    corrected, singular = cv_correct(samples, control)
    np.testing.assert_allclose(np.asarray(corrected), np.asarray(samples),
                               atol=1e-5)


def test_render_cv_end_to_end():
    scene, cfg = cornell_box_scene(width=10, height=10, spp=16, max_depth=3)
    out = render_cv(scene, cfg, jax.random.key(2), mode="exact")
    for img in (out.image_plain, out.image_cv):
        a = np.asarray(img)
        assert a.shape == (10, 10, 3)
        assert np.all(np.isfinite(a)) and a.min() >= 0 and a.max() <= 1
    # the reference's own quality check: the two estimators agree on average
    # (LTS.ipynb cells 37-38 image-MAE cross-validation)
    from light_transport_tpu.tally.stats import image_mae

    assert image_mae(out.image_plain, out.image_cv) < 0.15
    assert out.grad_log_pdf.shape == (10, 10, 16, 6)


@pytest.mark.slow
def test_cv_pixel_dive():
    from light_transport_tpu.integrators.control_variates import cv_pixel_dive

    scene, cfg = cornell_box_scene(width=20, height=20, spp=4, max_depth=3)
    # the reference's idiom: hand-picked pixels, many more samples
    dive = cv_pixel_dive(scene, cfg, jax.random.key(4),
                         pixels=[(5, 10), (15, 3)], n_samples=64)
    assert dive.samples.shape == (2, 64, 3)
    assert dive.grad_log_pdf.shape == (2, 64, 6)
    assert np.all(np.isfinite(np.asarray(dive.pixel_cv)))
    # CV-corrected per-pixel variance should not exceed the plain variance
    # (by much) on average
    v_plain = np.asarray(dive.samples).var(axis=1).mean()
    v_cv = np.asarray(dive.corrected).var(axis=1).mean()
    assert v_cv <= v_plain * 1.2, (v_plain, v_cv)


def _cv_correct_f64(samples, control):
    """Plain float64 numpy form of the per-pixel CV solve."""
    out = []
    for s, c in zip(np.asarray(samples, np.float64),
                    np.asarray(control, np.float64)):
        x = np.concatenate([s, c], axis=1)
        x = x - x.mean(axis=0, keepdims=True)
        cov = x.T @ x
        d = s.shape[1]
        alpha = -(cov[:d, d:] @ np.linalg.pinv(cov[d:, d:]))
        out.append(s + (alpha @ c.T).T)
    return np.stack(out)


def test_cv_correct_matches_float64_solve():
    """Correlated controls (a near-collinear pair) against the float64
    solve; every matrix product in the traced solve is pinned to HIGHEST
    precision, so a GPU cannot run it as TF32."""
    rng = np.random.default_rng(4)
    p, s = 16, 64
    base = rng.normal(size=(p, s, 2))
    control = np.concatenate(
        [base, base[..., :1] + 0.05 * rng.normal(size=(p, s, 1))], axis=-1)
    beta = np.array([[1.0, -2.0, 0.5], [0.3, 1.0, 1.0], [2.0, 0.0, -1.0]])
    samples = 3.0 + control @ beta.T + 0.1 * rng.normal(size=(p, s, 3))
    got, singular = cv_correct(jnp.asarray(samples, jnp.float32),
                               jnp.asarray(control, jnp.float32))
    ref = _cv_correct_f64(samples, control)
    assert not bool(singular.any())
    np.testing.assert_allclose(np.asarray(got), ref, atol=2e-3)
    jaxpr = jax.make_jaxpr(cv_correct)(jnp.asarray(samples, jnp.float32),
                                       jnp.asarray(control, jnp.float32))
    dots = [e for e in _all_eqns(jaxpr.jaxpr)
            if e.primitive.name == "dot_general"]
    assert len(dots) >= 3
    for e in dots:
        assert e.params["precision"] == (jax.lax.Precision.HIGHEST,) * 2, e


def _all_eqns(jaxpr):
    """Every equation of ``jaxpr`` and of the jaxprs nested in its params
    (vmap, pjit, custom rules)."""
    for e in jaxpr.eqns:
        yield e
        for v in e.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    yield from _all_eqns(sub)
