"""Adaptive sampling (integrators/adaptive.py): exact budget accounting,
unbiasedness vs the uniform renderer, variance-driven allocation, and the
equal-budget MSE win."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from light_transport_tpu.integrators.adaptive import (
    _integer_alloc,
    render_adaptive,
)
from light_transport_tpu.scene.cornell import cornell_box_scene


def test_integer_alloc_sums_exactly():
    for seed in range(5):
        rng = np.random.default_rng(seed)
        w = jnp.asarray(rng.random(97) * rng.integers(1, 4, 97))
        a = np.asarray(_integer_alloc(w, 1234))
        assert a.sum() == 1234 and (a >= 0).all()
    # degenerate: all-zero weights still spend the budget
    a = np.asarray(_integer_alloc(jnp.zeros(10), 100))
    assert a.sum() == 100 and (a >= 0).all()


def test_adaptive_budget_exact_and_explores_every_pixel():
    scene, cfg = cornell_box_scene(width=12, height=12, spp=8, max_depth=2)
    img, counts = render_adaptive(scene, cfg, jax.random.key(0), rounds=4,
                                  return_counts=True)
    counts = np.asarray(counts)
    assert counts.sum() == 12 * 12 * 8  # the reference's exact budget
    # round 0 is uniform, so every pixel owns at least spp/rounds samples
    assert counts.min() >= 8 // 4
    # and the later rounds actually re-allocate (not uniform throughout)
    assert counts.max() > 8
    assert np.asarray(img).shape == (12, 12, 3)


def test_adaptive_spp_must_divide():
    scene, cfg = cornell_box_scene(width=4, height=4, spp=10, max_depth=1)
    with pytest.raises(ValueError, match="divisible"):
        render_adaptive(scene, cfg, jax.random.key(0), rounds=4)


def test_adaptive_rejects_split_fresnel():
    # the adaptive rounds only trace the stochastic-Fresnel tracer;
    # api.render must refuse rather than silently change the estimator
    from light_transport_tpu.api import render

    scene, cfg = cornell_box_scene(width=4, height=4, spp=4, max_depth=1)
    cfg = dataclasses.replace(cfg, fresnel_mode="split")
    with pytest.raises(ValueError, match="stochastic"):
        render(scene, cfg, integrator="adaptive")


def test_adaptive_unbiased_vs_reference():
    """Adaptive pixel means must agree with a high-spp uniform reference:
    allocation depends only on previous rounds, so each pixel's mean stays
    an unbiased estimator."""
    from light_transport_tpu.integrators.path_tracer import (
        render_progressive)

    scene, cfg = cornell_box_scene(width=12, height=12, spp=16, max_depth=2)
    ref = np.asarray(render_progressive(scene, cfg, jax.random.key(99),
                                        n_passes=48))
    imgs = [np.asarray(render_adaptive(scene, cfg, jax.random.key(s),
                                       rounds=4)) for s in range(4)]
    mean = np.mean(imgs, axis=0)
    # seed-averaged image converges on the reference (global + per-pixel)
    assert abs(mean.mean() - ref.mean()) < 0.01
    assert np.abs(mean - ref).mean() < 0.03


def test_adaptive_beats_uniform_at_equal_budget():
    """Equal total budget, MSE vs a high-spp reference: the adaptive
    allocation must not lose to uniform, and composed with the sobol
    sampler must win materially (thresholds calibrated in
    /tmp smoke + PERF.md §sampler)."""
    from light_transport_tpu.integrators.path_tracer import (
        render_image, render_progressive)

    scene, cfg = cornell_box_scene(width=16, height=16, spp=16, max_depth=2)
    ref = np.asarray(render_progressive(scene, cfg, jax.random.key(99),
                                        n_passes=48))

    def mse(fn):
        return float(np.mean([
            ((np.asarray(fn(s)) - ref) ** 2).mean() for s in range(3)]))

    m_uni = mse(lambda s: render_image(scene, cfg, jax.random.key(s)))
    m_ad = mse(lambda s: render_adaptive(scene, cfg, jax.random.key(s),
                                         rounds=4))
    cq = dataclasses.replace(cfg, sampler="sobol")
    m_adq = mse(lambda s: render_adaptive(scene, cq, jax.random.key(s),
                                          rounds=4))
    assert m_ad < 1.15 * m_uni, (m_ad, m_uni)
    assert m_adq < 0.8 * m_uni, (m_adq, m_uni)


def test_one_sample_pixels_do_not_steer_allocation():
    """After the first round every pixel holds one sample and no variance
    estimate, so the second round must spread its budget uniformly.  The
    jitted l2 - l*l of a one-sample pixel is not zero where the compiler
    fuses it into a multiply-add; that residue must not count as
    variance."""
    from light_transport_tpu.integrators.adaptive import _round

    scene, cfg = cornell_box_scene(width=12, height=12, spp=4, max_depth=2)
    n_pix = 12 * 12
    stats = (jnp.zeros((n_pix, 3)), jnp.zeros((n_pix,)), jnp.zeros((n_pix,)),
             jnp.zeros((n_pix,), jnp.int32))
    for r in range(2):
        stats, alloc = _round(scene, cfg, jax.random.key(3), n_pix, stats,
                              jnp.asarray(r, jnp.int32), None)
        np.testing.assert_array_equal(np.asarray(alloc), 1)
    assert (np.asarray(stats[3]) == 2).all()
