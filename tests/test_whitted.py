import pytest
import jax
import numpy as np

from light_transport_tpu.api import render
from light_transport_tpu.core.config import RenderConfig
from light_transport_tpu.scene.cornell import cornell_box_scene


def test_whitted_render_sane():
    scene, cfg = cornell_box_scene(width=32, height=32, spp=1, max_depth=2)
    img = np.asarray(render(scene, cfg, integrator="whitted"))
    assert img.shape == (32, 32, 3)
    assert np.all(np.isfinite(img))
    assert 0.0 <= img.min() and img.max() <= 1.0
    assert img.mean() > 0.05  # lit scene
    # left/right wall hue check
    left, right = img[16, 2], img[16, -3]
    assert left[0] > left[1]
    assert right[1] > right[0]


def test_whitted_deterministic():
    scene, cfg = cornell_box_scene(width=16, height=16, spp=1, max_depth=2)
    a = np.asarray(render(scene, cfg, integrator="whitted", seed=0))
    b = np.asarray(render(scene, cfg, integrator="whitted", seed=1))
    # no stochastic terms by default -> identical regardless of seed
    np.testing.assert_array_equal(a, b)


def test_whitted_shadowing():
    # the cone occludes the ceiling light: the floor region below it must be
    # no brighter than in the identical scene without the cone
    scene_c, cfg = cornell_box_scene(width=48, height=48, spp=1, max_depth=0)
    scene_o, _ = cornell_box_scene(width=48, height=48, spp=1, max_depth=0,
                                   include_cone=False)
    img_c = np.asarray(render(scene_c, cfg, integrator="whitted"))
    img_o = np.asarray(render(scene_o, cfg, integrator="whitted"))
    floor = (slice(40, 47), slice(18, 30))
    assert img_c[floor].mean() < img_o[floor].mean() - 0.01


@pytest.mark.slow
def test_whitted_indirect_option():
    from light_transport_tpu.integrators.whitted import render_whitted

    scene, cfg = cornell_box_scene(width=12, height=12, spp=1, max_depth=1)
    base = np.asarray(render_whitted(scene, cfg, jax.random.key(0)))
    ind = np.asarray(
        render_whitted(scene, cfg, jax.random.key(0), indirect_samples=2)
    )
    assert np.all(np.isfinite(ind))
    assert ind.mean() >= base.mean() - 1e-6  # indirect only adds energy


def test_whitted_queue_matches_unrolled():
    """The iterative weighted ray queue (trace_whitted_queue) must
    reproduce the statically unrolled tree at shallow depth
    (same shading per node; only sub-cutoff subtrees differ) and complete
    a depth-8 render — infeasible for the 2^depth unrolled form — in a
    bounded number of supersteps."""
    import dataclasses
    import time

    import jax.numpy as jnp

    from light_transport_tpu.integrators.path_tracer import camera_rays
    from light_transport_tpu.integrators.whitted import (
        render_whitted,
        trace_whitted,
        trace_whitted_queue,
    )

    scene, cfg = cornell_box_scene(width=16, height=16, spp=1, max_depth=3)
    n = cfg.height * cfg.width
    cfg1 = dataclasses.replace(cfg, spp=1)
    # jittered rays: the no-AA grid puts rays exactly on box corners, where
    # jit FMA contraction vs eager evaluation flips watertight edge hits —
    # the queue's step is jitted, so degenerate rays would compare a jitted
    # against an eager intersector instead of the two traversal orders
    u_aa = jax.random.uniform(jax.random.key(4), (n, 2))
    o, d = camera_rays(scene, cfg1, u_aa)
    unrolled = np.asarray(jax.jit(
        lambda o, d: trace_whitted(scene, o, d, 3))(o, d))
    queued = np.asarray(trace_whitted_queue(scene, o, d, 3))
    # dropped sub-cutoff subtrees bound the difference by a few times the
    # 1e-3 weight cutoff (local radiance can exceed 1)
    np.testing.assert_allclose(queued, unrolled, atol=6e-3)

    # depth-8 completes (render_whitted auto-switches to the queue there)
    deep_cfg = dataclasses.replace(cfg, max_depth=8)
    t0 = time.time()
    img = np.asarray(render_whitted(scene, deep_cfg, jax.random.key(0)))
    assert np.isfinite(img).all() and img.shape == (16, 16, 3)
    assert img.mean() > 0.05
    # deeper recursion only adds energy on this scene
    shallow = np.asarray(render_whitted(scene, cfg, jax.random.key(0)))
    assert img.mean() >= shallow.mean() - 1e-4


def test_indirect_samples_applied_on_deep_queue_path():
    """indirect_samples used to be dropped silently when max_depth > 4
    routed to the ray queue (advisor r3); both paths must add the same
    hemisphere indirect-diffuse term."""
    import dataclasses

    import jax
    import numpy as np

    from light_transport_tpu.integrators.whitted import render_whitted
    from light_transport_tpu.scene.cornell import cornell_box_scene

    scene, cfg = cornell_box_scene(width=12, height=12, spp=1, max_depth=5)
    key = jax.random.key(7)
    base = np.asarray(render_whitted(scene, cfg, key))
    with_ind = np.asarray(render_whitted(scene, cfg, key,
                                         indirect_samples=2))
    # the term is additive pre-clip: it must change the image...
    assert np.abs(with_ind - base).max() > 1e-4
    # ...and match the unrolled path's term at the shared depth-4 point
    cfg4 = dataclasses.replace(cfg, max_depth=4)
    b4 = np.asarray(render_whitted(scene, cfg4, key))
    w4 = np.asarray(render_whitted(scene, cfg4, key, indirect_samples=2))
    # same scene/key: deep-queue delta tracks the unrolled delta closely
    # (they differ only through the secondary tracer's extra depth)
    d_deep = (with_ind - base).mean()
    d_unrl = (w4 - b4).mean()
    assert d_deep > 0 and d_unrl > 0
    assert abs(d_deep - d_unrl) < 0.5 * max(d_deep, d_unrl)


def test_whitted_queue_full_tree_glass_depth5():
    """advisor r3: the queue's default iteration cap (2^depth + 1) was
    below the worst-case significant-node count 2^(depth+1) - 1, silently
    dropping un-popped subtrees on glass-heavy scenes where every branch
    weight stays above the cutoff (at depth 4: old cap 17 < 31 worst-case
    nodes).  The glass scene exercises a
    dense reflect/refract tree; queue and unrolled must now agree up to the
    cutoff-bounded subtree drops."""
    import dataclasses

    import jax.numpy as jnp

    from light_transport_tpu.integrators.path_tracer import camera_rays
    from light_transport_tpu.integrators.whitted import (
        trace_whitted,
        trace_whitted_queue,
    )
    from light_transport_tpu.models.presets import glass_scene

    scene, cfg = glass_scene(width=12, height=12, spp=1, max_depth=4)
    n = cfg.height * cfg.width
    cfg1 = dataclasses.replace(cfg, spp=1)
    u_aa = jax.random.uniform(jax.random.key(9), (n, 2))
    o, d = camera_rays(scene, cfg1, u_aa)
    unrolled = np.asarray(jax.jit(
        lambda o, d: trace_whitted(scene, o, d, 4))(o, d))
    queued = np.asarray(trace_whitted_queue(scene, o, d, 4))
    np.testing.assert_allclose(queued, unrolled, atol=2e-2)
    # tight cutoff shrinks the gap (proves the residual is the documented
    # sub-cutoff subtree drop, not lost stack entries).  The bound is on
    # the 95th percentile: a handful of rays grazing the curved glass can
    # flip a watertight edge decision between the two (differently
    # compiled) traversal orders, moving one lane's whole subtree — a
    # dropped-stack bug would instead shift a large fraction of lanes.
    queued_tight = np.asarray(
        trace_whitted_queue(scene, o, d, 4, weight_cutoff=1e-5))
    err = np.abs(queued_tight - unrolled)
    assert np.quantile(err, 0.95) < 2e-3, np.quantile(err, [0.5, 0.95, 1.0])
    assert err.max() < 5e-2, err.max()


def test_whitted_full_depth_indirect():
    """indirect_mode='full': the queue recurses the
    hemisphere GI term at every node like src/render_old.py:186-194.  It
    must add energy relative to no-indirect, stay close to the
    primary-only estimate (the recursion's extra terms carry a 0.01*
    albedo^2 factor), and stay finite/clipped."""
    import numpy as np

    from light_transport_tpu.integrators.whitted import render_whitted
    from light_transport_tpu.models.presets import hard_shadow_scene

    scene, cfg = hard_shadow_scene(width=48, height=48)
    key = jax.random.key(2)
    img0 = np.asarray(render_whitted(scene, cfg, key))
    img_p = np.asarray(render_whitted(scene, cfg, key,
                                      indirect_samples=4))
    img_f = np.asarray(render_whitted(scene, cfg, key,
                                      indirect_samples=4,
                                      indirect_mode="full"))
    assert np.isfinite(img_f).all()
    # GI adds energy over the no-indirect render
    assert img_f.mean() > img0.mean()
    # ... and the full recursion adds only a small second-order term over
    # the primary-only estimate (different RNG streams -> loose bound)
    assert abs(img_f.mean() - img_p.mean()) < 0.05 * max(img_p.mean(), 1e-6)
