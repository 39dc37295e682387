import jax
import jax.numpy as jnp
import numpy as np
import pytest

from light_transport_tpu.core import math as lm
from light_transport_tpu.core import rng
from light_transport_tpu.core.config import RenderConfig
from light_transport_tpu.integrators.path_tracer import (
    camera_rays,
    render_image,
    trace_paths,
)
from light_transport_tpu.scene.cornell import cornell_box_scene
from light_transport_tpu.scene.geometry import TriangleMesh, quad_triangles
from light_transport_tpu.scene.material import Material, MaterialTable, presets
from light_transport_tpu.scene.scene import Scene


@pytest.fixture(scope="module")
def small_scene():
    return cornell_box_scene(width=24, height=24, spp=4, max_depth=3)


def test_camera_rays_geometry(small_scene):
    scene, cfg = small_scene
    n = cfg.height * cfg.width * cfg.spp
    u_aa = jnp.zeros((n, 2))
    o, d = camera_rays(scene, cfg, u_aa)
    assert o.shape == (n, 3) and d.shape == (n, 3)
    np.testing.assert_allclose(
        np.asarray(o), np.broadcast_to(np.asarray(scene.camera), o.shape),
        atol=1e-6,
    )
    np.testing.assert_allclose(np.asarray(lm.norm(d)), 1.0, atol=1e-5)
    # rays point into the box (-z; camera is at z = dim + 0.5, screen at dim)
    assert np.all(np.asarray(d[:, 2]) < 0)
    # first lane is the top-left pixel: direction has +y (top) and -x (left)
    d0 = np.asarray(d[0])
    assert d0[0] < 0 and d0[1] > 0


def test_render_image_sane(small_scene):
    scene, cfg = small_scene
    img = render_image(scene, cfg, jax.random.key(0))
    img = np.asarray(img)
    assert img.shape == (cfg.height, cfg.width, 3)
    assert np.all(np.isfinite(img))
    assert img.min() >= 0.0 and img.max() <= 1.0
    assert img.mean() > 0.02  # not black
    # left wall is red-ish, right wall green-ish in the LTS scene
    left = img[12, 1]
    right = img[12, -2]
    assert left[0] > left[1]
    assert right[1] > right[0]


def test_render_deterministic(small_scene):
    scene, cfg = small_scene
    a = np.asarray(render_image(scene, cfg, jax.random.key(7)))
    b = np.asarray(render_image(scene, cfg, jax.random.key(7)))
    np.testing.assert_array_equal(a, b)
    c = np.asarray(render_image(scene, cfg, jax.random.key(8)))
    assert not np.array_equal(a, c)


def test_trace_is_pure_function_of_uniforms(small_scene):
    scene, cfg = small_scene
    n = 64
    key = jax.random.key(3)
    u = rng.path_uniforms(key, n, cfg.max_depth)
    u_aa = jax.random.uniform(jax.random.key(4), (n, 2))
    o, d = camera_rays(scene, cfg, jnp.tile(u_aa, (cfg.height * cfg.width * cfg.spp // n, 1))[: cfg.height * cfg.width * cfg.spp])
    o, d = o[:n], d[:n]
    r1, rec1 = trace_paths(scene, cfg, o, d, u)
    r2, rec2 = trace_paths(scene, cfg, o, d, u)
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
    np.testing.assert_array_equal(np.asarray(rec1.log_pdf), np.asarray(rec2.log_pdf))


def single_emitter_scene(emission=10.0, light_y=1.0, half=0.5,
                         light_diffuse=True):
    """A diffuse floor at y=0 with a square emitter overhead."""
    floor = quad_triangles((-5, 0, -5), (-5, 0, 5), (5, 0, 5), (5, 0, -5))
    lightq = quad_triangles(
        (-half, light_y, -half),
        (half, light_y, -half),
        (half, light_y, half),
        (-half, light_y, half),
    )
    mats = MaterialTable.build(
        [
            Material(color=presets.WHITE_2),
            Material(color=presets.WHITE, emission=emission,
                     is_diffuse=light_diffuse),
        ]
    )
    verts = np.concatenate([floor, lightq])
    ids = np.asarray([0, 0, 1, 1], np.int32)
    is_light = np.asarray([False, False, True, True])
    mesh = TriangleMesh.build(verts, ids, is_light)
    scene = Scene.build(mesh, mats, camera=[0.0, 3.0, 8.0])
    return scene


def test_nee_direct_lighting_matches_quadrature():
    """Single-bounce NEE at a point under an area light vs numeric integral.

    This is the statistical parity test generalizing the reference's
    image-MAE cross-check (LTS.ipynb cells 37-38): the estimator's mean must
    match the analytic direct-illumination integral within MC error.
    """
    emission, light_y, half = 10.0, 1.0, 0.5
    scene = single_emitter_scene(emission, light_y, half)
    cfg = RenderConfig(max_depth=1, spp=1)

    # lanes all start just above the floor (below the emitter plane so the
    # camera ray doesn't pass through the light) shooting straight down
    n = 1 << 14
    o = jnp.tile(jnp.asarray([[0.0, 0.5, 0.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]]), (n, 1))
    u = rng.path_uniforms(jax.random.key(0), n, cfg.max_depth)
    radiance, _ = trace_paths(scene, cfg, o, d, u)
    mc = np.asarray(radiance).mean(axis=0)
    se = np.asarray(radiance).std(axis=0) / np.sqrt(n)

    # ground truth: L * rho/pi * integral over light of cos/cos'/r^2 dA
    rho = 0.55  # WHITE_2 diffuse
    L = emission * 1.0  # emission * white diffuse
    xs = np.linspace(-half, half, 400)
    zs = np.linspace(-half, half, 400)
    X, Z = np.meshgrid(xs, zs)
    # shade point at origin (floor y=0), light points at y=light_y
    r2 = X**2 + Z**2 + light_y**2
    cos_t = light_y / np.sqrt(r2)  # floor normal +y
    cos_p = light_y / np.sqrt(r2)  # light normal (-y toward floor); |cos|
    integrand = cos_t * cos_p / r2
    dA = (xs[1] - xs[0]) * (zs[1] - zs[0])
    truth = L * (rho / np.pi) * integrand.sum() * dA
    for c in range(3):
        assert abs(mc[c] - truth) < 4 * se[c] + 1e-3, (c, mc[c], truth, se[c])


def test_emission_modes():
    # non-diffuse emitter: path terminates at the light (the reference's
    # `else: break`, src/path_tracing.py:143-145), so radiance == emission
    scene = single_emitter_scene(emission=5.0, light_diffuse=False)
    # camera ray pointed straight at the light from below
    n = 8
    o = jnp.tile(jnp.asarray([[0.0, 0.5, 0.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    u = rng.path_uniforms(jax.random.key(1), n, 2)
    cfg = RenderConfig(max_depth=2, emission_mode="first_hit")
    r, _ = trace_paths(scene, cfg, o, d, u)
    np.testing.assert_allclose(np.asarray(r), 5.0, rtol=1e-5)


def test_max_depth_zero_paths_terminate(small_scene):
    scene, cfg = small_scene
    n = 16
    o = jnp.tile(jnp.asarray([[0.0, 0.0, 0.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
    u = rng.path_uniforms(jax.random.key(2), n, 1)
    cfg1 = RenderConfig(max_depth=1)
    r, rec = trace_paths(scene, cfg1, o, d, u)
    assert np.all(np.isfinite(np.asarray(r)))
    assert rec.log_pdf.shape == (n, 1)


def test_miss_rays_are_black():
    scene = single_emitter_scene()
    n = 4
    o = jnp.tile(jnp.asarray([[0.0, 2.0, 0.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[1.0, 0.5, 0.0]]), (n, 1))
    d = lm.normalize(d)
    u = rng.path_uniforms(jax.random.key(3), n, 3)
    r, rec = trace_paths(scene, RenderConfig(max_depth=3), o, d, u)
    np.testing.assert_allclose(np.asarray(r), 0.0, atol=1e-7)
    assert not np.any(np.asarray(rec.alive))


def test_nee_all_matches_one_sample():
    """The legacy all-lights NEE quadrature ('all', cast_all_shadow_rays,
    src/light_samples.py:119-143) and the one-random-sample estimator
    ('one') target the same direct-lighting integral: image means agree
    within MC error, and the 'all' variant is deterministic per seed only
    through the BSDF chain (the light connection itself has no randomness)."""
    import dataclasses

    scene, cfg = cornell_box_scene(width=16, height=16, spp=16, max_depth=2,
                                   include_cone=False)
    img_one = np.asarray(render_image(scene, cfg, jax.random.key(0)))
    cfg_all = dataclasses.replace(cfg, nee_mode="all")
    img_all = np.asarray(render_image(scene, cfg_all, jax.random.key(0)))
    assert abs(img_one.mean() - img_all.mean()) < 0.015, (
        img_one.mean(), img_all.mean())
    # the deterministic connection slashes direct-lighting noise: per-pixel
    # deviation from the (smoother) 'all' image stays moderate
    assert np.abs(img_one - img_all).mean() < 0.05


# --- fresnel_mode="split": deterministic both-branch Fresnel ---------------


def glass_slab_scene(emission=5.0, ior=1.5, top=2.0, bottom=1.8):
    """Non-diffuse emitter floor at y=0 under a horizontal glass slab."""
    floor = quad_triangles((-5, 0, -5), (-5, 0, 5), (5, 0, 5), (5, 0, -5))
    # +y outward normal for the slab's top face, -y for its bottom face
    slab_top = quad_triangles((-5, top, -5), (-5, top, 5), (5, top, 5),
                              (5, top, -5))
    slab_bot = quad_triangles((-5, bottom, -5), (5, bottom, -5),
                              (5, bottom, 5), (-5, bottom, 5))
    mats = MaterialTable.build(
        [
            Material(color=presets.WHITE, emission=emission,
                     is_diffuse=False),
            Material(color=presets.WHITE, transmission=1.0, ior=ior,
                     is_diffuse=False),
        ]
    )
    verts = np.concatenate([floor, slab_top, slab_bot])
    ids = np.asarray([0, 0, 1, 1, 1, 1], np.int32)
    is_light = np.asarray([True, True, False, False, False, False])
    mesh = TriangleMesh.build(verts, ids, is_light)
    return Scene.build(mesh, mats, camera=[0.0, 3.0, 0.0])


def _slab_rays(n):
    o = jnp.tile(jnp.asarray([[0.1, 3.0, 0.1]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]]), (n, 1))
    return o, d


def test_fresnel_split_deterministic_and_exact():
    """At normal incidence through a glass slab onto an emitter, the split
    estimator (src/render.py:121-153 contract) is DETERMINISTIC — radiance
    is independent of the uniforms — and equals the closed-form multiple-
    reflection series E*(1-R)^2*(1+R^2+...) truncated at max_depth."""
    from light_transport_tpu.integrators.path_tracer import trace_paths_split
    from light_transport_tpu.ops.sampling import schlick_r0

    scene = glass_slab_scene()
    cfg = RenderConfig(max_depth=6, rr_start=10, emission_mode="nee")
    n = 8
    o, d = _slab_rays(n)
    u1 = rng.path_uniforms(jax.random.key(1), n, cfg.max_depth)
    u2 = rng.path_uniforms(jax.random.key(2), n, cfg.max_depth)
    r1 = np.asarray(trace_paths_split(scene, cfg, o, d, u1))
    r2 = np.asarray(trace_paths_split(scene, cfg, o, d, u2))
    np.testing.assert_allclose(r1, r2, atol=1e-6)  # uniform-independent

    R = float(schlick_r0(jnp.asarray(1.0), jnp.asarray(1.5)))
    # depth 6 admits the direct chain (3 bounces) and one internal
    # double-reflection (5 bounces); the R^4 term needs 7
    expected = 5.0 * (1.0 - R) ** 2 * (1.0 + R ** 2)
    np.testing.assert_allclose(r1.mean(axis=0), expected, rtol=2e-3)


def test_fresnel_split_variance_and_mean_parity():
    """Same-mean, lower-variance vs the stochastic one-branch rule (the
    split is a conditional-expectation / Rao-Blackwell step)."""
    from light_transport_tpu.integrators.path_tracer import trace_paths_split

    scene = glass_slab_scene()
    cfg = RenderConfig(max_depth=6, rr_start=10, emission_mode="nee")
    n = 2048
    o, d = _slab_rays(n)
    u = rng.path_uniforms(jax.random.key(3), n, cfg.max_depth)
    r_split = np.asarray(trace_paths_split(scene, cfg, o, d, u))[:, 1]
    r_stoch = np.asarray(trace_paths(scene, cfg, o, d, u)[0])[:, 1]
    se = r_stoch.std() / np.sqrt(n)
    assert abs(r_split.mean() - r_stoch.mean()) < 4 * se + 1e-3
    assert r_split.std() < 0.1 * r_stoch.std()  # ~0 vs Bernoulli spread


def test_fresnel_split_reduces_to_stochastic_without_glass():
    """No transmissive surfaces -> no splits: the split driver must produce
    the stochastic tracer's radiance exactly (same uniforms)."""
    from light_transport_tpu.integrators.path_tracer import trace_paths_split

    scene = single_emitter_scene()
    cfg = RenderConfig(max_depth=3)
    n = 64
    o = jnp.tile(jnp.asarray([[0.0, 2.5, 0.0]]), (n, 1))
    d = lm.normalize(jnp.tile(jnp.asarray([[0.05, -1.0, 0.02]]), (n, 1)))
    u = rng.path_uniforms(jax.random.key(4), n, cfg.max_depth)
    r_split = np.asarray(trace_paths_split(scene, cfg, o, d, u))
    r_stoch = np.asarray(trace_paths(scene, cfg, o, d, u)[0])
    np.testing.assert_allclose(r_split, r_stoch, atol=1e-6)


def test_fresnel_split_render_cornell_parity():
    """End-to-end: fresnel_mode='split' through the public API on the glass
    Cornell scene agrees with the flagship render at the image-mean level."""
    import dataclasses

    import light_transport_tpu as lt

    scene, cfg = cornell_box_scene(width=16, height=16, spp=8, max_depth=4)
    img = np.asarray(lt.render(scene, cfg, seed=0))
    cfg_s = dataclasses.replace(cfg, fresnel_mode="split")
    img_s = np.asarray(lt.render(scene, cfg_s, seed=0))
    assert np.all(np.isfinite(img_s)) and img_s.max() > 0.1
    assert abs(img.mean() - img_s.mean()) < 0.02, (img.mean(), img_s.mean())


def test_rr_preserves_single_channel_energy():
    """advisor r3 (README deviation 14): Russian roulette keyed on the
    green channel (the reference's `1-throughput[1]`) killed red-only
    paths with probability 1 and no compensation, so all red
    inter-reflection past rr_start vanished.  In a closed all-red box the
    only deep transport is red: deeper renders must keep adding energy
    past the RR onset instead of flat-lining at the bounce-(rr_start+1)
    image."""
    import dataclasses

    half = 1.0
    quads = [
        quad_triangles((-half, -half, -half), (-half, -half, half),
                       (half, -half, half), (half, -half, -half)),   # floor
        quad_triangles((-half, half, -half), (half, half, -half),
                       (half, half, half), (-half, half, half)),     # ceil
        quad_triangles((-half, -half, -half), (-half, half, -half),
                       (-half, half, half), (-half, -half, half)),   # left
        quad_triangles((half, -half, -half), (half, -half, half),
                       (half, half, half), (half, half, -half)),     # right
        quad_triangles((-half, -half, -half), (half, -half, -half),
                       (half, half, -half), (-half, half, -half)),   # back
    ]
    s = 0.3
    lq = quad_triangles((-s, half - 1e-3, -s), (s, half - 1e-3, -s),
                        (s, half - 1e-3, s), (-s, half - 1e-3, s))
    red = Material(color=presets.RED)   # diffuse (0.7, 0, 0)
    src = Material(color=presets.WHITE, emission=8.0)
    mesh = TriangleMesh.build(
        np.concatenate(quads + [lq]),
        np.asarray([0] * 10 + [1, 1], np.int32),
        np.asarray([False] * 10 + [True, True]),
    )
    scene = Scene.build(mesh, MaterialTable.build([red, src]),
                        camera=[0.0, 0.0, half - 0.05])
    cfg = RenderConfig(width=12, height=12, spp=16, max_depth=5,
                       f_distance=0.5)
    shallow = float(np.asarray(
        render_image(scene, cfg, jax.random.key(0)))[..., 0].mean())
    deep_cfg = dataclasses.replace(cfg, max_depth=10)
    deep = float(np.asarray(
        render_image(scene, deep_cfg, jax.random.key(0)))[..., 0].mean())
    # bounces 5-9 run under RR (rr_start=3); green-keyed RR killed every
    # red path there, making deep == shallow up to the bounce-5 RR noise
    assert deep > shallow * 1.02, (shallow, deep)


def test_emission_color_consistent_across_estimators():
    """README deviation 15: one light radiance (emission * emission_color)
    for both the hit-scored and the NEE estimator.  A cyan-tinted emitter
    must produce the same hue through a camera-direct view (emission at
    hit) as through NEE on the floor; the reference convention gave the
    direct view an untinted (white) light."""
    tint = (0.2, 1.0, 1.0)
    scene = single_emitter_scene(emission=10.0)
    # rebuild with a tinted emitter
    mats = MaterialTable.build([
        Material(color=presets.WHITE_2),
        Material(color=presets.WHITE, emission=10.0, emission_color=tint),
    ])
    scene = scene.replace(materials=mats)
    from light_transport_tpu.scene.lights import LightTable

    scene = scene.replace(lights=LightTable.build(scene.mesh, mats))
    n = 256
    cfg = RenderConfig(width=1, height=1, spp=1, max_depth=2,
                       emission_mode="always")
    # camera-direct: rays straight up into the emitter
    o_up = jnp.tile(jnp.asarray([[0.0, 0.5, 0.0]], jnp.float32), (n, 1))
    d_up = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32), (n, 1))
    u = rng.path_uniforms(jax.random.key(1), n, cfg.max_depth)
    rad_hit, _ = trace_paths(scene, cfg, o_up, d_up, u)
    hit = np.asarray(rad_hit).mean(axis=0)
    # NEE-lit: rays down at the floor (bounce-0 direct term dominates)
    o_dn = jnp.tile(jnp.asarray([[0.0, 0.5, 0.0]], jnp.float32), (n, 1))
    d_dn = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32), (n, 1))
    cfg1 = RenderConfig(width=1, height=1, spp=1, max_depth=1)
    rad_nee, _ = trace_paths(scene, cfg1, o_dn, d_dn, u[:, :1])
    nee = np.asarray(rad_nee).mean(axis=0)
    # both spectra must be proportional to the tint (hue equality)
    np.testing.assert_allclose(hit / hit[1], np.asarray(tint) / tint[1],
                               rtol=1e-4)
    # floor reflectance WHITE_2 is grey (uniform), so the NEE spectrum is
    # tint * grey — same hue
    np.testing.assert_allclose(nee / nee[1], np.asarray(tint) / tint[1],
                               rtol=1e-3)


def test_compact_tail_matches_full_width():
    """RenderConfig.compact_tail: the host-driven multi-level tail
    compaction reproduces the full-width tracer's
    estimate exactly up to compilation-partition rounding: per-lane math
    is elementwise, intersection/NEE are lane-order-independent, and dead
    lanes' radiance is final when flushed — but the segmented jits fuse
    differently than the end-to-end render jit, so the comparison is a
    tight tolerance, not bitwise.  min_width is forced tiny so several
    compaction levels actually execute at test scale."""
    import dataclasses

    import numpy as np

    from light_transport_tpu.api import render
    from light_transport_tpu.integrators import path_tracer as pt
    from light_transport_tpu.scene.cornell import cornell_box_scene

    scene, cfg = cornell_box_scene(width=40, height=40, spp=4, max_depth=8)
    cfg = dataclasses.replace(cfg, rr_start=5, emission_mode="always")
    key = jax.random.key(3)
    img_full = np.asarray(render(scene, cfg, seed=3))

    o, d, u = pt._camera_lanes(scene, cfg, key)
    rad_full, _ = pt.trace_paths(scene, cfg, o, d, u)
    rad_comp = pt.trace_paths_compact(scene, cfg, o, d, u,
                                      segment=2, min_width=256)
    np.testing.assert_allclose(np.asarray(rad_full),
                               np.asarray(rad_comp), rtol=0, atol=1e-5)

    cfg_c = dataclasses.replace(cfg, compact_tail=True)
    img_comp = np.asarray(render(scene, cfg_c, seed=3))
    np.testing.assert_allclose(img_full, img_comp, rtol=0, atol=1e-5)
    assert np.abs(img_full - img_comp).mean() < 1e-7


def test_emission_mode_mis_unbiased_vs_nee():
    """emission_mode='mis' (power-heuristic NEE<->BSDF combination)
    estimates the same transport as 'nee': same scene,
    same spp, image means agree within 3 sigma of the pooled per-pixel
    MC error; and on a bright area light the MIS image's per-pixel
    variance is no worse (the power heuristic only reweights, never adds
    a strategy the partition didn't already count)."""
    import dataclasses

    import numpy as np

    from light_transport_tpu.api import render
    from light_transport_tpu.integrators.path_tracer import render_image
    from light_transport_tpu.scene.cornell import cornell_box_scene

    scene, cfg = cornell_box_scene(width=48, height=48, spp=24, max_depth=4,
                                   emission=200.0)
    out = {}
    for mode in ("nee", "mis"):
        c = dataclasses.replace(cfg, emission_mode=mode)
        _, samples = render_image(scene, c, jax.random.key(7),
                                  return_samples=True)
        out[mode] = np.asarray(samples, np.float64)
    m_nee = out["nee"].mean(axis=2)
    m_mis = out["mis"].mean(axis=2)
    # pooled standard error of the per-pixel mean difference
    se = np.sqrt((out["nee"].var(axis=2) + out["mis"].var(axis=2))
                 / cfg.spp)
    z = np.abs(m_mis - m_nee) / np.maximum(se, 1e-4)
    # 3-sigma agreement for ~all pixels (floor guards zero-variance pixels)
    assert np.mean(z < 3.0) > 0.99, np.mean(z < 3.0)
    assert abs(m_mis.mean() - m_nee.mean()) < 3 * se.mean() / np.sqrt(
        m_nee.size) * 10 + 2e-3
    # MIS must not be noisier overall (clip to display range — the metric
    # that matters for images)
    v_nee = np.clip(out["nee"], 0, 1).var(axis=2).mean()
    v_mis = np.clip(out["mis"], 0, 1).var(axis=2).mean()
    assert v_mis <= v_nee * 1.05, (v_mis, v_nee)


def test_emission_mode_mis_requires_nee_one():
    import dataclasses

    import pytest

    from light_transport_tpu.api import render
    from light_transport_tpu.scene.cornell import cornell_box_scene

    scene, cfg = cornell_box_scene(width=8, height=8, spp=1, max_depth=2)
    cfg = dataclasses.replace(cfg, emission_mode="mis", nee_mode="all")
    with pytest.raises(ValueError, match="mis"):
        render(scene, cfg, seed=0)
