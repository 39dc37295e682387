"""Point (delta) light sources: closed-form direct lighting, shadowing,
glossy interaction, Whitted Phong parity, and scene/API plumbing.

The capability makes the reference GUI's 'Point' source option
(app.py:152-158) a first-class light type instead of the tiny-emissive-quad
emulation (models/presets.hard_shadow_scene).  A delta light admits an
EXACT closed form for the path tracer's direct term —
``f(wi) * I * cos(theta) / r^2`` — so these are golden-value tests in the
tests/test_oracle.py sense, not MC comparisons.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from light_transport_tpu.core import rng
from light_transport_tpu.core.config import RenderConfig
from light_transport_tpu.integrators.path_tracer import trace_paths
from light_transport_tpu.ops import sampling
from light_transport_tpu.scene.geometry import TriangleMesh, quad_triangles
from light_transport_tpu.scene.material import Color, Material, MaterialTable
from light_transport_tpu.scene.scene import Scene

ALBEDO = (0.6, 0.4, 0.2)
L_POS = (0.5, 3.0, -0.25)
L_INT = (11.0, 7.0, 5.0)


def _floor_scene(material=None, extra_quads=(), extra_mats=()):
    """A single big quad at y=0 (normal +y) with a point light above it."""
    mat = material or Material(color=Color.of((0, 0, 0), ALBEDO, (0, 0, 0)))
    quads = [quad_triangles([-8, 0, -8], [8, 0, -8], [8, 0, 8], [-8, 0, 8])]
    ids = [np.zeros(2, np.int32)]
    for qi, (q, mi) in enumerate(zip(extra_quads, extra_mats)):
        quads.append(q)
        ids.append(np.full(len(q), 1 + qi, np.int32))
    verts = np.concatenate(quads)
    mesh = TriangleMesh.build(
        verts, np.concatenate(ids), np.zeros(len(verts), bool))
    mats = MaterialTable.build([mat, *extra_mats])
    scene = Scene.build(mesh, mats, camera=[0.0, 5.0, 0.0])
    return scene.with_point_lights([L_POS], [L_INT])


def _down_rays(points_xz, h=4.0):
    """Vertical rays from height ``h`` down onto the floor points."""
    pts = np.asarray(points_xz, np.float64)
    o = np.stack([pts[:, 0], np.full(len(pts), h), pts[:, 1]], -1)
    d = np.tile([0.0, -1.0, 0.0], (len(pts), 1))
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def _analytic_direct(points_xz, f_rgb):
    """f * I * cos(theta) / r^2 at floor points (normal +y, no occluder)."""
    pts = np.asarray(points_xz, np.float64)
    hit = np.stack([pts[:, 0], np.zeros(len(pts)), pts[:, 1]], -1)
    to_l = np.asarray(L_POS) - hit
    r2 = (to_l ** 2).sum(-1)
    cos = to_l[:, 1] / np.sqrt(r2)  # dot(+y, wi)
    return np.asarray(f_rgb) * np.asarray(L_INT) * (cos / r2)[:, None]


def test_point_light_closed_form_diffuse():
    scene = _floor_scene()
    cfg = RenderConfig(width=4, height=4, spp=1, max_depth=1)
    pts = [(0.0, 0.0), (1.5, -2.0), (-3.0, 1.0), (4.0, 4.0)]
    o, d = _down_rays(pts)
    u = jnp.zeros((len(pts), 1, rng.NUM_U))  # depth-1: no bounce uniforms used
    radiance, _ = trace_paths(scene, cfg, o, d, u)
    want = _analytic_direct(pts, np.asarray(ALBEDO) / np.pi)
    # the shading point is lifted eps off the surface before the distance
    # is measured (shadow_o = hit + eps*n_s), a ~1e-4 shift in r
    np.testing.assert_allclose(np.asarray(radiance), want, rtol=5e-4)


# A blocker quad at y=1.5 that sits on the light path of floor point
# (2.5, 0.75) — the segment to L_POS crosses y=1.5 at (1.5, 0.25) — but
# NOT on the vertical camera ray above either test point.
_BLOCKER = quad_triangles([1.2, 1.5, -0.05], [1.8, 1.5, -0.05],
                          [1.8, 1.5, 0.55], [1.2, 1.5, 0.55])
_SHADOWED_PT = (2.5, 0.75)
_LIT_PT = (4.0, 4.0)


def test_point_light_shadowed_lane_is_black():
    """A small blocker quad between the light and one floor point."""
    b_mat = Material(color=Color.of((0, 0, 0), (0.5, 0.5, 0.5), (0, 0, 0)))
    scene = _floor_scene(extra_quads=[_BLOCKER], extra_mats=[b_mat])
    cfg = RenderConfig(width=4, height=4, spp=1, max_depth=1)
    pts = [_SHADOWED_PT, _LIT_PT]
    o, d = _down_rays(pts)
    u = jnp.zeros((len(pts), 1, rng.NUM_U))
    radiance, _ = trace_paths(scene, cfg, o, d, u)
    r = np.asarray(radiance)
    np.testing.assert_allclose(r[0], 0.0, atol=1e-7)
    want = _analytic_direct(pts, np.asarray(ALBEDO) / np.pi)
    np.testing.assert_allclose(r[1], want[1], rtol=5e-4)


def test_point_light_closed_form_glossy():
    """On a glossy floor the direct term evaluates the full modified-Phong
    f toward the light (mirror axis of the incoming vertical ray)."""
    kd, ks, shin = (0.2, 0.3, 0.1), (0.5, 0.4, 0.6), 16.0
    mat = Material(color=Color.of((0, 0, 0), kd, ks), shininess=shin,
                   is_diffuse=False, is_glossy=True)
    scene = _floor_scene(material=mat)
    cfg = RenderConfig(width=4, height=4, spp=1, max_depth=1)
    pts = [(0.0, 0.0), (2.5, 1.0)]
    o, d = _down_rays(pts)
    u = jnp.zeros((len(pts), 1, rng.NUM_U))
    radiance, _ = trace_paths(scene, cfg, o, d, u)
    # mirror of straight-down incidence about +y is straight up
    hit = np.stack([np.asarray(pts)[:, 0], np.zeros(2),
                    np.asarray(pts)[:, 1]], -1)
    to_l = np.asarray(L_POS) - hit
    wi = to_l / np.linalg.norm(to_l, axis=-1, keepdims=True)
    f = np.asarray(sampling.glossy_f(
        jnp.asarray(kd, jnp.float32)[None, :].repeat(2, 0),
        jnp.asarray(ks, jnp.float32)[None, :].repeat(2, 0),
        jnp.asarray(shin, jnp.float32),
        jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32).repeat(2, 0),
        jnp.asarray(wi, jnp.float32)))
    r2 = (to_l ** 2).sum(-1)
    cos = to_l[:, 1] / np.sqrt(r2)
    want = f * np.asarray(L_INT) * (cos / r2)[:, None]
    np.testing.assert_allclose(np.asarray(radiance), want, rtol=5e-4)


def test_zero_intensity_point_light_changes_nothing():
    """The delta term consumes NO uniforms, so a black point light leaves
    the trace bitwise identical to a point-light-free scene."""
    from light_transport_tpu.scene.cornell import cornell_box_scene

    scene, cfg = cornell_box_scene(width=8, height=8, spp=1, max_depth=3)
    n = 32
    key = jax.random.key(5)
    u = rng.path_uniforms(key, n, cfg.max_depth)
    o = jnp.tile(jnp.asarray([[0.0, 0.0, 7.9]], jnp.float32), (n, 1))
    d = jnp.asarray(np.random.default_rng(1).normal(size=(n, 3)),
                    jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    r0, _ = trace_paths(scene, cfg, o, d, u)
    s2 = scene.with_point_lights([[0.0, 0.0, 0.0]], [[0.0, 0.0, 0.0]])
    r1, _ = trace_paths(s2, cfg, o, d, u)
    np.testing.assert_array_equal(np.asarray(r0), np.asarray(r1))


def test_whitted_point_light_shadow():
    """Whitted Phong-shades toward the point; occluded lanes keep ambient
    only (reference per-light rule, src/render_old.py:70-134)."""
    from light_transport_tpu.integrators.whitted import trace_whitted

    b_mat = Material(color=Color.of((0, 0, 0), (0.5, 0.5, 0.5), (0, 0, 0)))
    amb = (0.05, 0.02, 0.01)
    mat = Material(color=Color.of(amb, ALBEDO, (0.1, 0.1, 0.1)),
                   shininess=32.0)
    scene = _floor_scene(material=mat, extra_quads=[_BLOCKER],
                         extra_mats=[b_mat])
    pts = [_SHADOWED_PT, _LIT_PT]
    o, d = _down_rays(pts)
    img = np.asarray(trace_whitted(scene, o, d, depth=1))
    # shadowed lane: ambient term only = o_amb * light ambient (ones)
    np.testing.assert_allclose(img[0], amb, rtol=1e-5)
    # lit lane: strictly brighter than ambient, finite
    assert np.all(img[1] > np.asarray(amb))
    assert np.all(np.isfinite(img))


def test_point_light_preset_renders():
    from light_transport_tpu.api import render
    from light_transport_tpu.models.presets import point_light_scene

    scene, cfg = point_light_scene(width=16, height=16, spp=2, max_depth=3)
    img = np.asarray(render(scene, cfg, seed=0))
    assert np.all(np.isfinite(img)) and 0.0 < img.mean() < 1.0
    # the hard point-light shadow of the cone must darken some floor pixels
    # relative to the brightest floor region
    assert img.min() < img.max()


def test_with_bvh_preserves_point_lights():
    scene = _floor_scene()
    assert scene.point_lights is not None
    s2 = scene.with_bvh()
    assert s2.point_lights is not None
    np.testing.assert_array_equal(np.asarray(s2.point_lights.position),
                                  np.asarray(scene.point_lights.position))


def test_bdpt_mixed_lights_render():
    """MIXED area+point scenes run both light-origin families in one
    render (per-lane family pick, _light_family): the image must be
    finite and carry BOTH light sets' energy (brighter than either
    single-family render of the same scene)."""
    from light_transport_tpu.api import render
    from light_transport_tpu.integrators.bdpt import _light_family
    from light_transport_tpu.scene.cornell import cornell_box_scene

    scene, cfg = cornell_box_scene(width=10, height=10, spp=4, max_depth=3)
    mixed = scene.with_point_lights([[0.0, 3.0, 0.0]], [[30.0, 30.0, 30.0]])
    mode, q = _light_family(mixed)
    assert mode == "mixed" and 0.05 <= q <= 0.95
    img_a = np.asarray(render(scene, cfg, seed=0, integrator="bdpt"))
    img_m = np.asarray(render(mixed, cfg, seed=0, integrator="bdpt"))
    assert np.all(np.isfinite(img_m))
    assert img_m.mean() > img_a.mean() + 0.005


@pytest.mark.slow
def test_bdpt_mixed_lights_additive():
    """Radiance is linear in emission, so on an unclipped scene the mixed
    render's expectation is the SUM of the area-only and point-only
    renders — the strongest end-to-end check on the family-pick MIS
    algebra (any wrong q factor de-partitions the weights and shifts the
    brightness)."""
    from light_transport_tpu.integrators.bdpt import render_bdpt
    from light_transport_tpu.scene.cornell import cornell_box_scene

    pos, inten = [[0.0, 3.0, 0.0]], [[15.0, 15.0, 15.0]]
    s_area, cfg = cornell_box_scene(width=16, height=16, spp=24, max_depth=3,
                                    include_cone=False, emission=0.35)
    s_point, _ = cornell_box_scene(width=16, height=16, spp=24, max_depth=3,
                                   include_cone=False, emission=0.0)
    s_point = s_point.with_point_lights(pos, inten)
    s_mixed = s_area.with_point_lights(pos, inten)

    ia = np.asarray(render_bdpt(s_area, cfg, jax.random.key(0)))
    ip = np.asarray(render_bdpt(s_point, cfg, jax.random.key(1)))
    im = np.asarray(render_bdpt(s_mixed, cfg, jax.random.key(2)))
    assert max(ia.max(), ip.max(), im.max()) < 0.99  # nothing clipped
    assert abs((ia.mean() + ip.mean()) - im.mean()) < 0.004, (
        ia.mean(), ip.mean(), im.mean()
    )


@pytest.mark.slow
def test_bdpt_mixed_lights_match_path_tracer():
    """On a specular-free mixed-lit Cornell both estimators are unbiased
    (PT: area NEE + deterministic point term; BDPT: per-lane family
    walks), so the images must agree within MC error."""
    from light_transport_tpu.integrators.bdpt import render_bdpt
    from light_transport_tpu.integrators.path_tracer import render_image
    from light_transport_tpu.scene.cornell import cornell_box_scene
    from light_transport_tpu.tally.stats import image_mae

    scene, cfg = cornell_box_scene(width=20, height=20, spp=32, max_depth=4,
                                   include_cone=False, emission=0.6)
    scene = scene.with_point_lights([[0.0, 3.0, 0.0]],
                                    [[60.0, 60.0, 60.0]])
    img_pt = np.asarray(render_image(scene, cfg, jax.random.key(0)))
    img_bd = np.asarray(render_bdpt(scene, cfg, jax.random.key(1)))
    assert abs(img_pt.mean() - img_bd.mean()) < 0.012, (
        img_pt.mean(), img_bd.mean()
    )
    assert image_mae(img_pt, img_bd) < 0.06


def test_bdpt_point_light_renders():
    """Point-only lighting through bdpt: the delta-origin light subpaths
    plus the deterministic s=1 connections produce a finite, lit image."""
    from light_transport_tpu.api import render
    from light_transport_tpu.models.presets import point_light_scene

    scene, cfg = point_light_scene(width=12, height=12, spp=4, max_depth=3)
    img = np.asarray(render(scene, cfg, seed=0, integrator="bdpt"))
    assert np.all(np.isfinite(img)) and 0.05 < img.mean() < 1.0


@pytest.mark.slow
def test_bdpt_point_light_matches_path_tracer():
    """Both estimators are unbiased on the specular-free point-lit Cornell,
    so the images must agree within MC error — the strongest check on the
    delta-origin MIS bookkeeping (origin_delta exclusions, the x P NEE-pick
    ratio, the 1/P-weighted pt_rev): any density error shifts the
    brightness.  (The cone is excluded because a delta light seen through
    glass is transport the path tracer structurally CANNOT sample — see
    test_bdpt_point_light_caustics_exceed_path_tracer.)"""
    from light_transport_tpu.integrators.bdpt import render_bdpt
    from light_transport_tpu.integrators.path_tracer import render_image
    from light_transport_tpu.scene.cornell import cornell_box_scene
    from light_transport_tpu.tally.stats import image_mae

    scene, cfg = cornell_box_scene(width=20, height=20, spp=32, max_depth=4,
                                   include_cone=False, emission=0.0)
    scene = scene.with_point_lights([[0.0, 3.0, 0.0]],
                                    [[200.0, 200.0, 200.0]])
    img_pt = np.asarray(render_image(scene, cfg, jax.random.key(0)))
    img_bd = np.asarray(render_bdpt(scene, cfg, jax.random.key(1)))
    assert abs(img_pt.mean() - img_bd.mean()) < 0.01, (
        img_pt.mean(), img_bd.mean()
    )
    assert image_mae(img_pt, img_bd) < 0.06


@pytest.mark.slow
def test_bdpt_point_light_caustics_exceed_path_tracer():
    """On the glass-cone scene bdpt's light-tracing splats carry point-light
    caustics (L -> refract -> refract -> diffuse -> camera) that the path
    tracer structurally cannot sample at ANY depth: a delta light cannot be
    BSDF-hit, and NEE shadow rays do not cross glass.  So at max_depth=4
    (the first depth that admits the family):

      - bdpt without light tracing must MATCH the path tracer (the s>=2
        connection for the caustic sits exactly at the depth cap, where the
        specular-light-adjacent exclusion keeps PT parity), and
      - bdpt WITH light tracing must be measurably brighter — the caustic
        splats take MIS weight 1 (every alternative strategy has a delta
        vertex at its junction)."""
    from light_transport_tpu.integrators.bdpt import render_bdpt
    from light_transport_tpu.integrators.path_tracer import render_image
    from light_transport_tpu.models.presets import point_light_scene

    scene, cfg = point_light_scene(width=16, height=16, spp=48, max_depth=4)
    pt = float(np.asarray(render_image(scene, cfg, jax.random.key(0))).mean())
    bd_no_lt = float(np.asarray(
        render_bdpt(scene, cfg, jax.random.key(2), None, False)).mean())
    bd_lt = float(np.asarray(
        render_bdpt(scene, cfg, jax.random.key(1))).mean())
    assert abs(pt - bd_no_lt) < 0.01, (pt, bd_no_lt)
    assert bd_lt > pt + 0.005, (bd_lt, pt)


def test_point_mis_partition_of_unity():
    """Balance-heuristic weights must sum to 1 over the strategies that can
    produce the 2-segment point-light path (camera -> v1 -> L).  With a
    delta origin there are exactly TWO (s=0 cannot hit a delta position):

      A: s=1, t=2  (deterministic NEE connect from v1; light picked with
                    density 1)
      C: s=2, t=1  (light walk: pick 1/P, isotropic 1/4pi emission to v1,
                    film splat)

    Evaluated through the module's own cam_side_mis / light_side_mis, so
    any inconsistency in the delta-origin algebra (origin_delta exclusion,
    the x P s'=1 ratio, the 1/P factor inside pt_rev) breaks the sum."""
    import jax.numpy as jnp

    from light_transport_tpu.core import math as lm
    from light_transport_tpu.integrators.bdpt import (
        Vertices,
        _camera_pdf_dir,
        _to_area,
        cam_side_mis,
        generate_camera_subpaths,
        light_side_mis,
    )
    from light_transport_tpu.integrators.path_tracer import camera_rays
    from light_transport_tpu.models.presets import point_light_scene

    scene, cfg = point_light_scene(width=8, height=8, spp=1, max_depth=2)
    p_count = scene.point_lights.num
    n = 64
    key = jax.random.key(7)
    u_aa = jax.random.uniform(key, (n, 2))
    o, d = camera_rays(scene, cfg, jnp.tile(u_aa, (1, 1)))
    o, d = o[:n], d[:n]
    cam_u = jax.random.uniform(jax.random.fold_in(key, 1), (n, 2, 2))
    cam = generate_camera_subpaths(scene, cfg, o, d, cam_u)

    lp = jnp.broadcast_to(scene.point_lights.position[0], (n, 3))
    v1, v1ns = cam.pos[:, 0], cam.ns[:, 0]
    usable = np.asarray(cam.valid[:, 0] & ~cam.is_delta[:, 0])
    zeros = jnp.zeros((n,))
    pick_p = 1.0 / p_count
    inv_4pi = 1.0 / (4.0 * np.pi)

    to_l = lp - v1
    d2 = jnp.maximum(lm.dot(to_l, to_l), 1e-20)
    cos_c = jnp.abs(lm.dot(v1ns, to_l / jnp.sqrt(d2)[:, None]))
    # light-walk density of generating v1: pick x isotropic emission, area
    pt_rev = pick_p * inv_4pi * cos_c / d2

    # A: s=1, t=2 — exactly the denominators the point s=1 block builds
    # (no light-side terms: s'=0 does not exist for a delta origin)
    w_a = 1.0 / (1.0 + cam_side_mis(cam, 0, pt_rev, zeros, True))

    # C: s=2, t=1 — light subpath (delta origin, v1 walk vertex) splatted
    # to the camera; junction rev density = camera area density at v1
    dir_cp = (v1 - scene.camera) / jnp.linalg.norm(
        v1 - scene.camera, axis=-1, keepdims=True)
    cam_area_pdf = _to_area(_camera_pdf_dir(scene, cfg, dir_cp),
                            jnp.broadcast_to(scene.camera, v1.shape),
                            v1, v1ns)
    lv_c = Vertices(
        pos=(cam.pos * 0.0).at[:, 0].set(v1),
        ns=(cam.ns * 0.0).at[:, 0].set(v1ns),
        diffuse=cam.diffuse * 0.0, beta=cam.beta * 0.0,
        # the walk's stored fwd density carries the direction term only
        # (the pick enters as the k==0 fwd = pick_p)
        pdf_fwd=(cam.pdf_fwd * 0.0).at[:, 0].set(inv_4pi * cos_c / d2),
        pdf_rev=cam.pdf_rev * 0.0,
        valid=(cam.valid & False).at[:, 0].set(cam.valid[:, 0]),
        is_light=cam.is_light & False, is_delta=cam.is_delta & False,
        emit=cam.emit * 0.0, spec=cam.spec * 0.0, shin=cam.shin * 0.0,
        win=cam.win * 0.0,
    )
    l0 = dict(pos=lp, ns=jnp.broadcast_to(
        jnp.asarray([0.0, -1.0, 0.0]), (n, 3)))
    w_c = 1.0 / (1.0 + light_side_mis(
        lv_c, l0, pick_p, 1, cam_area_pdf, zeros,
        origin_delta=True, nee_pick_ratio=float(p_count)))

    total = np.asarray(w_a + w_c)[usable]
    assert usable.sum() > 24
    np.testing.assert_allclose(total, 1.0, rtol=1e-4)


def test_mixed_mis_partition_of_unity():
    """MIXED-mode partition of unity, both families, through the module's
    own cam_side_mis / light_side_mis with the family-pick factors.

    Point-family 2-segment path (camera -> v1 -> point light L): two
    strategies —
      A: s=1, t=2 (deterministic NEE, density 1 per light)
      C: s=2, t=1 (light walk: family pick q_point, light pick 1/P,
                   isotropic emission, film splat)
    Area-family 2-segment path (camera -> v1 -> area point L): three —
      A': s=1, t=2 (area NEE, density 1/A; the walk alternatives carry
                    q_area, applied outside cam_side_mis as in the s=1
                    block)
      B': s=0, t=3 (camera walk hits the light; the s'=1 alternative is
                    NEE at 1/A while deeper walks carry q_area/A —
                    s1_ratio=1/q_area)
      C': s=2, t=1 (area-family light walk + splat,
                    nee_pick_ratio=1/q_area)
    Any wrong q factor in any hook breaks one of the sums."""
    import jax.numpy as jnp

    from light_transport_tpu.core import math as lm
    from light_transport_tpu.integrators.bdpt import (
        Vertices,
        _camera_pdf_dir,
        _diffuse_pdf_area,
        _remap,
        _to_area,
        cam_side_mis,
        generate_camera_subpaths,
        light_side_mis,
    )
    from light_transport_tpu.integrators.path_tracer import camera_rays
    from light_transport_tpu.scene.cornell import cornell_box_scene
    from light_transport_tpu.scene.lights import sample_light_points

    scene, cfg = cornell_box_scene(width=8, height=8, spp=1, max_depth=2,
                                   include_cone=False)
    scene = scene.with_point_lights([[0.0, 3.0, 0.0]],
                                    [[25.0, 25.0, 25.0]])
    q_point = 0.37  # any interior value must partition
    q_area = 1.0 - q_point
    p_count = scene.point_lights.num
    n = 64
    key = jax.random.key(7)
    u_aa = jax.random.uniform(key, (n, 2))
    o, d = camera_rays(scene, cfg, jnp.tile(u_aa, (1, 1)))
    o, d = o[:n], d[:n]
    cam_u = jax.random.uniform(jax.random.fold_in(key, 1), (n, 2, 2))
    cam = generate_camera_subpaths(scene, cfg, o, d, cam_u)
    v1, v1ns = cam.pos[:, 0], cam.ns[:, 0]
    usable = np.asarray(
        cam.valid[:, 0] & ~cam.is_delta[:, 0] & ~cam.is_light[:, 0]
    )
    zeros = jnp.zeros((n,))
    dir_cp = (v1 - scene.camera) / jnp.linalg.norm(
        v1 - scene.camera, axis=-1, keepdims=True)
    cam_area_pdf = _to_area(_camera_pdf_dir(scene, cfg, dir_cp),
                            jnp.broadcast_to(scene.camera, v1.shape),
                            v1, v1ns)

    def light_walk_verts(fwd0):
        base = Vertices(
            pos=(cam.pos * 0.0).at[:, 0].set(v1),
            ns=(cam.ns * 0.0).at[:, 0].set(v1ns),
            diffuse=cam.diffuse * 0.0, beta=cam.beta * 0.0,
            pdf_fwd=(cam.pdf_fwd * 0.0).at[:, 0].set(fwd0),
            pdf_rev=cam.pdf_rev * 0.0,
            valid=(cam.valid & False).at[:, 0].set(cam.valid[:, 0]),
            is_light=cam.is_light & False, is_delta=cam.is_delta & False,
            emit=cam.emit * 0.0, spec=cam.spec * 0.0, shin=cam.shin * 0.0,
            win=cam.win * 0.0,
        )
        return base

    # ---- point family ----------------------------------------------------
    lp_p = jnp.broadcast_to(scene.point_lights.position[0], (n, 3))
    to_l = lp_p - v1
    d2 = jnp.maximum(lm.dot(to_l, to_l), 1e-20)
    cos_c = jnp.abs(lm.dot(v1ns, to_l / jnp.sqrt(d2)[:, None]))
    inv_4pi = 1.0 / (4.0 * np.pi)
    pick_p = 1.0 / p_count
    # the walk's density of generating v1 includes the family pick
    pt_rev_p = q_point * pick_p * inv_4pi * cos_c / d2
    w_a_p = 1.0 / (1.0 + cam_side_mis(cam, 0, pt_rev_p, zeros, True))
    lv_p = light_walk_verts(inv_4pi * cos_c / d2)
    l0_p = dict(pos=lp_p, ns=jnp.broadcast_to(
        jnp.asarray([0.0, -1.0, 0.0]), (n, 3)))
    w_c_p = 1.0 / (1.0 + light_side_mis(
        lv_p, l0_p, q_point * pick_p, 1, cam_area_pdf, zeros,
        origin_delta=True, nee_pick_ratio=float(p_count) / q_point))
    total_p = np.asarray(w_a_p + w_c_p)[usable]

    # ---- area family -----------------------------------------------------
    ul = jax.random.uniform(jax.random.fold_in(key, 2), (n, 3))
    lp, ln, _, pdf_pos = sample_light_points(scene.lights, ul[:, 0],
                                             ul[:, 1], ul[:, 2])
    inv_area = 1.0 / float(scene.lights.total_area)
    qs_rev = _diffuse_pdf_area(v1ns, v1, lp, ln)  # v1 scatters -> L
    pt_rev = _diffuse_pdf_area(ln, lp, v1, v1ns)  # L emits -> v1
    # A': the s=1 block — every camera-side alternative is a q_area walk
    denom_a = q_area * cam_side_mis(cam, 0, pt_rev, zeros, True) \
        + _remap(qs_rev) / _remap(pdf_pos)
    w_a = 1.0 / (1.0 + denom_a)
    # B': the s=0 block — pt_rev carries the walk's q_area/A, the i==j
    # (s'=1 NEE) term is restored with s1_ratio
    cam_b = cam._replace(
        pos=cam.pos.at[:, 1].set(lp),
        ns=cam.ns.at[:, 1].set(ln),
        pdf_fwd=cam.pdf_fwd.at[:, 1].set(qs_rev),
        valid=cam.valid.at[:, 1].set(cam.valid[:, 0]),
        is_delta=cam.is_delta.at[:, 1].set(False),
    )
    w_b = 1.0 / (1.0 + cam_side_mis(cam_b, 1, q_area * inv_area, pt_rev,
                                    True, s1_ratio=1.0 / q_area))
    # C': the t=1 block — origin density q_area/A, NEE ratio 1/q_area
    lv_a = light_walk_verts(pt_rev)
    l0_a = dict(pos=lp, ns=ln)
    w_c = 1.0 / (1.0 + light_side_mis(
        lv_a, l0_a, q_area * inv_area, 1, cam_area_pdf, qs_rev,
        origin_delta=False, nee_pick_ratio=1.0 / q_area))
    total_a = np.asarray(w_a + w_b + w_c)[usable]

    assert usable.sum() > 24
    np.testing.assert_allclose(total_p, 1.0, rtol=1e-4)
    np.testing.assert_allclose(total_a, 1.0, rtol=1e-4)


def test_cv_render_with_point_lights_runs():
    """render_cv rides trace_paths, so the delta term must flow through the
    CV gradient pipeline without NaNs."""
    from light_transport_tpu.integrators.control_variates import render_cv
    from light_transport_tpu.models.presets import point_light_scene

    scene, cfg = point_light_scene(width=6, height=6, spp=2, max_depth=2)
    out = render_cv(scene, cfg, jax.random.key(0))
    img = np.asarray(out.image_cv)
    assert np.all(np.isfinite(img))
