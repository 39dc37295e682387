import jax
import numpy as np
import pytest

from light_transport_tpu.integrators.bdpt import (
    generate_camera_subpaths,
    generate_light_subpaths,
    render_bdpt,
)
from light_transport_tpu.integrators.path_tracer import camera_rays, render_image
from light_transport_tpu.scene.cornell import cornell_box_scene
from light_transport_tpu.tally.stats import image_mae


@pytest.mark.slow
def test_bdpt_matches_path_tracer_diffuse_scene():
    """Both estimators are unbiased on an all-diffuse scene, so the images
    must agree within MC error — the strongest check on the MIS weights:
    any pdf bookkeeping error shifts the brightness."""
    scene, cfg = cornell_box_scene(width=20, height=20, spp=32, max_depth=4,
                                   include_cone=False)
    img_pt = np.asarray(render_image(scene, cfg, jax.random.key(0)))
    img_bd = np.asarray(render_bdpt(scene, cfg, jax.random.key(1)))
    assert abs(img_pt.mean() - img_bd.mean()) < 0.01, (
        img_pt.mean(), img_bd.mean()
    )
    assert image_mae(img_pt, img_bd) < 0.06


def test_bdpt_with_specular_scene_sane():
    scene, cfg = cornell_box_scene(width=16, height=16, spp=8, max_depth=4)
    img = np.asarray(render_bdpt(scene, cfg, jax.random.key(2)))
    assert np.all(np.isfinite(img))
    assert 0 <= img.min() and img.max() <= 1
    assert img.mean() > 0.05


def test_subpath_shapes_and_masks():
    scene, cfg = cornell_box_scene(width=8, height=8, spp=1, max_depth=3,
                                   include_cone=False)
    n = 64
    key = jax.random.key(3)
    u_aa = jax.random.uniform(key, (n, 2))
    import jax.numpy as jnp

    o, d = camera_rays(scene, cfg, jnp.tile(u_aa, (1, 1)))
    o, d = o[:n], d[:n]
    cam_u = jax.random.uniform(jax.random.fold_in(key, 1), (n, 3, 2))
    cam = generate_camera_subpaths(scene, cfg, o, d, cam_u)
    assert cam.pos.shape == (n, 3, 3)
    v = np.asarray(cam.valid)
    # validity is a prefix property: valid[k] implies valid[k-1]
    assert np.all(v[:, 1] <= v[:, 0]) and np.all(v[:, 2] <= v[:, 1])
    # closed box: every camera ray hits something
    assert v[:, 0].all()

    lv, l0 = generate_light_subpaths(scene, cfg, jax.random.fold_in(key, 2),
                                     n, cam_u)
    # light origin on the ceiling cutout
    lp = np.asarray(l0["pos"])
    np.testing.assert_allclose(lp[:, 1], 7.5, atol=1e-4)
    # most first bounces land in the box (the Cornell front face is open —
    # the camera looks in through it — so downward-sampled rays toward +z
    # legitimately escape)
    assert np.asarray(lv.valid)[:, 0].mean() > 0.6
    # light-walk throughput starts from Le * cos / (pdf_pos * pdf_dir):
    # with cosine sampling the cos cancels, leaving Le * A * pi = 800 pi
    # (invalid lanes are masked to zero)
    b0 = np.asarray(lv.beta)[:, 0]
    ok = np.asarray(lv.valid)[:, 0]
    np.testing.assert_allclose(b0[ok], 800.0 * np.pi, rtol=1e-4)


def test_bdpt_deterministic():
    scene, cfg = cornell_box_scene(width=8, height=8, spp=4, max_depth=3,
                                   include_cone=False)
    a = np.asarray(render_bdpt(scene, cfg, jax.random.key(5)))
    b = np.asarray(render_bdpt(scene, cfg, jax.random.key(5)))
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_bdpt_light_tracing_matches_path_tracer():
    """With t=1 strategies enabled, the MIS weights repartition across the
    full strategy space — any error in the splat geometry, the camera
    importance density, or the weight partition shifts the image mean."""
    scene, cfg = cornell_box_scene(width=16, height=16, spp=32, max_depth=4,
                                   include_cone=False)
    img_pt = np.asarray(render_image(scene, cfg, jax.random.key(0)))
    img_lt = np.asarray(
        render_bdpt(scene, cfg, jax.random.key(2), light_tracing=True)
    )
    assert abs(img_pt.mean() - img_lt.mean()) < 0.012, (
        img_pt.mean(), img_lt.mean()
    )
    assert image_mae(img_pt, img_lt) < 0.06


def test_bdpt_light_tracing_specular_scene():
    # light tracing adds energy PT structurally misses (light seen through
    # specular chains); the image must stay finite and sane
    scene, cfg = cornell_box_scene(width=12, height=12, spp=8, max_depth=4)
    img = np.asarray(
        render_bdpt(scene, cfg, jax.random.key(3), light_tracing=True)
    )
    assert np.isfinite(img).all() and 0 <= img.min() and img.max() <= 1


def test_mis_partition_of_unity():
    """Balance-heuristic weights must sum to 1 over all sampled strategies
    that can produce the same path.  For the 2-segment path (camera -> v1 ->
    light point) with light tracing enabled there are exactly three:

      A: s=1, t=2  (NEE connect from v1)
      B: s=0, t=3  (camera walk hits the light)
      C: s=2, t=1  (light-subpath splat onto the film)

    Each weight is evaluated through the module's own cam_side_mis /
    light_side_mis on identical junction densities, so any inconsistency in
    the ratio algebra (remap, delta handling, camera importance) breaks the
    partition.  (Reference contract: get_mis_weight, src/bdpt.py:298-359.)
    """
    import jax.numpy as jnp

    from light_transport_tpu.core import math as lm
    from light_transport_tpu.integrators.bdpt import (
        Vertices,
        _camera_pdf_dir,
        _diffuse_pdf_area,
        _remap,
        _to_area,
        cam_side_mis,
        light_side_mis,
    )
    from light_transport_tpu.scene.lights import sample_light_points

    scene, cfg = cornell_box_scene(width=8, height=8, spp=1, max_depth=2,
                                   include_cone=False)
    n = 64  # = width * height * spp lanes from camera_rays
    key = jax.random.key(7)
    u_aa = jax.random.uniform(key, (n, 2))
    o, d = camera_rays(scene, cfg, jnp.tile(u_aa, (1, 1)))
    o, d = o[:n], d[:n]
    cam_u = jax.random.uniform(jax.random.fold_in(key, 1), (n, 2, 2))
    cam = generate_camera_subpaths(scene, cfg, o, d, cam_u)

    ul = jax.random.uniform(jax.random.fold_in(key, 2), (n, 3))
    lp, ln, _, pdf_pos = sample_light_points(scene.lights, ul[:, 0],
                                             ul[:, 1], ul[:, 2])
    v1, v1ns = cam.pos[:, 0], cam.ns[:, 0]
    p1 = cam.pdf_fwd[:, 0]
    usable = np.asarray(
        cam.valid[:, 0] & ~cam.is_delta[:, 0] & ~cam.is_light[:, 0]
    )
    zeros = jnp.zeros((n,))
    pdf_area_light = 1.0 / float(scene.lights.total_area)

    qs_rev = _diffuse_pdf_area(v1ns, v1, lp, ln)  # v1 scatters -> L
    pt_rev = _diffuse_pdf_area(ln, lp, v1, v1ns)  # L emits -> v1

    # A: s=1, t=2 (same denominators the s=1 block of render_bdpt builds)
    denom_a = cam_side_mis(cam, 0, pt_rev, zeros, True) \
        + _remap(qs_rev) / _remap(pdf_pos)
    w_a = 1.0 / (1.0 + denom_a)

    # B: s=0, t=3 — fabricate the camera walk continuing into the light
    cam_b = cam._replace(
        pos=cam.pos.at[:, 1].set(lp),
        ns=cam.ns.at[:, 1].set(ln),
        pdf_fwd=cam.pdf_fwd.at[:, 1].set(qs_rev),
        valid=cam.valid.at[:, 1].set(cam.valid[:, 0]),
        is_delta=cam.is_delta.at[:, 1].set(False),
    )
    w_b = 1.0 / (1.0 + cam_side_mis(cam_b, 1, pdf_area_light, pt_rev, True))

    # C: s=2, t=1 — light subpath (L origin, v1 walk vertex) splatted to the
    # camera; junction rev density = camera area density at v1
    dir_cp = (v1 - scene.camera) / jnp.linalg.norm(
        v1 - scene.camera, axis=-1, keepdims=True)
    cam_area_pdf = _to_area(_camera_pdf_dir(scene, cfg, dir_cp),
                            jnp.broadcast_to(scene.camera, v1.shape),
                            v1, v1ns)
    lv_c = Vertices(
        pos=cam.pos * 0.0, ns=cam.ns * 0.0, diffuse=cam.diffuse * 0.0,
        beta=cam.beta * 0.0, pdf_fwd=(cam.pdf_fwd * 0.0).at[:, 0].set(pt_rev),
        pdf_rev=cam.pdf_rev * 0.0,
        valid=(cam.valid & False).at[:, 0].set(cam.valid[:, 0]),
        is_light=cam.is_light & False, is_delta=cam.is_delta & False,
        emit=cam.emit * 0.0,
        spec=cam.spec * 0.0, shin=cam.shin * 0.0,
        win=cam.win * 0.0,
    )._replace()
    lv_c = lv_c._replace(pos=lv_c.pos.at[:, 0].set(v1),
                         ns=lv_c.ns.at[:, 0].set(v1ns))
    l0 = dict(pos=lp, ns=ln)
    w_c = 1.0 / (1.0 + light_side_mis(lv_c, l0, pdf_area_light, 1,
                                      cam_area_pdf, qs_rev))

    total = np.asarray(w_a + w_b + w_c)[usable]
    assert usable.sum() > 24
    np.testing.assert_allclose(total, 1.0, rtol=1e-4)


def test_mis_partition_of_unity_s2():
    """Partition of unity at an s>=2 junction: for the
    3-segment path (camera -> v1 -> m -> light point L) there are exactly
    four sampled strategies with light tracing on:

      A: s=2, t=2  (connect v1 <-> m, light walk L -> m)
      B: s=1, t=3  (camera walk reaches m, NEE connect to L)
      C: s=0, t=4  (camera walk hits the light)
      D: s=3, t=1  (light walk L -> m -> v1, film splat from v1)

    v1 and m are taken from a REAL camera subpath so the walk's stored
    pdf_fwd/pdf_rev enter the weights exactly as render_bdpt uses them;
    the light-side structures are fabricated with the same junction
    densities.  Any inconsistency between cam_side_mis and light_side_mis
    at depth >= 2 (ratio chaining, qsm handling, the walk's pdf_rev)
    breaks the sum."""
    import jax.numpy as jnp

    from light_transport_tpu.core import math as lm
    from light_transport_tpu.integrators.bdpt import (
        Vertices,
        _camera_pdf_dir,
        _diffuse_pdf_area,
        _remap,
        _to_area,
        cam_side_mis,
        light_side_mis,
    )
    from light_transport_tpu.scene.lights import sample_light_points

    scene, cfg = cornell_box_scene(width=8, height=8, spp=1, max_depth=3,
                                   include_cone=False)
    n = 64
    key = jax.random.key(11)
    u_aa = jax.random.uniform(key, (n, 2))
    o, d = camera_rays(scene, cfg, u_aa)
    cam_u = jax.random.uniform(jax.random.fold_in(key, 1), (n, 3, 2))
    cam = generate_camera_subpaths(scene, cfg, o[:n], d[:n], cam_u)

    ul = jax.random.uniform(jax.random.fold_in(key, 2), (n, 3))
    lp, ln, _, pdf_pos = sample_light_points(scene.lights, ul[:, 0],
                                             ul[:, 1], ul[:, 2])
    pdf_area_light = 1.0 / float(scene.lights.total_area)

    v1, ns1 = cam.pos[:, 0], cam.ns[:, 0]
    m, nsm = cam.pos[:, 1], cam.ns[:, 1]
    usable = np.asarray(
        cam.valid[:, 0] & cam.valid[:, 1]
        & ~cam.is_delta[:, 0] & ~cam.is_delta[:, 1]
        & ~cam.is_light[:, 0] & ~cam.is_light[:, 1]
    )
    zeros = jnp.zeros((n,))

    # the walk's stored densities must match the closed forms the MIS
    # blocks recompute (loose: independent f32 evaluation orders)
    np.testing.assert_allclose(
        np.asarray(cam.pdf_fwd[:, 1])[usable],
        np.asarray(_diffuse_pdf_area(ns1, v1, m, nsm))[usable],
        rtol=5e-3)
    np.testing.assert_allclose(
        np.asarray(cam.pdf_rev[:, 0])[usable],
        np.asarray(_diffuse_pdf_area(nsm, m, v1, ns1))[usable],
        rtol=5e-3)

    # shared pairwise densities (area measure) — v1<->m taken from the
    # walk's own storage so every strategy chains the same f32 values and
    # the partition is exact
    p_m = cam.pdf_fwd[:, 1]                             # v1 -> m
    p_mv1 = cam.pdf_rev[:, 0]                           # m -> v1
    p_mL = _diffuse_pdf_area(nsm, m, lp, ln)      # m -> L
    p_Lm = _diffuse_pdf_area(ln, lp, m, nsm)      # L emits -> m

    # A: s=2, t=2 — mirror of the s>=2 connection block at j=0, i=0
    lv_a = Vertices(
        pos=(cam.pos * 0.0).at[:, 0].set(m),
        ns=(cam.ns * 0.0).at[:, 0].set(nsm),
        diffuse=cam.diffuse * 0.0,
        beta=cam.beta * 0.0,
        pdf_fwd=(cam.pdf_fwd * 0.0).at[:, 0].set(p_Lm),
        pdf_rev=cam.pdf_rev * 0.0,
        valid=(cam.valid & False).at[:, 0].set(cam.valid[:, 1]),
        is_light=cam.is_light & False,
        is_delta=cam.is_delta & False,
        emit=cam.emit * 0.0,
        spec=cam.spec * 0.0, shin=cam.shin * 0.0,
        win=cam.win * 0.0,
    )
    l0 = dict(pos=lp, ns=ln)
    denom_a = cam_side_mis(cam, 0, p_mv1, zeros, True) \
        + light_side_mis(lv_a, l0, pdf_area_light, 1, p_m, p_mL)
    w_a = 1.0 / (1.0 + denom_a)

    # B: s=1, t=3 — the NEE block at j=1
    denom_b = cam_side_mis(cam, 1, p_Lm, p_mv1, True) \
        + _remap(p_mL) / _remap(pdf_pos)
    w_b = 1.0 / (1.0 + denom_b)

    # C: s=0, t=4 — camera walk continues into the light
    cam_c = cam._replace(
        pos=cam.pos.at[:, 2].set(lp),
        ns=cam.ns.at[:, 2].set(ln),
        pdf_fwd=cam.pdf_fwd.at[:, 2].set(p_mL),
        valid=cam.valid.at[:, 2].set(cam.valid[:, 1]),
        is_delta=cam.is_delta.at[:, 2].set(False),
    )
    w_c = 1.0 / (1.0 + cam_side_mis(cam_c, 2, pdf_area_light, p_Lm, True))

    # D: s=3, t=1 — light walk L -> m -> v1, splat from v1 to the camera
    dir_cp = (v1 - scene.camera) / jnp.linalg.norm(
        v1 - scene.camera, axis=-1, keepdims=True)
    cam_area_v1 = _to_area(_camera_pdf_dir(scene, cfg, dir_cp),
                           jnp.broadcast_to(scene.camera, v1.shape),
                           v1, ns1)
    lv_d = Vertices(
        pos=(cam.pos * 0.0).at[:, 0].set(m).at[:, 1].set(v1),
        ns=(cam.ns * 0.0).at[:, 0].set(nsm).at[:, 1].set(ns1),
        diffuse=cam.diffuse * 0.0,
        beta=cam.beta * 0.0,
        pdf_fwd=(cam.pdf_fwd * 0.0).at[:, 0].set(p_Lm).at[:, 1].set(p_mv1),
        pdf_rev=cam.pdf_rev * 0.0,
        valid=(cam.valid & False).at[:, 0].set(cam.valid[:, 1])
                                 .at[:, 1].set(cam.valid[:, 1]),
        is_light=cam.is_light & False,
        is_delta=cam.is_delta & False,
        emit=cam.emit * 0.0,
        spec=cam.spec * 0.0, shin=cam.shin * 0.0,
        win=cam.win * 0.0,
    )
    denom_d = light_side_mis(lv_d, l0, pdf_area_light, 2, cam_area_v1, p_m)
    w_d = 1.0 / (1.0 + denom_d)

    total = np.asarray(w_a + w_b + w_c + w_d)[usable]
    assert usable.sum() > 20, usable.sum()
    np.testing.assert_allclose(total, 1.0, rtol=1e-4)


def test_mis_partition_of_unity_at_depth_cap():
    """Partition of unity for a path at the depth cap (advisor r3): with
    max_depth=2 the path camera -> v1 -> m -> L has max_depth+1 surface
    vertices, so the s'=0 strategy (camera walk hits the light) can never
    sample it — random_walk only produces max_depth vertices.  Exactly
    three strategies remain with light tracing on:

      A: s=1, t=3  (camera walk reaches m at j = max_d-1, NEE connect to L)
      B: s=2, t=2  (connect v1 <-> m at the (i+1)+(j+1) == max_d cap)
      D: s=3, t=1  (light walk L -> m -> v1, film splat at i = max_d-1)

    Before the skip_s0 fix every denominator also carried the unreachable
    s'=0 ratio, so the weights summed to < 1 and deepest-bounce radiance
    was systematically under-weighted."""
    import jax.numpy as jnp

    from light_transport_tpu.integrators.bdpt import (
        Vertices,
        _camera_pdf_dir,
        _diffuse_pdf_area,
        _to_area,
        cam_side_mis,
        light_side_mis,
    )
    from light_transport_tpu.scene.lights import sample_light_points

    scene, cfg = cornell_box_scene(width=8, height=8, spp=1, max_depth=2,
                                   include_cone=False)
    n = 64
    key = jax.random.key(13)
    u_aa = jax.random.uniform(key, (n, 2))
    o, d = camera_rays(scene, cfg, u_aa)
    cam_u = jax.random.uniform(jax.random.fold_in(key, 1), (n, 2, 2))
    cam = generate_camera_subpaths(scene, cfg, o[:n], d[:n], cam_u)

    ul = jax.random.uniform(jax.random.fold_in(key, 2), (n, 3))
    lp, ln, _, pdf_pos = sample_light_points(scene.lights, ul[:, 0],
                                             ul[:, 1], ul[:, 2])
    pdf_area_light = 1.0 / float(scene.lights.total_area)

    v1, ns1 = cam.pos[:, 0], cam.ns[:, 0]
    m, nsm = cam.pos[:, 1], cam.ns[:, 1]
    usable = np.asarray(
        cam.valid[:, 0] & cam.valid[:, 1]
        & ~cam.is_delta[:, 0] & ~cam.is_delta[:, 1]
        & ~cam.is_light[:, 0] & ~cam.is_light[:, 1]
    )
    zeros = jnp.zeros((n,))

    # with max_len == 2 the walk never fills pdf_rev[0] (the continuation
    # sample that would set it is skipped at the last step), so chain the
    # closed form everywhere instead of the stored value
    p_v1 = cam.pdf_fwd[:, 0]
    p_m = cam.pdf_fwd[:, 1]
    p_mv1 = _diffuse_pdf_area(nsm, m, v1, ns1)
    p_mL = _diffuse_pdf_area(nsm, m, lp, ln)
    p_Lm = _diffuse_pdf_area(ln, lp, m, nsm)

    # A: s=1 at j = max_d-1 — the s=1 block with the s'=0 term excluded
    denom_a = cam_side_mis(cam, 1, p_Lm, p_mv1, True)
    w_a = 1.0 / (1.0 + denom_a)

    # B: s=2, i=0, j=0 — the s>=2 block at the (i+1)+(j+1) == max_d cap
    lv_b = Vertices(
        pos=(cam.pos * 0.0).at[:, 0].set(m),
        ns=(cam.ns * 0.0).at[:, 0].set(nsm),
        diffuse=cam.diffuse * 0.0,
        beta=cam.beta * 0.0,
        pdf_fwd=(cam.pdf_fwd * 0.0).at[:, 0].set(p_Lm),
        pdf_rev=cam.pdf_rev * 0.0,
        valid=(cam.valid & False).at[:, 0].set(cam.valid[:, 1]),
        is_light=cam.is_light & False,
        is_delta=cam.is_delta & False,
        emit=cam.emit * 0.0,
        spec=cam.spec * 0.0, shin=cam.shin * 0.0,
        win=cam.win * 0.0,
    )
    l0 = dict(pos=lp, ns=ln)
    denom_b = cam_side_mis(cam, 0, p_mv1, zeros, True) \
        + light_side_mis(lv_b, l0, pdf_area_light, 1, p_m, p_mL,
                         skip_s0=True)
    w_b = 1.0 / (1.0 + denom_b)

    # D: s=3, t=1 — splat at i = max_d-1
    dir_cp = (v1 - scene.camera) / jnp.linalg.norm(
        v1 - scene.camera, axis=-1, keepdims=True)
    cam_area_v1 = _to_area(_camera_pdf_dir(scene, cfg, dir_cp),
                           jnp.broadcast_to(scene.camera, v1.shape),
                           v1, ns1)
    lv_d = Vertices(
        pos=(cam.pos * 0.0).at[:, 0].set(m).at[:, 1].set(v1),
        ns=(cam.ns * 0.0).at[:, 0].set(nsm).at[:, 1].set(ns1),
        diffuse=cam.diffuse * 0.0,
        beta=cam.beta * 0.0,
        pdf_fwd=(cam.pdf_fwd * 0.0).at[:, 0].set(p_Lm).at[:, 1].set(p_mv1),
        pdf_rev=cam.pdf_rev * 0.0,
        valid=(cam.valid & False).at[:, 0].set(cam.valid[:, 1])
                                 .at[:, 1].set(cam.valid[:, 1]),
        is_light=cam.is_light & False,
        is_delta=cam.is_delta & False,
        emit=cam.emit * 0.0,
        spec=cam.spec * 0.0, shin=cam.shin * 0.0,
        win=cam.win * 0.0,
    )
    denom_d = light_side_mis(lv_d, l0, pdf_area_light, 2, cam_area_v1,
                             p_m, skip_s0=True)
    w_d = 1.0 / (1.0 + denom_d)

    total = np.asarray(w_a + w_b + w_d)[usable]
    assert usable.sum() > 20, usable.sum()
    np.testing.assert_allclose(total, 1.0, rtol=1e-4)


@pytest.mark.slow
def test_bdpt_specular_chain_parity_glass_scene():
    """BDPT vs PT on the glass (whisky tumbler in the Cornell box) scene:
    specular transmissive chains are exercised, and both estimators target
    the same transport paths, so the image means must agree within MC error
    (3 sigma; sigma from the PT per-sample spread + a multi-seed BDPT
    spread).  A wrong Fresnel split or MIS weight on specular chains shifts
    the mean well outside this band."""
    from light_transport_tpu.models.presets import glass_scene

    scene, cfg = glass_scene(width=20, height=20, spp=24, max_depth=5)
    from light_transport_tpu.integrators.path_tracer import render_image

    img_pt, samples = render_image(scene, cfg, jax.random.key(0),
                                   return_samples=True)
    img_pt = np.asarray(img_pt)
    s = np.clip(np.asarray(samples), 0.0, 1.0)
    n_samp = s.shape[2] * s.shape[0] * s.shape[1]
    se_pt = float(np.sqrt(s.var(axis=2).mean() / n_samp))

    n_seeds = 5
    bd_imgs = np.stack([
        np.asarray(render_bdpt(scene, cfg, jax.random.key(10 + k)))
        for k in range(n_seeds)
    ])
    bd = bd_imgs.reshape(n_seeds, -1).mean(axis=1)
    se_bd = float(np.std(bd, ddof=1) / np.sqrt(len(bd)))
    diff = abs(img_pt.mean() - float(np.mean(bd)))
    bound = 3.0 * np.sqrt(se_pt**2 + se_bd**2) + 1e-3
    assert diff < bound, (img_pt.mean(), np.mean(bd), diff, bound)

    # per-pixel bound (mean-level-only parity would let
    # spatially compensating MIS errors — e.g. swapped strategy weights —
    # pass).  Per-pixel luminance z-scores against the combined per-pixel
    # MC error; a localized systematic shift inflates the tail.
    lum = img_pt.mean(axis=-1)
    bd_lum = bd_imgs.mean(axis=-1)
    sig_pt = np.sqrt(s.mean(axis=-1).var(axis=2) / cfg.spp)
    sig_bd = bd_lum.std(axis=0, ddof=1) / np.sqrt(n_seeds)
    sig = np.sqrt(sig_pt**2 + sig_bd**2) + 5e-3
    z = np.abs(lum - bd_lum.mean(axis=0)) / sig
    mae = np.abs(lum - bd_lum.mean(axis=0)).mean()
    exp_mae = (np.sqrt(2 / np.pi) * sig).mean()
    assert mae < 2.0 * exp_mae, (mae, exp_mae)
    assert np.quantile(z, 0.95) < 4.0, np.quantile(z, [0.5, 0.95, 1.0])


def test_bdpt_absorbing_media_parity_glass_scene():
    """BDPT vs PT on the whisky-glass scene with a strongly ABSORBING
    liquid (sigma_a > 0, sigma_s = 0): BDPT's subpath walks now carry the
    interior medium and Beer-Lambert their segments,
    so both estimators target the same transport — image means within
    3 sigma, and the absorption must actually bite (darker than the
    clear-liquid render), proving the attenuation path executed."""
    import dataclasses

    from light_transport_tpu.models.presets import glass_scene
    from light_transport_tpu.integrators.path_tracer import render_image
    from light_transport_tpu.scene.material import Material, MaterialTable
    from light_transport_tpu.scene.cornell import cornell_materials
    from light_transport_tpu.scene.glass import glass_materials
    from light_transport_tpu.scene.material import presets

    scene, cfg = glass_scene(width=20, height=20, spp=24, max_depth=5)
    rows = cornell_materials() + glass_materials()
    # liquid = glass row 1 (mat id 6): tint it with absorption
    rows[6] = dataclasses.replace(rows[6], sigma_a=(0.05, 0.15, 0.3))
    scene_a = dataclasses.replace(
        scene, materials=MaterialTable.build(rows))

    img_pt, samples = render_image(scene_a, cfg, jax.random.key(0),
                                   return_samples=True)
    img_pt = np.asarray(img_pt)
    s = np.clip(np.asarray(samples), 0.0, 1.0)
    n_samp = s.shape[2] * s.shape[0] * s.shape[1]
    se_pt = float(np.sqrt(s.var(axis=2).mean() / n_samp))

    n_seeds = 5
    bd_imgs = np.stack([
        np.asarray(render_bdpt(scene_a, cfg, jax.random.key(30 + k)))
        for k in range(n_seeds)
    ])
    bd = bd_imgs.reshape(n_seeds, -1).mean(axis=1)
    se_bd = float(np.std(bd, ddof=1) / np.sqrt(len(bd)))
    diff = abs(img_pt.mean() - float(np.mean(bd)))
    bound = 3.0 * np.sqrt(se_pt**2 + se_bd**2) + 1e-3
    assert diff < bound, (img_pt.mean(), float(np.mean(bd)), diff, bound)

    # the attenuation must actually darken the BDPT estimate vs the
    # clear-liquid scene (guards against the medium state silently never
    # engaging, which would also "pass" parity on a PT with the same bug)
    bd_clear = np.asarray(render_bdpt(scene, cfg, jax.random.key(30)))
    assert bd_imgs[0].mean() < bd_clear.mean() - 1e-4, (
        bd_imgs[0].mean(), bd_clear.mean())
