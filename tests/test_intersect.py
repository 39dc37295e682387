import pytest
import jax.numpy as jnp
import numpy as np

from light_transport_tpu.ops import intersect
from light_transport_tpu.scene.geometry import TriangleMesh


def single_tri_mesh():
    verts = np.asarray(
        [[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]]
    )
    return TriangleMesh.build(verts, [0])


def test_triangle_hit_and_t():
    mesh = single_tri_mesh()
    o = jnp.asarray([[0.2, 0.2, 1.0], [0.2, 0.2, 1.0], [2.0, 2.0, 1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    hit = intersect.intersect_rays(o, d, mesh)
    assert bool(hit.valid[0])  # straight down onto the triangle
    np.testing.assert_allclose(float(hit.t[0]), 1.0, atol=1e-5)
    assert int(hit.tri[0]) == 0
    assert not bool(hit.valid[1])  # points away
    assert not bool(hit.valid[2])  # outside barycentric range


def test_triangle_edge_and_parallel():
    mesh = single_tri_mesh()
    o = jnp.asarray([[0.5, 0.5, 1.0], [0.0, 0.0, 0.5]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    hit = intersect.intersect_rays(o, d, mesh)
    assert bool(hit.valid[0])  # on the hypotenuse edge (u+v == 1)
    assert not bool(hit.valid[1])  # parallel to the plane


def test_nearest_of_two():
    verts = np.asarray(
        [
            [[-1, -1, -1.0], [1, -1, -1.0], [0, 1, -1.0]],
            [[-1, -1, -3.0], [1, -1, -3.0], [0, 1, -3.0]],
        ]
    )
    mesh = TriangleMesh.build(verts, [0, 0])
    o = jnp.asarray([[0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit = intersect.intersect_rays(o, d, mesh)
    assert int(hit.tri[0]) == 0
    np.testing.assert_allclose(float(hit.t[0]), 1.0, atol=1e-5)


def test_chunked_matches_unchunked():
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(40, 3, 3))
    mesh = TriangleMesh.build(verts, np.zeros(40, np.int32))
    o = jnp.asarray(rng.normal(size=(100, 3)).astype(np.float32)) * 3
    d_np = rng.normal(size=(100, 3)).astype(np.float32)
    d = jnp.asarray(d_np / np.linalg.norm(d_np, axis=-1, keepdims=True))
    h0 = intersect.intersect_rays(o, d, mesh)
    h1 = intersect.intersect_rays(o, d, mesh, ray_chunk=17)
    np.testing.assert_array_equal(np.asarray(h0.valid), np.asarray(h1.valid))
    np.testing.assert_array_equal(np.asarray(h0.tri), np.asarray(h1.tri))
    np.testing.assert_allclose(np.asarray(h0.t), np.asarray(h1.t), rtol=1e-6)
    occ0 = intersect.occluded(o, d, mesh, jnp.full((100,), 2.0))
    occ1 = intersect.occluded(o, d, mesh, jnp.full((100,), 2.0), ray_chunk=17)
    np.testing.assert_array_equal(np.asarray(occ0), np.asarray(occ1))


def test_occluded_respects_max_dist():
    mesh = single_tri_mesh()
    o = jnp.asarray([[0.2, 0.2, 1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    assert bool(intersect.occluded(o, d, mesh, jnp.asarray([2.0]))[0])
    assert not bool(intersect.occluded(o, d, mesh, jnp.asarray([0.5]))[0])


def test_sphere_intersect():
    o = jnp.asarray([[0.0, 0.0, 5.0], [0.0, 3.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    t = intersect.sphere_intersect(o, d, jnp.asarray([0.0, 0.0, 0.0]), 1.0)
    np.testing.assert_allclose(float(t[0]), 4.0, atol=1e-5)
    assert np.isinf(float(t[1]))


def test_plane_intersect():
    o = jnp.asarray([[0.0, 0.0, 2.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    t = intersect.plane_intersect(
        o, d, jnp.asarray([0.0, 0.0, 0.0]), jnp.asarray([0.0, 0.0, 1.0])
    )
    np.testing.assert_allclose(float(t[0]), 2.0, atol=1e-6)


def test_aabb_intersect():
    o = jnp.asarray([[0.0, 0.0, 5.0], [3.0, 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    hit, tn, tf = intersect.aabb_intersect(
        o, d, jnp.asarray([-1.0, -1.0, -1.0]), jnp.asarray([1.0, 1.0, 1.0])
    )
    assert bool(hit[0]) and not bool(hit[1])
    np.testing.assert_allclose(float(tn[0]), 4.0, atol=1e-5)
    np.testing.assert_allclose(float(tf[0]), 6.0, atol=1e-5)


def _fan_mesh(n_spokes=12):
    """Triangle fan around the origin in the z=0 plane."""
    from light_transport_tpu.scene.geometry import TriangleMesh

    ang = np.linspace(0, 2 * np.pi, n_spokes + 1)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
    tris = np.stack(
        [np.zeros((n_spokes, 3)), rim[:-1], rim[1:]], axis=1
    ).astype(np.float32)
    return TriangleMesh.build(tris, np.zeros(n_spokes, np.int32))


def test_watertight_matches_mt_on_interior_hits():
    from light_transport_tpu.scene.geometry import TriangleMesh

    rng = np.random.default_rng(11)
    verts = rng.normal(scale=2.0, size=(300, 3, 3)).astype(np.float32)
    mesh = TriangleMesh.build(verts, np.zeros(300, np.int32))
    o = jnp.asarray(rng.normal(scale=4.0, size=(512, 3)).astype(np.float32))
    d_raw = rng.normal(size=(512, 3)).astype(np.float32)
    d = jnp.asarray(d_raw / np.linalg.norm(d_raw, axis=1, keepdims=True))
    hm = intersect.intersect_rays(o, d, mesh)
    hw = intersect.intersect_rays_watertight(o, d, mesh)
    vm, vw = np.asarray(hm.valid), np.asarray(hw.valid)
    # the two formulations agree except at f32-rounding edge cases
    assert (vm != vw).mean() < 0.01
    both = vm & vw
    agree = np.asarray(hm.tri)[both] == np.asarray(hw.tri)[both]
    # grazing hits in a random soup may resolve to a different (overlapping)
    # nearest triangle under the two rounding schemes
    assert agree.mean() > 0.99
    np.testing.assert_allclose(np.asarray(hm.t)[both][agree],
                               np.asarray(hw.t)[both][agree],
                               rtol=1e-3, atol=1e-5)


def test_watertight_shared_edges_never_crack():
    """Rays aimed exactly at shared fan edges and at the shared center
    vertex must always hit at least one triangle — the property the
    watertight transform guarantees (reference src/intersects.py:267-445)."""
    mesh = _fan_mesh(24)
    ang = np.linspace(0, 2 * np.pi, 25)[:-1]
    # points exactly on each spoke (shared edge between two triangles), at
    # several radii, plus the center vertex shared by all 24
    radii = np.asarray([1e-4, 0.25, 0.5 + 1e-7, 0.999], np.float32)
    pts = np.concatenate(
        [np.stack([r * np.cos(ang), r * np.sin(ang), np.zeros_like(ang)], -1)
         for r in radii]
        + [np.zeros((1, 3), np.float32)]
    ).astype(np.float32)
    # oblique viewpoint so the permute/shear axes vary per-ray
    cam = np.asarray([0.3, -0.2, 3.0], np.float32)
    o = jnp.asarray(np.tile(cam, (len(pts), 1)))
    dd = pts - cam
    d = jnp.asarray(dd / np.linalg.norm(dd, axis=1, keepdims=True))
    hw = intersect.intersect_rays_watertight(o, d, mesh)
    assert bool(np.asarray(hw.valid).all()), (
        "watertight test dropped an edge/vertex ray"
    )
    np.testing.assert_allclose(
        np.asarray(hw.t), np.linalg.norm(dd, axis=1), rtol=1e-4
    )


def test_watertight_respects_t_window():
    mesh = _fan_mesh(6)
    o = jnp.asarray([[0.1, 0.05, 2.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    assert bool(intersect.intersect_rays_watertight(o, d, mesh).valid[0])
    h = intersect.intersect_rays_watertight(o, d, mesh, t_max=1.5)
    assert not bool(h.valid[0])
    h = intersect.intersect_rays_watertight(o, d, mesh, t_min=2.5)
    assert not bool(h.valid[0])


@pytest.mark.slow
def test_watertight_ray_chunking():
    mesh = _fan_mesh(8)
    rng = np.random.default_rng(5)
    o = jnp.asarray(np.tile([0.0, 0.0, 3.0], (300, 1)).astype(np.float32))
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    pts[:, 2] = 0.0
    dd = pts - np.asarray([0, 0, 3.0])
    d = jnp.asarray(dd / np.linalg.norm(dd, axis=1, keepdims=True))
    full = intersect.intersect_rays_watertight(o, d, mesh)
    chunked = intersect.intersect_rays_watertight(o, d, mesh, ray_chunk=128)
    np.testing.assert_array_equal(np.asarray(full.valid),
                                  np.asarray(chunked.valid))
    np.testing.assert_array_equal(np.asarray(full.tri),
                                  np.asarray(chunked.tri))


def test_watertight_shared_edges_unfriendly_coordinates():
    """Shared-edge watertightness over a float32-hostile coordinate range
   : the fan is scaled by 1/3 (vertices land off the
    binary grid) and translated to a large offset where one ulp is ~2^-11 of
    the geometry scale, so every edge-function product rounds.  The argument
    in ops/intersect.py (adjacent triangles see the same rounded products,
    negated) must hold here too: no edge or vertex ray may fall through.

    The reference instead re-evaluates exactly-zero edge functions in
    float64 (src/intersects.py:316-329) — this program runs float32
    throughout; this test is the evidence the f32-only policy is safe.
    """
    from light_transport_tpu.scene.geometry import TriangleMesh

    n_spokes = 24
    off = np.asarray([4096.37, -8192.11, 513.77], np.float64)
    scale = 1.0 / 3.0
    ang = np.linspace(0, 2 * np.pi, n_spokes + 1)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
    tris = (np.stack([np.zeros((n_spokes, 3)), rim[:-1], rim[1:]], axis=1)
            * scale + off)
    mesh = TriangleMesh.build(tris.astype(np.float32),
                              np.zeros(n_spokes, np.int32))
    # aim exactly along the spokes (shared edges) and at the center vertex,
    # using the float32-rounded vertex positions as targets
    v32 = tris.astype(np.float32)
    targets = [v32[:, 0, :][:1]]  # shared center vertex
    for r in (0.2, 0.5, 0.93):
        # points on each spoke: center + r * (rim_vertex - center), rounded
        spoke = v32[:, 0, :] + np.float32(r) * (v32[:, 1, :] - v32[:, 0, :])
        targets.append(spoke.astype(np.float32))
    pts = np.concatenate(targets)
    cam = (off + np.asarray([0.21, -0.13, 2.7])).astype(np.float32)
    o = jnp.asarray(np.tile(cam, (len(pts), 1)))
    dd = pts.astype(np.float64) - cam.astype(np.float64)
    d = jnp.asarray((dd / np.linalg.norm(dd, axis=1, keepdims=True))
                    .astype(np.float32))
    hw = intersect.intersect_rays_watertight(o, d, mesh)
    assert bool(np.asarray(hw.valid).all()), (
        "watertight test dropped an edge/vertex ray at unfriendly coords"
    )


def test_watertight_render_parity():
    """Scene.with_watertight() routes the whole render through the
    PBRT-style watertight test (the reference flagship's convention,
    src/utils.py:52-68 -> src/intersects.py:267-445).  On crack-free
    geometry it must reproduce the robust-MT render: same RNG, same
    estimator, only the triangle test differs.  The watertight transform
    computes t by different arithmetic, so hit points differ in ULPs and
    individual paths diverge numerically — the comparison is statistical
    (same-seed images estimate the same integrand; per-pixel deltas are
    bounce-noise-sized), plus an MAE bound far below image contrast."""
    import numpy as np

    from light_transport_tpu.api import render
    from light_transport_tpu.scene.cornell import cornell_box_scene

    scene, cfg = cornell_box_scene(width=32, height=32, spp=4, max_depth=3)
    assert not scene.watertight
    img_mt = np.asarray(render(scene, cfg, seed=9))
    img_wt = np.asarray(render(scene.with_watertight(), cfg, seed=9))
    assert np.isfinite(img_wt).all()
    assert abs(img_wt.mean() - img_mt.mean()) < 2e-3
    mae = np.abs(img_wt - img_mt).mean()
    assert mae < 8e-3, mae


def test_watertight_occlusion_parity():
    """occluded_watertight agrees with the MT any-hit away from edges and
    honors the active-lane empty-interval convention through dispatch."""
    import numpy as np

    from light_transport_tpu.ops.dispatch import scene_occluded
    from light_transport_tpu.scene.cornell import cornell_box_scene

    scene, _ = cornell_box_scene(width=8, height=8, spp=1, max_depth=2)
    rng = np.random.default_rng(3)
    n = 256
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    occ_mt = np.asarray(scene_occluded(scene, o, d, 5.0))
    occ_wt = np.asarray(scene_occluded(scene.with_watertight(), o, d, 5.0))
    assert (occ_mt == occ_wt).mean() > 0.99
    # inactive lanes report unoccluded in both modes
    active = np.zeros((n,), bool)
    occ_off = np.asarray(
        scene_occluded(scene.with_watertight(), o, d, 5.0, active=active))
    assert not occ_off.any()
