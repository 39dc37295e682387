"""Renderable analytic sphere/plane primitives.

The reference defines Sphere/Plane jitclasses with scalar kernels
(src/primitives.py:41-66, src/intersects.py:11-42,142-162) but never renders
them; here they are first-class scene members (scene/analytic.py) merged
into the dispatch path, so every integrator shades them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from light_transport_tpu.core.config import RenderConfig
from light_transport_tpu.integrators.path_tracer import render_image
from light_transport_tpu.integrators.whitted import render_whitted
from light_transport_tpu.scene.analytic import AnalyticPrims
from light_transport_tpu.scene.cornell import sphere_triangles
from light_transport_tpu.scene.geometry import TriangleMesh, quad_triangles
from light_transport_tpu.scene.material import (
    Color,
    Material,
    MaterialTable,
    presets,
)
from light_transport_tpu.scene.scene import Scene

_C = (0.0, 0.0, -1.0)  # sphere center
_R = 1.0


def _base(analytic=None, sphere_mesh=False, sphere_mat=None, n_theta=48):
    """Floor + ceiling light + (analytic | tessellated) sphere."""
    floor = quad_triangles((-20, -1, -20), (-20, -1, 20), (20, -1, 20),
                           (20, -1, -20))
    lq = quad_triangles((-2, 8, -3), (2, 8, -3), (2, 8, 1), (-2, 8, 1))
    tris = [floor, lq]
    mat_id = [0, 0, 1, 1]
    is_light = [False, False, True, True]
    if sphere_mesh:
        st = sphere_triangles(center=_C, radius=_R, n_theta=n_theta,
                              n_phi=2 * n_theta)
        tris.append(st)
        mat_id += [2] * len(st)
        is_light += [False] * len(st)
    mats = MaterialTable.build([
        Material(color=presets.GREY),
        # emission tuned so the floor does NOT clip at 1.0 (clipped
        # pixels would hide shadows from the assertions below)
        Material(color=presets.WHITE, emission=6.0),
        sphere_mat or Material(color=presets.TURQUOISE),
    ])
    mesh = TriangleMesh.build(np.concatenate(tris),
                              np.asarray(mat_id, np.int32),
                              np.asarray(is_light, bool))
    scene = Scene.build(mesh, mats, camera=[0.0, 1.0, 6.0],
                        analytic=analytic)
    cfg = RenderConfig(width=40, height=40, spp=8, max_depth=3,
                       f_distance=3.0)
    return scene, cfg


@pytest.mark.slow
def test_analytic_sphere_matches_tessellated():
    """A diffuse analytic sphere renders the same image as a finely
    tessellated mesh sphere of the same center/radius (same seed, same
    estimator; tolerance covers the tessellation error)."""
    prims = AnalyticPrims.build(spheres=[(_C, _R, 2)])
    scene_a, cfg = _base(analytic=prims)
    scene_m, _ = _base(sphere_mesh=True)
    img_a = np.asarray(render_image(scene_a, cfg, jax.random.key(0)))
    img_m = np.asarray(render_image(scene_m, cfg, jax.random.key(0)))
    assert np.abs(img_a - img_m).mean() < 0.015
    assert abs(img_a.mean() - img_m.mean()) < 0.01


def test_analytic_sphere_matches_tessellated_fast():
    """Cheap default-suite version of the test above: coarser tessellation
    (n_theta=24, ~2.3k tris — the CPU brute-force N x T render dominates
    the slow variant's 135 s) and fewer samples, with a correspondingly
    looser bound (measured MAE 0.0007)."""
    prims = AnalyticPrims.build(spheres=[(_C, _R, 2)])
    scene_a, cfg = _base(analytic=prims)
    scene_m, _ = _base(sphere_mesh=True, n_theta=24)
    cfg = dataclasses.replace(cfg, spp=6)
    img_a = np.asarray(render_image(scene_a, cfg, jax.random.key(0)))
    img_m = np.asarray(render_image(scene_m, cfg, jax.random.key(0)))
    assert np.abs(img_a - img_m).mean() < 0.005
    assert abs(img_a.mean() - img_m.mean()) < 0.003


def test_analytic_sphere_occludes_shadow_rays():
    """The analytic sphere blocks visibility: shadow rays from floor points
    under the sphere toward the overhead light must report occluded, while
    rays well to the side must not (the NEE path uses exactly this call)."""
    from light_transport_tpu.ops.dispatch import scene_occluded

    prims = AnalyticPrims.build(spheres=[(_C, _R, 2)])
    scene, _ = _base(analytic=prims)
    light_c = jnp.asarray([0.0, 8.0, -1.0])
    under = jnp.asarray([[0.0, -0.999, -1.0], [0.3, -0.999, -0.8],
                         [-0.3, -0.999, -1.2]])
    aside = jnp.asarray([[5.0, -0.999, 3.0], [-6.0, -0.999, -4.0]])
    pts = jnp.concatenate([under, aside])
    to_l = light_c - pts
    dist = jnp.linalg.norm(to_l, axis=-1)
    wi = to_l / dist[:, None]
    occ = np.asarray(scene_occluded(scene, pts, wi, dist * (1 - 1e-3)))
    assert occ[:3].all(), occ
    assert not occ[3:].any(), occ


def test_analytic_plane_matches_quad_floor():
    """An analytic floor plane shades identically to the (large) floor quad
    over the camera frustum."""
    prims = AnalyticPrims.build(planes=[((0, -1, 0), (0, 1, 0), 0)])
    # scene with plane floor: drop the quad floor by lifting it far away
    floor_far = quad_triangles((-1, -999, -1), (-1, -999, 1), (1, -999, 1),
                               (1, -999, -1))
    lq = quad_triangles((-2, 8, -3), (2, 8, -3), (2, 8, 1), (-2, 8, 1))
    mats = MaterialTable.build([
        Material(color=presets.GREY),
        Material(color=presets.WHITE, emission=6.0),
        Material(color=presets.TURQUOISE),
    ])
    mesh_p = TriangleMesh.build(
        np.concatenate([floor_far, lq]), np.asarray([0, 0, 1, 1], np.int32),
        np.asarray([False, False, True, True], bool))
    scene_p = Scene.build(mesh_p, mats, camera=[0.0, 1.0, 6.0],
                          analytic=prims)
    scene_q, cfg = _base()
    img_p = np.asarray(render_image(scene_p, cfg, jax.random.key(2)))
    img_q = np.asarray(render_image(scene_q, cfg, jax.random.key(2)))
    # identical geometry within the frustum -> same estimator, same seed;
    # skip the horizon rows where the finite quad legitimately ends and the
    # infinite plane continues
    np.testing.assert_allclose(img_p[8:], img_q[8:], atol=5e-3)


def test_whitted_renders_analytic_sphere():
    prims = AnalyticPrims.build(spheres=[(_C, _R, 2)])
    scene, cfg = _base(analytic=prims)
    img = np.asarray(render_whitted(scene, cfg, jax.random.key(0)))
    assert np.all(np.isfinite(img))
    assert img.mean() > 0.01
    # sphere silhouette: center pixels differ from the empty scene
    img0 = np.asarray(render_whitted(_base()[0], cfg, jax.random.key(0)))
    assert np.abs(img - img0)[14:26, 14:26].mean() > 0.01


def test_mirror_sphere_reflects_floor():
    """A mirror analytic sphere shows the floor in its lower half."""
    mirror = Material(color=presets.SILVER, is_diffuse=False, is_mirror=True,
                      reflection=1.0)
    prims = AnalyticPrims.build(spheres=[(_C, _R, 2)])
    scene, cfg = _base(analytic=prims, sphere_mat=mirror)
    img = np.asarray(render_image(scene, cfg, jax.random.key(3)))
    assert np.all(np.isfinite(img))
    # lower sphere region reflects the lit grey floor -> non-trivially bright
    assert img[22:27, 17:23].mean() > 0.02


def test_scene_occluded_inactive_lanes_skip_analytic():
    """advisor r3: the analytic-primitive OR-term in scene_occluded ignored
    ``active``, so inactive lanes (documented to report unoccluded) came
    back occluded whenever an analytic prim crossed their ray.  The
    triangle paths already honored the mask via their -inf max_dist."""
    from light_transport_tpu.ops.dispatch import scene_occluded

    prims = AnalyticPrims.build(spheres=[(_C, _R, 2)])
    scene, _ = _base(analytic=prims)
    # rays straight through the sphere center
    o = jnp.asarray([[0.0, 0.0, 4.0]] * 2, jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 2, jnp.float32)
    md = jnp.asarray([10.0, 10.0], jnp.float32)
    active = jnp.asarray([True, False])
    occ = np.asarray(scene_occluded(scene, o, d, md, active=active))
    assert occ[0]          # live lane: the sphere occludes
    assert not occ[1]      # dead lane: must report unoccluded
