"""Intersection dispatch (ops/dispatch.py) and the roped BVH walk it routes
to: one routine per scene kind, the same answers as brute force."""

import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest

from light_transport_tpu.accel import bvh as bvh_mod
from light_transport_tpu.core.config import RenderConfig
from light_transport_tpu.ops import dispatch, intersect
from light_transport_tpu.scene.geometry import TriangleMesh
from light_transport_tpu.scene.material import Material, MaterialTable, presets
from light_transport_tpu.scene.scene import Scene


def random_mesh(t, seed=0, spread=4.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, size=(t, 1, 3))
    tri = base + rng.normal(scale=0.4, size=(t, 3, 3))
    is_light = np.zeros(t, bool)
    is_light[0] = True  # a light table needs one emitter
    return TriangleMesh.build(tri, np.zeros(t, np.int32), is_light)


def random_rays(n, seed=1, spread=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def scene_of_kind(kind, t=120, seed=0):
    mats = MaterialTable.build([Material(color=presets.WHITE, emission=1.0)])
    scene = Scene.build(random_mesh(t, seed), mats, camera=[0.0, 0.0, 9.0])
    if kind == "bvh":
        return scene.with_bvh()
    if kind == "watertight":
        return scene.with_watertight()
    return scene


KINDS = ["brute", "bvh", "watertight"]
ROUTINES = {
    ("brute", "nearest"): (intersect, "intersect_rays"),
    ("bvh", "nearest"): (bvh_mod, "intersect_bvh"),
    ("watertight", "nearest"): (intersect, "intersect_rays_watertight"),
    ("brute", "any"): (intersect, "occluded"),
    ("bvh", "any"): (bvh_mod, "occluded_bvh"),
    ("watertight", "any"): (intersect, "occluded_watertight"),
}


def test_no_pallas_package():
    assert importlib.util.find_spec("light_transport_tpu.ops.pallas") is None


@pytest.mark.parametrize("query", ["nearest", "any"])
@pytest.mark.parametrize("kind", KINDS)
def test_dispatch_routes_by_scene_kind(monkeypatch, kind, query):
    """Each scene kind reaches exactly its routine, and no other."""
    scene = scene_of_kind(kind)
    o, d = random_rays(64)
    calls = []
    for (_, _), (mod, name) in ROUTINES.items():
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    if query == "nearest":
        dispatch.scene_intersect(scene, o, d)
    else:
        dispatch.scene_occluded(scene, o, d, 5.0)
    expected = ROUTINES[(kind, query)][1]
    # the BVH any-hit routine is a thin wrapper over the nearest walk
    assert calls[0] == expected, calls
    assert set(calls) <= {expected, "intersect_bvh"}, calls


@pytest.mark.parametrize("kind", KINDS)
def test_dispatch_nearest_matches_brute_force(kind):
    scene = scene_of_kind(kind, seed=3)
    o, d = random_rays(200, seed=4)
    got = dispatch.scene_intersect(scene, o, d)
    ref = intersect.intersect_rays(o, d, scene.mesh)
    np.testing.assert_array_equal(np.asarray(got.valid),
                                  np.asarray(ref.valid))
    v = np.asarray(ref.valid)
    np.testing.assert_allclose(np.asarray(got.t)[v], np.asarray(ref.t)[v],
                               rtol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_dispatch_any_hit_matches_brute_force(kind):
    scene = scene_of_kind(kind, seed=5)
    o, d = random_rays(200, seed=6)
    md = jnp.linspace(0.5, 12.0, 200)
    got = dispatch.scene_occluded(scene, o, d, md)
    ref = intersect.occluded(o, d, scene.mesh, md)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("kind", KINDS)
def test_inactive_lanes_miss_and_are_unoccluded(kind):
    """``active=False`` lanes report no hit and no occlusion; active lanes
    are unchanged."""
    scene = scene_of_kind(kind, seed=7)
    o, d = random_rays(128, seed=8)
    active = jnp.asarray(np.arange(128) % 3 != 0)
    full = dispatch.scene_intersect(scene, o, d)
    part = dispatch.scene_intersect(scene, o, d, active=active)
    a = np.asarray(active)
    assert not np.asarray(part.valid)[~a].any()
    np.testing.assert_array_equal(np.asarray(part.tri)[a],
                                  np.asarray(full.tri)[a])
    occ_full = dispatch.scene_occluded(scene, o, d, 20.0)
    occ = dispatch.scene_occluded(scene, o, d, 20.0, active=active)
    assert np.asarray(occ_full).any()
    assert not np.asarray(occ)[~a].any()
    np.testing.assert_array_equal(np.asarray(occ)[a],
                                  np.asarray(occ_full)[a])


@pytest.mark.parametrize("query", ["nearest", "any"])
def test_chunked_bvh_pads_and_matches(monkeypatch, query):
    """Batches above BVH_LANE_CHUNK run as padded chunks with the same
    result (chunk shrunk so the test stays small; 300 = 2 chunks + 44)."""
    scene = scene_of_kind("bvh", seed=9)
    o, d = random_rays(300, seed=10)
    if query == "nearest":
        ref = dispatch.scene_intersect(scene, o, d)
    else:
        ref = dispatch.scene_occluded(scene, o, d, 8.0)
    monkeypatch.setattr(dispatch, "BVH_LANE_CHUNK", 128)
    if query == "nearest":
        got = dispatch.scene_intersect(scene, o, d)
        np.testing.assert_array_equal(np.asarray(got.tri),
                                      np.asarray(ref.tri))
        np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))
    else:
        got = dispatch.scene_occluded(scene, o, d, 8.0)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("t,n", [(40, 96), (500, 300), (2000, 700)])
def test_roped_walk_matches_brute_force(t, n):
    mesh = random_mesh(t, seed=t)
    bvh, ordered = bvh_mod.build(mesh)
    o, d = random_rays(n, seed=t + 1)
    got = bvh_mod.intersect_bvh(o, d, ordered, bvh)
    ref = intersect.intersect_rays(o, d, ordered)
    np.testing.assert_array_equal(np.asarray(got.valid),
                                  np.asarray(ref.valid))
    v = np.asarray(ref.valid)
    np.testing.assert_allclose(np.asarray(got.t)[v], np.asarray(ref.t)[v],
                               rtol=1e-6)
    same_tri = np.asarray(got.tri)[v] == np.asarray(ref.tri)[v]
    assert same_tri.mean() > 0.99


def test_roped_walk_dead_lanes_and_any_hit():
    """Dead lanes (t_max = -inf) retire without a hit; any-hit agrees with
    brute force on the live ones."""
    mesh = random_mesh(2000, seed=11)
    bvh, ordered = bvh_mod.build(mesh)
    o, d = random_rays(512, seed=12)
    live = np.arange(512) % 4 != 1
    t_max = jnp.where(jnp.asarray(live), jnp.inf, -jnp.inf)
    got = bvh_mod.intersect_bvh(o, d, ordered, bvh, t_max=t_max)
    assert not np.asarray(got.valid)[~live].any()
    ref = intersect.intersect_rays(o, d, ordered)
    np.testing.assert_array_equal(np.asarray(got.valid)[live],
                                  np.asarray(ref.valid)[live])
    md = jnp.full((512,), 3.0)
    occ = bvh_mod.occluded_bvh(o, d, ordered, bvh, md)
    occ_ref = intersect.occluded(o, d, ordered, md)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(occ_ref))


def test_bvh_render_path_uses_no_platform_branch():
    """A BVH scene renders through dispatch on the CPU exactly as it would
    on any backend: the module names no platform."""
    import inspect

    src = inspect.getsource(dispatch)
    assert "platform" not in src and "default_backend" not in src
    from light_transport_tpu.integrators.path_tracer import render_image
    import jax

    scene = scene_of_kind("bvh", t=60, seed=13)
    img = np.asarray(render_image(scene, RenderConfig(width=8, height=8,
                                                      spp=1, max_depth=2),
                                  jax.random.key(0)))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
