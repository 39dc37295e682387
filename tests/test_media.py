"""Interior participating media in the surface path tracer.

The reference gestures at volumetric transport (``Medium`` enum,
src/constants.py:17-24; unused ``henyey_greenstein``,
src/medium_samples.py:14-16) but never attenuates anything inside its
transmissive objects.  Here Beer-Lambert absorption and HG in-scattering run
along every interior path segment; these tests pin the physics to analytic
values on a slab geometry where the answer is closed-form.
"""

import pytest
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from light_transport_tpu.core import rng
from light_transport_tpu.core.config import RenderConfig
from light_transport_tpu.integrators.path_tracer import trace_paths
from light_transport_tpu.scene.geometry import TriangleMesh, quad_triangles
from light_transport_tpu.scene.material import Color, Material, MaterialTable
from light_transport_tpu.scene.scene import Scene

_WHITE = Color.of((0, 0, 0), (1, 1, 1), (1, 1, 1))


def _slab_scene(sigma_a=(0.0, 0.0, 0.0), sigma_s=0.0, g=0.0, thickness=1.0,
                emission=1.0):
    """Camera rays -> glass slab (ior=1: straight transmission) -> emissive
    wall.  Outward normals: front face +z, back face -z, so the segment
    between them registers as interior (backface exit hit)."""
    half = 50.0  # effectively infinite quads
    front = quad_triangles(  # CCW seen from +z -> normal +z
        (-half, -half, 0.0), (half, -half, 0.0),
        (half, half, 0.0), (-half, half, 0.0))
    back = quad_triangles(  # CCW seen from -z -> normal -z
        (-half, -half, -thickness), (-half, half, -thickness),
        (half, half, -thickness), (half, -half, -thickness))
    wall = quad_triangles(  # emissive wall behind, facing +z
        (-half, -half, -5.0), (half, -half, -5.0),
        (half, half, -5.0), (-half, half, -5.0))
    tris = np.concatenate([front, back, wall])
    mat_id = np.asarray([0, 0, 0, 0, 1, 1], np.int32)
    is_light = np.asarray([0, 0, 0, 0, 1, 1], bool)
    glass = Material(color=_WHITE, ior=1.0, transmission=1.0,
                     is_diffuse=False, is_mirror=False,
                     sigma_a=tuple(sigma_a), sigma_s=sigma_s, medium_g=g)
    # black diffuse: the wall emits but does not reflect, so each path
    # scores at most once (emission_mode="always" + a reflective light
    # would double-count re-crossing paths)
    black = Color.of((0, 0, 0), (0, 0, 0), (0, 0, 0))
    light = Material(color=black, emission=emission)
    mesh = TriangleMesh.build(tris, mat_id, is_light)
    return Scene.build(mesh, MaterialTable.build([glass, light]),
                       camera=[0.0, 0.0, 3.0])


def _trace(scene, n=512, max_depth=4, seed=0):
    cfg = RenderConfig(width=1, height=1, spp=1, max_depth=max_depth,
                       emission_mode="always")
    origins = jnp.tile(jnp.asarray([[0.0, 0.0, 3.0]], jnp.float32), (n, 1))
    directions = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32),
                          (n, 1))
    uniforms = rng.path_uniforms(jax.random.key(seed), n, max_depth)
    radiance, _ = trace_paths(scene, cfg, origins, directions, uniforms)
    return np.asarray(radiance)


def test_beer_lambert_exact():
    """Pure absorption: radiance through the slab = E * exp(-sigma_a * L)
    per channel, exactly (perpendicular rays, ior=1, no randomness on the
    transmissive chain)."""
    sa = (0.5, 1.0, 2.0)
    L = 1.25
    scene = _slab_scene(sigma_a=sa, thickness=L)
    rad = _trace(scene, n=64)
    want = np.exp(-np.asarray(sa) * L)
    np.testing.assert_allclose(rad, np.broadcast_to(want, rad.shape),
                               rtol=2e-3)


def test_no_medium_is_identity():
    """sigma_a = 0 reproduces the un-attenuated radiance exactly."""
    scene = _slab_scene(sigma_a=(0.0, 0.0, 0.0))
    rad = _trace(scene, n=32)
    np.testing.assert_allclose(rad, 1.0, rtol=1e-4)


def test_hg_in_scattering_band():
    """Pure scattering (albedo 1): every forward path still reaches the
    (effectively infinite) emissive wall, so mean transmitted radiance lies
    between the unscattered fraction exp(-sigma_s*L) and 1, and scattering
    must actually remove energy from the collimated beam vs sigma_s=0."""
    ss, L = 0.8, 1.0
    scene = _slab_scene(sigma_s=ss, thickness=L)
    rad = _trace(scene, n=4096, max_depth=16).mean(axis=0)
    lo = np.exp(-ss * L)
    assert np.all(rad > lo - 1e-3), (rad, lo)
    assert np.all(rad <= 1.0 + 1e-6)
    # backscatter exists: some energy is lost to camera-side exits
    assert np.all(rad < 0.999), rad


@pytest.mark.slow
def test_scatter_depth_truncation_monotone():
    """Deeper bounce budgets recover more multiply-scattered light."""
    scene = _slab_scene(sigma_s=2.0, thickness=1.0)
    shallow = _trace(scene, n=4096, max_depth=2).mean()
    deep = _trace(scene, n=4096, max_depth=16).mean()
    assert deep > shallow + 0.01, (shallow, deep)


def _shadow_scene(sigma_a=(0.0, 0.0, 0.0), sigma_s=0.0, slab=True,
                  emission=50.0):
    """Diffuse floor at y=0, small emissive quad at y=3 facing down, and an
    (effectively infinite) horizontal glass slab spanning y in [1, 1.5]
    between them — every NEE shadow ray crosses 0.5 units of glass
    interior nearly vertically."""
    half, s = 50.0, 0.1
    floor = quad_triangles(  # CCW from +y -> normal +y
        (-half, 0.0, -half), (-half, 0.0, half),
        (half, 0.0, half), (half, 0.0, -half))
    light = quad_triangles(  # normal -y (faces the floor)
        (-s, 3.0, -s), (s, 3.0, -s), (s, 3.0, s), (-s, 3.0, s))
    tris = [floor, light]
    mat_id = [0, 0, 1, 1]
    is_light = [0, 0, 1, 1]
    if slab:
        bottom = quad_triangles(  # outward normal -y
            (-half, 1.0, -half), (half, 1.0, -half),
            (half, 1.0, half), (-half, 1.0, half))
        top = quad_triangles(  # outward normal +y
            (-half, 1.5, -half), (-half, 1.5, half),
            (half, 1.5, half), (half, 1.5, -half))
        tris += [bottom, top]
        mat_id += [2, 2, 2, 2]
        is_light += [0, 0, 0, 0]
    mesh = TriangleMesh.build(np.concatenate(tris),
                              np.asarray(mat_id, np.int32),
                              np.asarray(is_light, bool))
    white = Material(color=_WHITE)
    src = Material(color=_WHITE, emission=emission)
    glass = Material(color=_WHITE, ior=1.0, transmission=1.0,
                     is_diffuse=False, is_mirror=False,
                     sigma_a=tuple(sigma_a), sigma_s=sigma_s)
    return Scene.build(mesh, MaterialTable.build([white, src, glass]),
                       camera=[0.0, 5.0, 0.0])


def _direct_at_floor(scene, shadow_mode, n=256, seed=2):
    """Bounce-0 NEE contribution for lanes aimed straight down at the
    floor origin (max_depth=1 -> radiance is the direct term only)."""
    cfg = RenderConfig(width=1, height=1, spp=1, max_depth=1,
                       shadow_mode=shadow_mode)
    # start below the slab so the lane hits the floor, not the light
    origins = jnp.tile(jnp.asarray([[0.0, 0.8, 0.0]], jnp.float32), (n, 1))
    directions = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32),
                          (n, 1))
    uniforms = rng.path_uniforms(jax.random.key(seed), n, 1)
    radiance, _ = trace_paths(scene, cfg, origins, directions, uniforms)
    return np.asarray(radiance).mean(axis=0)


def test_shadow_transmittance_analytic():
    """Media-aware NEE: colored-glass shadows carry
    straight-line Beer-Lambert attenuation.  With identical seeds the
    absorbing-slab render divided by the clear-slab render must equal
    exp(-sigma_t * 0.5) per channel (shadow rays are near-vertical: the
    light spans 0.1/3 in angle, < 0.1% path-length spread)."""
    sa = (2.0, 0.5, 0.0)
    clear = _direct_at_floor(_shadow_scene(), "transmittance")
    tinted = _direct_at_floor(_shadow_scene(sigma_a=sa), "transmittance")
    want = np.exp(-np.asarray(sa) * 0.5)
    np.testing.assert_allclose(tinted / clear, want, rtol=5e-3)
    # scattering extinction also attenuates the unscattered direct term
    scat = _direct_at_floor(_shadow_scene(sigma_s=1.0), "transmittance")
    np.testing.assert_allclose(scat / clear, np.exp(-1.0 * 0.5), rtol=5e-3)


def test_shadow_opaque_blocks_glass():
    """The reference shadow rule (shadow_mode='opaque', the default):
    any occluder blocks — direct light under the slab is exactly zero
    (cast_one_shadow_ray, src/light_samples.py:44-52)."""
    dark = _direct_at_floor(_shadow_scene(), "opaque")
    np.testing.assert_allclose(dark, 0.0, atol=1e-7)
    # and without the slab the two modes agree exactly
    a = _direct_at_floor(_shadow_scene(slab=False), "opaque")
    b = _direct_at_floor(_shadow_scene(slab=False), "transmittance")
    np.testing.assert_allclose(a, b, rtol=1e-6)
    assert a.mean() > 0


def test_scene_transmittance_op():
    """ops/dispatch.scene_transmittance directly: exp(-sigma_t*L) through
    the slab, 1.0 for segments that stop short, 0.0 through opaque."""
    from light_transport_tpu.ops.dispatch import scene_transmittance

    sa, ss = (1.0, 2.0, 4.0), 0.5
    scene = _shadow_scene(sigma_a=sa, sigma_s=ss)
    o = jnp.asarray([[0.0, 0.01, 0.0]] * 3, jnp.float32)
    d = jnp.asarray([[0.0, 1.0, 0.0]] * 3, jnp.float32)
    # crosses the slab / stops short of it / runs into the light quad
    md = jnp.asarray([2.8, 0.5, 3.5], jnp.float32)
    tr = np.asarray(scene_transmittance(scene, o, d, md))
    want = np.exp(-(np.asarray(sa) + ss) * 0.5)
    np.testing.assert_allclose(tr[0], want, rtol=1e-3)
    np.testing.assert_allclose(tr[1], 1.0)
    # the light surface itself is an opaque blocker (consistent with the
    # occlusion rule: only the *sampled* point is exempt via max_dist)
    np.testing.assert_allclose(tr[2], 0.0, atol=1e-7)
    # straight down into the floor: opaque -> 0
    d2 = jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32)
    tr2 = np.asarray(scene_transmittance(
        scene, jnp.asarray([[0.3, 0.9, 0.0]], jnp.float32), d2,
        jnp.asarray([4.0], jnp.float32)))
    np.testing.assert_allclose(tr2, 0.0, atol=1e-7)


def test_transmittance_segment_ending_inside_medium():
    """advisor r3 follow-up: a shadow segment whose endpoint (the sampled
    light) lies *inside* a transmissive object used to skip the closing
    interior span entirely — Beer-Lambert was only applied on backface
    exits, so a light embedded in absorbing glass received full unattenuated
    direct light while the mirrored geometry (shading point inside, light
    outside) attenuated correctly.  The entered-but-not-exited extinction is
    now carried and applied over the closing span."""
    from light_transport_tpu.ops.dispatch import scene_transmittance

    sa, ss = (1.0, 2.0, 4.0), 0.5
    scene = _shadow_scene(sigma_a=sa, sigma_s=ss)  # slab spans y in [1, 1.5]
    o = jnp.asarray([[0.0, 0.01, 0.0]] * 2, jnp.float32)
    d = jnp.asarray([[0.0, 1.0, 0.0]] * 2, jnp.float32)
    # endpoints 0.20 and 0.25 into the slab interior (y = 1.20 / 1.25)
    md = jnp.asarray([1.20, 1.25], jnp.float32) - 0.01
    tr = np.asarray(scene_transmittance(scene, o, d, md))
    sig_t = np.asarray(sa) + ss
    np.testing.assert_allclose(tr[0], np.exp(-sig_t * 0.20), rtol=2e-3)
    np.testing.assert_allclose(tr[1], np.exp(-sig_t * 0.25), rtol=2e-3)
    # the mirrored case (start inside, exit through the top face) was
    # already exit-attributed; pin it too so the estimator stays symmetric
    o2 = jnp.asarray([[0.0, 1.2, 0.0]], jnp.float32)
    tr2 = np.asarray(scene_transmittance(
        scene, o2, jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
        jnp.asarray([1.0], jnp.float32)))
    np.testing.assert_allclose(tr2[0], np.exp(-sig_t * 0.3), rtol=2e-3)


@pytest.mark.slow
def test_anisotropy_forward_bias():
    """g -> 1 scatters forward: transmission through the slab increases
    with g at fixed sigma_s."""
    iso = _trace(_slab_scene(sigma_s=2.0, g=0.0), n=8192,
                 max_depth=16).mean()
    fwd = _trace(_slab_scene(sigma_s=2.0, g=0.9), n=8192,
                 max_depth=16).mean()
    assert fwd > iso + 0.02, (iso, fwd)


def test_transmittance_nee_no_double_count():
    """advisor r3: with shadow_mode='transmittance' + emission_mode='nee',
    direct light through glass used to be scored twice — once by the
    attenuated NEE and again when the diffuse bounce's BSDF chain crossed
    the slab and hit the light with emit_ok granted by the transmissive
    hit.  An ior=1, sigma=0 slab is a physical no-op, so the full-depth
    render with the slab must equal the slab-free render (same seeds).
    Pre-fix the slab render's floor was measurably brighter."""
    cfg = RenderConfig(width=1, height=1, spp=1, max_depth=4,
                       shadow_mode="transmittance", emission_mode="nee")
    n = 8192

    def run(scene, seed=3):
        origins = jnp.tile(jnp.asarray([[0.0, 0.8, 0.0]], jnp.float32),
                           (n, 1))
        directions = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32),
                              (n, 1))
        uniforms = rng.path_uniforms(jax.random.key(seed), n, cfg.max_depth)
        radiance, _ = trace_paths(scene, cfg, origins, directions, uniforms)
        return float(np.asarray(radiance).mean())

    with_slab = run(_shadow_scene())
    no_slab = run(_shadow_scene(slab=False))
    assert no_slab > 0
    # MC noise at 8k lanes is ~1%; the double count was a >5% brightening
    assert abs(with_slab - no_slab) / no_slab < 0.04, (with_slab, no_slab)


def test_transmittance_max_hits_closeout_blocks():
    """advisor r3: shadow segments still marching after ``max_hits``
    transmissive crossings used to stop testing surfaces entirely, so an
    occluder behind >max_hits interfaces leaked full direct light.  Now a
    final any-hit query blocks conservatively."""
    from light_transport_tpu.ops.dispatch import scene_transmittance

    # two stacked ior-1 slabs -> 4 interfaces > max_hits=3 crossings
    half = 50.0
    quads = []
    for y0, y1 in ((1.0, 1.5), (1.8, 2.3)):
        quads.append(quad_triangles((-half, y0, -half), (half, y0, -half),
                                    (half, y0, half), (-half, y0, half)))
        quads.append(quad_triangles((-half, y1, -half), (-half, y1, half),
                                    (half, y1, half), (half, y1, -half)))
    mesh = TriangleMesh.build(
        np.concatenate(quads), np.zeros(8, np.int32), np.zeros(8, bool))
    glass = Material(color=_WHITE, ior=1.0, transmission=1.0,
                     is_diffuse=False, is_mirror=False)
    scene = Scene.build(mesh, MaterialTable.build([glass]),
                        camera=[0.0, 5.0, 0.0])
    o = jnp.asarray([[0.0, 0.5, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    # segment ending above the 4th interface: the 4th crossing is beyond
    # the max_hits=3 march, so the close-out must block (conservative)
    t_long = np.asarray(scene_transmittance(scene, o, d, 3.0))
    np.testing.assert_allclose(t_long, 0.0, atol=1e-7)
    # segment ending between the slabs: 2 crossings, fully transmitted
    t_short = np.asarray(scene_transmittance(scene, o, d, 1.65))
    np.testing.assert_allclose(t_short, 1.0, atol=1e-6)


def test_nested_media_carried_state_exact():
    """Carried-medium upgrade (README deviation 16, advisor r3): a span
    that ends on a NESTED object's front face must attenuate by the
    enclosing medium.  Outer absorbing slab z in [-1.2, 0] containing an
    inner absorbing slab z in [-0.9, -0.3], ior=1 everywhere (straight
    transmission), emissive wall behind: the closed-form transmission is
    exp(-sigma_o * 0.6) * exp(-sigma_i * 0.6).  The old backface-exit
    attribution missed the outer span that ends on the inner front face
    (it scored exp(-sigma_o * 0.3) instead of 0.6)."""
    half = 50.0
    sa_o = (0.5, 1.0, 0.0)
    sa_i = (0.0, 0.7, 1.5)

    def slab(z_front, z_back):
        front = quad_triangles(  # normal +z
            (-half, -half, z_front), (half, -half, z_front),
            (half, half, z_front), (-half, half, z_front))
        back = quad_triangles(  # normal -z
            (-half, -half, z_back), (-half, half, z_back),
            (half, half, z_back), (half, -half, z_back))
        return np.concatenate([front, back])

    wall = quad_triangles(  # emissive wall facing +z
        (-half, -half, -5.0), (half, -half, -5.0),
        (half, half, -5.0), (-half, half, -5.0))
    tris = np.concatenate([slab(0.0, -1.2), slab(-0.3, -0.9), wall])
    mat_id = np.asarray([0] * 4 + [1] * 4 + [2] * 2, np.int32)
    is_light = np.asarray([False] * 8 + [True] * 2)
    outer = Material(color=_WHITE, ior=1.0, transmission=1.0,
                     is_diffuse=False, is_mirror=False, sigma_a=sa_o)
    inner = Material(color=_WHITE, ior=1.0, transmission=1.0,
                     is_diffuse=False, is_mirror=False, sigma_a=sa_i)
    black = Color.of((0, 0, 0), (0, 0, 0), (0, 0, 0))
    light = Material(color=black, emission=1.0)
    mesh = TriangleMesh.build(tris, mat_id, is_light)
    scene = Scene.build(mesh, MaterialTable.build([outer, inner, light]),
                        camera=[0.0, 0.0, 3.0])

    cfg = RenderConfig(width=1, height=1, spp=1, max_depth=8,
                       emission_mode="always")
    n = 64
    origins = jnp.tile(jnp.asarray([[0.0, 0.0, 3.0]], jnp.float32), (n, 1))
    directions = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32),
                          (n, 1))
    uniforms = rng.path_uniforms(jax.random.key(4), n, cfg.max_depth)
    radiance, _ = trace_paths(scene, cfg, origins, directions, uniforms)
    rad = np.asarray(radiance)
    want = np.exp(-np.asarray(sa_o) * 0.6) * np.exp(-np.asarray(sa_i) * 0.6)
    np.testing.assert_allclose(rad, np.broadcast_to(want, rad.shape),
                               rtol=3e-3)
