import jax
import jax.numpy as jnp
import numpy as np

from light_transport_tpu.api import simulate
from light_transport_tpu.core.config import (
    MediumConfig,
    PhotonRunConfig,
    RenderConfig,
)
from light_transport_tpu.integrators.path_tracer import (
    render_image,
    render_progressive,
    render_with_detectors,
)
from light_transport_tpu.scene.cornell import cornell_box_scene
from light_transport_tpu.scene.medium import LayeredMedium


def test_surface_detectors():
    scene, cfg = cornell_box_scene(width=16, height=16, spp=4, max_depth=3)
    img, energy, hits = render_with_detectors(scene, cfg, jax.random.key(0))
    t = scene.mesh.num_triangles
    energy, hits = np.asarray(energy), np.asarray(hits)
    assert energy.shape == (t,) and hits.shape == (t,)
    assert hits.sum() > 0 and np.all(hits >= 0)
    # the camera faces the box: the back wall (z=-dim; triangles 4,5 in the
    # builder layout) must collect many primary hits
    assert hits[4] + hits[5] > 16 * 16 * 4 * 0.05
    # energy only where hits
    assert np.all((energy > 0) <= (hits > 0))
    # image identical to the plain render with the same key
    img_ref = np.asarray(render_image(scene, cfg, jax.random.key(0)))
    np.testing.assert_allclose(np.asarray(img), img_ref, atol=1e-6)


def test_progressive_matches_mc_mean():
    scene, cfg = cornell_box_scene(width=10, height=10, spp=4, max_depth=2)
    img1 = np.asarray(render_progressive(scene, cfg, jax.random.key(1),
                                         n_passes=1))
    img4 = np.asarray(render_progressive(scene, cfg, jax.random.key(1),
                                         n_passes=4))
    assert img4.shape == img1.shape
    # more passes -> closer to an independent high-spp reference
    import dataclasses

    big = dataclasses.replace(cfg, spp=32)
    ref = np.asarray(render_image(scene, big, jax.random.key(99)))
    err1 = np.abs(img1 - ref).mean()
    err4 = np.abs(img4 - ref).mean()
    assert err4 < err1 * 1.1  # noise shrinks (allow slack for luck)


def test_photon_exit_detector_image():
    m = LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=20.0, g=0.8, n=1.4)],
                            n_above=1.0)
    cfg = PhotonRunConfig(n_photons=50_000, nr=32, nz=32, dr=0.02, dz=0.02,
                          detector_nx=32, detector_extent=0.32)
    res = simulate(m, cfg, seed=0)
    det = np.asarray(res.detector_xy)
    assert det.shape == (32, 32)
    # edge bins clamp out-of-extent exits, so the detector total equals the
    # total diffuse reflectance (up to f32 summation order)
    np.testing.assert_allclose(det.sum(), float(res.refl_r.sum()), rtol=1e-4)
    # pencil beam at the origin: the center of the detector is brightest
    # (skip the outermost ring — those bins clamp the out-of-extent tail)
    c = det[14:18, 14:18].mean()
    ring = det[2:4, 8:24].mean()
    assert c > 3 * (ring + 1e-9), (c, ring)
    # radial symmetry: x/y marginals roughly equal
    np.testing.assert_allclose(
        det.sum(axis=0), det.sum(axis=1), rtol=0.5, atol=det.max() * 0.1
    )


def test_detector_disabled_shape():
    m = LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.0)])
    cfg = PhotonRunConfig(n_photons=2_000, nr=8, nz=8)
    res = simulate(m, cfg, seed=0)
    assert res.detector_xy.shape == (1, 1)


def test_detector_through_sharded_paths():
    """detector_xy through the sharded engine on the 8-device CPU mesh
    (the psum'd detector was once tested single-device only).  The psum'd
    image must agree statistically with the single-device run and conserve
    exit energy exactly."""
    from light_transport_tpu.parallel.mesh import make_mesh, simulate_sharded

    m = LayeredMedium.build(
        [MediumConfig(mu_a=1.0, mu_s=20.0, g=0.8, n=1.4)], n_above=1.0)
    n = 40_000
    cfg = PhotonRunConfig(n_photons=n, nr=16, nz=16, dr=0.04, dz=0.04,
                          detector_nx=16, detector_extent=0.32)
    mesh = make_mesh(8)
    res8 = simulate_sharded(m, cfg, jax.random.key(3), mesh=mesh,
                            lanes_per_device=2048)
    det8 = np.asarray(res8.detector_xy, np.float64)
    assert det8.shape == (16, 16)
    # exit-energy conservation through the psum: detector total == R_d total
    np.testing.assert_allclose(det8.sum(), float(res8.refl_r.sum()),
                               rtol=1e-4)
    # single-device statistical parity on the rebinned image
    res1 = simulate(m, cfg, seed=7)
    det1 = np.asarray(res1.detector_xy, np.float64)
    a = det8.reshape(4, 4, 4, 4).sum((1, 3)) / n
    b = det1.reshape(4, 4, 4, 4).sum((1, 3)) / n
    se = np.sqrt(np.maximum(b, 1e-6) / n) * 3 + 2e-3
    assert np.all(np.abs(a - b) < 3 * se), np.abs(a - b).max()

