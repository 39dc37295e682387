"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4c)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from light_transport_tpu.core.config import MediumConfig, PhotonRunConfig
from light_transport_tpu.parallel.mesh import (
    make_mesh,
    render_sharded,
    simulate_sharded,
)
from light_transport_tpu.scene.cornell import cornell_box_scene
from light_transport_tpu.scene.medium import LayeredMedium
from light_transport_tpu.tally.stats import binomial_stderr
from light_transport_tpu.transport.photon import simulate_photons


def medium():
    return LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.5, n=1.0)])


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_simulate_launches_exact_quota():
    cfg = PhotonRunConfig(n_photons=10_001, nr=16, nz=16)  # not divisible by 8
    res = simulate_sharded(medium(), cfg, jax.random.key(0),
                           lanes_per_device=512)
    assert res.n_launched == 10_001
    assert abs(res.energy_total() - 1.0) < 1e-2


def test_sharded_simulate_cap_raises(monkeypatch):
    """A device that reaches its superstep cap with photons left fails the
    run instead of returning short tallies."""
    from light_transport_tpu.transport import photon

    monkeypatch.setattr(photon, "default_max_supersteps",
                        lambda n_photons, lanes: 16)
    cfg = PhotonRunConfig(n_photons=10_001, nr=16, nz=16)
    with pytest.raises(photon.SuperstepCapError) as err:
        simulate_sharded(medium(), cfg, jax.random.key(0),
                         lanes_per_device=64)
    assert err.value.tallies.n_launched < 10_001
    assert err.value.photons_left > 0


def test_sharded_matches_single_device_statistically():
    n = 40_000
    cfg = PhotonRunConfig(n_photons=n, nr=16, nz=16, dr=0.05, dz=0.05)
    res8 = simulate_sharded(medium(), cfg, jax.random.key(1),
                            lanes_per_device=1024)
    res1 = simulate_photons(medium(), cfg, jax.random.key(2), lanes=8192)
    rd8, rd1 = res8.total_reflectance(), res1.total_reflectance()
    se = binomial_stderr(rd1, n) * np.sqrt(2)
    assert abs(rd8 - rd1) < 3 * se + 1e-3, (rd8, rd1, se)
    a8, a1 = res8.total_absorption(), res1.total_absorption()
    assert abs(a8 - a1) < 3 * se + 1e-3, (a8, a1)


def test_sharded_render_matches_unsharded():
    scene, cfg = cornell_box_scene(width=16, height=16, spp=8, max_depth=3)
    mesh = make_mesh()
    img_sharded = np.asarray(render_sharded(scene, cfg, jax.random.key(3),
                                            mesh=mesh))
    from light_transport_tpu.integrators.path_tracer import render_image

    img_ref = np.asarray(render_image(scene, cfg, jax.random.key(3)))
    # identical uniforms and lane layout -> same estimator; tolerance only
    # for cross-sharding float reassociation
    np.testing.assert_allclose(img_sharded, img_ref, atol=2e-5)


def test_sharded_bdpt_matches_unsharded():
    """BDPT with camera AND light-subpath lanes sharded over the mesh:
    lane uniforms are drawn at global width (bitwise-identical per-lane
    transport), and the t=1 splat film psums over the batch axis —
    tolerance covers only the splat's cross-device summation order."""
    from light_transport_tpu.integrators.bdpt import render_bdpt
    from light_transport_tpu.parallel.mesh import render_bdpt_sharded

    scene, cfg = cornell_box_scene(width=12, height=12, spp=2, max_depth=3)
    mesh = make_mesh()
    img_s = np.asarray(render_bdpt_sharded(scene, cfg, jax.random.key(5),
                                           mesh=mesh))
    img_r = np.asarray(render_bdpt(scene, cfg, jax.random.key(5)))
    np.testing.assert_allclose(img_s, img_r, atol=5e-6)


def test_sharded_bdpt_point_lights_and_padding():
    """Point-light (delta-origin) sharded BDPT on a lane count NOT
    divisible by the device count (13*5*1 = 65 over 8 devices, 7 pad
    lanes): pad lanes must neither splat onto the film nor leak into the
    sliced radiance rows."""
    from light_transport_tpu.integrators.bdpt import render_bdpt
    from light_transport_tpu.models.presets import point_light_scene
    from light_transport_tpu.parallel.mesh import render_bdpt_sharded

    scene, cfg = point_light_scene(width=13, height=5, spp=1, max_depth=3)
    mesh = make_mesh()
    img_s = np.asarray(render_bdpt_sharded(scene, cfg, jax.random.key(6),
                                           mesh=mesh))
    img_r = np.asarray(render_bdpt(scene, cfg, jax.random.key(6)))
    np.testing.assert_allclose(img_s, img_r, atol=5e-6)


@pytest.mark.slow
def test_sharded_bdpt_mixed_lights_matches_unsharded():
    """Mixed area+point sharded BDPT: the per-lane family pick and every
    per-lane MIS density ride the shard."""
    from light_transport_tpu.integrators.bdpt import render_bdpt
    from light_transport_tpu.parallel.mesh import render_bdpt_sharded

    scene, cfg = cornell_box_scene(width=12, height=12, spp=2, max_depth=3)
    scene = scene.with_point_lights([[0.0, 3.0, 0.0]],
                                    [[30.0, 30.0, 30.0]])
    mesh = make_mesh()
    img_s = np.asarray(render_bdpt_sharded(scene, cfg, jax.random.key(7),
                                           mesh=mesh))
    img_r = np.asarray(render_bdpt(scene, cfg, jax.random.key(7)))
    np.testing.assert_allclose(img_s, img_r, atol=5e-6)


def test_sharded_render_with_point_lights_matches_unsharded():
    """Point (delta) lights ride the replicated scene pytree through
    shard_map — the sharded estimator must match the single-device one
    exactly (same uniforms, same lane layout)."""
    from light_transport_tpu.integrators.path_tracer import render_image
    from light_transport_tpu.models.presets import point_light_scene

    scene, cfg = point_light_scene(width=12, height=12, spp=4, max_depth=3)
    mesh = make_mesh()
    img_sharded = np.asarray(render_sharded(scene, cfg, jax.random.key(3),
                                            mesh=mesh))
    img_ref = np.asarray(render_image(scene, cfg, jax.random.key(3)))
    np.testing.assert_allclose(img_sharded, img_ref, atol=2e-5)


def test_sharded_render_honors_sampler_and_dof():
    """render_sharded shares the single-device lane preamble
    (path_tracer._camera_lanes), so cfg.sampler='sobol' and the thin-lens
    aperture must shape the sharded image exactly as the unsharded one
    (they were silently ignored before the preamble was unified)."""
    import dataclasses

    from light_transport_tpu.integrators.path_tracer import render_image

    scene, cfg = cornell_box_scene(width=12, height=12, spp=8, max_depth=2)
    cfg = dataclasses.replace(cfg, sampler="sobol", aperture=0.3,
                              focus_distance=4.0)
    mesh = make_mesh()
    img_sharded = np.asarray(render_sharded(scene, cfg, jax.random.key(3),
                                            mesh=mesh))
    img_ref = np.asarray(render_image(scene, cfg, jax.random.key(3)))
    np.testing.assert_allclose(img_sharded, img_ref, atol=2e-5)


@pytest.mark.slow
def test_sharded_render_different_device_counts_agree():
    scene, cfg = cornell_box_scene(width=16, height=16, spp=4, max_depth=2)
    img2 = np.asarray(
        render_sharded(scene, cfg, jax.random.key(5), mesh=make_mesh(2))
    )
    img8 = np.asarray(
        render_sharded(scene, cfg, jax.random.key(5), mesh=make_mesh(8))
    )
    np.testing.assert_allclose(img2, img8, atol=2e-5)


_MULTIHOST_WORKER = r'''
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

pid = int(sys.argv[1])
port = sys.argv[2]

from light_transport_tpu.parallel.mesh import init_multihost, simulate_sharded
from light_transport_tpu.core.config import MediumConfig, PhotonRunConfig
from light_transport_tpu.scene.medium import LayeredMedium

mesh = init_multihost(coordinator="localhost:" + port,
                      num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert mesh.devices.size == 4, mesh
m = LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.5, n=1.0)])
cfg = PhotonRunConfig(n_photons=4096, nr=16, nz=16, dr=0.05, dz=0.05)
t = simulate_sharded(m, cfg, jax.random.key(11), mesh=mesh,
                     lanes_per_device=1024)
# out_specs=P() -> fully replicated tallies: every process reads the global
# psum'd result from its addressable shards
assert t.n_launched == cfg.n_photons, t.n_launched
print("RD", pid, repr(t.total_reflectance()), flush=True)
jax.distributed.shutdown()
print("OK", pid, flush=True)
'''


def test_multihost_two_process_smoke(tmp_path):
    """init_multihost + simulate_sharded across a REAL two-process
    jax.distributed CPU cluster (Gloo collectives over localhost): the
    4-device global mesh spans both processes, the photon quota shards
    across it, and the psum'd tallies replicate back exactly — the same
    code path a multi-host run takes (the argument plumbing of
    parallel/mesh.init_multihost must not bit-rot)."""
    import os
    import socket
    import subprocess
    import sys

    worker = tmp_path / "mh_worker.py"
    worker.write_text(_MULTIHOST_WORKER)
    # an ephemeral free port, released just before the workers bind it
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    # the workers set jax_platforms themselves; conftest's env is inherited
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(i), port],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"OK {i}" in out, out
    # both processes must report the identical global reflectance
    rds = sorted(line for out in outs for line in out.splitlines()
                 if line.startswith("RD "))
    assert len(rds) == 2, outs
    assert rds[0].split()[2] == rds[1].split()[2], rds
