import pytest
import dataclasses
import os

import jax
import numpy as np

from light_transport_tpu.core.config import MediumConfig, PhotonRunConfig
from light_transport_tpu.scene.medium import LayeredMedium
from light_transport_tpu.transport.photon import simulate_photons
from light_transport_tpu.utils.checkpoint import (
    accumulate,
    load_tallies,
    save_tallies,
    simulate_resumable,
)
from light_transport_tpu.utils.profiling import StepTimer, compile_and_steady


def medium():
    return LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.5)])


def test_checkpoint_roundtrip(tmp_path):
    cfg = PhotonRunConfig(n_photons=5_000, nr=16, nz=16)
    res = simulate_photons(medium(), cfg, jax.random.key(0), lanes=1024)
    p = str(tmp_path / "ckpt.npz")
    save_tallies(p, res, seed=0, batches_done=3)
    loaded, seed, batches = load_tallies(p)
    assert seed == 0 and batches == 3
    np.testing.assert_array_equal(
        np.asarray(res.absorb_rz), np.asarray(loaded.absorb_rz)
    )


@pytest.mark.slow
def test_resumable_matches_uninterrupted(tmp_path):
    cfg = PhotonRunConfig(n_photons=8_000, nr=16, nz=16)
    p1 = str(tmp_path / "a.npz")
    full = simulate_resumable(medium(), cfg, seed=7, checkpoint_path=p1,
                              n_batches=4, lanes=512)
    # simulate an interruption: run 2 batches into a fresh checkpoint by
    # truncating, then resume
    p2 = str(tmp_path / "b.npz")
    half = simulate_resumable(
        medium(), dataclasses.replace(cfg, n_photons=4_000), seed=7,
        checkpoint_path=p2, n_batches=2, lanes=512,
    )
    # hand-craft the checkpoint as if batches 0-1 of the 4-batch run finished
    save_tallies(p2, half, seed=7, batches_done=2)
    resumed = simulate_resumable(medium(), cfg, seed=7, checkpoint_path=p2,
                                 n_batches=4, lanes=512)
    np.testing.assert_allclose(
        np.asarray(full.refl_r), np.asarray(resumed.refl_r), rtol=1e-6
    )
    assert resumed.n_launched == cfg.n_photons


def test_accumulate():
    cfg = PhotonRunConfig(n_photons=2_000, nr=8, nz=8)
    a = simulate_photons(medium(), cfg, jax.random.key(1), lanes=512)
    b = simulate_photons(medium(), cfg, jax.random.key(2), lanes=512)
    tot = accumulate(a, b)
    assert tot.n_launched == 4_000
    np.testing.assert_allclose(
        np.asarray(tot.absorb_rz),
        np.asarray(a.absorb_rz) + np.asarray(b.absorb_rz),
        rtol=1e-6,
    )


def test_profiling_helpers():
    t = StepTimer()
    for _ in range(3):
        with t.step():
            pass
    assert len(t.times) == 3 and t.steps_per_sec() > 0

    import jax.numpy as jnp

    f = jax.jit(lambda x: x * 2)
    t_compile, t_steady = compile_and_steady(f, jnp.ones(8))
    assert t_compile > 0 and t_steady > 0


def test_presets_importable():
    from light_transport_tpu.models.presets import PRESETS, hg_sweep

    assert set(PRESETS) >= {"demo", "multilayer", "mesh", "full_scale",
                            "lts", "glass"}
    sweep = list(hg_sweep(g_values=(0.5,), mu_a_values=(1.0,),
                          mu_s_values=(10.0,)))
    assert len(sweep) == 1


def test_glass_geometry():
    from light_transport_tpu.scene.glass import design_glass

    mesh = design_glass(resolution=12)
    assert mesh.num_triangles > 100
    v = mesh.vertices()
    assert np.isfinite(v).all()
    # glass body spans radius up to 7, base at y in [-0.5, 0.5]
    r = np.sqrt(v[..., 0] ** 2 + v[..., 2] ** 2)
    np.testing.assert_allclose(r.max(), 7.0, atol=1e-6)
    assert v[..., 1].min() >= -0.5 - 1e-6
    assert v[..., 1].max() <= 12.5 + 1e-6


def test_glass_windings_outward():
    """advisor r3: the glass builders wound their solids inward (cylinder,
    box) or mixed (tube), inverting the tracer's geometric inside/outside
    test — and with it the IOR ratio and interior Beer-Lambert attribution
    — at every glass-scene interface.  Pin the outward convention: a ray
    from far outside toward each solid's centroid must FIRST hit a
    front-facing triangle (dot(n_geo, dir) < 0)."""
    import jax.numpy as jnp

    from light_transport_tpu.ops import intersect
    from light_transport_tpu.scene.geometry import TriangleMesh
    from light_transport_tpu.scene.glass import (
        box_triangles,
        cylinder_triangles,
        tube_triangles,
    )

    solids = {
        "cylinder": (cylinder_triangles(6.0, 8.0, (0, 4.5, 0)), (0, 4.5, 0)),
        "box": (box_triangles((0, 3.0, 0), (5, 5, 5)), (0, 3.0, 0)),
        "tube": (tube_triangles(6.0, 7.0, 12.0, (0, 6.5, 0)), (6.5, 6.5, 0)),
    }
    dirs = np.asarray([[1.0, 0.3, 0.2], [-0.5, -1.0, 0.4],
                       [0.2, 0.1, -1.0], [-1.0, 0.5, -0.5]])
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for name, (tris, target) in solids.items():
        mesh = TriangleMesh.build(tris, np.zeros(len(tris), np.int32))
        o = jnp.asarray(np.asarray(target) - 60.0 * dirs, jnp.float32)
        d = jnp.asarray(dirs, jnp.float32)
        hit = intersect.intersect_rays(o, d, mesh)
        assert bool(hit.valid.all()), name
        n_geo = np.asarray(mesh.normal)[np.asarray(hit.tri)]
        cos = np.sum(n_geo * dirs, axis=1)
        assert np.all(cos < 0), (name, cos)


def test_checkpoint_suffixless_path_resumes(tmp_path):
    """advisor r3: np.savez appends '.npz' to suffix-less paths while the
    resume existence check used the raw path, so `--checkpoint ckpt`
    runs silently restarted from batch 0 every time.  Saves are also
    atomic now (tmp + os.replace) — no stray tmp file remains."""
    cfg = PhotonRunConfig(n_photons=2_000, nr=8, nz=8)
    res = simulate_photons(medium(), cfg, jax.random.key(0), lanes=512)
    p = str(tmp_path / "ckpt")  # no extension
    save_tallies(p, res, seed=5, batches_done=2)
    assert os.path.exists(p + ".npz")
    assert not os.path.exists(p + ".npz.tmp")
    loaded, seed, batches = load_tallies(p)  # raw path loads too
    assert seed == 5 and batches == 2
    # resumable run sees the checkpoint through the raw path: with
    # batches_done == n_batches nothing re-runs and the result is the
    # checkpointed tallies verbatim
    out = simulate_resumable(medium(), cfg, seed=5, checkpoint_path=p,
                             n_batches=2, lanes=512)
    np.testing.assert_array_equal(np.asarray(out.absorb_rz),
                                  np.asarray(loaded.absorb_rz))


def test_accumulate_counters_exact_many_batches():
    """advisor r3: accumulate() plain-added the two-word exact counters,
    letting the lo word grow past 2^24 after ~256 merges and rounding the
    photon count.  The counter-aware merge keeps it exact."""
    import jax.numpy as jnp

    from light_transport_tpu.tally.tallies import PhotonTallies

    cfg = PhotonRunConfig(n_photons=0, nr=4, nz=4)
    one = PhotonTallies.zeros(cfg)
    # 60,000 launches per batch: 400 plain-added lo words would reach
    # 2.4e7 > 2^24 and round
    one = one.replace(launched=jnp.asarray([0.0, 60_000.0]))
    total = PhotonTallies.zeros(cfg)
    for _ in range(400):
        total = accumulate(total, one)
    assert total.n_launched == 400 * 60_000


def test_checkpoint_kill_and_resume(tmp_path, monkeypatch):
    """A resumable run killed after two of four batches resumes from its
    checkpoint and ends bit-identical to an uninterrupted run."""
    import light_transport_tpu.transport.photon as photon

    cfg = PhotonRunConfig(n_photons=4_000, nr=8, nz=8)
    ref = simulate_resumable(medium(), cfg, seed=3,
                             checkpoint_path=str(tmp_path / "ref"),
                             n_batches=4, lanes=512)
    real = photon.simulate_photons
    done = []

    def dies_after_two(*a, **k):
        if len(done) == 2:
            raise KeyboardInterrupt("killed")
        done.append(1)
        return real(*a, **k)

    ckpt = str(tmp_path / "run")
    monkeypatch.setattr(photon, "simulate_photons", dies_after_two)
    with pytest.raises(KeyboardInterrupt):
        simulate_resumable(medium(), cfg, seed=3, checkpoint_path=ckpt,
                           n_batches=4, lanes=512)
    assert load_tallies(ckpt)[2] == 2
    monkeypatch.setattr(photon, "simulate_photons", real)
    out = simulate_resumable(medium(), cfg, seed=3, checkpoint_path=ckpt,
                             n_batches=4, lanes=512)
    assert out.n_launched == ref.n_launched == 4_000
    for f in dataclasses.fields(out):
        np.testing.assert_array_equal(np.asarray(getattr(out, f.name)),
                                      np.asarray(getattr(ref, f.name)))


_CACHE_PROBE = (
    "import jax; from light_transport_tpu.core.cache import "
    "enable_compile_cache; p = enable_compile_cache(); "
    "print(p); print(jax.config.jax_compilation_cache_dir)")


def _cache_probe(env_dir):
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = root
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.split(), root


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_placement(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without it
    the cache sits at the checkout's fixed .jax_cache/."""
    env_dir = str(tmp_path / "cc") if from_env else None
    (returned, active), root = _cache_probe(env_dir)
    expected = env_dir if from_env else os.path.join(root, ".jax_cache")
    assert returned == active == expected


def test_native_library_rebuilds_when_source_newer(tmp_path):
    import shutil

    from light_transport_tpu.accel import native

    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    src = tmp_path / "bvh_builder.cpp"
    shutil.copy(native._SRC_PATH, src)
    lib = tmp_path / "liblt_native.so"
    native.build_library(str(src), str(lib))
    first = lib.stat().st_mtime_ns
    native.build_library(str(src), str(lib))  # up to date: no rebuild
    assert lib.stat().st_mtime_ns == first
    os.utime(src, ns=(first + 10**9, first + 10**9))  # source now newer
    native.build_library(str(src), str(lib))
    assert lib.stat().st_mtime_ns > first
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "bvh_builder.cpp", "liblt_native.so"]  # no temp file left


def test_default_lanes_rule():
    from light_transport_tpu.transport.photon import (
        MAX_LANES,
        MIN_LANES,
        default_lanes,
    )

    assert default_lanes(1_000) == MIN_LANES
    assert default_lanes(1_000_000) == MIN_LANES
    assert default_lanes(10_000_000) == 10_000_000 // 16
    assert default_lanes(10**9) == MAX_LANES
