#!/usr/bin/env python3
"""Smoke test of the main paths on one NVIDIA GPU, each against a reference.

    python3 chip_smoke.py            # phases 1-5 on one card
    python3 chip_smoke.py --multi    # phase 6 only: the sharded entries on
                                     # a 4-device mesh vs 1-device runs

Phases (each prints one line: name, ok, steady seconds, compile-inclusive
first-call seconds, and every compared number beside its limit):

1. device — JAX/jaxlib versions, ``jax.devices()``, the card's name and
   power limit.
2. photon_physics — ``api.simulate`` at 1e6 photons against the published
   MCML validation values (van de Hulst, MCML slab, Giovanelli) by the 3σ
   rule of tests/test_photon.py; the ``multilayer`` preset's energy
   closure.
3. photon_full_scale — the ``full_scale`` preset's tallies at full size
   (512² (r,z), 512² detector, 128³ volume) at 1e7 photons: exact launch
   count, energy closure, steps/s.
4. renders — the LTS golden image; the path, whitted, bdpt, adaptive and cv
   integrators on the LTS scene against the same call on JAX's CPU backend
   in this process (same code, independent backend); the LTS notebook size
   (150x150, 12 spp, depth 4) timed.
5. meshes — the ``glass`` preset (414 tris) against the CPU backend; the
   ~123k-tri soft-shadow scene at 400x400, 10 spp, depth 3, timed; BVH
   hits against brute-force ``intersect_rays`` on 2^16 rays of each scene.
6. multi (``--multi`` only) — ``simulate_sharded``, ``render_sharded`` and
   ``render_bdpt_sharded`` on 4 devices against their 1-device runs by the
   statistics of tests/test_sharding.py.

There is no CPU fallback: the script exits non-zero, printing no result,
unless ``jax.devices()[0].platform == "gpu"``.  Any failed phase makes the
exit code 1 and suppresses the final line.  When every phase passes, the
last line of stdout is one JSON object naming the device:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "lts_cornell_48.npy")

# workload sizes (module constants so a CPU rehearsal can shrink them)
PHYSICS_PHOTONS = 1_000_000
FULL_SCALE_PHOTONS = 10_000_000
LTS_NOTEBOOK = (150, 150, 12, 4)  # width, height, spp, max_depth
SOFT_SHADOW = (400, 400, 10, 3)
HIT_RAYS = 1 << 16
MULTI_PHOTONS = 10_000_001  # not divisible by the device count
MULTI_BDPT = (48, 48, 4, 3)

# ---------------------------------------------------------------------------
# comparison helpers (pure numpy; unit-tested on the CPU)
# ---------------------------------------------------------------------------


class Check:
    """One compared number: ``value`` must satisfy ``value <op> limit``."""

    OPS = {"<=": np.less_equal, "<": np.less, ">=": np.greater_equal,
           ">": np.greater, "==": np.equal}

    def __init__(self, name: str, value, op: str, limit):
        if op not in self.OPS:
            raise ValueError(f"unknown comparison {op!r}")
        self.name, self.value, self.op, self.limit = name, value, op, limit
        self.ok = bool(self.OPS[op](value, limit))

    def __str__(self):
        return f"{self.name}={_fmt(self.value)} ({self.op} {_fmt(self.limit)})"


def _fmt(x):
    if isinstance(x, (bool, np.bool_)):
        return str(bool(x))
    if isinstance(x, (int, np.integer)):
        return str(int(x))
    return f"{float(x):.6g}"


def mc_check(name: str, estimate: float, truth: float, std_err: float,
             abs_floor: float) -> Check:
    """The 3σ parity rule of tally/stats.mc_parity_3sigma as a Check."""
    return Check(f"{name}|d|", abs(estimate - truth), "<=",
                 3.0 * std_err + abs_floor)


def image_stats(img, ref) -> dict:
    """Cross-backend image agreement: difference of image means, mean
    absolute error, largest pixel error and the share of pixels with a
    channel off by more than 1e-3."""
    a = np.asarray(img, np.float64)
    b = np.asarray(ref, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"image shapes differ: {a.shape} vs {b.shape}")
    err = np.abs(a - b)
    return {"mean_diff": abs(a.mean() - b.mean()), "mae": err.mean(),
            "max_err": err.max(),
            "frac_px_over_1e-3": (err.max(axis=-1) > 1e-3).mean()}


def hit_agreement(t_a, tri_a, valid_a, t_b, tri_b, valid_b,
                  tie_rtol: float = 1e-5) -> dict:
    """Compare two hit records of the same rays.

    Returns the number of rays whose valid flag differs, the largest
    relative ``t`` difference over rays both report as hits, and the number
    of rays whose triangle ids differ although their ``t`` values are not a
    tie (a tie: the two ``t`` agree to ``tie_rtol``, e.g. a ray through a
    shared edge may report either triangle)."""
    valid_a = np.asarray(valid_a, bool)
    valid_b = np.asarray(valid_b, bool)
    both = valid_a & valid_b
    t_a = np.asarray(t_a, np.float64)[both]
    t_b = np.asarray(t_b, np.float64)[both]
    rel = np.abs(t_a - t_b) / np.maximum(np.abs(t_b), 1e-12)
    tri_diff = np.asarray(tri_a)[both] != np.asarray(tri_b)[both]
    return {
        "valid_mismatch": int((valid_a != valid_b).sum()),
        "hits": int(both.sum()),
        "t_max_rel_err": float(rel.max()) if rel.size else 0.0,
        "tri_mismatch_non_tie": int((tri_diff & (rel > tie_rtol)).sum()),
    }


def shared_edge_rays(v0, e1, e2, o, d, eps: float = 1e-5):
    """Rays whose nearest triangle hit lies on an edge two triangles share.

    Float64 Möller–Trumbore of every ray against every triangle, with the
    barycentric test widened by ``eps``; a ray is flagged when the nearest
    such hit has a barycentric coordinate within ``eps`` of zero on an edge
    that another triangle also has.  Such a ray's hit, miss or triangle is
    decided by the last ulp of float32 arithmetic."""
    v0, e1, e2 = (np.asarray(a, np.float64) for a in (v0, e1, e2))
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    p = np.cross(d[:, None, :], e2[None])
    det = (e1[None] * p).sum(-1)
    inv = 1.0 / np.where(np.abs(det) < 1e-300, 1e-300, det)
    s = o[:, None, :] - v0[None]
    u = (s * p).sum(-1) * inv
    q = np.cross(s, e1[None])
    v = (d[:, None, :] * q).sum(-1) * inv
    t = (e2[None] * q).sum(-1) * inv
    w = 1.0 - u - v
    near = (np.minimum(np.minimum(u, v), w) >= -eps) & (t > 1e-6) & (
        np.abs(det) > 1e-12)
    tt = np.where(near, t, np.inf)
    j = tt.argmin(1)
    hit = np.isfinite(tt.min(1))

    # count each edge's triangles; u~0 is edge v0-v2, v~0 is v0-v1 and
    # w~0 is v1-v2 (u, v weigh v1, v2)
    verts = np.stack([v0, v0 + e1, v0 + e2], 1).round(6)
    edges = [(0, 2), (0, 1), (1, 2)]
    keys = [[tuple(sorted((tuple(tri[a]), tuple(tri[b])))) for a, b in edges]
            for tri in verts]
    count = {}
    for ks in keys:
        for k in ks:
            count[k] = count.get(k, 0) + 1
    shared = np.array([[count[k] > 1 for k in ks] for ks in keys])
    rows = np.arange(o.shape[0])
    on_edge = np.abs(np.stack([u[rows, j], v[rows, j], w[rows, j]], 1)) <= eps
    return hit & (on_edge & shared[j]).any(1)


def alloc_agreement(alloc_a, alloc_b) -> dict:
    """Compare two integer sample allocations over the same pixels: the
    number of pixels whose counts differ, and the largest difference of
    their running totals.  Allocations made by rounding the same
    cumulative target, computed in two summation orders, differ only
    where a target lies at a rounding boundary: each such flip moves one
    sample across one pixel boundary, so the running totals differ by at
    most 1."""
    a = np.asarray(alloc_a, np.int64).ravel()
    b = np.asarray(alloc_b, np.int64).ravel()
    if a.shape != b.shape:
        raise ValueError(f"allocation shapes differ: {a.shape} vs {b.shape}")
    return {"px_mismatch": int((a != b).sum()),
            "cum_max_diff": int(np.abs(np.cumsum(a) - np.cumsum(b)).max())}


def mean_and_stderr(values) -> tuple:
    """Mean of independent estimates and its standard error."""
    x = np.asarray(values, np.float64)
    return float(x.mean()), float(x.std(ddof=1) / np.sqrt(x.size))


def random_rays(key_seed: int, n: int, lo, hi):
    """``n`` rays with origins uniform in the box [lo, hi] and directions
    uniform on the sphere (numpy, so both backends see the same rays)."""
    rng = np.random.default_rng(key_seed)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    o = lo + rng.random((n, 3)) * (hi - lo)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


# ---------------------------------------------------------------------------
# phase runner
# ---------------------------------------------------------------------------


class Smoke:
    """Runs phases, prints one line per phase, remembers any failure."""

    def __init__(self):
        self.failed = []

    def phase(self, name: str, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception:  # a phase failure is reported and fails the run
            traceback.print_exc()
            print(f"phase {name}: ok=False error (traceback on stderr) "
                  f"wall_s={time.perf_counter() - t0:.2f}", flush=True)
            self.failed.append(name)
            return
        checks = out.get("checks", [])
        ok = all(c.ok for c in checks)
        fields = " ".join(f"{k}={_fmt(v) if not isinstance(v, str) else v}"
                          for k, v in out.get("info", {}).items())
        print(f"phase {name}: ok={ok} wall_s={time.perf_counter() - t0:.2f} "
              f"{fields} | " + "; ".join(str(c) for c in checks), flush=True)
        if not ok:
            self.failed.append(name)


def _timed(fn):
    """(result, compile-inclusive first call s, steady second call s),
    each call waited on until its device work is done."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, first, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(jax, card: str):
    import jaxlib

    return {"info": {"jax": jax.__version__, "jaxlib": jaxlib.__version__,
                     "devices": str(jax.devices()).replace(" ", ""),
                     "card": card.replace("\n", " / ").replace(" ", "_")},
            "checks": [Check("platform_is_gpu",
                             jax.devices()[0].platform == "gpu", "==",
                             True)]}


def phase_photon_physics(jax):
    from light_transport_tpu.api import simulate
    from light_transport_tpu.core.config import MediumConfig, PhotonRunConfig
    from light_transport_tpu.models.presets import multilayer_mismatch
    from light_transport_tpu.scene.medium import LayeredMedium
    from light_transport_tpu.tally.stats import binomial_stderr

    n = PHYSICS_PHOTONS
    cfg = PhotonRunConfig(n_photons=n, nr=50, nz=50, dr=0.002, dz=0.002)

    def run(layers, seed=0, **kw):
        res = simulate(LayeredMedium.build(layers, **kw), cfg, seed=seed)
        jax.block_until_ready(res)
        return res

    vdh = [MediumConfig(mu_a=1.0, mu_s=9.0, g=0.0, n=1.0)]
    t0 = time.perf_counter()
    run(vdh, seed=99)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = run(vdh)
    steady = time.perf_counter() - t0
    checks = [mc_check("vdHulst_Rd", res.total_reflectance(), 0.41550,
                       binomial_stderr(0.41550, n), 1e-3)]
    res = run([MediumConfig(mu_a=10.0, mu_s=90.0, g=0.75, n=1.0,
                            thickness=0.02)])
    checks += [
        mc_check("mcml_slab_Rd", res.total_reflectance(), 0.09739,
                 binomial_stderr(0.09739, n), 1e-3),
        mc_check("mcml_slab_Tt", res.total_transmittance(), 0.66096,
                 binomial_stderr(0.66096, n), 2e-3)]
    res = run([MediumConfig(mu_a=10.0, mu_s=90.0, g=0.0, n=1.5)],
              n_above=1.0)
    r_total = res.specular_reflectance() + res.total_reflectance()
    checks += [
        Check("giovanelli_Rsp|d|", abs(res.specular_reflectance() - 0.04),
              "<=", 1e-6),
        mc_check("giovanelli_R", r_total, 0.2600,
                 binomial_stderr(0.26, n), 2e-3)]
    medium, mcfg = multilayer_mismatch()
    ml = simulate(medium, dataclasses.replace(mcfg, n_photons=n), seed=1)
    checks += [
        Check("multilayer_launched", ml.n_launched, "==", n),
        # closure is exact per photon up to roulette (zero-mean, ~1e-7 at
        # this n) and float32 rounding of the tally sums; 5e-3 is the
        # CPU suite's bound (tests/test_photon.py::test_energy_conservation)
        Check("multilayer_energy|E-1|", abs(ml.energy_total() - 1.0), "<=",
              5e-3)]
    return {"info": {"photons": n, "first_call_s": first,
                     "vdHulst_steady_s": steady}, "checks": checks}


def phase_photon_full_scale(jax):
    from light_transport_tpu.api import simulate
    from light_transport_tpu.models.presets import full_scale

    medium, cfg = full_scale()
    n = FULL_SCALE_PHOTONS
    cfg = dataclasses.replace(cfg, n_photons=n)
    t0 = time.perf_counter()
    res = simulate(medium, cfg, seed=0)
    jax.block_until_ready(res)
    dt = time.perf_counter() - t0
    shapes = (tuple(res.absorb_rz.shape), tuple(res.detector_xy.shape),
              tuple(res.absorb_xyz.shape))
    vol = np.asarray(res.absorb_xyz, np.float64)
    absorbed = max(res.absorbed_weight, 1e-30)
    return {"info": {"photons": n, "seconds_incl_compile": dt,
                     "steps": res.n_steps,
                     "steps_per_s_incl_compile": res.n_steps / dt,
                     "steps_per_photon": res.n_steps / n,
                     "R_d": res.total_reflectance(),
                     "A": res.total_absorption(),
                     # grids clip out-of-extent deposits into edge cells,
                     # so each grid's sum would equal its scalar total
                     # but for float32 swamping in hot cells
                     "volume_sum/absorbed": vol.sum() / absorbed,
                     "rz_sum/absorbed": float(np.asarray(
                         res.absorb_rz, np.float64).sum()) / absorbed,
                     "detector_sum/refl": float(np.asarray(
                         res.detector_xy, np.float64).sum()) / max(
                             float(np.asarray(res.refl_r).sum()), 1e-30)},
            "checks": [
                Check("shapes_full_size",
                      shapes == ((512, 512), (512, 512), (128, 128, 128)),
                      "==", True),
                Check("launched", res.n_launched, "==", n),
                # every photon's weight ends absorbed or exited (roulette
                # is zero-mean); the tallies are float32 sums whose adds
                # land atomically in no fixed order, so they round
                # differently run to run — 1e-3 bounds that rounding at
                # 1e7 photons with a wide margin
                Check("energy|E-1|", abs(res.energy_total() - 1.0), "<=",
                      1e-3),
                Check("volume_finite", bool(np.isfinite(vol).all()), "==",
                      True)]}


def _lts(width=48, height=48, spp=4, max_depth=3):
    from light_transport_tpu.scene.cornell import cornell_box_scene

    return cornell_box_scene(width=width, height=height, spp=spp,
                             max_depth=max_depth)


def _render_fn(integrator, scene, cfg, seed):
    import jax

    from light_transport_tpu.api import render

    if integrator == "cv":
        from light_transport_tpu.integrators.control_variates import (
            render_cv,
        )

        return lambda: np.asarray(
            render_cv(scene, cfg, jax.random.key(seed)).image_cv)
    return lambda: np.asarray(render(scene, cfg, seed=seed,
                                     integrator=integrator))


# Cross-backend tolerances.  Both backends draw identical threefry
# uniforms, but XLA's CPU and GPU code round a few operations differently
# (fused multiply-adds, transcendental approximations).  A one-ulp
# difference can flip a discrete branch — Russian roulette, the Fresnel
# reflect/refract pick, a light pick — and that lane then follows another
# path, moving its pixel by a whole sample's contribution.  So single
# pixels may differ a lot; the image mean and the mean absolute error may
# not:
# - path, bdpt, cv, glass, and the first round of adaptive:
#   MEAN_DIFF is 1% of the LTS image mean (≈0.25); MAE allows ~25 flipped
#   samples of 4-spp pixels (a flip moves a pixel by ≤ ~0.25, i.e. the
#   MAE by ≤ 0.25/6912).
# - whitted traces one unjittered ray per pixel; where that ray lies on an
#   edge shared by two triangles (on a square image, the diagonal of each
#   wall quad), Möller–Trumbore's hit, miss or triangle choice is decided
#   by the last ulp.  Only those pixels may differ by more than 1e-3, and
#   every other pixel is held to MAE.
# - adaptive allocates each round's samples by rounding a cumulative sum
#   of variance weights, which the two backends sum in another order, so
#   a target at a rounding boundary may round the other way; such a flip
#   moves one sample across one pixel boundary and changes the next
#   round's data, so the two final images are partly independent
#   estimates and are not compared pixel by pixel.  Compared instead: the
#   first round (no allocation yet) like path; each round's allocation
#   computed on the GPU from the CPU's running stats against the CPU's
#   own — the running totals may differ by at most 1 (rounding flips
#   only); and, since adaptive is unbiased per pixel
#   (integrators/adaptive.py), the mean of its unclipped images over
#   ADAPTIVE_SEEDS seeds against a high-spp path reference within 3
#   standard errors of the two means.
MEAN_DIFF = 2e-3
MAE = 1e-3
ADAPTIVE_SEEDS = 128
REFERENCE_SPP = 64


def _adaptive_rounds(jax, scene, cfg, seed, rounds=4):
    """render_adaptive's round loop.  Returns the running stats before
    each round, each round's allocation, and the unclipped image."""
    import jax.numpy as jnp

    from light_transport_tpu.integrators.adaptive import _round

    n_pix = cfg.height * cfg.width
    dtype = scene.camera.dtype
    stats = (jnp.zeros((n_pix, 3), dtype), jnp.zeros((n_pix,), dtype),
             jnp.zeros((n_pix,), dtype), jnp.zeros((n_pix,), jnp.int32))
    inputs, allocs = [], []
    for r in range(rounds):
        inputs.append([np.asarray(x) for x in stats])
        stats, alloc = _round(scene, cfg, jax.random.key(seed),
                              n_pix * (cfg.spp // rounds), stats,
                              jnp.asarray(r, jnp.int32), None)
        allocs.append(np.asarray(alloc))
    sum_rgb, _, _, count = (np.asarray(x) for x in stats)
    unclipped = sum_rgb / np.maximum(count, 1)[:, None]
    return inputs, allocs, unclipped


def _path_unclipped_mean(jax, scene, cfg, seed):
    """Mean unclipped radiance of a path render (every pixel has cfg.spp
    samples, so this is the mean of the unclipped pixel estimates)."""
    import jax.numpy as jnp

    from light_transport_tpu.integrators.path_tracer import (
        _camera_lanes,
        trace_paths,
    )

    o, d, u = _camera_lanes(scene, cfg, jax.random.key(seed))
    return float(jnp.mean(trace_paths(scene, cfg, o, d, u)[0]))


def _check_whitted(jax, scene, cfg, g, c):
    import jax.numpy as jnp

    from light_transport_tpu.integrators.path_tracer import camera_rays

    with jax.default_device(jax.devices("cpu")[0]):
        o, d = camera_rays(scene, dataclasses.replace(cfg, spp=1),
                           jnp.zeros((cfg.height * cfg.width, 2),
                                     scene.camera.dtype))
    m = scene.mesh
    edge = shared_edge_rays(m.v0, m.e1, m.e2, o, d).reshape(
        cfg.height, cfg.width)
    err = np.abs(np.asarray(g, np.float64) - np.asarray(c, np.float64))
    flipped = err.max(-1) > 1e-3
    return ([Check("whitted_px_off_1e-3_not_on_shared_edge",
                   int((flipped & ~edge).sum()), "==", 0),
             Check("whitted_mae_off_shared_edges", err[~edge].mean(), "<=",
                   MAE)],
            {"whitted_shared_edge_px": int(edge.sum()),
             "whitted_px_off_1e-3": int(flipped.sum())})


def _check_adaptive(jax, scene, cfg):
    import jax.numpy as jnp

    from light_transport_tpu.integrators.adaptive import _round

    with jax.default_device(jax.devices("cpu")[0]):
        scene_c, cfg_c = _lts()
        inputs_c, allocs_c, _ = _adaptive_rounds(jax, scene_c, cfg_c, 7)
    inputs_g, _, _ = _adaptive_rounds(jax, scene, cfg, 7)
    # the first round's stats (every pixel one sample, no allocation yet)
    img = [f[0] / np.maximum(f[3], 1)[:, None]
           for f in (inputs_g[1], inputs_c[1])]
    st = image_stats(img[0], img[1])
    checks = [Check("adaptive_round0_counts_equal",
                    bool((inputs_g[1][3] == inputs_c[1][3]).all()), "==",
                    True),
              Check("adaptive_round0_mean_diff", st["mean_diff"], "<=",
                    MEAN_DIFF),
              Check("adaptive_round0_mae", st["mae"], "<=", MAE)]
    info = {}
    n_pix = cfg.height * cfg.width
    budget = n_pix * (cfg.spp // len(allocs_c))
    for r, (stats_c, alloc_c) in enumerate(zip(inputs_c, allocs_c)):
        # the GPU's allocation from the CPU's stats of the same round
        _, alloc_g = _round(scene, cfg, jax.random.key(7), budget,
                            tuple(jnp.asarray(x) for x in stats_c),
                            jnp.asarray(r, jnp.int32), None)
        ag = alloc_agreement(alloc_g, alloc_c)
        checks.append(Check(f"adaptive_alloc{r}_cum_max_diff",
                            ag["cum_max_diff"], "<=", 1))
        info[f"adaptive_alloc{r}_px_mismatch"] = ag["px_mismatch"]

    # unbiasedness on the card: adaptive vs a high-spp path reference
    ref_cfg = dataclasses.replace(cfg, spp=REFERENCE_SPP)
    ad = [_adaptive_rounds(jax, scene, cfg, 100 + k)[2].mean()
          for k in range(ADAPTIVE_SEEDS)]
    ref = [_path_unclipped_mean(jax, scene, ref_cfg, 1000 + k)
           for k in range(ADAPTIVE_SEEDS)]
    (m_a, se_a), (m_r, se_r) = mean_and_stderr(ad), mean_and_stderr(ref)
    checks.append(mc_check("adaptive_vs_path_ref_mean", m_a, m_r,
                           float(np.hypot(se_a, se_r)), 0.0))
    info.update(adaptive_unclipped_mean=m_a, path_ref_unclipped_mean=m_r,
                adaptive_mean_stderr=se_a, path_ref_mean_stderr=se_r)
    return checks, info


def phase_renders(jax):
    from light_transport_tpu.integrators.path_tracer import render_image

    cpu = jax.devices("cpu")[0]
    checks, info = [], {}

    # golden: tests/test_golden_images.py::test_lts_cornell_golden settings
    scene, cfg = _lts()
    golden = np.load(GOLDEN)
    img = np.asarray(render_image(scene, cfg, jax.random.key(42)))
    st = image_stats(img, golden)
    checks += [Check("golden_mae", st["mae"], "<", 2e-3),
               Check("golden_max_err", st["max_err"], "<", 0.05)]

    for integ in ("path", "whitted", "bdpt", "adaptive", "cv"):
        g, first, steady = _timed(_render_fn(integ, scene, cfg, 7))
        with jax.default_device(cpu):
            scene_c, cfg_c = _lts()
            c = _render_fn(integ, scene_c, cfg_c, 7)()
        st = image_stats(g, c)
        ok_shape = g.shape == (cfg.height, cfg.width, 3)
        checks.append(Check(f"{integ}_finite_shape",
                            ok_shape and bool(np.isfinite(g).all()), "==",
                            True))
        if integ == "whitted":
            more, more_info = _check_whitted(jax, scene, cfg, g, c)
        elif integ == "adaptive":
            more, more_info = _check_adaptive(jax, scene, cfg)
            more_info["adaptive_mae_vs_cpu"] = st["mae"]
        else:
            more = [Check(f"{integ}_mean_diff", st["mean_diff"], "<=",
                          MEAN_DIFF),
                    Check(f"{integ}_mae", st["mae"], "<=", MAE)]
            more_info = {}
        checks += more
        info.update(more_info)
        info[f"{integ}_first_s"] = first
        info[f"{integ}_s"] = steady
        info[f"{integ}_max_err"] = st["max_err"]

    scene, cfg = _lts(*LTS_NOTEBOOK)
    img, first, steady = _timed(_render_fn("path", scene, cfg, 0))
    info["lts150_first_s"] = first
    info["lts150_s"] = steady
    checks.append(Check("lts150_finite", bool(np.isfinite(img).all()), "==",
                        True))
    return {"info": info, "checks": checks}


def _bvh_vs_brute(jax, scene, n_rays, seed):
    """BVH nearest hits vs brute force on ``n_rays`` random rays inside the
    scene's bounding box (both on the GPU)."""
    import jax.numpy as jnp

    from light_transport_tpu.accel.bvh import intersect_bvh
    from light_transport_tpu.ops.intersect import intersect_rays

    v = scene.mesh.vertices()
    lo, hi = v.reshape(-1, 3).min(0), v.reshape(-1, 3).max(0)
    o, d = random_rays(seed, n_rays, lo, hi)
    o, d = jnp.asarray(o), jnp.asarray(d)
    bvh_fn = jax.jit(lambda o, d: intersect_bvh(o, d, scene.mesh, scene.bvh))
    brute_fn = jax.jit(lambda o, d: intersect_rays(o, d, scene.mesh,
                                                   ray_chunk=256))
    hb = jax.device_get(bvh_fn(o, d))
    hr = jax.device_get(brute_fn(o, d))
    t0 = time.perf_counter()
    jax.block_until_ready(bvh_fn(o, d))
    t_bvh = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(brute_fn(o, d))
    t_brute = time.perf_counter() - t0
    st = hit_agreement(hb.t, hb.tri, hb.valid, hr.t, hr.tri, hr.valid)
    return st, t_bvh, t_brute


def phase_meshes(jax):
    from light_transport_tpu.models.presets import (
        glass_scene,
        soft_shadow_scene,
    )

    cpu = jax.devices("cpu")[0]
    checks, info = [], {}
    scene, cfg = glass_scene()
    info["glass_tris"] = int(scene.mesh.v0.shape[0])
    g, first, steady = _timed(_render_fn("path", scene, cfg, 3))
    with jax.default_device(cpu):
        scene_c, cfg_c = glass_scene()
        c = _render_fn("path", scene_c, cfg_c, 3)()
    st = image_stats(g, c)
    checks += [Check("glass_finite", bool(np.isfinite(g).all()), "==", True),
               Check("glass_mean_diff", st["mean_diff"], "<=", MEAN_DIFF),
               Check("glass_mae", st["mae"], "<=", MAE)]
    info.update(glass_first_s=first, glass_s=steady, glass_mean=g.mean())
    hits, t_bvh, t_brute = _bvh_vs_brute(jax, scene, HIT_RAYS, 5)
    checks += [Check("glass_valid_mismatch", hits["valid_mismatch"], "==", 0),
               Check("glass_t_rel_err", hits["t_max_rel_err"], "<=", 1e-5),
               Check("glass_tri_mismatch", hits["tri_mismatch_non_tie"],
                     "==", 0)]
    info.update(glass_hits=hits["hits"], glass_bvh_2e16_s=t_bvh,
                glass_brute_2e16_s=t_brute)

    t0 = time.perf_counter()
    width, height, spp, depth = SOFT_SHADOW
    scene, cfg = soft_shadow_scene(width, height, spp, depth)
    info["soft_build_s"] = time.perf_counter() - t0
    info["soft_tris"] = int(scene.mesh.v0.shape[0])
    img, first, steady = _timed(_render_fn("path", scene, cfg, 0))
    checks += [Check("soft_finite_shape",
                     img.shape == (height, width, 3)
                     and bool(np.isfinite(img).all()), "==", True),
               Check("soft_mean", float(img.mean()), ">", 0.01)]
    info.update(soft_first_s=first, soft_s=steady, soft_mean=img.mean())
    hits, t_bvh, t_brute = _bvh_vs_brute(jax, scene, HIT_RAYS, 6)
    checks += [Check("soft_valid_mismatch", hits["valid_mismatch"], "==", 0),
               Check("soft_t_rel_err", hits["t_max_rel_err"], "<=", 1e-5),
               Check("soft_tri_mismatch", hits["tri_mismatch_non_tie"],
                     "==", 0)]
    info.update(soft_hits=hits["hits"], soft_bvh_2e16_s=t_bvh,
                soft_brute_2e16_s=t_brute)
    return {"info": info, "checks": checks}


def phase_multi(jax, n_dev: int = 4):
    from light_transport_tpu.core.config import MediumConfig, PhotonRunConfig
    from light_transport_tpu.integrators.bdpt import render_bdpt
    from light_transport_tpu.integrators.path_tracer import render_image
    from light_transport_tpu.parallel.mesh import (
        make_mesh,
        render_bdpt_sharded,
        render_sharded,
        simulate_sharded,
    )
    from light_transport_tpu.scene.medium import LayeredMedium
    from light_transport_tpu.tally.stats import binomial_stderr
    from light_transport_tpu.transport.photon import simulate_photons

    if len(jax.devices()) < n_dev:
        raise RuntimeError(f"--multi needs {n_dev} devices, found "
                           f"{len(jax.devices())}")
    mesh = make_mesh(n_dev)
    checks, info = [], {}

    medium = LayeredMedium.build(
        [MediumConfig(mu_a=1.0, mu_s=9.0, g=0.5, n=1.0)])
    n = MULTI_PHOTONS
    cfg = PhotonRunConfig(n_photons=n, nr=16, nz=16, dr=0.05, dz=0.05)
    res4, first, steady = _timed(lambda: simulate_sharded(
        medium, cfg, jax.random.key(1), mesh=mesh))
    res1 = simulate_photons(medium, cfg, jax.random.key(2))
    se = binomial_stderr(res1.total_reflectance(), n) * np.sqrt(2)
    checks += [
        Check("sim_launched", res4.n_launched, "==", n),
        Check("sim_energy|E-1|", abs(res4.energy_total() - 1.0), "<=", 1e-2),
        Check("sim_Rd|d|", abs(res4.total_reflectance()
                               - res1.total_reflectance()), "<=",
              3 * se + 1e-3),
        Check("sim_A|d|", abs(res4.total_absorption()
                              - res1.total_absorption()), "<=",
              3 * se + 1e-3)]
    info.update(sim_first_s=first, sim_s=steady)

    # identical uniforms and lane layout -> the same estimator; the bound
    # covers the cross-device summation order only (tests/test_sharding.py)
    scene, rcfg = _lts(*LTS_NOTEBOOK)
    img4, first, steady = _timed(lambda: np.asarray(render_sharded(
        scene, rcfg, jax.random.key(3), mesh=mesh)))
    img1 = np.asarray(render_image(scene, rcfg, jax.random.key(3)))
    st = image_stats(img4, img1)
    checks += [Check("render_max_err", st["max_err"], "<=", 2e-5)]
    info.update(render_first_s=first, render_s=steady)

    scene, rcfg = _lts(*MULTI_BDPT)
    img4, first, steady = _timed(lambda: np.asarray(render_bdpt_sharded(
        scene, rcfg, jax.random.key(5), mesh=mesh)))
    img1 = np.asarray(render_bdpt(scene, rcfg, jax.random.key(5)))
    st = image_stats(img4, img1)
    checks += [Check("bdpt_max_err", st["max_err"], "<=", 5e-6)]
    info.update(bdpt_first_s=first, bdpt_s=steady)
    return {"info": info, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-device sharded phase")
    args = ap.parse_args(argv)

    from light_transport_tpu.core.cache import enable_compile_cache

    enable_compile_cache()

    import jax

    from light_transport_tpu.utils.profiling import gpu_name_and_power_limit

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    card = gpu_name_and_power_limit()

    smoke = Smoke()
    smoke.phase("device", lambda: phase_device(jax, card))
    if args.multi:
        smoke.phase("multi", lambda: phase_multi(jax))
    else:
        smoke.phase("photon_physics", lambda: phase_photon_physics(jax))
        smoke.phase("photon_full_scale",
                    lambda: phase_photon_full_scale(jax))
        smoke.phase("renders", lambda: phase_renders(jax))
        smoke.phase("meshes", lambda: phase_meshes(jax))
    print(card)
    if smoke.failed:
        print(f"failed phases: {', '.join(smoke.failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
