"""Independent scalar oracle for the surface path tracer.

A deliberately naive per-ray numpy implementation of the same estimator
(NEE + cosine BSDF sampling + first-hit emission) written without any
shared code — the 'small trusted CPU oracle' SURVEY.md §4 calls for.  The
vectorized integrator must agree with it within Monte Carlo error on a
diffuse scene; any systematic estimator drift (pdf factor, geometry term,
throughput update, emission rule) shows up as a mean shift.
"""

import jax
import numpy as np
import pytest

from light_transport_tpu.core.config import RenderConfig
from light_transport_tpu.integrators.path_tracer import render_image
from light_transport_tpu.scene.cornell import (
    cornell_box_triangles,
    light_triangles,
)
from light_transport_tpu.scene.cornell import cornell_box_scene

DIM = 7.5
EMISSION = 200.0
RHO = {0: np.array([0.55, 0.55, 0.55]),  # surface (WHITE_2)
       1: np.array([0.7, 0.0, 0.0]),  # left (RED)
       2: np.array([0.0, 0.6, 0.0])}  # right (GREEN)


def _build_oracle_scene():
    verts, kind = cornell_box_triangles(DIM)
    lv = light_triangles(DIM)
    tris = np.concatenate([verts, lv])
    mats = list(kind) + [3, 3]  # 3 = light
    v0 = tris[:, 0]
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return v0, e1, e2, n, np.asarray(mats)


def _intersect(v0, e1, e2, o, d, t_min=1e-5, t_max=np.inf):
    pvec = np.cross(d, e2)
    det = np.einsum("ij,ij->i", e1, pvec)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(det == 0, 1, det), 0.0)
    tvec = o - v0
    u = np.einsum("ij,ij->i", tvec, pvec) * inv
    qvec = np.cross(tvec, e1)
    v = np.einsum("j,ij->i", d, qvec) * inv
    t = np.einsum("ij,ij->i", e2, qvec) * inv
    valid = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    valid &= (t > t_min) & (t < t_max)
    t = np.where(valid, t, np.inf)
    i = int(np.argmin(t))
    return (i, t[i]) if np.isfinite(t[i]) else (-1, np.inf)


def _trace_oracle(rng, v0, e1, e2, nrm, mats, o, d, max_depth, rr_start=3):
    radiance = np.zeros(3)
    tp = np.ones(3)
    for bounce in range(max_depth):
        i, t = _intersect(v0, e1, e2, o, d)
        if i < 0:
            break
        hp = o + t * d
        n = nrm[i]
        if np.dot(n, d) > 0:
            n = -n
        if mats[i] == 3:  # light
            if bounce == 0:
                radiance += EMISSION * tp
            # light material is diffuse white in the reference scene
            rho = np.ones(3)
        else:
            rho = RHO[mats[i]]

        # NEE: uniform point on the 2x2 light square
        lp = np.array([rng.uniform(-1, 1), DIM, rng.uniform(-1, 1)])
        to_l = lp - (hp + 1e-4 * n)
        dist = np.linalg.norm(to_l)
        wi = to_l / dist
        j, tj = _intersect(v0, e1, e2, hp + 1e-4 * n, wi,
                           t_max=dist * (1 - 1e-3))
        if j < 0:  # visible
            g = abs(np.dot(n, wi)) * abs(wi[1]) / dist**2  # light n = -y
            radiance += tp * (EMISSION * 1.0) * (rho / np.pi) * g * 4.0

        # cosine bounce
        u1, u2 = rng.uniform(), rng.uniform()
        st = np.sqrt(u1)
        phi = 2 * np.pi * u2
        local = np.array(
            [st * np.cos(phi), st * np.sin(phi), np.sqrt(1 - u1)]
        )
        # orthonormal basis
        a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
        tgt = np.cross(n, a)
        tgt /= np.linalg.norm(tgt)
        btg = np.cross(n, tgt)
        nd = local[0] * tgt + local[1] * btg + local[2] * n
        tp = tp * rho  # f*cos/pdf == rho for cosine sampling
        o = hp + 1e-4 * nd
        d = nd
        if bounce > rr_start:
            r_r = max(0.05, 1 - tp[1])
            if rng.uniform() < r_r:
                break
            tp = tp / (1 - r_r)
    return radiance


@pytest.mark.slow
def test_path_tracer_matches_scalar_oracle():
    v0, e1, e2, nrm, mats = _build_oracle_scene()
    rng = np.random.default_rng(0)
    cam = np.array([0.0, 0.0, DIM + 0.5])
    max_depth = 3

    # oracle: random pixels over the screen, many paths
    n_paths = 4000
    samples_oracle = np.zeros((n_paths, 3))
    for p in range(n_paths):
        x = rng.uniform(-1, 1)
        y = rng.uniform(-1, 1)
        pixel = np.array([x, y, DIM])
        d = pixel - cam
        d /= np.linalg.norm(d)
        samples_oracle[p] = _trace_oracle(rng, v0, e1, e2, nrm, mats, cam, d,
                                          max_depth)
    oracle_mean = samples_oracle.mean(axis=0)
    oracle_se = samples_oracle.std(axis=0) / np.sqrt(n_paths)

    # framework: raw unclipped radiance samples over the same camera domain
    scene, _ = cornell_box_scene(width=40, height=40, spp=8,
                                 max_depth=max_depth, include_cone=False)
    cfg = RenderConfig(width=40, height=40, spp=8, max_depth=max_depth,
                       f_distance=DIM)
    _, samples = render_image(scene, cfg, jax.random.key(1),
                              return_samples=True)
    frame = np.asarray(samples).reshape(-1, 3)
    frame_mean = frame.mean(axis=0)
    frame_se = frame.std(axis=0) / np.sqrt(frame.shape[0])

    for c in range(3):
        tol = 4 * np.hypot(oracle_se[c], frame_se[c]) + 0.01
        assert abs(oracle_mean[c] - frame_mean[c]) < tol, (
            c, oracle_mean, frame_mean, tol
        )
