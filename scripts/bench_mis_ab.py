#!/usr/bin/env python3
"""A/B emission_mode='nee' vs 'mis': per-pixel
display-clipped variance at equal spp on three Cornell variants —
(a) stock, (b) small-bright light (5x smaller per side, 25x emission:
the regime where NEE is already near-optimal and MIS must match it, not
lose), and (c) LARGE-close light (4x larger per side, 1/16 emission):
shading points near the light see the NEE estimator's cos*cos/r^2
geometry term explode while BSDF sampling covers the light cheaply — the
power heuristic downweights NEE exactly there, which is where the
variance win lives.  Runs on CPU (estimator property, not a kernel)."""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import dataclasses

import numpy as np


def small_light_scene(width, height, spp, max_depth, shrink=5.0):
    from light_transport_tpu.scene import cornell as C
    from light_transport_tpu.scene.geometry import (TriangleMesh,
                                                    concat_meshes,
                                                    quad_triangles)
    from light_transport_tpu.scene.material import MaterialTable
    from light_transport_tpu.scene.scene import Scene

    dim = 7.5
    mats_rows = C.cornell_materials(emission=200.0 * shrink * shrink)
    mats = MaterialTable.build(mats_rows)
    wall_verts, wall_kind = C.cornell_box_triangles(dim)
    wall_ids = np.where(wall_kind == 1, 1,
                        np.where(wall_kind == 2, 2, 0)).astype(np.int32)
    walls = TriangleMesh.build(wall_verts, wall_ids)
    s = 1.0 / shrink
    lq = quad_triangles((-s, dim - 0.01, -s), (s, dim - 0.01, -s),
                        (s, dim - 0.01, s), (-s, dim - 0.01, s))
    lights = TriangleMesh.build(lq, np.full(2, 4, np.int32),
                                np.ones(2, bool))
    mesh = concat_meshes([walls, lights])
    scene = Scene.build(mesh, mats, camera=[0.0, 0.0, dim + 0.5])
    cfg = RenderConfig(width=width, height=height, spp=spp,
                       max_depth=max_depth, f_distance=dim + 0.5 - dim / 2)
    return scene, cfg


from light_transport_tpu.core.config import RenderConfig  # noqa: E402


def glossy_plate_scene(width, height, spp, max_depth, shininess=80.0,
                       half=3.0, power=60.0):
    """The regime MIS was built for (r5), Veach-style: a 45°-tilted glossy
    plate whose specular reflection of the camera points straight up into
    an overhead area light.  Every plate pixel is a highlight pixel.  With
    a LARGE light and a NARROW lobe, NEE's area sampling mostly lands
    where cos^n ~ 0 (high-variance spikes where it doesn't) while BSDF
    sampling follows the lobe — the power heuristic trades them
    per-direction.  ``power`` is total emitted power: radiance scales as
    1/half² so regimes with different light sizes are comparable."""
    from light_transport_tpu.scene.geometry import (TriangleMesh,
                                                    concat_meshes,
                                                    quad_triangles)
    from light_transport_tpu.scene.material import (Color, Material,
                                                    MaterialTable)
    from light_transport_tpu.scene.scene import Scene

    glossy = Material(color=Color.of((0, 0, 0), (0.05, 0.05, 0.05),
                                     (0.90, 0.90, 0.90)),
                      shininess=shininess, is_diffuse=False,
                      is_glossy=True)
    source = Material(color=Color.of((1, 1, 1), (1, 1, 1), (1, 1, 1)),
                      shininess=1, emission=power / (4.0 * half * half))
    mats = MaterialTable.build([glossy, source])
    # plate: 6x6 quad through the origin, tilted 45° about x (normal
    # (0, 1, 1)/sqrt2) — camera rays along -z reflect to +y
    s = 3.0 * 0.70710678
    pq = quad_triangles((-3.0, -s, s), (3.0, -s, s),
                        (3.0, s, -s), (-3.0, s, -s))
    plate = TriangleMesh.build(pq, np.zeros(2, np.int32))
    lq = quad_triangles((-half, 6.0, -half), (half, 6.0, -half),
                        (half, 6.0, half), (-half, 6.0, half))
    lights = TriangleMesh.build(lq, np.full(2, 1, np.int32),
                                np.ones(2, bool))
    mesh = concat_meshes([plate, lights])
    scene = Scene.build(mesh, mats, camera=[0.0, 0.0, 9.0])
    cfg = RenderConfig(width=width, height=height, spp=spp,
                       max_depth=max_depth, f_distance=4.5)
    return scene, cfg


def clipped_var(scene, cfg, mode, seeds):
    import jax

    from light_transport_tpu.integrators.path_tracer import render_image

    c = dataclasses.replace(cfg, emission_mode=mode)
    vs, ms = [], []
    for sd in seeds:
        _, samples = render_image(scene, c, jax.random.key(sd),
                                  return_samples=True)
        s = np.clip(np.asarray(samples, np.float64), 0, 1)
        vs.append(s.var(axis=2).mean())
        ms.append(s.mean())
    return float(np.mean(vs)), float(np.mean(ms))


def truth_image(scene, cfg, spp=64, n_seeds=6):
    """Converged clipped-display ground truth: mean of RAW (unclipped)
    per-sample radiance over spp*n_seeds samples, clipped once at the end
    (the spp->inf limit of the renderer's clip-of-mean display).  Uses
    emission_mode='mis' for the lowest-variance unbiased estimator; the
    raw mean is mode-independent (both estimators unbiased — verified:
    0.8355 vs 0.8237 ± 0.0155 at 192 samples on glossy-n400)."""
    import jax

    from light_transport_tpu.integrators.path_tracer import render_image

    c = dataclasses.replace(cfg, spp=spp, emission_mode="mis")
    acc = None
    for sd in range(100, 100 + n_seeds):
        _, samples = render_image(scene, c, jax.random.key(sd),
                                  return_samples=True)
        s = np.asarray(samples, np.float64).mean(axis=2)
        acc = s if acc is None else acc + s
    return np.clip(acc / n_seeds, 0.0, 1.0)


def rmse_vs_truth(scene, cfg, mode, seeds, truth):
    """Per-pixel RMSE of the displayed (clip-of-mean) image at the
    configured spp vs the converged truth — variance AND clipping bias.
    The clipped-variance metric alone is misleading when the estimators'
    display means diverge (NEE's glossy-highlight spikes clip to a
    near-black image whose variance is low because it is WRONG)."""
    import jax

    from light_transport_tpu.integrators.path_tracer import render_image

    c = dataclasses.replace(cfg, emission_mode=mode)
    errs = []
    for sd in seeds:
        img = np.asarray(render_image(scene, c, jax.random.key(sd)),
                         np.float64)
        errs.append(((img - truth) ** 2).mean())
    return float(np.sqrt(np.mean(errs)))


def main():
    from light_transport_tpu.scene.cornell import cornell_box_scene

    seeds = [0, 1, 2]
    stock, cfg = cornell_box_scene(width=48, height=48, spp=16, max_depth=4)
    small, cfg2 = small_light_scene(48, 48, 16, 4)
    large, cfg3 = small_light_scene(48, 48, 16, 4, shrink=0.25)
    gl80, cfg4 = glossy_plate_scene(48, 48, 16, 3, shininess=80.0)
    gl400, cfg5 = glossy_plate_scene(48, 48, 16, 3, shininess=400.0)
    for label, sc, cf in (("stock", stock, cfg),
                          ("small-bright", small, cfg2),
                          ("large-close", large, cfg3),
                          ("glossy-n80", gl80, cfg4),
                          ("glossy-n400", gl400, cfg5)):
        v_nee, m_nee = clipped_var(sc, cf, "nee", seeds)
        v_mis, m_mis = clipped_var(sc, cf, "mis", seeds)
        print(f"{label}: var nee {v_nee:.3e}  mis {v_mis:.3e}  "
              f"ratio {v_nee/max(v_mis,1e-30):.2f}x   "
              f"mean nee {m_nee:.4f} mis {m_mis:.4f}", flush=True)
        if label.startswith("glossy"):
            truth = truth_image(sc, cf)
            r_nee = rmse_vs_truth(sc, cf, "nee", seeds, truth)
            r_mis = rmse_vs_truth(sc, cf, "mis", seeds, truth)
            print(f"{label}: RMSE-vs-truth nee {r_nee:.4f}  "
                  f"mis {r_mis:.4f}  ratio {r_nee/max(r_mis,1e-30):.2f}x"
                  f"  (truth mean {truth.mean():.4f})", flush=True)


if __name__ == "__main__":
    main()
