"""Soft shadows from a large area light over a dense mesh.

Mirrors the reference's soft_shadow.ipynb — its heaviest published workload:
a ~123k-triangle scene at 400x400, 10 spp, depth 3, which it renders in
525 s on CPU.  Here the mesh carries a BVH and every ray walks it
(models/presets.soft_shadow_scene).  Pass --quick for a 200x200x4spp
variant.
"""

import sys

import numpy as np

from _common import report, save_image, timed_twice

from light_transport_tpu.api import render
from light_transport_tpu.models.presets import soft_shadow_scene


def main():
    quick = "--quick" in sys.argv
    if quick:
        scene, cfg = soft_shadow_scene(width=200, height=200, spp=4)
    else:
        scene, cfg = soft_shadow_scene()
    img, t_jit, t_steady = timed_twice(
        lambda: np.asarray(render(scene, cfg, seed=0)))
    p = save_image(img, "soft_shadow.png", gamma=2.2)
    report("soft_shadow", t_jit, steady_seconds=round(t_steady, 3), tris=int(scene.mesh.v0.shape[0]),
           pixels=cfg.width * cfg.height, spp=cfg.spp,
           mean=float(img.mean()), image=p,
           reference_seconds=525.0 if not quick else None)


if __name__ == "__main__":
    main()
