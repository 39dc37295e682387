"""Flagship Cornell-box path trace + control-variates pipeline.

Mirrors the reference's LTS.ipynb / LTS_fix1.ipynb: render the Cornell box
(red/green walls, glass cone, ceiling area light) with the NEE path tracer,
then run the control-variates variance-reduction pass — plain image
("image_ver1"), CV-corrected image ("image_ver2"), and the 500-sample deep
dive at four hand-picked pixels (src/path_tracing.py:310-364).

The reference renders 150x150x12spp in 73-110 s on CPU; this runs the same
scene end-to-end jitted (PERF.md has the time on one GPU).
"""

import numpy as np
import jax

from _common import report, save_image, timed_twice, timer

from light_transport_tpu.integrators.control_variates import (
    cv_pixel_dive,
    render_cv,
)
from light_transport_tpu.scene.cornell import cornell_box_scene


def main():
    scene, cfg = cornell_box_scene(width=150, height=150, spp=12, max_depth=4)

    def go():
        out = render_cv(scene, cfg, jax.random.key(0))
        jax.block_until_ready(out)
        return out
    out, t_jit, t_steady = timed_twice(go)
    plain = np.asarray(out.image_plain)
    cv = np.asarray(out.image_cv)
    var_plain = np.asarray(out.samples).var(axis=2).mean()
    p1 = save_image(plain, "lts_cornell_plain.png")
    p2 = save_image(cv, "lts_cornell_cv.png")
    report("lts_cornell", t_jit, steady_seconds=round(t_steady, 3), mean_plain=float(plain.mean()),
           mean_cv=float(cv.mean()), sample_variance=float(var_plain),
           images=[p1, p2])

    # the reference's extra pass: 500 fresh samples at 4 chosen pixels
    pixels = [(40, 40), (40, 110), (110, 40), (110, 110)]
    with timer() as t:
        dive = cv_pixel_dive(scene, cfg, jax.random.key(1), pixels,
                             n_samples=500)
        jax.block_until_ready(dive)
    for k, (r, c) in enumerate(pixels):
        s = np.asarray(dive.samples[k])
        cvs = np.asarray(dive.corrected[k])
        print(f"pixel ({r},{c}): plain {s.mean(0).round(4)} "
              f"var {s.var(0).mean():.5f} -> cv var {cvs.var(0).mean():.5f}")
    report("lts_cornell_pixel_dive", t.seconds)


if __name__ == "__main__":
    main()
