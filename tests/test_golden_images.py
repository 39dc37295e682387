"""Golden-image regression tests.

Two layers of protection against silent estimator regressions that the
statistical parity tests are too loose to see:

1. **Cross-implementation golden**: our Whitted render of the reference's
   hard_shadow.ipynb scene vs the PNG checked into the reference repo
   (examples/hard_shadow.png — the reference's own published output).
   Measured agreement at the time this test was written: MAE 0.010,
   p95 |err| 0.043, image means within 0.4%.
2. **Own-render golden**: a stored render of the LTS Cornell parity scene
   at a fixed seed; any change to camera geometry, sampling, BSDF or light
   handling shifts it.
"""

import pathlib

import jax
import numpy as np
import pytest

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
REF_PNG = pathlib.Path(
    "/root/reference/LightTransportSimulator/light_transport/examples/"
    "hard_shadow.png"
)


def _load_ref_plot_area():
    """Extract the imshow plot area from the reference's matplotlib PNG:
    bounding box of densely black-or-green columns/rows (the rendered image
    is black sky over a green floor; figure margins and tick labels are
    sparse), then trim the axes spines."""
    import matplotlib.pyplot as plt

    ref = plt.imread(REF_PNG)[..., :3]
    mask = ((ref < 0.15).all(-1)) | ((ref[..., 1] > 0.25) & (ref[..., 0] < 0.2))
    rows = np.where(mask.sum(1) > mask.shape[1] * 0.3)[0]
    cols = np.where(mask.sum(0) > mask.shape[0] * 0.3)[0]
    return ref[rows.min() + 2:rows.max() - 1, cols.min() + 2:cols.max() - 1]


def _resize_nearest(img, h, w):
    yi = np.clip((np.arange(h) + 0.5) * img.shape[0] / h, 0,
                 img.shape[0] - 1).astype(int)
    xi = np.clip((np.arange(w) + 0.5) * img.shape[1] / w, 0,
                 img.shape[1] - 1).astype(int)
    return img[yi][:, xi]


@pytest.mark.skipif(not REF_PNG.exists(), reason="reference PNG not present")
def test_whitted_vs_reference_hard_shadow_png():
    from light_transport_tpu.integrators.whitted import render_whitted
    from light_transport_tpu.models.presets import hard_shadow_scene

    scene, cfg = hard_shadow_scene(width=200, height=200)
    img = np.asarray(render_whitted(scene, cfg, jax.random.key(0)))
    crop = _load_ref_plot_area()
    ours = _resize_nearest(img, crop.shape[0], crop.shape[1])
    err = np.abs(ours - crop)
    assert err.mean() < 0.03, err.mean()
    assert np.percentile(err, 95) < 0.10, np.percentile(err, 95)
    assert abs(ours.mean() - crop.mean()) < 0.02


def test_lts_cornell_golden():
    """Fixed-seed LTS Cornell render vs the stored golden.  Same platform
    (the CPU test mesh) is deterministic; the tolerance absorbs cross-
    platform rounding only."""
    from light_transport_tpu.integrators.path_tracer import render_image
    from light_transport_tpu.scene.cornell import cornell_box_scene

    scene, cfg = cornell_box_scene(width=48, height=48, spp=4, max_depth=3)
    img = np.asarray(render_image(scene, cfg, jax.random.key(42)))
    golden_path = GOLDEN_DIR / "lts_cornell_48.npy"
    assert golden_path.exists(), (
        "golden missing — regenerate with scripts/make_goldens.py"
    )
    golden = np.load(golden_path)
    err = np.abs(img - golden)
    assert err.mean() < 2e-3, err.mean()
    assert err.max() < 0.05, err.max()
