"""Runnable presets: the five BASELINE.json configs plus the reference's
demo scenes, each a zero-argument callable returning everything needed to
run (the reference keeps these as notebook literals; SURVEY.md §5 calls for
a real config system)."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from light_transport_tpu.core.config import (
    MediumConfig,
    PhotonRunConfig,
    RenderConfig,
)
from light_transport_tpu.scene.cornell import cornell_box_scene
from light_transport_tpu.scene.medium import LayeredMedium


def demo_homogeneous():
    """BASELINE config 1: ~1e5 photons, homogeneous absorbing/scattering
    medium, reflectance + fluence tallies."""
    medium = LayeredMedium.build(
        [MediumConfig(mu_a=1.0, mu_s=9.0, g=0.0, n=1.0)]
    )
    cfg = PhotonRunConfig(n_photons=100_000, nr=64, nz=64, dr=0.02, dz=0.02)
    return medium, cfg


def hg_sweep(g_values=(0.0, 0.5, 0.9), mu_a_values=(0.1, 1.0, 10.0),
             mu_s_values=(10.0, 90.0)):
    """BASELINE config 2: anisotropic HG sweep in a semi-infinite medium.
    Yields (label, medium, cfg) triples."""
    for g in g_values:
        for mu_a in mu_a_values:
            for mu_s in mu_s_values:
                medium = LayeredMedium.build(
                    [MediumConfig(mu_a=mu_a, mu_s=mu_s, g=g, n=1.0)]
                )
                cfg = PhotonRunConfig(n_photons=100_000, nr=64, nz=64,
                                      dr=0.02, dz=0.02)
                yield f"g={g}_mua={mu_a}_mus={mu_s}", medium, cfg


def multilayer_mismatch():
    """BASELINE config 3: layered slab with refractive-index mismatch
    (Fresnel/TIR at interfaces, layered fluence depth profile)."""
    medium = LayeredMedium.build(
        [
            MediumConfig(mu_a=1.0, mu_s=100.0, g=0.9, n=1.4, thickness=0.1),
            MediumConfig(mu_a=1.0, mu_s=10.0, g=0.0, n=1.0, thickness=0.1),
            MediumConfig(mu_a=2.0, mu_s=10.0, g=0.7, n=1.37, thickness=0.2),
        ],
        n_above=1.0,
        n_below=1.0,
    )
    cfg = PhotonRunConfig(n_photons=200_000, nr=64, nz=100, dr=0.01, dz=0.005)
    return medium, cfg


def mesh_scene():
    """BASELINE config 4: triangle-mesh geometry with per-surface detectors
    (the LTS Cornell+cone parity scene at its notebook settings)."""
    scene, cfg = cornell_box_scene(width=150, height=150, spp=12, max_depth=4)
    return scene.with_bvh(), cfg


def full_scale():
    """BASELINE config 5: 1e8 photons into a 3D fluence volume + a 512x512
    detector image, photon batches sharded across the mesh.

    The 3-D cartesian volume (128^3 cells, 0.2 mm pitch) covers +/-1.28 cm
    around the beam axis and 2.56 cm of depth — the same physical extent as
    the (r, z) MCML grid.  Every tally is deposited at every step.
    """
    medium = LayeredMedium.build(
        [MediumConfig(mu_a=0.5, mu_s=50.0, g=0.9, n=1.37)]
    )
    cfg = PhotonRunConfig(n_photons=100_000_000, nr=512, nz=512,
                          dr=0.005, dz=0.005,
                          detector_nx=512, detector_extent=1.28,
                          vol_nx=128, vol_ny=128, vol_nz=128,
                          vol_dx=0.02, vol_dy=0.02, vol_dz=0.02)
    return medium, cfg


def lts_scene(**kw):
    """The flagship notebook scene (LTS.ipynb cells 11-18)."""
    return cornell_box_scene(**kw)


def point_light_scene(width=150, height=150, spp=12, max_depth=4):
    """Cornell box lit by a true point (delta) light — the reference GUI's
    'Point' source option (app.py:152-158) as a first-class scene.

    Same geometry as the LTS scene with emission=0 (the top panel stays as
    dark geometry) and one bare-bulb point light in the upper middle of
    the room — an isotropic point near a surface floods it with 1/r^2
    irradiance, so a mid-room placement keeps every wall at a sane
    distance (the reference GUI's default point position is similarly
    mid-room, app.py:153-156).  Intensity matches the area panel's total
    power: a one-sided Lambertian panel emits ``pi * L * A``; an
    isotropic point of equal power has ``I = L * A / 4`` = 200 * 4 / 4 =
    200."""
    scene, cfg = cornell_box_scene(width=width, height=height, spp=spp,
                                   max_depth=max_depth, emission=0.0)
    scene = scene.with_point_lights([[0.0, 3.0, 0.0]],
                                    [[200.0, 200.0, 200.0]])
    return scene, cfg


def hard_shadow_scene(width=400, height=400):
    """The reference's hard_shadow.ipynb scene, rebuilt exactly: a 2-unit
    BRONZE cube at [0,2]^3 on a green floor (y=-2, x +/-52, z +/-7), a point
    light at (3,5,3) (tiny emissive quad; our Whitted shades from light-row
    centroids), camera (0,0,3.5) with the screen plane at z=3 (the
    notebook's legacy ``scene.depth``), 400x400, depth 3 — the golden-image
    parity scene vs examples/hard_shadow.png."""
    from light_transport_tpu.scene.geometry import (
        TriangleMesh,
        concat_meshes,
        quad_triangles,
    )
    from light_transport_tpu.scene.material import (
        Material,
        MaterialTable,
        presets,
    )
    from light_transport_tpu.scene.scene import Scene

    # cube.obj: unit-2 cube spanning [0,2]^3, quad faces fanned like the
    # reference loader (examples/obj/cube.obj + hard_shadow.ipynb cell 9)
    v = np.array([[0, 2, 2], [0, 0, 2], [2, 0, 2], [2, 2, 2],
                  [0, 2, 0], [0, 0, 0], [2, 0, 0], [2, 2, 0]], np.float64)
    faces = [(0, 1, 2, 3), (7, 6, 5, 4), (3, 2, 6, 7),
             (4, 0, 3, 7), (4, 5, 1, 0), (1, 5, 6, 2)]
    cube_t = np.concatenate(
        [quad_triangles(v[a], v[b], v[c], v[d]) for a, b, c, d in faces])
    cube = TriangleMesh.build(cube_t, np.zeros(len(cube_t), np.int32))
    floor = TriangleMesh.build(
        quad_triangles((-52, -2, -7), (-52, -2, 7), (52, -2, 7),
                       (52, -2, -7)),
        np.asarray([1, 1], np.int32))
    s = 0.01  # point light (hard_shadow.ipynb cell 11) as a tiny quad
    lq = quad_triangles((3 - s, 5, 3 - s), (3 + s, 5, 3 - s),
                        (3 + s, 5, 3 + s), (3 - s, 5, 3 + s))
    lights = TriangleMesh.build(lq, np.asarray([2, 2], np.int32),
                                np.asarray([True, True]))
    green = Material(color=presets.GREEN, shininess=90, reflection=0.1)
    source = Material(color=presets.WHITE, shininess=1, reflection=0.9,
                      emission=1.0)
    mats = MaterialTable.build([presets.BRONZE_MAT, green, source])
    mesh = concat_meshes([cube, floor, lights])
    scene = Scene.build(mesh, mats, camera=[0.0, 0.0, 3.5])
    cfg = RenderConfig(width=width, height=height, spp=1, max_depth=3,
                       f_distance=3.0)
    return scene, cfg


def glass_scene(width=100, height=100, spp=4, max_depth=3):
    """The refraction demo: whisky glass (glass body + liquid + ice)
    standing in the Cornell box so the colored walls show through the
    transmissive chains (examples/refraction.ipynb +
    examples/obj/glass.py)."""
    from light_transport_tpu.scene.geometry import concat_meshes
    from light_transport_tpu.scene.glass import design_glass, glass_materials
    from light_transport_tpu.scene.material import MaterialTable
    from light_transport_tpu.scene.scene import Scene

    import dataclasses

    base, cfg = cornell_box_scene(width=width, height=height, spp=spp,
                                  max_depth=max_depth, include_cone=False)
    # specular chains dominate this scene: use the estimator-correct "nee"
    # emission rule (light hits count after specular chains) — "first_hit"
    # (reference flagship parity) structurally drops that energy
    cfg = dataclasses.replace(cfg, emission_mode="nee")
    dim = 7.5
    # tumbler is 12.5 tall with radius 7: scale into the box and stand it
    # on the floor (y = -dim), centered.  design_glass spans y in
    # [-0.5, 12.5] around its origin (the 1-unit base cylinder is centered
    # at y=0), so lift by the scaled base half-height too — translating
    # the origin straight to the floor sinks the base through it
    glass = design_glass(mat_offset=5).scaled(0.85)
    y_min = float(glass.vertices()[..., 1].min())
    glass = glass.translated((0.0, -dim + 0.01 - y_min, 0.0))
    # rebuild the material table: the 5 Cornell rows (ids 0-4 in base.mesh,
    # shared with cornell_box_scene so the definitions cannot drift)
    # followed by the 3 glass rows (mat_offset=5 above)
    from light_transport_tpu.scene.cornell import cornell_materials

    mats = MaterialTable.build(cornell_materials() + glass_materials())
    mesh = concat_meshes([base.mesh, glass])
    scene = Scene.build(mesh, mats, camera=[0.0, 0.0, dim + 0.5]).with_bvh()
    return scene, cfg


def soft_shadow_scene(width=400, height=400, spp=10, max_depth=3):
    """The reference's soft_shadow.ipynb — its heaviest published workload:
    a ~123k-triangle sphere over a floor under a large area light, at
    400x400, 10 spp, depth 3 (the reference renders it in 525 s on CPU).
    The mesh carries a BVH."""
    from light_transport_tpu.scene.cornell import sphere_triangles
    from light_transport_tpu.scene.geometry import (
        TriangleMesh,
        concat_meshes,
        quad_triangles,
    )
    from light_transport_tpu.scene.material import (
        Material,
        MaterialTable,
        presets,
    )
    from light_transport_tpu.scene.scene import Scene

    sph = sphere_triangles(center=(0, 1, 0), radius=1.5, n_theta=176,
                           n_phi=352)  # 123,200 triangles
    floor = quad_triangles((-8, -0.5, -8), (-8, -0.5, 8), (8, -0.5, 8),
                           (8, -0.5, -8))
    lq = quad_triangles((-1.5, 6, -1.5), (1.5, 6, -1.5), (1.5, 6, 1.5),
                        (-1.5, 6, 1.5))
    mesh = concat_meshes([
        TriangleMesh.build(sph, np.zeros(len(sph), np.int32)),
        TriangleMesh.build(floor, np.asarray([1, 1], np.int32)),
        TriangleMesh.build(lq, np.asarray([2, 2], np.int32),
                           np.asarray([True, True])),
    ])
    mats = MaterialTable.build([
        Material(color=presets.TURQUOISE),
        Material(color=presets.WHITE_2),
        Material(color=presets.WHITE, emission=8.0),
    ])
    scene = Scene.build(mesh, mats, camera=[0.0, 1.0, 7.0]).with_bvh()
    cfg = RenderConfig(width=width, height=height, spp=spp,
                       max_depth=max_depth, f_distance=3.5)
    return scene, cfg


PRESETS: Dict[str, Callable] = {
    "demo": demo_homogeneous,
    "multilayer": multilayer_mismatch,
    "mesh": mesh_scene,
    "full_scale": full_scale,
    "lts": lts_scene,
    "glass": glass_scene,
    "point": point_light_scene,
    "soft_shadow": soft_shadow_scene,
}
