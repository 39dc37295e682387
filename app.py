"""Streamlit GUI — the reference's interactive front end (app.py:1-266),
rebuilt over this framework's presets and integrators.

Run with:  streamlit run app.py

The reference GUI offers an object picker (pyvista primitives/upload), a
background choice (floor / Cornell box), light setup, camera widgets, and a
render button (app.py:43-260).  This mirrors that flow: scene preset or OBJ
upload, integrator choice, resolution/spp/depth sliders, render + display
with elapsed time and scene stats (the reference surfaces elapsed time, BVH
depth, and triangle count, app.py:253-256).

Streamlit is not part of this image's baked dependencies; the module
degrades to a clear message when it is missing (the CLI,
``python -m light_transport_tpu.cli``, is the tested headless front end).
"""

from __future__ import annotations

import sys
import time


def main() -> int:
    try:
        import streamlit as st
    except ImportError:
        print(
            "streamlit is not installed in this environment.\n"
            "Use the CLI front end instead:\n"
            "  python -m light_transport_tpu.cli render --preset lts\n"
            "  python -m light_transport_tpu.cli simulate --preset demo\n"
        )
        return 1

    import jax
    import numpy as np

    from light_transport_tpu.api import render
    import dataclasses

    st.title("light_transport_tpu")
    st.caption("JAX Monte Carlo light transport")

    scene_name = st.sidebar.selectbox(
        "Scene", ["lts (Cornell + cone)", "glass", "teapot (OBJ)"]
    )
    integrator = st.sidebar.selectbox(
        "Integrator", ["path", "adaptive", "whitted", "bdpt", "cv"]
    )
    sampler = st.sidebar.selectbox(
        "Sampler (path/adaptive)", ["uniform", "sobol"]
    )
    width = st.sidebar.slider("Width", 32, 512, 150, step=16)
    height = st.sidebar.slider("Height", 32, 512, 150, step=16)
    spp = st.sidebar.slider("Samples per pixel", 1, 64, 8)
    max_depth = st.sidebar.slider("Max depth", 1, 8, 4)
    seed = st.sidebar.number_input("Seed", value=0, step=1)
    uploaded = st.sidebar.file_uploader("...or upload an OBJ", type=["obj"])

    if st.button("Render"):
        t0 = time.time()
        scene, cfg = _build_scene(scene_name, uploaded)
        cfg = dataclasses.replace(
            cfg, width=width, height=height, spp=spp, max_depth=max_depth,
            sampler=sampler if integrator in ("path", "adaptive")
            else "uniform",
        )
        if integrator == "cv":
            from light_transport_tpu.integrators.control_variates import render_cv

            out = render_cv(scene, cfg, jax.random.key(int(seed)))
            img = np.asarray(out.image_cv)
        else:
            img = np.asarray(
                render(scene, cfg, seed=int(seed), integrator=integrator)
            )
        elapsed = time.time() - t0
        st.image(np.clip(img, 0, 1), use_container_width=True)
        st.text(
            f"{scene.mesh.num_triangles} triangles | "
            f"{'BVH' if scene.bvh is not None else 'brute force'} | "
            f"{elapsed:.2f} s (incl. compile on first render)"
        )
    return 0


def _build_scene(scene_name: str, uploaded):
    import numpy as np

    from light_transport_tpu.models import presets as P

    if uploaded is not None:
        import tempfile

        from light_transport_tpu.scene.geometry import (
            TriangleMesh,
            concat_meshes,
            quad_triangles,
        )
        from light_transport_tpu.scene.material import (
            Material,
            MaterialTable,
            presets as mats_p,
        )
        from light_transport_tpu.scene.objio import parse_obj
        from light_transport_tpu.scene.scene import Scene
        from light_transport_tpu.core.config import RenderConfig

        with tempfile.NamedTemporaryFile(suffix=".obj") as fh:
            fh.write(uploaded.getvalue())
            fh.flush()
            verts = parse_obj(fh.name)
        verts -= verts.mean(axis=(0, 1))
        dim = float(np.abs(verts).max()) * 1.2
        mesh = TriangleMesh.build(verts, np.zeros(len(verts), np.int32))
        floor = TriangleMesh.build(
            quad_triangles((-4 * dim, -dim, -4 * dim), (-4 * dim, -dim, 4 * dim),
                           (4 * dim, -dim, 4 * dim), (4 * dim, -dim, -4 * dim)),
            np.asarray([1, 1]),
        )
        lq = quad_triangles((-dim, 3 * dim, -dim), (dim, 3 * dim, -dim),
                            (dim, 3 * dim, dim), (-dim, 3 * dim, dim))
        lights = TriangleMesh.build(lq, np.asarray([2, 2]),
                                    np.asarray([True, True]))
        mats = MaterialTable.build([
            Material(color=mats_p.TURQUOISE),
            Material(color=mats_p.WHITE_2),
            Material(color=mats_p.WHITE, emission=4.0),
        ])
        scene = Scene.build(concat_meshes([mesh, floor, lights]), mats,
                            camera=[0.0, 0.0, 3.0 * dim]).with_bvh()
        return scene, RenderConfig(f_distance=1.5 * dim)

    if scene_name.startswith("lts"):
        return P.lts_scene()
    if scene_name == "glass":
        return P.glass_scene()
    # teapot preset
    from light_transport_tpu.scene.geometry import (
        TriangleMesh, concat_meshes, quad_triangles,
    )
    from light_transport_tpu.scene.material import (
        Material, MaterialTable, presets as mats_p,
    )
    from light_transport_tpu.scene.objio import reference_obj_path
    from light_transport_tpu.scene.scene import Scene
    from light_transport_tpu.core.config import RenderConfig
    import numpy as np

    path = reference_obj_path("teapot.obj")
    if path is None:
        raise RuntimeError("teapot asset unavailable")
    from light_transport_tpu.scene.objio import parse_obj

    verts = parse_obj(path)
    verts -= verts.mean(axis=(0, 1))
    mesh = TriangleMesh.build(verts, np.zeros(len(verts), np.int32))
    floor = TriangleMesh.build(
        quad_triangles((-8, -1.8, -8), (-8, -1.8, 8), (8, -1.8, 8),
                       (8, -1.8, -8)), np.asarray([1, 1]),
    )
    lq = quad_triangles((-1.5, 6, -1.5), (1.5, 6, -1.5), (1.5, 6, 1.5),
                        (-1.5, 6, 1.5))
    lights = TriangleMesh.build(lq, np.asarray([2, 2]),
                                np.asarray([True, True]))
    mats = MaterialTable.build([
        Material(color=mats_p.TURQUOISE),
        Material(color=mats_p.WHITE_2),
        Material(color=mats_p.WHITE, emission=4.0),
    ])
    scene = Scene.build(concat_meshes([mesh, floor, lights]), mats,
                        camera=[0.0, 0.0, 9.0]).with_bvh()
    return scene, RenderConfig(f_distance=5.0)


if __name__ == "__main__":
    sys.exit(main())
