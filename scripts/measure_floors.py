#!/usr/bin/env python3
"""Time the plain XLA paths on one GPU: the floors a hand-written kernel
must beat end to end, and the A/B runs behind three design choices.

    python3 scripts/measure_floors.py [--only SECTION ...] [--out FILE]

Sections (all by default):

- ``rates``   — ``api.simulate`` on the demo (1e5), multilayer (2e5) and
                full_scale (1e7) presets: compile-inclusive first call,
                steady calls, steps/s.
- ``lanes``   — ``simulate_photons`` over lane counts 2^14..2^20 on the demo
                medium at 1e5 and 1e6 photons, multilayer at 2e5 and
                full_scale at 1e7, plus the width ``default_lanes`` picks
                for each: the sweep behind that rule.
- ``glass``   — the ``glass`` preset rendered with its BVH (roped walk) and
                by brute force (``bvh=None``).
- ``chunk``   — ``ops.dispatch.BVH_LANE_CHUNK`` at 2^18 against one walk
                (2^24) on two BVH scenes of more than 2^18 lanes: the
                123k-tri soft-shadow render (400x400, 10 spp, depth 3) and
                the glass preset at 512x512, 4 spp, depth 3.
- ``raysort`` — the roped walk on 2^18 diffuse-bounce rays of the 123k-tri
                scene, as is and behind a direction-major Morton sort of
                the rays (the ray sort that fed the removed cluster-cull
                kernel, kept here only for this A/B).

Every record is one JSON line on stdout (and appended to ``--out``); the
first line is the card's name and power limit.  Times are wall seconds
around calls waited on with ``block_until_ready``; "steady" calls follow a
compiling one at the same shapes.  Refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _timed(jax, fn, repeats):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    steady = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        steady.append(time.perf_counter() - t0)
    return out, first, steady


def rates(jax, emit):
    from light_transport_tpu.api import simulate
    from light_transport_tpu.models import presets

    for name, n, repeats in (("demo", None, 3), ("multilayer", None, 3),
                             ("full_scale", 10_000_000, 2)):
        medium, cfg = presets.PRESETS[name]()
        if n is not None:
            cfg = dataclasses.replace(cfg, n_photons=n)
        res, first, steady = _timed(
            jax, lambda: simulate(medium, cfg, seed=0), repeats)
        emit(f"simulate_{name}", photons=cfg.n_photons,
             launched=res.n_launched, first_s=first, steady_s=steady,
             steps=res.n_steps, steps_per_s=res.n_steps / min(steady))


def lanes(jax, emit):
    from light_transport_tpu.models import presets
    from light_transport_tpu.transport.photon import (
        default_lanes,
        simulate_photons,
    )

    for name, n in (("demo", 100_000), ("demo", 1_000_000),
                    ("multilayer", 200_000), ("full_scale", 10_000_000)):
        medium, cfg = presets.PRESETS[name]()
        cfg = dataclasses.replace(cfg, n_photons=n)
        # the powers of two, and the width the default rule picks
        for width in sorted({1 << 14, 1 << 16, 1 << 18, 1 << 20,
                             default_lanes(n)}):
            if width > n:
                continue
            res, first, steady = _timed(
                jax, lambda: simulate_photons(medium, cfg,
                                              jax.random.key(0),
                                              lanes=width), 1)
            emit("lane_sweep", preset=name, photons=n, lanes=width,
                 default_lanes=default_lanes(n), launched=res.n_launched,
                 first_s=first, steady_s=steady[0],
                 steps_per_s=res.n_steps / steady[0])


def _render(jax, scene, cfg, seed=0):
    import numpy as np

    from light_transport_tpu.api import render

    return lambda: np.asarray(render(scene, cfg, seed=seed))


def glass(jax, emit):
    from light_transport_tpu.models.presets import glass_scene

    scene, cfg = glass_scene()
    for route, sc in (("bvh", scene), ("brute", scene.replace(bvh=None))):
        _, first, steady = _timed(jax, _render(jax, sc, cfg), 3)
        emit("glass_render", route=route, tris=int(scene.mesh.v0.shape[0]),
             first_s=first, steady_s=steady)


def chunk(jax, emit):
    from light_transport_tpu.models.presets import (
        glass_scene,
        soft_shadow_scene,
    )
    from light_transport_tpu.ops import dispatch

    scenes = (("soft_shadow_400x400x10", soft_shadow_scene(400, 400, 10, 3)),
              ("glass_512x512x4", glass_scene(512, 512, 4, 3)))
    default = dispatch.BVH_LANE_CHUNK
    try:
        for name, (scene, cfg) in scenes:
            for size in (1 << 18, 1 << 24):
                dispatch.BVH_LANE_CHUNK = size
                jax.clear_caches()  # the constant is read at trace time
                _, first, steady = _timed(jax, _render(jax, scene, cfg), 3)
                emit("bvh_chunk", scene=name,
                     lanes=cfg.width * cfg.height * cfg.spp, chunk=size,
                     first_s=first, steady_s=steady)
    finally:
        dispatch.BVH_LANE_CHUNK = default


def _morton_sorted(jax, fn, lo, hi, origins, directions):
    """``fn(origins, directions)`` on rays sorted by a 32-bit key — 2 bits
    of quantised direction per axis above an 8-bit-per-axis Morton code of
    the origin — with the result put back in input order."""
    import jax.numpy as jnp

    def spread(x):  # low 8 bits of x, 3 apart
        x = x & 0xFF
        x = (x | (x << 8)) & jnp.uint32(0xF00F)
        x = (x | (x << 4)) & jnp.uint32(0xC30C3)
        return (x | (x << 2)) & jnp.uint32(0x249249)

    q = (jnp.clip((origins - lo) / (hi - lo), 0.0, 1.0) * 255.0).astype(
        jnp.uint32)
    morton = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    qd = jnp.clip((directions + 1.0) * 0.5 * 3.999, 0.0, 3.0).astype(
        jnp.uint32)
    key = (((qd[:, 0] << 4) | (qd[:, 1] << 2) | qd[:, 2]) << 24) | morton
    perm = jnp.argsort(key)
    out = fn(origins[perm], directions[perm])
    inv = jnp.zeros_like(perm).at[perm].set(
        jnp.arange(perm.shape[0], dtype=perm.dtype))
    return jax.tree.map(lambda x: x[inv], out)


def raysort(jax, emit):
    import jax.numpy as jnp
    import numpy as np

    from light_transport_tpu.accel.bvh import intersect_bvh
    from light_transport_tpu.integrators.path_tracer import camera_rays
    from light_transport_tpu.models.presets import soft_shadow_scene

    scene, cfg = soft_shadow_scene(512, 512, 1, 3)  # 2^18 primary rays
    n = cfg.width * cfg.height
    rng = np.random.default_rng(0)
    o, d = camera_rays(scene, cfg,
                       jnp.asarray(rng.random((n, 2)), scene.camera.dtype))
    walk = jax.jit(lambda o, d: intersect_bvh(o, d, scene.mesh, scene.bvh))
    hit = walk(o, d)
    # diffuse bounce: from each primary hit, a cosine-free uniform
    # hemisphere direction about the facing normal
    mesh = scene.mesh
    nrm = jnp.cross(jnp.asarray(mesh.e1)[hit.tri],
                    jnp.asarray(mesh.e2)[hit.tri])
    nrm = nrm / jnp.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = jnp.where((jnp.sum(nrm * d, axis=1) > 0)[:, None], -nrm, nrm)
    p = o + d * jnp.where(hit.valid, hit.t, 0.0)[:, None]
    v = jnp.asarray(rng.normal(size=(n, 3)), p.dtype)
    v = v / jnp.linalg.norm(v, axis=1, keepdims=True)
    v = jnp.where((jnp.sum(v * nrm, axis=1) < 0)[:, None], -v, v)
    keep = np.asarray(hit.valid)
    bo, bd = (p + 1e-4 * nrm)[keep], v[keep]
    emit("bounce_rays", rays=int(bo.shape[0]), valid_share=float(keep.mean()))

    verts = np.concatenate([mesh.v0, mesh.v0 + mesh.e1, mesh.v0 + mesh.e2])
    lo = jnp.asarray(verts.min(0) - 0.1, p.dtype)
    hi = jnp.asarray(verts.max(0) + 0.1, p.dtype)
    sorted_walk = jax.jit(lambda o, d: _morton_sorted(
        jax, lambda a, b: intersect_bvh(a, b, mesh, scene.bvh), lo, hi, o, d))
    results = {}
    for _ in range(2):  # alternate, so drift hits both alike
        for name, fn in (("plain", walk), ("sorted", sorted_walk)):
            out, first, steady = _timed(jax, lambda: fn(bo, bd), 3)
            results[name] = out
            emit("bounce_walk", variant=name, first_s=first, steady_s=steady)
    emit("bounce_walk_agree", tri_equal=float(np.mean(
        np.asarray(results["plain"].tri) == np.asarray(results["sorted"].tri))))


SECTIONS = {"rates": rates, "lanes": lanes, "glass": glass, "chunk": chunk,
            "raysort": raysort}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=list(SECTIONS),
                    default=list(SECTIONS))
    ap.add_argument("--out", help="also append each JSON line to this file")
    args = ap.parse_args(argv)

    from light_transport_tpu.core.cache import enable_compile_cache

    enable_compile_cache()

    import jax

    from light_transport_tpu.utils.profiling import gpu_name_and_power_limit

    if jax.devices()[0].platform != "gpu":
        print("measure_floors.py measures a GPU; JAX found "
              f"{jax.devices()[0].platform}", file=sys.stderr)
        return 1
    card = gpu_name_and_power_limit()
    print(card, flush=True)

    def emit(name, **fields):
        line = json.dumps({"name": name, "card": card, **fields})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for section in args.only:
        SECTIONS[section](jax, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
