#!/usr/bin/env python3
"""A/B the tail-compacted camera tracer on the fix1-scale workload
(300x300, depth 8, 50 spp, RR from bounce 5 — src/path_tracing_fix1.py
config, BASELINE.md row 8).  Prints steady seconds for the full-width and
compacted renders plus per-bounce occupancy."""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=300)
    ap.add_argument("--height", type=int, default=300)
    ap.add_argument("--spp", type=int, default=50)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import dataclasses

    import jax
    import numpy as np

    from light_transport_tpu.integrators import path_tracer as pt
    from light_transport_tpu.scene.cornell import cornell_box_scene

    scene, cfg = cornell_box_scene(width=args.width, height=args.height,
                                   spp=args.spp, max_depth=args.depth)
    cfg = dataclasses.replace(cfg, rr_start=5, emission_mode="always")
    key = jax.random.key(1)
    print(f"devices: {jax.devices()}", file=sys.stderr)
    import jax.numpy as jnp

    o, d, u = jax.jit(lambda k: pt._camera_lanes(scene, cfg, k))(key)
    jax.block_until_ready(o)

    full = jax.jit(lambda o, d, u: pt.trace_paths(scene, cfg, o, d, u)[0])

    def occupancy():
        _, rec = jax.jit(
            lambda o, d, u: pt.trace_paths(scene, cfg, o, d, u))(o, d, u)
        return np.asarray(rec.alive.mean(axis=0))

    def timed(fn, label):
        r = fn(o, d, u)
        jax.block_until_ready(r)  # compile
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            r = fn(o, d, u)
            s = float(jnp.asarray(r).sum())  # forcing fetch
            best = min(best, time.perf_counter() - t0)
        print(f"{label}: steady {best:.3f}s  (checksum {s:.4f})")
        return best, s

    occ = occupancy()
    print("per-bounce occupancy:", np.round(occ, 3).tolist())
    t_full, s_full = timed(lambda *a: full(*a), "full-width")
    t_comp, s_comp = timed(
        lambda o, d, u: pt.trace_paths_compact(scene, cfg, o, d, u),
        "compact-tail")
    print(f"speedup: {t_full / t_comp:.2f}x; checksum rel delta "
          f"{abs(s_full - s_comp) / abs(s_full):.2e}")


if __name__ == "__main__":
    main()
