#!/usr/bin/env python3
"""Benchmark: photon scatter steps/sec/chip (the BASELINE.json metric).

Times the photon engine (``transport/photon.simulate_photons``, the XLA
superstep engine behind ``api.simulate``) on an anisotropic HG medium with a
mismatched index, at steady state on the attached GPU, and prints ONE JSON
line:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

``value`` is lane events (scatter steps) per second over all steady trials
(their total steps over their total seconds); the best and the median trial
are reported beside it, and the compile-inclusive first run apart as
``first_run_s``.  Every run must launch exactly ``--photons`` photons, or the
script fails without a record.  The record names the device and the card's
power limit.

Baseline: the reference CPU sustains ~1e5 bounce-steps/s (SURVEY.md §6 —
4.5M paths in 149 s with ~2 BVH traversals per bounce; BASELINE.md derived
anchor), so vs_baseline = value / 1e5.

There is no CPU fallback: the script exits non-zero unless JAX finds a GPU.

    python3 bench.py [--photons N] [--repeats R]
"""

import argparse
import json
import statistics
import sys
import time

BASELINE_STEPS_PER_SEC = 1e5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--photons", type=int, default=10_000_000)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    from light_transport_tpu.core.cache import enable_compile_cache

    enable_compile_cache()

    import jax

    from light_transport_tpu.api import simulate
    from light_transport_tpu.core.config import MediumConfig, PhotonRunConfig
    from light_transport_tpu.scene.medium import LayeredMedium
    from light_transport_tpu.utils.profiling import gpu_name_and_power_limit

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    card = gpu_name_and_power_limit()

    medium = LayeredMedium.build(
        [MediumConfig(mu_a=1.0, mu_s=9.0, g=0.9, n=1.37)], n_above=1.0)
    cfg = PhotonRunConfig(n_photons=args.photons, nr=64, nz=64,
                          dr=0.01, dz=0.01)

    def run(seed):
        t0 = time.perf_counter()
        tallies = simulate(medium, cfg, seed=seed)
        jax.block_until_ready(tallies)
        dt = time.perf_counter() - t0
        if tallies.n_launched != args.photons:
            raise RuntimeError(f"launched {tallies.n_launched} photons of "
                               f"{args.photons}")
        return tallies, dt

    _, first_run_s = run(0)
    steps, seconds = [], []
    for i in range(args.repeats):
        tallies, dt = run(i + 1)
        steps.append(tallies.n_steps)
        seconds.append(dt)
    rates = [n / dt for n, dt in zip(steps, seconds)]
    value = sum(steps) / sum(seconds)
    print(json.dumps({
        "metric": "photon_scatter_steps_per_sec_per_chip",
        "value": value,
        "unit": "steps/s/chip",
        "vs_baseline": value / BASELINE_STEPS_PER_SEC,
        "engine": "xla_superstep",
        "photons": args.photons,
        "best_steps_per_sec": max(rates),
        "median_steps_per_sec": statistics.median(rates),
        "first_run_s": first_run_s,
        "trials_steps": steps,
        "trials_s": seconds,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
