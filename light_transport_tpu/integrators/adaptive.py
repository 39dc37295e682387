"""Adaptive sampling: variance-driven per-pixel sample allocation.

The reference spends its sample budget uniformly — every pixel gets
``spp`` paths (render loop, src/path_tracing.py:263-287) no matter whether
it shows a flat wall or a glass caustic.  This renderer keeps the same
total budget (``cfg.spp`` samples/pixel on average) but re-allocates it
round by round toward the pixels whose estimates are still noisy,
minimizing image MSE for a fixed budget.  With ``sampler="uniform"`` the
two-stage argument makes every pixel mean exactly unbiased: each round's
allocation is a function of *previous* rounds' samples only, and the new
threefry draws are independent of that allocation.  With
``sampler="sobol"`` the argument does not strictly carry over — a pixel's
future Owen-scrambled points share the scramble realization with the
samples that drove its allocation, so the per-pixel sample count is
(weakly) correlated with the point values it goes on to consume.  The
estimator remains consistent (every pixel's QMC sequence converges to the
same integral regardless of where it is truncated) and the residual
correlation is practically negligible, but strict finite-``n``
unbiasedness is a uniform-sampler property only.

Static-shape discipline: every round traces the SAME static lane count
``B = H*W*spp / rounds``; the only thing that changes is a device-side
lane→pixel map built from the allocation by prefix sum + ``searchsorted``
(no ragged arrays, no host round-trip in the loop body, one compiled
executable reused by all rounds).  The allocation is integerized by
differencing a rounded cumulative target (largest-remainder style), so
each round's lanes sum to exactly ``B``.

Works with both samplers.  With ``cfg.sampler="sobol"`` every pixel owns
one QMC sequence and each round resumes it at the pixel's running sample
count (ops/qmc.lane_uniforms — point values are allocation-independent),
so adaptive re-allocation composes with the O(1/n) stratification.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from light_transport_tpu.core import rng
from light_transport_tpu.core.config import RenderConfig
from light_transport_tpu.scene.scene import Scene

# fraction of each adaptive round allocated uniformly: keeps exploring
# pixels whose variance estimate is still zero/low (a dark pixel that saw
# no light yet must keep receiving samples) and bounds the worst case at
# a constant factor of the uniform renderer
_EXPLORE = 0.25


def _integer_alloc(weights: jnp.ndarray, budget: int) -> jnp.ndarray:
    """Nonnegative int allocation summing exactly to ``budget``,
    proportional to ``weights`` (rounded-cumulative differencing)."""
    w = jnp.maximum(weights, 0.0)
    # all-zero weights spend the budget uniformly instead of dropping it
    w = jnp.where(jnp.sum(w) > 0, w, jnp.ones_like(w))
    c = jnp.cumsum(w)
    total = jnp.maximum(c[-1], 1e-30)
    targets = jnp.round(c / total * budget).astype(jnp.int32)
    return jnp.diff(targets, prepend=jnp.asarray(0, jnp.int32))


@partial(jax.jit, static_argnums=(1, 3, 6))
def _round(scene, cfg: RenderConfig, key, budget: int,
           stats, round_idx, ray_chunk):
    """One adaptive round: allocate ``budget`` lanes from the running
    stats, trace, scatter the results back.  ``stats`` =
    (sum_rgb (P,3), sum_l (P,), sum_l2 (P,), count (P,) int32)."""
    from light_transport_tpu.integrators.path_tracer import (
        _pixel_camera_rays, trace_paths)

    sum_rgb, sum_l, sum_l2, count = stats
    n_pix = count.shape[0]

    # per-pixel priority: the MARGINAL MSE gain of one more sample,
    # d(var/n)/dn ~ var/n^2 — greedy-equalizing it drives the optimal
    # n_p ∝ σ_p allocation (plain sem^2 = var/n over-concentrates at
    # n_p ∝ σ_p^2).  Variance is taken on DISPLAY-clipped luminance: the
    # image contract clips to [0,1], so an emitter pixel whose raw
    # radiance ~200 has huge raw variance but zero display variance —
    # unclipped stats sank the whole budget into light pixels (measured
    # 2.3x WORSE than uniform).  Round 0 (count==0) falls back to uniform
    # via the explore mix.  A one-sample pixel has no variance estimate:
    # its l2 - l*l is zero only where the backend rounds both products
    # alike, and a fused multiply-add leaves l*l's rounding error there,
    # which would then steer the whole allocation.
    n = count.astype(jnp.float32)
    safe_n = jnp.maximum(n, 1.0)
    var = jnp.maximum(sum_l2 / safe_n - (sum_l / safe_n) ** 2, 0.0)
    gain = jnp.where(count > 1, var / (safe_n * safe_n), 0.0)
    norm = jnp.maximum(jnp.sum(gain), 1e-30)
    w = _EXPLORE / n_pix + (1.0 - _EXPLORE) * gain / norm
    w = jnp.where(jnp.sum(gain) > 0, w, jnp.ones_like(w) / n_pix)
    alloc = _integer_alloc(w, budget)

    # lane -> pixel via the allocation's prefix sum; lane's rank within
    # its pixel continues that pixel's sample sequence at `count`
    cum = jnp.cumsum(alloc)
    lane = jnp.arange(budget, dtype=jnp.int32)
    pixel = jnp.searchsorted(cum, lane, side="right").astype(jnp.int32)
    start = cum[pixel] - alloc[pixel]  # exclusive prefix
    sample = count[pixel] + (lane - start)

    u_lens = None
    if cfg.sampler == "sobol":
        from light_transport_tpu.ops import qmc

        seed_bits = jax.random.bits(key, dtype=jnp.uint32)
        u_aa, uniforms = qmc.lane_uniforms(seed_bits, pixel, sample,
                                           cfg.max_depth,
                                           dtype=scene.camera.dtype)
        if cfg.aperture > 0.0:
            lx, ly = qmc.scrambled_pair(pixel, sample, qmc.LENS_PAIR,
                                        seed_bits,
                                        dtype=scene.camera.dtype)
            u_lens = jnp.stack([lx, ly], axis=-1)
    else:
        k_r = jax.random.fold_in(key, round_idx)
        k_aa, k_u, k_lens = jax.random.split(k_r, 3)
        u_aa = jax.random.uniform(k_aa, (budget, 2),
                                  dtype=scene.camera.dtype)
        uniforms = rng.path_uniforms(k_u, budget, cfg.max_depth,
                                     dtype=scene.camera.dtype)
        if cfg.aperture > 0.0:
            u_lens = jax.random.uniform(k_lens, (budget, 2),
                                        dtype=scene.camera.dtype)

    origins, directions = _pixel_camera_rays(scene, cfg, pixel, u_aa,
                                             u_lens)
    radiance, _ = trace_paths(scene, cfg, origins, directions, uniforms,
                              ray_chunk=ray_chunk)
    # display-clipped luminance for the variance stats only — the pixel
    # ESTIMATE (sum_rgb) stays the raw unbiased radiance
    lum = (0.2126 * radiance[:, 0] + 0.7152 * radiance[:, 1]
           + 0.0722 * radiance[:, 2])
    lum = jnp.minimum(lum, 1.0)
    sum_rgb = sum_rgb.at[pixel].add(radiance)
    sum_l = sum_l.at[pixel].add(lum)
    sum_l2 = sum_l2.at[pixel].add(lum * lum)
    count = count.at[pixel].add(1)
    return (sum_rgb, sum_l, sum_l2, count), alloc


def render_adaptive(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    rounds: int = 4,
    ray_chunk: Optional[int] = None,
    return_counts: bool = False,
):
    """Render with the reference's total budget (``H*W*spp`` paths) spent
    adaptively over ``rounds`` variance-driven rounds.

    Returns the ``(H, W, 3)`` image clipped to [0, 1] (same contract as
    ``render_image``; reference clip at src/path_tracing.py:305), plus the
    per-pixel sample-count map when ``return_counts``.  ``cfg.spp`` must
    be divisible by ``rounds`` (keeps the per-round lane count static and
    the budget exact).
    """
    if cfg.spp % rounds != 0:
        raise ValueError(
            f"cfg.spp ({cfg.spp}) must be divisible by rounds ({rounds})")
    n_pix = cfg.height * cfg.width
    budget = n_pix * (cfg.spp // rounds)
    dtype = scene.camera.dtype
    stats = (
        jnp.zeros((n_pix, 3), dtype),
        jnp.zeros((n_pix,), dtype),
        jnp.zeros((n_pix,), dtype),
        jnp.zeros((n_pix,), jnp.int32),
    )
    for r in range(rounds):
        stats, _ = _round(scene, cfg, key, budget, stats,
                          jnp.asarray(r, jnp.int32), ray_chunk)
    sum_rgb, _, _, count = stats
    img = sum_rgb / jnp.maximum(count, 1).astype(dtype)[:, None]
    image = jnp.clip(img, 0.0, 1.0).reshape(cfg.height, cfg.width, 3)
    if return_counts:
        return image, count.reshape(cfg.height, cfg.width)
    return image
