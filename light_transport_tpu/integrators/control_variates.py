"""Control-variates variance reduction — the reference's research flagship.

Pipeline contract (reference): the CV-instrumented tracer records each
bounce's BSDF-sampling log-pdf (src/path_tracing.py:94-96), perturbs the
*logit* of every input uniform by ±0.01 and re-traces to get finite-
difference gradients (``calculate_gradients``, src/path_tracing.py:203-249),
then per pixel solves the zero-variance linear correction
``alpha = -Sigma_cs^T pinv(Sigma_cc)``, ``corrected = samples + alpha @
control`` with ``control = -0.5 * grad_log_pdf`` (LTS.ipynb cell 32,
including its singular-covariance fallback).

Upgrades (all deliberate, documented):

- **exact mode** (default): because a path is a pure function of its uniform
  tensor, the per-bounce log-pdf gradients are one ``jax.grad`` of the
  summed records w.r.t. the logit-uniforms — machine-precision score
  values at ~1 extra backward pass, replacing the reference's 4*max_depth
  full re-traces per sample;
- **fd mode**: the reference's central-difference scheme, vectorized over
  the 2*max_depth perturbation slots with vmap (provided for parity runs);
- the per-pixel covariance solve is a batched ``vmap`` of small (C x C)
  pinv problems instead of a Python double loop.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from light_transport_tpu.core import rng
from light_transport_tpu.core.config import RenderConfig
from light_transport_tpu.integrators.path_tracer import (
    camera_rays,
    trace_paths,
)
from light_transport_tpu.scene.scene import Scene

FD_STEP = 0.01  # reference logit perturbation (src/path_tracing.py:210,230)


class CVRender(NamedTuple):
    image_plain: jnp.ndarray  # (H, W, 3) plain MC mean  ("image_ver1")
    image_cv: jnp.ndarray  # (H, W, 3) CV-corrected     ("image_ver2")
    samples: jnp.ndarray  # (H, W, spp, 3) raw radiance samples
    grad_log_pdf: jnp.ndarray  # (H, W, spp, 2*max_depth) score values
    log_pdf: jnp.ndarray  # (H, W, spp, max_depth)
    singular: jnp.ndarray  # (H, W) bool: pixels where the solve was skipped


def _with_bsdf_logits(uniforms: jnp.ndarray, x_logit: jnp.ndarray,
                      exact_primal: bool = False):
    """Rebuild the uniform tensor with BSDF slots taken from logits.

    ``exact_primal``: only valid when ``x_logit == logit(u_bsdf)`` (the
    exact-gradient base point, NOT an FD-perturbed one) — substitutes
    ``u + (sigmoid(x) - stop_grad(sigmoid(x)))``, whose primal is the raw
    uniform bitwise while the tangent still flows through the sigmoid.
    Keeps the graded forward trace's radiance bit-identical to a plain
    ``trace_paths(uniforms)`` without paying a second forward pass."""
    u_bsdf = rng.sigmoid(x_logit)  # (N, D, 2)
    if exact_primal:
        raw = jnp.stack(
            [uniforms[:, :, rng.U_BSDF0], uniforms[:, :, rng.U_BSDF1]],
            axis=-1,
        )
        u_bsdf = raw + (u_bsdf - jax.lax.stop_gradient(u_bsdf))
    return uniforms.at[:, :, rng.U_BSDF0].set(u_bsdf[:, :, 0]).at[
        :, :, rng.U_BSDF1
    ].set(u_bsdf[:, :, 1])


def grad_log_pdf_exact(scene: Scene, cfg: RenderConfig, origins, directions,
                       uniforms):
    """d(sum_b log pdf_b)/d(logit u) for every lane: one backward pass.

    Returns ``(radiance, log_pdf (N, D), grad (N, 2D))`` with the gradient
    layout matching the reference's ``record_s_set`` ordering — first the
    max_depth u0 slots, then the max_depth u1 slots
    (src/path_tracing.py:209-247).
    """
    x0 = rng.logit(
        jnp.stack(
            [uniforms[:, :, rng.U_BSDF0], uniforms[:, :, rng.U_BSDF1]],
            axis=-1,
        )
    )  # (N, D, 2)

    def total_logpdf(x):
        # exact_primal: the forward values are the raw uniforms bitwise
        # (gradients still flow through the logit parametrization), so the
        # aux radiance below equals trace_paths(uniforms) exactly
        u = _with_bsdf_logits(uniforms, x, exact_primal=True)
        radiance, rec = trace_paths(scene, cfg, origins, directions, u)
        return rec.log_pdf.sum(), (radiance, rec)

    # radiance rides along as aux — the graded forward pass already
    # computes it, so a separate trace at the raw uniforms would double
    # the forward cost for nothing
    (_, (radiance, rec)), grads = jax.value_and_grad(
        total_logpdf, has_aux=True)(x0)
    g = jnp.concatenate([grads[:, :, 0], grads[:, :, 1]], axis=-1)  # (N, 2D)
    return radiance, rec.log_pdf, g


def grad_log_pdf_fd(scene: Scene, cfg: RenderConfig, origins, directions,
                    uniforms, step: float = FD_STEP):
    """The reference's central-difference gradients, vectorized.

    For each of the 2*max_depth logit slots, re-trace with the slot shifted
    by ±step and difference the summed log-pdf records — the vmapped form of
    ``calculate_gradients`` (src/path_tracing.py:203-249; the notebook sums
    the per-bounce records before differencing, LTS.ipynb cell 32).
    """
    d = cfg.max_depth
    x0 = rng.logit(
        jnp.stack(
            [uniforms[:, :, rng.U_BSDF0], uniforms[:, :, rng.U_BSDF1]],
            axis=-1,
        )
    )  # (N, D, 2)

    def logpdf_sum_with(x):
        u = _with_bsdf_logits(uniforms, x)
        _, rec = trace_paths(scene, cfg, origins, directions, u)
        return rec.log_pdf.sum(axis=-1)  # (N,)

    def perturb(slot, sign):
        b = slot % d
        k = slot // d  # 0 -> u0 block, 1 -> u1 block (reference layout)
        delta = jnp.zeros_like(x0).at[:, b, k].set(sign * step)
        return logpdf_sum_with(x0 + delta)

    slots = jnp.arange(2 * d)
    plus = jax.lax.map(lambda s: perturb(s, 1.0), slots)  # (2D, N)
    minus = jax.lax.map(lambda s: perturb(s, -1.0), slots)
    g = ((plus - minus) / (2.0 * step)).T  # (N, 2D)
    radiance, rec = trace_paths(scene, cfg, origins, directions, uniforms)
    return radiance, rec.log_pdf, g


def cv_correct(samples: jnp.ndarray, control: jnp.ndarray,
               eps: float = 1e-8):
    """Per-pixel zero-variance CV solve (LTS.ipynb cell 32).

    ``samples``: (P, S, 3); ``control``: (P, S, C).  Returns
    ``(corrected (P, S, 3), singular (P,))``; singular pixels fall back to
    the *uncorrected* samples (deviation from the notebook, which zeroes
    them and counts ``singular_cnt`` — zeroing a pixel is clearly a bug).
    """
    def per_pixel(s, c):
        sc = jnp.concatenate([s, c], axis=1)  # (S, 3+C)
        mean = sc.mean(axis=0, keepdims=True)
        x = sc - mean
        # float32 products run as TF32 on GPUs unless pinned (10-bit
        # mantissa); the covariance of near-collinear score controls then
        # loses the digits pinv needs, so every product here is HIGHEST
        mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
        cov = mm(x.T, x)  # notebook uses the uncentered-by-1/S form; scale
        # cancels inside alpha = -Sigma_cs^T pinv(Sigma_cc)
        sdim = s.shape[1]
        sigma_cs = cov[:sdim, sdim:].T  # (C, 3)
        sigma_cc = cov[sdim:, sdim:]  # (C, C)
        alpha = -mm(sigma_cs.T, jnp.linalg.pinv(sigma_cc))  # (3, C)
        zv = mm(alpha, c.T)  # (3, S)
        corrected = s + zv.T
        bad = ~jnp.all(jnp.isfinite(corrected))
        corrected = jnp.where(bad, s, corrected)
        return corrected, bad

    return jax.vmap(per_pixel)(samples, control)


class PixelDive(NamedTuple):
    """Deep-dive telemetry for hand-picked pixels (the reference's extra
    500-sample pass at 4 chosen pixels, src/path_tracing.py:310-364)."""

    samples: jnp.ndarray  # (P, S, 3) radiance samples
    log_pdf: jnp.ndarray  # (P, S, max_depth)
    grad_log_pdf: jnp.ndarray  # (P, S, 2*max_depth)
    corrected: jnp.ndarray  # (P, S, 3) CV-corrected samples
    pixel_plain: jnp.ndarray  # (P, 3) plain means
    pixel_cv: jnp.ndarray  # (P, 3) CV-corrected means


def _cv_lane_uniforms(scene: Scene, cfg: RenderConfig, key: jax.Array,
                      n: int):
    """The CV renderers' lane random inputs: AA jitter, path uniforms, and
    (when ``cfg.aperture > 0``) thin-lens aperture points.

    CV deliberately stays on iid threefry draws — its per-pixel covariance
    solve assumes independent samples, which Owen-scrambled QMC points are
    not (the CLI rejects ``--sampler sobol`` with the cv integrator).  The 2-way
    key split is kept for ``aperture == 0`` so pinhole CV runs are bitwise
    unchanged; lens uniforms are NOT part of the differentiated/perturbed
    slot set (they parametrize the primary ray like the AA jitter, which
    the reference's gradient scheme also leaves alone,
    src/path_tracing.py:203-249)."""
    if cfg.aperture > 0.0:
        k_aa, k_u, k_lens = jax.random.split(key, 3)
        u_lens = jax.random.uniform(k_lens, (n, 2), dtype=scene.camera.dtype)
    else:
        k_aa, k_u = jax.random.split(key)
        u_lens = None
    u_aa = jax.random.uniform(k_aa, (n, 2), dtype=scene.camera.dtype)
    uniforms = rng.path_uniforms(k_u, n, cfg.max_depth,
                                 dtype=scene.camera.dtype)
    return u_aa, uniforms, u_lens


def cv_pixel_dive(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    pixels,  # sequence of (row, col) pixel coordinates
    n_samples: int = 500,
    mode: str = "exact",
) -> PixelDive:
    """Draw ``n_samples`` fresh paths through each selected pixel with full
    CV telemetry — the reference's "choose some pixels and draw more
    samples" pass, vectorized over (pixels x samples) lanes."""
    import numpy as np

    from light_transport_tpu.integrators.path_tracer import (
        _pixel_camera_rays)

    pix = np.asarray(pixels, np.int32).reshape(-1, 2)
    p = pix.shape[0]
    n = p * n_samples
    pixel_ids = jnp.asarray(
        np.repeat(pix[:, 0] * cfg.width + pix[:, 1], n_samples), jnp.int32)

    u_aa, uniforms, u_lens = _cv_lane_uniforms(scene, cfg, key, n)
    origins, directions = _pixel_camera_rays(scene, cfg, pixel_ids, u_aa,
                                             u_lens)
    grad_fn = grad_log_pdf_exact if mode == "exact" else grad_log_pdf_fd
    radiance, log_pdf, g = grad_fn(scene, cfg, origins, directions, uniforms)

    samples = radiance.reshape(p, n_samples, 3)
    control = -0.5 * g.reshape(p, n_samples, -1)
    corrected, _ = cv_correct(samples, control)
    return PixelDive(
        samples=samples,
        log_pdf=log_pdf.reshape(p, n_samples, -1),
        grad_log_pdf=g.reshape(p, n_samples, -1),
        corrected=corrected,
        pixel_plain=samples.mean(axis=1),
        pixel_cv=corrected.mean(axis=1),
    )


from functools import partial


@partial(jax.jit, static_argnums=(1, 3))
def render_cv(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    mode: str = "exact",
) -> CVRender:
    """Full CV render: plain image + CV-corrected image + telemetry.

    Mirrors the reference's flagship ``render_scene`` outputs image_ver1 /
    image_ver2 (src/path_tracing.py:371-387 + LTS.ipynb cell 32).
    """
    n = cfg.height * cfg.width * cfg.spp
    u_aa, uniforms, u_lens = _cv_lane_uniforms(scene, cfg, key, n)
    origins, directions = camera_rays(scene, cfg, u_aa, u_lens)

    if mode == "exact":
        radiance, log_pdf, g = grad_log_pdf_exact(
            scene, cfg, origins, directions, uniforms
        )
    elif mode == "fd":
        radiance, log_pdf, g = grad_log_pdf_fd(
            scene, cfg, origins, directions, uniforms
        )
    else:
        raise ValueError(f"unknown CV mode: {mode}")

    def to_pix(x):
        # lanes are spp-major: (spp, H, W, ...) -> (H*W, spp, ...)
        x = x.reshape((cfg.spp, cfg.height * cfg.width) + x.shape[1:])
        return jnp.moveaxis(x, 0, 1)

    samples = to_pix(radiance)  # (P, S, 3)
    control = -0.5 * to_pix(g)  # (P, S, 2D) — LTS.ipynb cell 32
    corrected, singular = cv_correct(samples, control)

    hw = (cfg.height, cfg.width)
    image_plain = jnp.clip(samples.mean(axis=1), 0, 1).reshape(hw + (3,))
    image_cv = jnp.clip(corrected.mean(axis=1), 0, 1).reshape(hw + (3,))
    return CVRender(
        image_plain=image_plain,
        image_cv=image_cv,
        samples=samples.reshape(hw + (cfg.spp, 3)),
        grad_log_pdf=to_pix(g).reshape(hw + (cfg.spp, 2 * cfg.max_depth)),
        log_pdf=to_pix(log_pdf).reshape(hw + (cfg.spp, cfg.max_depth)),
        singular=singular.reshape(hw),
    )
