"""Vector math over SoA ``(..., 3)`` arrays.

Array replacement for the reference's per-vector helpers
(`src/vectors.py:5-26`, `src/utils.py:71-80` in the reference tree): every op
is batched over leading dims so the whole photon/ray population is processed
by one vectorized call instead of a Python loop.
"""

from __future__ import annotations

import jax.numpy as jnp

# Ray-offset epsilon.  Deliberately 100x the reference's EPSILON = 1e-6
# (src/constants.py:12): the reference runs float64, we default to float32,
# where 1e-6 offsets re-intersect the spawning surface
# ("shadow acne").
EPSILON = 1e-4

INV_PI = 1.0 / jnp.pi
INV_2PI = 0.5 / jnp.pi
INV_4PI = 0.25 / jnp.pi
PI_OVER_2 = jnp.pi / 2
PI_OVER_4 = jnp.pi / 4


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis: ``(...,3),(...,3)->(...)``."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3D cross product (explicit components; avoids jnp.cross's
    generality and keeps XLA fusion simple)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def norm(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(v, v), 0.0))


def normalize(v: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Safe normalize; zero vectors map to zero instead of NaN (the masked
    lanes of a terminated path carry junk data that must not poison XLA)."""
    n2 = jnp.maximum(dot(v, v), eps)
    return v * jnp.expand_dims(jnp.sqrt(1.0 / n2), -1)


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of direction ``d`` about normal ``n``.

    Physics contract: reference ``get_reflected_direction`` (src/brdf.py:7-9).
    """
    return normalize(d - 2.0 * jnp.expand_dims(dot(d, n), -1) * n)


def refract(d: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray):
    """Snell refraction. ``n`` must face the incoming side (dot(d,n) <= 0);
    ``eta = n_incident / n_transmit``.

    Returns ``(t, total_internal_reflection_mask)``. Physics contract:
    reference transmit branch (src/path_tracing.py:125-136).
    """
    cos_i = -dot(d, n)
    k = 1.0 - eta**2 * (1.0 - cos_i**2)
    tir = k <= 0.0
    # double-where sqrt guard: sqrt'(0) = inf at the TIR boundary, and the
    # masked-lane cotangent then arrives as inf * 0 = NaN, poisoning the
    # CV score gradients two bounces downstream (grad_log_pdf_exact).
    # Values are bitwise unchanged (TIR lanes still see sqrt-of-0 = 0).
    pos = k > 0.0
    root = jnp.where(pos, jnp.sqrt(jnp.where(pos, k, 1.0)), 0.0)
    t = d * jnp.expand_dims(eta, -1) + n * jnp.expand_dims(
        eta * cos_i - root, -1
    )
    return normalize(t), tir


def orthonormal_frame(n: jnp.ndarray):
    """Branchless orthonormal basis ``(t, b)`` perpendicular to unit ``n``.

    Replaces the reference's branching ``create_orthonormal_system``
    (src/utils.py:71-80) with the Duff et al. branchless construction —
    a ``where`` select instead of data-dependent control flow, so it
    vectorizes across the whole lane population.
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = jnp.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], axis=-1)
    bvec = jnp.stack([b, sign + ny * ny * a, -ny], axis=-1)
    return t, bvec


def to_world(local: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Rotate local-frame direction (z along ``n``) into world space."""
    t, b = orthonormal_frame(n)
    return (
        local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n
    )


def luminance(rgb: jnp.ndarray) -> jnp.ndarray:
    """Rec.709 luma; used for Russian-roulette survival weighting."""
    w = jnp.asarray([0.2126, 0.7152, 0.0722], dtype=rgb.dtype)
    return dot(rgb, w)
