"""Low-discrepancy sampling: padded 2-D Sobol' points with hash-based Owen
scrambling.

The reference pre-draws every random number of a render into plain-uniform
tensors on the Scene (``scene.rand_0/rand_1``, src/scene.py:68-71) and its
paths are pure functions of them; this module upgrades that contract — same
tensor shapes, same purity — to a quasi-Monte-Carlo point set, selected with
``RenderConfig(sampler="sobol")``.  Each consecutive 2-D slot pair (AA
jitter, BSDF, light surface, pick/RR, medium) is a base-2 (0,2)-sequence:
after ``spp`` samples every power-of-two stratification of the pair is
exactly equidistributed, so pixel variance falls roughly as O(1/n) on
smooth integrands instead of MC's O(1/sqrt(n)).

Construction (all public-domain algorithms):

- Sobol' dimensions 0/1 as 32-bit GF(2) generator matrices — dimension 0 is
  the bit-reversal (van der Corput) matrix, dimension 1 the Pascal matrix
  via the ``v ^= v >> 1`` column recurrence.
- Owen scrambling and sample-index shuffling via the Laine–Karras style
  hash permutation with Burley's avalanche constants (Burley, "Practical
  Hash-based Owen Scrambling", JCGT 9(4), 2020): a bitwise permutation in
  which every output bit depends only on equal-or-higher-significance input
  bits — a valid nested uniform (Owen) scramble, so the (0,2)-net
  stratification survives while pixels and slot pairs decorrelate.
- Padding: every (pixel, pair) gets its own shuffle and scramble seeds, so
  cross-pair projections behave like independent stratified draws (the
  padded-sampler construction used by production renderers).

Everything is int32/uint32 bit arithmetic on full lane tensors — branchless,
shape-static; no tables beyond two (32,) uint32 constants.

Notes: the generator "matrix-vector product" is 32 unrolled
select-XORs fused by XLA into the surrounding uniform-tensor build; there is
no per-sample host work and no dynamic shape anywhere.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from light_transport_tpu.core import rng as _rng

__all__ = [
    "sobol2d",
    "owen_scramble",
    "scrambled_pair",
    "lane_uniforms",
    "render_uniforms",
]

_U32 = jnp.uint32


def _c(x: int):
    return _U32(np.uint32(x))


# Sobol' generator-matrix columns, MSB-aligned 32-bit.
# dim 0: van der Corput — column k is the single bit 31-k.
_V0 = np.array([np.uint32(1) << np.uint32(31 - k) for k in range(32)],
               dtype=np.uint32)
# dim 1: Pascal matrix mod 2 via the classic column recurrence v ^= v >> 1
# (first columns 0x80000000, 0xC0000000, 0xA0000000, 0xF0000000, ...).
_V1 = np.empty(32, dtype=np.uint32)
_v = np.uint32(1) << np.uint32(31)
for _k in range(32):
    _V1[_k] = _v
    _v = _v ^ (_v >> np.uint32(1))
del _v, _k


def _gf2_matvec(idx: jnp.ndarray, cols: np.ndarray) -> jnp.ndarray:
    """y = M @ idx over GF(2): XOR of columns selected by idx's bits."""
    idx = idx.astype(_U32)
    y = jnp.zeros_like(idx)
    for k in range(32):
        bit = (idx >> _c(k)) & _c(1)
        # bit * col == where(bit, col, 0), kept as a multiply so XLA fuses
        y = y ^ (bit * _c(int(cols[k])))
    return y


def _reverse_bits(x: jnp.ndarray) -> jnp.ndarray:
    x = x.astype(_U32)
    x = ((x >> _c(1)) & _c(0x55555555)) | ((x & _c(0x55555555)) << _c(1))
    x = ((x >> _c(2)) & _c(0x33333333)) | ((x & _c(0x33333333)) << _c(2))
    x = ((x >> _c(4)) & _c(0x0F0F0F0F)) | ((x & _c(0x0F0F0F0F)) << _c(4))
    x = ((x >> _c(8)) & _c(0x00FF00FF)) | ((x & _c(0x00FF00FF)) << _c(8))
    return (x >> _c(16)) | (x << _c(16))


def _laine_karras(x: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """LSB-up hash permutation (Burley 2020 listing 3 constants): each bit
    is perturbed only by strictly lower bits, so conjugating with
    bit-reversal yields a nested uniform (Owen) scramble."""
    x = x.astype(_U32) + seed.astype(_U32)
    x = x ^ (x * _c(0x6C50B47C))
    x = x ^ (x * _c(0xB82F1E52))
    x = x ^ (x * _c(0xC7AFE638))
    x = x ^ (x * _c(0x8D22F6E6))
    return x


def owen_scramble(x: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """Nested uniform scramble of an MSB-first fraction (or, applied to a
    sample index, an aligned-block-preserving shuffle)."""
    return _reverse_bits(_laine_karras(_reverse_bits(x), seed))


def _mix(x: jnp.ndarray) -> jnp.ndarray:
    """32-bit finalizer (lowbias32-style avalanche)."""
    x = x.astype(_U32)
    x = x ^ (x >> _c(16))
    x = x * _c(0x7FEB352D)
    x = x ^ (x >> _c(15))
    x = x * _c(0x846CA68B)
    return x ^ (x >> _c(16))


def _hash(a, b, c, d) -> jnp.ndarray:
    """Seed-domain hash of (pixel, pair, seed, tag) -> uint32."""
    h = _mix(jnp.asarray(a, _U32) ^ _c(0x9E3779B9))
    h = _mix(h + jnp.asarray(b, _U32) * _c(0x9E3779B9))
    h = _mix(h + jnp.asarray(c, _U32) * _c(0x85EBCA6B))
    return _mix(h + jnp.asarray(d, _U32) * _c(0xC2B2AE35))


def sobol2d(idx: jnp.ndarray):
    """Raw (unscrambled) 32-bit Sobol' dims 0/1 at ``idx``: two uint32
    MSB-first fractions.  First points: (0,0), (.5,.5), (.25,.75),
    (.75,.25), (.125,.625), ..."""
    idx = jnp.asarray(idx, _U32)
    return _reverse_bits(idx), _gf2_matvec(idx, _V1)


def _to_unit(x: jnp.ndarray, dtype) -> jnp.ndarray:
    """Top-24-bit uint32 fraction -> float in [tiny, 1): open interval so
    the CV pipeline's logit transform stays finite (core/rng.path_uniforms
    keeps the same contract)."""
    # python-float scale: JAX weak typing keeps the array's dtype (a
    # np.dtype from scene.camera.dtype is not callable, so no dtype(...))
    f = (x >> _c(8)).astype(dtype) * (1.0 / (1 << 24))
    return jnp.maximum(f, jnp.finfo(dtype).tiny)


def scrambled_pair(pixel, sample, pair, seed, dtype=jnp.float32):
    """One padded Owen-scrambled Sobol' 2-D point per lane.

    ``pixel``/``sample`` are int arrays of any (broadcastable) shape;
    ``pair`` and ``seed`` are scalars (traced or static).  Every
    (pixel, pair) gets its own index shuffle and per-axis value scrambles,
    all derived from ``seed`` — deterministic, counter-based, O(1) state,
    matching the RNG discipline of core/rng.
    """
    shuffle = _hash(pixel, pair, seed, 0)
    sx = _hash(pixel, pair, seed, 1)
    sy = _hash(pixel, pair, seed, 2)
    # Owen shuffle of the sample index: maps the aligned block {0..spp-1}
    # (spp a power of two) to an aligned block elsewhere in the sequence,
    # which is again a (0,m,2)-net; non-power-of-two spp stays unbiased,
    # just less evenly stratified.
    idx = owen_scramble(jnp.asarray(sample, _U32), shuffle)
    x, y = sobol2d(idx)
    return (_to_unit(owen_scramble(x, sx), dtype),
            _to_unit(owen_scramble(y, sy), dtype))


def _scrambled_x(pixel, sample, pair, seed, dtype=jnp.float32):
    """Dimension-0-only variant of :func:`scrambled_pair` (same x values).

    Used for slot layouts that consume an odd number of uniforms from the
    last pair: generating the unused y would cost a full 32-step GF(2)
    matvec plus two Owen scrambles per lane per bounce, relying on XLA
    dead-code elimination to remove it — skip it explicitly instead.
    """
    shuffle = _hash(pixel, pair, seed, 0)
    sx = _hash(pixel, pair, seed, 1)
    idx = owen_scramble(jnp.asarray(sample, _U32), shuffle)
    x = _reverse_bits(idx)  # Sobol' dim 0 = van der Corput
    return _to_unit(owen_scramble(x, sx), dtype)


# slot-pair layout per bounce: (BSDF0,BSDF1), (LIGHT0,LIGHT1), (PICK,RR),
# (MED, spare).  The pairings put each 2-D physical decision (hemisphere
# direction, light-surface point) on one stratified 2-D projection.
_PAIRS_PER_BOUNCE = 4

# thin-lens aperture point: a dedicated pair id far above the per-bounce
# range (1 + 4*max_depth) so it never collides at any depth
LENS_PAIR = 1 << 16


def lane_uniforms(seed, pixel, sample, max_depth: int, dtype=jnp.float32):
    """Per-lane QMC random inputs for arbitrary (pixel, sample) pairs.

    The lane-level generalization of :func:`render_uniforms`: ``pixel``
    and ``sample`` are (N,) int arrays — any pixel may appear any number
    of times with any sample indices (the adaptive renderer allocates
    lanes to pixels non-uniformly and resumes each pixel's OWN sequence
    at its running sample count).  Returns ``(u_aa (N, 2),
    uniforms (N, max_depth, NUM_U))`` — point values depend only on
    (seed, pixel, sample), never on the allocation.
    """
    seed = jnp.asarray(seed, _U32)
    ax, ay = scrambled_pair(pixel, sample, 0, seed, dtype)
    u_aa = jnp.stack([ax, ay], axis=-1)
    # NUM_U = 7 slots per bounce out of 4 pairs: the 4th pair contributes
    # only its x (MED) — its y is a documented spare, so it is never
    # generated (don't lean on XLA to dead-code the GF(2) matvec +
    # scrambles behind the stack/reshape/slice chain)
    assert _rng.NUM_U == 2 * _PAIRS_PER_BOUNCE - 1
    slots = []
    for b in range(max_depth):
        for p in range(_PAIRS_PER_BOUNCE - 1):
            pair_id = 1 + b * _PAIRS_PER_BOUNCE + p
            x, y = scrambled_pair(pixel, sample, pair_id, seed, dtype)
            slots.extend([x, y])
        pair_id = 1 + b * _PAIRS_PER_BOUNCE + (_PAIRS_PER_BOUNCE - 1)
        slots.append(_scrambled_x(pixel, sample, pair_id, seed, dtype))
    u = jnp.stack(slots, axis=-1).reshape(
        pixel.shape[0], max_depth, _rng.NUM_U)
    return u_aa, u


def render_uniforms(seed, height: int, width: int, spp: int, max_depth: int,
                    dtype=jnp.float32, sample_offset=0):
    """The QMC drop-in for a render's random inputs.

    Returns ``(u_aa (N, 2), uniforms (N, max_depth, NUM_U))`` with the
    path tracer's s-major lane layout (lane = s*H*W + pixel,
    path_tracer._camera_lanes) — shapes and the open-(0,1) range identical
    to the threefry draws they replace, so tracing stays a pure function
    of the tensors and every estimator (CV gradients included) is
    unchanged.  ``seed``: uint32 scalar (traced ok).

    ``sample_offset`` (int, traced ok): this pass covers sample indices
    ``[offset, offset + spp)`` of the per-(pixel, pair) sequences, so
    progressive accumulation at the same seed continues ONE point set —
    averaging k offset passes of spp samples reproduces the single
    k*spp-spp render exactly (path_tracer.render_progressive uses this).
    """
    n_pix = height * width
    pixel = jnp.tile(jnp.arange(n_pix, dtype=jnp.int32), spp)
    sample = jnp.repeat(
        jnp.asarray(sample_offset, jnp.int32)
        + jnp.arange(spp, dtype=jnp.int32), n_pix)
    return lane_uniforms(seed, pixel, sample, max_depth, dtype)
