"""Per-lane static-depth stacks for lockstep deferred-branch traversal.

Array replacement for the reference's Python recursion stacks
(``render.trace_ray`` src/render.py:121-153 and ``render_old``'s
reflect/refract recursion, src/render_old.py:118-162): every lane keeps a
fixed-capacity stack in SoA arrays, and push/pop are one-hot masked
selects — no dynamic shapes, no data-dependent control flow.  Used by
``integrators.whitted.trace_whitted_queue`` (scalar-weight payload) and
``integrators.path_tracer.trace_paths_split`` (rgb-throughput payload);
the payload is an arbitrary pytree of ``(N, ...)`` leaves.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def zeros(payload_example, size: int):
    """Stacks of ``size`` slots shaped after a payload pytree example."""
    return jax.tree.map(
        lambda p: jnp.zeros((p.shape[0], size) + p.shape[1:], p.dtype),
        payload_example,
    )


def _expand(onehot, leaf_ndim: int):
    return onehot.reshape(onehot.shape + (1,) * (leaf_ndim - 2))


def push(stack, top, lane_mask, payload, size: int):
    """Masked push: lanes in ``lane_mask`` write ``payload`` at their
    ``top`` slot and advance; the rest are untouched.  Callers gate
    ``lane_mask`` on ``top < size`` themselves (their overflow policies
    differ: the split tracer falls back to one-branch sampling, the
    whitted queue sizes the stack to make overflow impossible)."""
    idx = jnp.clip(top, 0, size - 1)
    onehot = (jnp.arange(size)[None, :] == idx[:, None]) & lane_mask[:, None]
    new = jax.tree.map(
        lambda s, p: jnp.where(_expand(onehot, s.ndim), p[:, None], s),
        stack, payload)
    return new, top + lane_mask.astype(jnp.int32)


def peek(stack, top, size: int):
    """Payload at the top slot.

    Lanes with an empty stack read slot 0 — which holds whatever was last
    pushed there (pop only decrements ``top``) — so callers MUST mask the
    result with their own ``can_pop = top > 0`` before use, and decrement
    ``top`` themselves.  The one-hot select keeps every leaf's dtype
    (bool included)."""
    pidx = jnp.clip(top - 1, 0, size - 1)
    onehot = jnp.arange(size)[None, :] == pidx[:, None]

    def take(s):
        # dtype-preserving one-hot extraction: where+sum promotes bools to
        # int32, silently breaking bool payload leaves downstream
        sel = jnp.where(_expand(onehot, s.ndim), s, jnp.zeros_like(s))
        out = jnp.max(sel, axis=1) if s.dtype == jnp.bool_ \
            else jnp.sum(sel, axis=1)
        return out.astype(s.dtype)

    return jax.tree.map(take, stack)
