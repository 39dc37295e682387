"""Frozen dataclasses registered as JAX pytrees.

``@dataclass`` turns a class into a frozen dataclass whose fields are pytree
children, except fields declared with ``field(static=True)``: those are
hashable metadata that become part of a jit cache key.  Every such class
gains ``.replace(**changes)``, a copy with some fields swapped.
"""

from __future__ import annotations

import dataclasses

import jax


def field(static: bool = False, **kwargs):
    """A dataclass field; ``static=True`` keeps it out of the pytree leaves."""
    return dataclasses.field(metadata={"static": static}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Make ``cls`` a frozen dataclass and register it as a pytree node."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls)
