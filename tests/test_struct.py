"""Frozen pytree dataclasses (core/struct.py) behind every device table."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from light_transport_tpu.core import struct
from light_transport_tpu.core.config import MediumConfig, PhotonRunConfig
from light_transport_tpu.scene.analytic import AnalyticPrims
from light_transport_tpu.scene.cornell import cornell_box_scene
from light_transport_tpu.scene.lights import PointLightTable
from light_transport_tpu.scene.medium import LayeredMedium
from light_transport_tpu.tally.tallies import PhotonTallies


def _scene():
    scene, _ = cornell_box_scene(width=4, height=4, spp=1, max_depth=1)
    return scene


def _instances():
    scene = _scene()
    bvh_scene = scene.with_bvh()
    return {
        "TriangleMesh": scene.mesh,
        "MaterialTable": scene.materials,
        "LightTable": scene.lights,
        "PointLightTable": PointLightTable.build([[0.0, 1.0, 0.0]],
                                                 [[1.0, 1.0, 1.0]]),
        "AnalyticPrims": AnalyticPrims.build(
            spheres=[((0.0, 0.0, 0.0), 1.0, 0)]),
        "LayeredMedium": LayeredMedium.build([MediumConfig()]),
        "PhotonTallies": PhotonTallies.zeros(PhotonRunConfig(nr=4, nz=4)),
        "BVH": bvh_scene.bvh,
        "Scene": bvh_scene,
    }


NAMES = ["TriangleMesh", "MaterialTable", "LightTable", "PointLightTable",
         "AnalyticPrims", "LayeredMedium", "PhotonTallies", "BVH", "Scene"]


@pytest.fixture(scope="module")
def instances():
    return _instances()


@pytest.mark.parametrize("name", NAMES)
def test_pytree_round_trip(instances, name):
    obj = instances[name]
    assert type(obj).__name__ == name
    leaves, treedef = jax.tree.flatten(obj)
    assert leaves and all(isinstance(x, jax.Array) for x in leaves)
    back = jax.tree.unflatten(treedef, leaves)
    assert type(back) is type(obj)
    for f in dataclasses.fields(obj):
        a, b = getattr(obj, f.name), getattr(back, f.name)
        if f.metadata.get("static"):
            assert a == b
        else:
            for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                assert x is y
    # a jitted identity returns an equal structure
    out = jax.jit(lambda t: t)(obj)
    assert jax.tree.structure(out) == treedef


@pytest.mark.parametrize("name", NAMES)
def test_replace_and_frozen(instances, name):
    obj = instances[name]
    first = dataclasses.fields(obj)[0].name
    new_val = jax.tree.map(lambda x: x + 1 if x.dtype != bool else ~x,
                           getattr(obj, first))
    rep = obj.replace(**{first: new_val})
    assert type(rep) is type(obj)
    assert getattr(rep, first) is new_val
    assert getattr(obj, first) is not new_val  # the original is untouched
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, first, new_val)


@pytest.mark.parametrize("name,field,other", [("Scene", "watertight", True),
                                              ("BVH", "max_leaf", 8)])
def test_static_field_is_hashed_into_jit(instances, name, field, other):
    """A static field is part of the jit cache key (retrace on change), and
    is not a leaf."""
    obj = instances[name]
    traces = []

    @jax.jit
    def f(t):
        traces.append(getattr(t, field))
        return jax.tree.leaves(t)[0]

    f(obj)
    f(obj)
    f(obj.replace(**{field: other}))
    assert traces == [getattr(obj, field), other]
    assert all(not isinstance(x, (bool, int))
               for x in jax.tree.leaves(obj))


def test_helper_marks_static_fields():
    @struct.dataclass
    class Pair:
        a: jnp.ndarray
        tag: str = struct.field(static=True, default="x")

    p = Pair(a=jnp.ones(2))
    assert len(jax.tree.leaves(p)) == 1
    assert jax.tree.structure(p) != jax.tree.structure(p.replace(tag="y"))
    np.testing.assert_array_equal(np.asarray(p.replace(a=jnp.zeros(2)).a),
                                  np.zeros(2))
