"""Exact-counter and 3-D fluence-volume tally tests.

The round-1 f32 counters rounded above 2^24 events (the full-scale artifact
recorded 99,999,952 of 1e8 launches); the two-word counters must be exact at
any scale, and the cartesian volume (BASELINE config 5)
must close energy with the exact scalar accumulator and be shard-invariant.
"""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from light_transport_tpu.core.config import MediumConfig, PhotonRunConfig
from light_transport_tpu.scene.medium import LayeredMedium
from light_transport_tpu.tally.tallies import (
    counter_add,
    counter_from_sum,
    counter_merge,
    counter_value,
    counter_zero,
)


def test_counter_exact_beyond_f32_range():
    # 1e8 via ragged odd increments: a plain f32 accumulator would round
    # (1e8 > 2^24); the two-word counter must stay exact
    incs = [48_271, 16_807, 1_048_575, 7, 999_983] * 40
    total = sum(incs)
    assert total > 2**26

    def body(c, i):
        return counter_add(c, jnp.float32(i)), None

    c, _ = jax.lax.scan(body, counter_zero(),
                        jnp.asarray(incs, jnp.float32))
    assert counter_value(c) == total
    # and the naive f32 sum demonstrably is NOT exact at this scale
    naive = jnp.float32(0.0)
    for i in incs:
        naive = naive + jnp.float32(i)
    assert float(naive) != total


def test_counter_from_sum_exact():
    # per-tile partials up to 2^24 whose direct f32 sum rounds
    vals = np.asarray([2**24 - 1, 2**23 + 3, 12_345_679, 1, 9_999_991] * 25,
                      np.float64)
    c = counter_from_sum(jnp.asarray(vals, jnp.float32))
    assert counter_value(c) == vals.sum()


def test_counter_merge():
    a = counter_add(counter_zero(), jnp.float32(2**23 + 111))
    b = counter_add(counter_zero(), jnp.float32(2**22 + 7))
    assert counter_value(counter_merge(a, b)) == (2**23 + 111) + (2**22 + 7)


def test_simulate_exact_launch_count():
    from light_transport_tpu.transport.photon import simulate_photons

    m = LayeredMedium.build([MediumConfig(mu_a=5.0, mu_s=5.0, g=0.0, n=1.0)])
    cfg = PhotonRunConfig(n_photons=30_011, nr=8, nz=8)  # prime-ish count
    res = simulate_photons(m, cfg, jax.random.key(0), lanes=4096)
    assert res.n_launched == 30_011
    assert res.n_steps > 0


def test_volume_tally_closes_energy():
    """3-D volume deposits equal the exact absorbed scalar (deposits clip
    into edge cells, so no weight escapes the grid)."""
    from light_transport_tpu.transport.photon import simulate_photons

    m = LayeredMedium.build([MediumConfig(mu_a=2.0, mu_s=8.0, g=0.5, n=1.0)])
    cfg = PhotonRunConfig(n_photons=20_000, nr=16, nz=16, dr=0.05, dz=0.05,
                          vol_nx=24, vol_ny=24, vol_nz=16,
                          vol_dx=0.05, vol_dy=0.05, vol_dz=0.05)
    res = simulate_photons(m, cfg, jax.random.key(1), lanes=4096)
    vol_sum = float(res.absorb_xyz.sum())
    assert abs(vol_sum - res.absorbed_weight) / res.absorbed_weight < 1e-3
    # the volume is beam-centered: the central column should dominate edges
    v = np.asarray(res.absorb_xyz)
    assert v[12, 12, :].sum() > 10 * v[0, 0, :].sum()
    # and it should integrate to the same depth profile as the (r,z) grid
    # (same dz bins; x/y clipping vs r-overflow bins differ only at edges)
    prof_xyz = v.sum(axis=(0, 1))
    prof_rz = np.asarray(res.absorb_rz).sum(axis=0)
    np.testing.assert_allclose(prof_xyz / prof_xyz.sum(),
                               prof_rz / prof_rz.sum(), atol=0.02)


@pytest.mark.slow
def test_volume_tally_shard_invariant():
    """Same config on 2 vs 8 shards: psum'd volumes agree statistically and
    energy closes on both."""
    from light_transport_tpu.parallel.mesh import make_mesh, simulate_sharded

    m = LayeredMedium.build([MediumConfig(mu_a=2.0, mu_s=8.0, g=0.5, n=1.0)])
    cfg = PhotonRunConfig(n_photons=16_000, nr=8, nz=8, dr=0.1, dz=0.1,
                          vol_nx=8, vol_ny=8, vol_nz=8,
                          vol_dx=0.1, vol_dy=0.1, vol_dz=0.1)
    r2 = simulate_sharded(m, cfg, jax.random.key(2), mesh=make_mesh(2),
                          lanes_per_device=1024)
    r8 = simulate_sharded(m, cfg, jax.random.key(2), mesh=make_mesh(8),
                          lanes_per_device=1024)
    assert r2.n_launched == 16_000
    assert r8.n_launched == 16_000
    for r in (r2, r8):
        vol_sum = float(r.absorb_xyz.sum())
        assert abs(vol_sum - r.absorbed_weight) / r.absorbed_weight < 1e-3
    v2 = np.asarray(r2.absorb_xyz) / 16_000
    v8 = np.asarray(r8.absorb_xyz) / 16_000
    # different RNG partitioning -> statistical agreement per cell
    assert np.abs(v2 - v8).max() < 0.01
    assert abs(v2.sum() - v8.sum()) < 3e-3


def test_counter_from_sum_many_partials_exact():
    """advisor r3: with >= 256 partials the old f32 lo-word sum exceeded
    2^24 and rounded; the int32 word sums stay exact."""
    import numpy as np

    from light_transport_tpu.tally.tallies import (
        counter_from_sum, counter_value)

    rng = np.random.default_rng(0)
    vals = rng.integers(0, 2 ** 24, size=1024).astype(np.float32)
    got = counter_value(counter_from_sum(jnp.asarray(vals)))
    want = float(np.sum(vals.astype(np.int64)))
    assert got == want, (got, want)


def test_wsum_add_keeps_what_plain_f32_swamps():
    """A total of 2^24 takes 10^4 increments of 0.75: a plain f32 running
    sum drops every one (ulp 2), the compensated sum keeps them all."""
    from light_transport_tpu.tally.tallies import wsum_add, wsum_value

    def body(carry, _):
        plain, comp = carry
        return (plain + jnp.float32(0.75),
                wsum_add(comp, jnp.float32(0.75))), None

    start = jnp.float32(2.0 ** 24)
    (plain, comp), _ = jax.lax.scan(
        jax.jit(body), (start, jnp.stack([start, jnp.float32(0.0)])), None,
        length=10_000)
    assert float(plain) == 2.0 ** 24  # swamped
    assert wsum_value(comp) == 2.0 ** 24 + 7_500.0


def test_tally_merge_adds_compensated_sums():
    from light_transport_tpu.tally.tallies import PhotonTallies

    z = PhotonTallies.zeros(PhotonRunConfig(n_photons=1, nr=4, nz=4))
    a = z.replace(absorbed=jnp.asarray([2.0 ** 24, 0.5]),
                  specular=jnp.asarray([3.0, 0.25]))
    b = z.replace(absorbed=jnp.asarray([1.0, 0.25]),
                  specular=jnp.asarray([1.0, 0.0]))
    m = a.merge(b)
    assert m.absorbed_weight == 2.0 ** 24 + 1.75
    assert float(np.asarray(m.specular, np.float64).sum()) == 4.25
