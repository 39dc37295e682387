"""Photon Monte Carlo parity tests.

Golden values are the classic MCML validation set (Wang/Jacques/Zheng 1995,
validated against van de Hulst 1980 and Giovanelli 1955) — the analytic/
tabulated oracles SURVEY.md §4 calls for, generalizing the reference's
image-MAE estimator cross-check to chi-squared/3-sigma physics parity.
"""

import jax
import pytest
import numpy as np

from light_transport_tpu.api import simulate
from light_transport_tpu.core.config import MediumConfig, PhotonRunConfig
from light_transport_tpu.scene.medium import LayeredMedium
from light_transport_tpu.tally.stats import binomial_stderr, mc_parity_3sigma
from light_transport_tpu.transport.photon import run_fixed_steps

N_PHOTONS = 100_000


def run(layers, n_photons=N_PHOTONS, seed=0, **kw):
    m = LayeredMedium.build(layers, **kw)
    cfg = PhotonRunConfig(n_photons=n_photons, nr=50, nz=50, dr=0.002, dz=0.002)
    return simulate(m, cfg, seed=seed), cfg


def test_van_de_hulst_isotropic_semi_infinite():
    # albedo 0.9, g=0, matched boundaries: R_d = 0.41550 (van de Hulst)
    res, _ = run([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.0, n=1.0)])
    rd = res.total_reflectance()
    se = binomial_stderr(0.41550, N_PHOTONS)
    assert mc_parity_3sigma(rd, 0.41550, se, abs_floor=1e-3), (rd, se)


def test_mcml_hg_slab():
    # MCML paper validation (Wang/Jacques/Zheng 1995, Table comparing with
    # van de Hulst): slab d=0.02 cm, mu_a=10, mu_s=90, g=0.75, matched:
    # R_d = 0.09739, T_t = 0.66096
    res, _ = run(
        [MediumConfig(mu_a=10.0, mu_s=90.0, g=0.75, n=1.0, thickness=0.02)]
    )
    rd = res.total_reflectance()
    tt = res.total_transmittance()
    se_r = binomial_stderr(0.09739, N_PHOTONS)
    se_t = binomial_stderr(0.66096, N_PHOTONS)
    assert mc_parity_3sigma(rd, 0.09739, se_r, abs_floor=1e-3), (rd, se_r)
    assert mc_parity_3sigma(tt, 0.66096, se_t, abs_floor=2e-3), (tt, se_t)


def test_giovanelli_mismatched_semi_infinite():
    # mu_a=10, mu_s=90, g=0 (isotropic), n_rel=1.5: total reflectance
    # (specular + diffuse) = 0.2600 (Giovanelli 1955; MCML paper reproduces
    # 0.25907).  Verified against an independent scalar MCML oracle
    # (R_d = 0.2186, R_sp = 0.04).
    res, _ = run(
        [MediumConfig(mu_a=10.0, mu_s=90.0, g=0.0, n=1.5)], n_above=1.0
    )
    # specular at launch should be ((1-1.5)/2.5)^2 = 0.04
    np.testing.assert_allclose(res.specular_reflectance(), 0.04, atol=1e-6)
    r_total = res.specular_reflectance() + res.total_reflectance()
    se = binomial_stderr(0.26, N_PHOTONS)
    assert mc_parity_3sigma(r_total, 0.2600, se, abs_floor=2e-3), (r_total, se)


def test_beer_lambert_ballistic():
    # pure absorber slab, matched: all transmitted weight = exp(-mu_a d)
    res, _ = run(
        [MediumConfig(mu_a=1.0, mu_s=0.0, g=0.0, n=1.0, thickness=1.0)]
    )
    t = res.total_transmittance()
    np.testing.assert_allclose(t, np.exp(-1.0), atol=3e-3)
    assert res.total_reflectance() < 1e-6


def test_fresnel_double_interface():
    # nearly transparent glass slab: T = (1-R)^2 / (1 - R^2) with R = 0.04
    res, _ = run(
        [MediumConfig(mu_a=1e-4, mu_s=0.0, g=0.0, n=1.5, thickness=0.01)],
        n_above=1.0, n_below=1.0,
    )
    r = 0.04
    t_truth = (1 - r) ** 2 / (1 - r * r)
    t = res.total_transmittance() + res.specular_reflectance() * 0  # diffuse T
    # specular (launch) reflection is tallied separately; the infinite
    # internal bounce series lands in trans/refl tallies
    total_t = res.total_transmittance()
    total_r = res.specular_reflectance() + res.total_reflectance()
    np.testing.assert_allclose(total_t, t_truth, atol=3e-3)
    np.testing.assert_allclose(total_r, 1 - t_truth, atol=3e-3)


def test_energy_conservation():
    res, _ = run(
        [
            MediumConfig(mu_a=1.0, mu_s=10.0, g=0.7, n=1.4, thickness=0.05),
            MediumConfig(mu_a=2.0, mu_s=20.0, g=0.5, n=1.3, thickness=0.05),
        ],
        n_above=1.0, n_below=1.0,
    )
    assert abs(res.energy_total() - 1.0) < 5e-3, res.energy_total()
    assert res.n_launched == N_PHOTONS


def test_split_layer_equivalence():
    # one thick layer == the same layer split in two (statistically)
    res1, _ = run(
        [MediumConfig(mu_a=5.0, mu_s=45.0, g=0.8, n=1.37, thickness=0.1)],
        seed=1,
    )
    res2, _ = run(
        [
            MediumConfig(mu_a=5.0, mu_s=45.0, g=0.8, n=1.37, thickness=0.04),
            MediumConfig(mu_a=5.0, mu_s=45.0, g=0.8, n=1.37, thickness=0.06),
        ],
        seed=2,
    )
    se = binomial_stderr(res1.total_reflectance(), N_PHOTONS) * np.sqrt(2)
    assert mc_parity_3sigma(
        res2.total_reflectance(), res1.total_reflectance(), se, abs_floor=1e-3
    )
    assert mc_parity_3sigma(
        res2.total_transmittance(), res1.total_transmittance(), se,
        abs_floor=1e-3,
    )


def test_determinism_same_seed():
    res1, _ = run([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.5, n=1.2)], seed=5,
                  n_photons=20_000)
    res2, _ = run([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.5, n=1.2)], seed=5,
                  n_photons=20_000)
    np.testing.assert_array_equal(
        np.asarray(res1.absorb_rz), np.asarray(res2.absorb_rz)
    )
    np.testing.assert_array_equal(
        np.asarray(res1.refl_r), np.asarray(res2.refl_r)
    )


def test_fluence_decreases_with_depth():
    # grid deep enough (2.5 cm) to contain the diffusion decay
    # (mu_eff = sqrt(3 mu_a mu_tr') = 3/cm -> decay length 0.33 cm)
    m = LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=20.0, g=0.9, n=1.0)])
    cfg = PhotonRunConfig(n_photons=N_PHOTONS, nr=50, nz=50, dr=0.05, dz=0.05)
    res = simulate(m, cfg, seed=0)
    a = np.asarray(res.absorb_rz).sum(axis=0)  # by depth
    # beyond the build-up region the depth profile must decay
    # (skip the last bin: it is the clamp/overflow bin)
    assert a[10] > a[25] > a[45] > 0


def test_run_fixed_steps_counts():
    m = LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.5)])
    cfg = PhotonRunConfig(nr=16, nz=16)
    state, tallies = run_fixed_steps(m, cfg, jax.random.key(0), lanes=512,
                                     n_steps=32)
    assert tallies.n_steps == 512 * 32  # every lane live every step
    assert tallies.n_launched > 0


def test_drain_compaction_equivalent():
    """Drain-tail compaction (simulate_photons compact_drain): forcing
    compaction through several power-of-two shrinks must preserve the
    exact launch count, energy closure, and the van de Hulst golden R_d;
    a run whose live set never falls below half occupancy is
    bitwise unchanged."""
    import jax
    import numpy as np

    from light_transport_tpu.transport.photon import simulate_photons

    m = LayeredMedium.build([MediumConfig(mu_a=1.0, mu_s=9.0, g=0.0, n=1.0)])
    cfg = PhotonRunConfig(n_photons=40_000, nr=32, nz=32, dr=0.05, dz=0.05)
    a = simulate_photons(m, cfg, jax.random.key(0), lanes=4096,
                         compact_drain=True, min_lanes=512)
    b = simulate_photons(m, cfg, jax.random.key(0), lanes=4096,
                         compact_drain=False)
    for t in (a, b):
        assert t.n_launched == 40_000
        assert abs(t.energy_total() - 1.0) < 5e-3
        se = binomial_stderr(0.41550, 40_000)
        assert mc_parity_3sigma(t.total_reflectance(), 0.41550, se,
                                abs_floor=1e-3)
    # the main phases are identical; only re-laned tail photons differ
    assert abs(a.total_reflectance() - b.total_reflectance()) < 5e-3


def test_max_supersteps_is_exact():
    """The superstep budget is a hard cap: rounds past it are masked
    no-ops, so a non-scattering, non-absorbing population (every lane
    alive every step) executes exactly lanes * max_supersteps live steps
    even though dispatch rounds come in static multiples of
    steps_per_batch (and the drain loop batches 4x4 rounds per sync).
    The run cannot finish inside the cap, so it raises and hands back the
    tallies of the work it did."""
    import dataclasses

    from light_transport_tpu.transport.photon import (
        SuperstepCapError,
        simulate_photons,
    )

    # a quota far larger than the cap can consume keeps every lane alive
    # (immediate respawn) -> live steps == lanes * cap exactly
    m = LayeredMedium.build(
        [MediumConfig(mu_a=0.0, mu_s=50.0, g=0.0, n=1.0, thickness=1e6)])
    cfg = PhotonRunConfig(n_photons=512_000, nr=8, nz=8, dr=0.1, dz=0.1)
    cfg = dataclasses.replace(cfg, steps_per_batch=8)
    with pytest.raises(SuperstepCapError) as err:
        simulate_photons(m, cfg, jax.random.key(0), lanes=512,
                         max_supersteps=21)  # not a multiple of any round
    t = err.value.tallies
    assert t.n_steps == 512 * 21, t.n_steps
    # unlaunched photons plus the lanes still alive (at most 512)
    left = err.value.photons_left - (512_000 - t.n_launched)
    assert 0 <= left <= 512, left


@pytest.mark.parametrize("compact_drain", [False, True])
def test_cap_in_drain_raises(compact_drain):
    """Every photon launched but some still alive at the cap: the drain
    loop must raise, not return a short run."""
    from light_transport_tpu.transport.photon import (
        SuperstepCapError,
        simulate_photons,
    )

    m = LayeredMedium.build([MediumConfig(mu_a=0.1, mu_s=90.0, g=0.0,
                                          n=1.0)])
    cfg = PhotonRunConfig(n_photons=256, nr=8, nz=8, dr=0.1, dz=0.1)
    with pytest.raises(SuperstepCapError) as err:
        simulate_photons(m, cfg, jax.random.key(0), lanes=256,
                         max_supersteps=40, compact_drain=compact_drain,
                         min_lanes=64)
    assert err.value.tallies.n_launched == 256
    assert 0 < err.value.photons_left <= 256
    # the same run with the default budget finishes every photon
    t = simulate_photons(m, cfg, jax.random.key(0), lanes=256)
    assert t.n_launched == 256
    assert abs(t.energy_total() - 1.0) < 5e-2


def test_default_max_supersteps_rule():
    from light_transport_tpu.transport.photon import (
        MIN_SUPERSTEPS,
        STEPS_PER_PHOTON_BUDGET,
        default_max_supersteps,
    )

    assert default_max_supersteps(1_000, 1_000) == MIN_SUPERSTEPS
    # 1e9 photons on 2^20 lanes: 954 photons per lane
    assert default_max_supersteps(10**9, 1 << 20) == (
        STEPS_PER_PHOTON_BUDGET * 954)
    assert default_max_supersteps(2**31 - 1, 1) == 1 << 30  # int32-safe
