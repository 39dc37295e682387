"""Photon Monte Carlo superstep engine for layered media.

This is the subsystem the reference stubbed out (``photon_tracing.py`` is
empty; ``henyey_greenstein`` defined but never called,
src/medium_samples.py:14-16) built as a data-parallel array program (BASELINE.json
north star): the per-photon random walk becomes a fully vectorized SoA photon
population advanced in lockstep *supersteps* — the MCML hop-drop-spin cycle
as branchless masked ops:

  hop   : sample optical depth tau = -ln(u); move min(tau/mu_t, boundary)
  drop  : deposit w * mu_a/mu_t into the (r, z) absorption grid (scatter-add)
  spin  : Henyey-Greenstein deflection (analytic inverse CDF)
  bounce: Fresnel reflect/refract at layer interfaces, with the remaining
          *dimensionless* optical depth carried across the interface
          (the MCML "sleft" rule), exit tallies at top/bottom
  roulette + respawn: dead lanes are reloaded with fresh photons from the
          launch quota so lanes stay occupied

Everything is a pure function of (seed, superstep counter) via threefry
fold-in; tallies are psum-reducible partials (see parallel/).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from light_transport_tpu.core.config import PhotonRunConfig
from light_transport_tpu.ops import sampling
from light_transport_tpu.scene.medium import LayeredMedium
from light_transport_tpu.tally.tallies import (
    PhotonTallies,
    counter_add,
    wsum_add,
)

# uniform slots per lane per superstep
_U_TAU, _U_HG, _U_PHI, _U_FRESNEL, _U_RR = range(5)
_NUM_U = 5


class PhotonState(NamedTuple):
    pos: jnp.ndarray  # (N, 3); z increases into the medium, surface at z=0
    dir: jnp.ndarray  # (N, 3) unit
    w: jnp.ndarray  # (N,) packet weight
    layer: jnp.ndarray  # (N,) int32 current layer
    tau: jnp.ndarray  # (N,) leftover optical depth of an interrupted hop
    alive: jnp.ndarray  # (N,) bool

    @staticmethod
    def dead(n: int, dtype=jnp.float32) -> "PhotonState":
        return PhotonState(
            pos=jnp.zeros((n, 3), dtype),
            dir=jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], dtype), (n, 1)),
            w=jnp.zeros((n,), dtype),
            layer=jnp.zeros((n,), jnp.int32),
            tau=jnp.zeros((n,), dtype),
            alive=jnp.zeros((n,), bool),
        )


def _specular_r(medium: LayeredMedium):
    """Launch-time specular reflection at the top surface (MCML R_sp)."""
    n0 = medium.n[0]
    return sampling.schlick_r0(medium.n_above, n0)


def _grid_indices(pos, cfg: PhotonRunConfig):
    r = jnp.sqrt(pos[:, 0] ** 2 + pos[:, 1] ** 2)
    ir = jnp.clip((r / cfg.dr).astype(jnp.int32), 0, cfg.nr - 1)
    iz = jnp.clip((pos[:, 2] / cfg.dz).astype(jnp.int32), 0, cfg.nz - 1)
    return ir, iz


def superstep(
    state: PhotonState,
    tallies: PhotonTallies,
    u: jnp.ndarray,  # (N, 5) uniforms for this superstep
    medium: LayeredMedium,
    cfg: PhotonRunConfig,
    quota: jnp.ndarray,  # () int32: photons still allowed to launch
) -> Tuple[PhotonState, PhotonTallies, jnp.ndarray]:
    """One lockstep hop-drop-spin event per lane. Returns updated
    (state, tallies, quota).

    The quota is int32 (exact to 2^31 photons); the round-1 f32 quota
    rounded decrements above 2^24 and launched 99,999,952 of 1e8.
    """
    n = state.w.shape[0]
    num_layers = medium.num_layers

    # ---- respawn dead lanes from the quota --------------------------------
    dead = ~state.alive
    # lane rank among dead lanes; exact while lanes < 2^24.  Comparing
    # against the f32-rounded quota is exact in effect: once quota exceeds
    # 2^24 every rank (< lanes) passes regardless of rounding.
    order = jnp.cumsum(dead.astype(jnp.float32))
    respawn = dead & (order <= quota.astype(jnp.float32))
    n_respawn_i = jnp.sum(respawn.astype(jnp.int32))
    n_respawn = n_respawn_i.astype(jnp.float32)
    r_sp = _specular_r(medium)
    w0 = 1.0 - r_sp
    pos = jnp.where(respawn[:, None], 0.0, state.pos)
    direc = jnp.where(
        respawn[:, None], jnp.asarray([0.0, 0.0, 1.0], state.dir.dtype), state.dir
    )
    w = jnp.where(respawn, w0, state.w)
    layer = jnp.where(respawn, 0, state.layer)
    tau = jnp.where(respawn, 0.0, state.tau)
    alive = state.alive | respawn
    quota = quota - n_respawn_i
    tallies = tallies.replace(
        specular=wsum_add(tallies.specular, n_respawn * r_sp),
        launched=counter_add(tallies.launched, n_respawn),
        steps=counter_add(tallies.steps, jnp.sum(alive.astype(jnp.float32))),
    )

    # ---- hop ---------------------------------------------------------------
    mu_t = medium.mu_t[layer]
    mu_a = medium.mu_a[layer]
    g = medium.g[layer]
    tau_new = jnp.where(tau > 0.0, tau, -jnp.log1p(-u[:, _U_TAU]))
    s = tau_new / jnp.maximum(mu_t, 1e-12)

    uz = direc[:, 2]
    z = pos[:, 2]
    zb = jnp.where(uz > 0.0, medium.z_bot[layer], medium.z_top[layer])
    safe_uz = jnp.where(jnp.abs(uz) < 1e-12, 1.0, uz)
    db = jnp.where(jnp.abs(uz) < 1e-12, jnp.inf, (zb - z) / safe_uz)
    db = jnp.maximum(db, 0.0)
    hits_boundary = alive & (db < s)

    dist = jnp.minimum(s, db)
    pos = jnp.where(alive[:, None], pos + direc * dist[:, None], pos)
    # leftover optical depth carried across the interface (MCML sleft)
    tau = jnp.where(hits_boundary, tau_new - db * mu_t, 0.0)

    # ---- drop + spin (scatter lanes) ---------------------------------------
    scatters = alive & ~hits_boundary
    ir, iz = _grid_indices(pos, cfg)
    albedo_comp = mu_a / jnp.maximum(mu_t, 1e-12)
    dw = jnp.where(scatters, w * albedo_comp, 0.0)
    tallies = tallies.replace(
        absorb_rz=tallies.absorb_rz.at[ir, iz].add(dw),
        absorbed=wsum_add(tallies.absorbed, jnp.sum(dw)),
    )
    if cfg.vol_nx > 0:
        # 3-D cartesian fluence volume: x/y centered on the beam axis,
        # z downward from the surface; clips into edge cells like the
        # (r, z) grid's overflow bins
        vx = jnp.clip(
            (pos[:, 0] / cfg.vol_dx + 0.5 * cfg.vol_nx).astype(jnp.int32),
            0, cfg.vol_nx - 1)
        vy = jnp.clip(
            (pos[:, 1] / cfg.vol_dy + 0.5 * cfg.vol_ny).astype(jnp.int32),
            0, cfg.vol_ny - 1)
        vz = jnp.clip((pos[:, 2] / cfg.vol_dz).astype(jnp.int32),
                      0, cfg.vol_nz - 1)
        tallies = tallies.replace(
            absorb_xyz=tallies.absorb_xyz.at[vx, vy, vz].add(dw)
        )
    w = w - dw

    cos_hg = sampling.sample_henyey_greenstein(g, u[:, _U_HG])
    new_dir_scatter = sampling.scatter_direction(direc, cos_hg, u[:, _U_PHI])

    # roulette (after drop, MCML convention)
    low_w = scatters & (w < cfg.weight_threshold)
    survive = u[:, _U_RR] < cfg.rr_survive
    w = jnp.where(low_w & survive, w / cfg.rr_survive, w)
    alive = alive & ~(low_w & ~survive)

    # ---- boundary (Fresnel) lanes ------------------------------------------
    going_down = uz > 0.0
    next_layer = jnp.where(going_down, layer + 1, layer - 1)
    n1 = medium.n[layer]
    # neighbor index via padded table [n_above, n_0..n_{L-1}, n_below]
    n_padded = jnp.concatenate(
        [medium.n_above[None], medium.n, medium.n_below[None]]
    )
    n2 = n_padded[jnp.clip(next_layer, -1, num_layers) + 1]
    cos_i = jnp.abs(uz)
    refl_p = sampling.fresnel_dielectric(cos_i, n1, n2)
    do_reflect = u[:, _U_FRESNEL] < refl_p

    # reflected: flip z component, stay in layer, keep leftover tau
    dir_reflect = direc * jnp.asarray([1.0, 1.0, -1.0], direc.dtype)
    # transmitted: Snell in the meridional plane
    eta = n1 / n2
    sin_t2 = eta**2 * (1.0 - cos_i**2)
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin_t2, 0.0))
    dir_transmit = jnp.stack(
        [
            direc[:, 0] * eta,
            direc[:, 1] * eta,
            jnp.sign(uz) * cos_t,
        ],
        axis=-1,
    )
    exits = hits_boundary & ~do_reflect & (
        (next_layer < 0) | (next_layer >= num_layers)
    )
    exit_top = exits & ~going_down
    exit_bot = exits & going_down
    w_top = jnp.where(exit_top, w, 0.0)
    w_bot = jnp.where(exit_bot, w, 0.0)
    tallies = tallies.replace(
        refl_r=tallies.refl_r.at[ir].add(w_top),
        trans_r=tallies.trans_r.at[ir].add(w_bot),
    )
    if cfg.detector_nx > 0:
        # cartesian exit-detector image over the top surface (config 5)
        nx = cfg.detector_nx
        half = cfg.detector_extent
        scale = nx / (2.0 * half)
        ix = jnp.clip(((pos[:, 0] + half) * scale).astype(jnp.int32), 0, nx - 1)
        iy = jnp.clip(((pos[:, 1] + half) * scale).astype(jnp.int32), 0, nx - 1)
        tallies = tallies.replace(
            detector_xy=tallies.detector_xy.at[ix, iy].add(w_top)
        )

    transmit_inside = hits_boundary & ~do_reflect & ~exits

    # ---- merge -------------------------------------------------------------
    new_dir = jnp.where(
        scatters[:, None],
        new_dir_scatter,
        jnp.where(
            (hits_boundary & do_reflect)[:, None],
            dir_reflect,
            jnp.where(hits_boundary[:, None], dir_transmit, direc),
        ),
    )
    new_layer = jnp.where(transmit_inside, next_layer, layer)
    alive = alive & ~exits

    # nudge boundary-lane z off the interface to dodge f32 re-hit loops
    z_adj = jnp.where(
        hits_boundary & alive, pos[:, 2] + jnp.sign(new_dir[:, 2]) * 1e-7, pos[:, 2]
    )
    pos = pos.at[:, 2].set(z_adj)

    new_state = PhotonState(
        pos=pos, dir=new_dir, w=w, layer=new_layer, tau=tau, alive=alive
    )
    return new_state, tallies, quota


# lane-count rule for simulate_photons(lanes=None): about 16 photons per
# lane, at least 2^16 lanes and at most 2^20 (40 MB of photon state).  From
# a sweep of 2^14..2^20 lanes on an H100 (scripts/measure_floors.py
# --only lanes; PERF.md): the demo medium at 1e5 and 1e6 photons ran
# fastest at 2^16 lanes (1.2x and 2.4x faster than 2^14; 2^18 lost to
# its drain tail at 1e6), full_scale at 1e7 ran fastest at 2^20 (6.8x
# faster than 2^14, 1.2x faster than 2^18).
MIN_LANES = 1 << 16
MAX_LANES = 1 << 20
PHOTONS_PER_LANE = 16

# superstep budget for simulate_photons(max_supersteps=None): 4096
# supersteps for every photon a lane carries (a full_scale photon lives
# ~410), and never fewer than 1e5, which covers the drain tail of small
# runs.  The budget guards against media whose photons never die; a run
# that exhausts it raises SuperstepCapError instead of returning short.
STEPS_PER_PHOTON_BUDGET = 4096
MIN_SUPERSTEPS = 100_000


class SuperstepCapError(RuntimeError):
    """A photon run reached ``max_supersteps`` while photons were still
    waiting to launch or alive.  ``tallies`` holds the work done up to the
    cap; ``photons_left`` counts the unlaunched plus the live photons."""

    def __init__(self, max_supersteps: int, photons_left: int, tallies):
        super().__init__(
            f"photon run reached max_supersteps={max_supersteps} with "
            f"{photons_left} photons unlaunched or alive; pass a larger "
            "max_supersteps (or more lanes)")
        self.max_supersteps = max_supersteps
        self.photons_left = photons_left
        self.tallies = tallies


def default_lanes(n_photons: int) -> int:
    """Lane count that ``simulate_photons`` uses when none is given."""
    return int(min(MAX_LANES, max(MIN_LANES, n_photons // PHOTONS_PER_LANE)))


def default_max_supersteps(n_photons: int, lanes: int) -> int:
    """Superstep budget of a run of ``n_photons`` on ``lanes`` lanes."""
    per_lane = -(-n_photons // max(lanes, 1))
    return int(min(1 << 30, max(MIN_SUPERSTEPS,
                                STEPS_PER_PHOTON_BUDGET * per_lane)))


def simulate_photons(
    medium: LayeredMedium,
    cfg: PhotonRunConfig,
    key: jax.Array,
    lanes: int | None = None,
    max_supersteps: int | None = None,
    compact_drain: bool | None = None,
    min_lanes: int = 65536,
) -> PhotonTallies:
    """Run exactly ``cfg.n_photons`` photons to completion (unbiased: the
    loop continues until every launched photon has exited or died).

    ``max_supersteps`` (default :func:`default_max_supersteps`) is a hard
    cap: a run that reaches it with photons unlaunched or alive raises
    :class:`SuperstepCapError`, so the tallies returned always hold every
    photon of ``cfg.n_photons``.

    Two phases:

    * **Main phase** (quota remaining): a device-side while-of-scan with
      per-step respawn keeps every lane occupied; the termination check
      runs once per ``cfg.steps_per_batch`` round on the device, so the
      host never waits on a superstep.  Bitwise identical to the
      round-2 engine while the quota lasts.
    * **Drain phase** (quota exhausted, survivors finishing): previously
      the full lane population stayed resident while a shrinking live set
      (albedo→1 photons live for hundreds of steps) finished — at 2^20
      lanes the tail cost hundreds of full-width supersteps for a few
      live lanes.  Now a host-driven loop compacts the live lanes
      (argsort-gather) straight down to the next power of two >= the live
      count, runs 4x-length rounds, and dispatches several rounds per
      host sync.  Compaction re-lanes a photon, which
      re-keys its remaining uniform stream — statistically equivalent,
      and runs that never trigger compaction are bitwise unchanged
      (verified: identical step counts and R_d vs the round-2 engine).
      ``compact_drain=None`` (auto) enables it at >= 2^16 lanes, where
      the tail dominates.

    All jitted pieces (``_main_phase``, ``_run_rounds``, ``_compact``)
    are module-level with the photon count carried as a *traced* quota,
    so repeated runs — including at different ``cfg.n_photons`` — reuse
    every compiled executable (per-call closures used to recompile the
    whole engine each run; see PERF.md §wall-vs-steady).
    """
    if lanes is None:
        lanes = default_lanes(cfg.n_photons)
    lanes = min(lanes, cfg.n_photons)
    if max_supersteps is None:
        max_supersteps = default_max_supersteps(cfg.n_photons, lanes)
    if compact_drain is None:
        compact_drain = lanes >= 65536
    round_len = max(1, cfg.steps_per_batch)
    # static jit key with n_photons neutralized: the quota is a *traced*
    # argument below, so re-running at a different photon count reuses
    # every compiled executable (the shapes don't depend on it)
    cfg_key = dataclasses.replace(cfg, n_photons=0)
    quota0 = jnp.asarray(cfg.n_photons, jnp.int32)

    state, tallies, quota, step = _main_phase(
        key, medium, quota0, cfg_key, lanes, round_len,
        jnp.asarray(max_supersteps, jnp.int32))

    n_lanes = lanes
    drain_len = round_len * 4  # uniforms key on the global step index, so
    # round granularity does not change the stream (bitwise-safe)
    rounds_per_sync = 4
    # the step counter advances deterministically (min(step+len, cap)), so
    # it is mirrored host-side instead of fetched every iteration
    step_h = int(step)
    while step_h < max_supersteps:
        n_alive = int(jnp.sum(state.alive))  # one sync per batch
        if n_alive == 0:
            break
        if compact_drain:
            target = max(min_lanes, 1 << (max(n_alive, 1) - 1).bit_length())
            target = min(target, n_lanes)
            if target != n_lanes:
                state = _compact(state, target)
                n_lanes = target
        # dispatch several rounds per sync so the device does not idle
        # while the host reads the live count
        for _ in range(rounds_per_sync):
            state, tallies, quota, step = _run_rounds(
                key, state, tallies, quota, step, medium, cfg_key,
                drain_len, jnp.asarray(max_supersteps, jnp.int32))
            step_h = min(step_h + drain_len, max_supersteps)
    else:  # the superstep budget ran out before the photons did
        left = int(quota) + int(jnp.sum(state.alive))
        if left:
            raise SuperstepCapError(max_supersteps, left, tallies)
    return tallies


@partial(jax.jit, static_argnames=("cfg", "length"))
def _run_rounds(key, state, tallies, quota, step, medium, cfg, length,
                cap):
    """``length`` supersteps under one dispatch (uniforms keyed on the
    global step index, so round granularity never changes the stream).

    ``cap`` (traced): the run's ``max_supersteps`` — steps past it are
    no-ops (state/tallies/quota passed through), so the documented hard
    cap holds exactly even though round length is a static multiple.

    Module-level jit: repeated ``simulate_photons`` calls at the same
    shapes reuse the compiled executable (per-call closures used to
    recompile every run — the whole wall-vs-steady gap of PERF.md).
    """
    n_lanes = state.w.shape[0]

    def one(carry2, s):
        state, tallies, quota = carry2
        u = jax.random.uniform(
            jax.random.fold_in(key, s), (n_lanes, _NUM_U),
            dtype=state.w.dtype,
        )
        new_state, new_tallies, new_quota = superstep(
            state, tallies, u, medium, cfg, quota
        )
        do = s < cap
        state = jax.tree.map(lambda a, b: jnp.where(do, a, b),
                             new_state, state)
        tallies = jax.tree.map(lambda a, b: jnp.where(do, a, b),
                               new_tallies, tallies)
        quota = jnp.where(do, new_quota, quota)
        return (state, tallies, quota), None

    (state, tallies, quota), _ = jax.lax.scan(
        one, (state, tallies, quota),
        step + jnp.arange(length, dtype=jnp.int32),
    )
    return state, tallies, quota, jnp.minimum(step + length, cap)


@partial(jax.jit, static_argnames=("cfg", "lanes", "round_len"))
def _main_phase(key, medium, quota0, cfg, lanes, round_len,
                max_supersteps):
    state = PhotonState.dead(lanes)
    tallies = PhotonTallies.zeros(cfg)

    def cond(carry):
        _, _, quota, step = carry
        return (quota > 0) & (step < max_supersteps)

    def round_body(carry):
        state, tallies, quota, step = carry
        return _run_rounds.__wrapped__(
            key, state, tallies, quota, step, medium, cfg, round_len,
            max_supersteps)

    return jax.lax.while_loop(
        cond, round_body,
        (state, tallies, quota0, jnp.asarray(0, jnp.int32)),
    )


@partial(jax.jit, static_argnums=1)
def _compact(state, target):
    # live lanes first (stable: preserves relative order), then slice
    order = jnp.argsort(~state.alive, stable=True)[:target]
    return jax.tree.map(lambda a: a[order], state)


def run_fixed_steps(
    medium: LayeredMedium,
    cfg: PhotonRunConfig,
    key: jax.Array,
    lanes: int,
    n_steps: int,
):
    """Benchmark kernel: ``n_steps`` supersteps with unconditional respawn
    (infinite quota).  Returns the tally pytree; ``tallies.steps`` counts
    total lane-events processed — the BASELINE throughput metric."""

    def step_fn(carry, step):
        state, tallies = carry
        u = jax.random.uniform(
            jax.random.fold_in(key, step), (lanes, _NUM_U), dtype=state.w.dtype
        )
        state, tallies, _ = superstep(
            state, tallies, u, medium, cfg,
            jnp.asarray(2**31 - 1, jnp.int32),  # unbounded respawn
        )
        return (state, tallies), None

    state = PhotonState.dead(lanes)
    tallies = PhotonTallies.zeros(cfg)
    (state, tallies), _ = jax.lax.scan(
        step_fn, (state, tallies), jnp.arange(n_steps, dtype=jnp.int32)
    )
    return state, tallies
