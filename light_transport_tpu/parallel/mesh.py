"""Multi-device scaling: photon/pixel batches over a device mesh.

The reference's only parallelism is shared-memory ``numba.prange`` over image
rows (src/path_tracing.py:266-270); there is no distributed backend at all
(SURVEY.md §2).  Here: a 1-D ``batch`` mesh axis,
photon/pixel lanes sharded across devices with ``shard_map``, the scene /
medium / material tables replicated, and tally partials reduced with
``jax.lax.psum`` (NCCL all-reduce over NVLink between the GPUs of one
host).  Multi-host runs reuse the same code — the mesh just spans hosts
after ``jax.distributed.initialize``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from light_transport_tpu.core.config import PhotonRunConfig, RenderConfig
from light_transport_tpu.scene.medium import LayeredMedium
from light_transport_tpu.scene.scene import Scene
from light_transport_tpu.tally.tallies import PhotonTallies

BATCH = "batch"


def make_mesh(n_devices: Optional[int] = None, axis: str = BATCH) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> Mesh:
    """Initialize multi-host execution and return the global mesh.

    With no arguments ``jax.distributed.initialize()`` discovers the
    cluster from a managed environment (e.g. SLURM); elsewhere pass the
    coordinator ``host:port``, the process count and this process's id.
    The returned mesh spans all hosts — the same ``batch``-axis sharding
    code then scales across them with no further changes.
    """
    if coordinator is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    else:
        jax.distributed.initialize()
    return make_mesh()


def simulate_sharded(
    medium: LayeredMedium,
    cfg: PhotonRunConfig,
    key: jax.Array,
    mesh: Optional[Mesh] = None,
    lanes_per_device: Optional[int] = None,
) -> PhotonTallies:
    """Photon run sharded over the mesh: each device simulates an equal
    share of the photon quota with an independently folded key; tallies
    are psum-reduced so every device returns the global result.

    Each device runs under ``default_max_supersteps`` of the largest
    share; reaching it with photons unlaunched or alive on any device
    raises ``SuperstepCapError``."""
    from light_transport_tpu.transport.photon import (
        SuperstepCapError,
        default_lanes,
        default_max_supersteps,
    )

    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    share = cfg.n_photons // n_dev
    if lanes_per_device is None:
        lanes_per_device = default_lanes(share)
    # device 0 carries the remainder, so its share bounds every device's
    local_max = share + cfg.n_photons - share * n_dev
    max_supersteps = default_max_supersteps(
        local_max, min(lanes_per_device, local_max))
    keys = jnp.broadcast_to(jax.random.key_data(key),
                            (n_dev,) + jax.random.key_data(key).shape)
    tallies, left = _simulate_sharded(medium, keys, cfg, mesh,
                                      lanes_per_device, max_supersteps)
    left = int(left)
    if left:
        raise SuperstepCapError(max_supersteps, left, tallies)
    return tallies


# jit around shard_map: outside jit, shard_map executes its body op by op
# on every device.  Everything that shapes the program is static.
@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _simulate_sharded(medium, keys, cfg, mesh, lanes_per_device,
                      max_supersteps):
    n_dev = mesh.devices.size
    share = cfg.n_photons // n_dev
    # device 0 absorbs the remainder so exactly n_photons launch in total
    rem = cfg.n_photons - share * n_dev
    # static upper bound per device
    local_cfg = dataclasses.replace(cfg, n_photons=share + rem)

    def per_device(medium, key):
        key = jax.random.wrap_key_data(key[0])
        idx = jax.lax.axis_index(BATCH)
        my_key = jax.random.fold_in(key, idx)
        my_quota = share + jnp.where(idx == 0, rem, 0)
        tallies, left = _simulate_dynamic_quota(
            medium, local_cfg, my_key, my_quota, lanes_per_device,
            max_supersteps)
        return jax.tree.map(lambda x: jax.lax.psum(x, BATCH),
                            (tallies, left))

    return shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(BATCH)),
        out_specs=P(),  # psum-reduced: replicated output
        check_vma=False,
    )(medium, keys)


def _simulate_dynamic_quota(medium, cfg, key, quota, lanes,
                            max_supersteps: int):
    """simulate_photons with a traced (dynamic) quota — used per-shard.

    Runs entirely device-side (it executes under ``shard_map``, so the
    host-driven drain compaction of ``simulate_photons`` is unavailable);
    the round body is ``transport.photon._run_rounds`` itself, so the
    superstep loop contract (global-step uniform keying, the exact
    ``max_supersteps`` cap masking) lives in one place.

    Returns ``(tallies, left)``: ``left`` counts the photons still
    unlaunched or alive when the loop stopped, nonzero only at the cap."""
    from light_transport_tpu.transport.photon import PhotonState, _run_rounds

    lanes = min(lanes, cfg.n_photons)
    round_len = max(1, cfg.steps_per_batch)

    state = PhotonState.dead(lanes)
    tallies = PhotonTallies.zeros(cfg)
    quota = quota.astype(jnp.int32)
    cap = jnp.asarray(max_supersteps, jnp.int32)

    def cond(carry):
        state, _, quota, step = carry
        return ((quota > 0) | jnp.any(state.alive)) & (step < cap)

    def round_body(carry):
        state, tallies, quota, step = carry
        return _run_rounds.__wrapped__(
            key, state, tallies, quota, step, medium, cfg, round_len, cap)

    state, tallies, quota, _ = jax.lax.while_loop(
        cond, round_body, (state, tallies, quota, jnp.asarray(0, jnp.int32))
    )
    return tallies, quota + jnp.sum(state.alive.astype(jnp.int32))


def render_sharded(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    mesh: Optional[Mesh] = None,
    ray_chunk: Optional[int] = None,
):
    """Camera render with the lane population sharded over the mesh.

    Pixel/sample lanes are split across devices (pure data parallelism — rays
    are independent); the scene tables replicate.  Output image is gathered
    to every device.

    The lane preamble is the shared :func:`path_tracer._camera_lanes`, so
    ``cfg.sampler`` (sobol QMC) and ``cfg.aperture`` (thin-lens DOF) apply
    here exactly as in the single-device render — and the pinhole/uniform
    default keeps its original key-split convention (bitwise-identical
    lanes to the unsharded render).
    """
    from light_transport_tpu.integrators.path_tracer import _camera_lanes

    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    n = cfg.height * cfg.width * cfg.spp
    pad = (-n) % n_dev

    origins, directions, uniforms = _camera_lanes(scene, cfg, key)
    if pad:
        z3 = jnp.zeros((pad, 3), origins.dtype)
        origins = jnp.concatenate([origins, z3])
        directions = jnp.concatenate(
            [directions, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], z3.dtype), (pad, 1))]
        )
        uniforms = jnp.concatenate(
            [uniforms, jnp.full((pad,) + uniforms.shape[1:], 0.5, uniforms.dtype)]
        )

    radiance = _trace_sharded(scene, origins, directions, uniforms, cfg,
                              mesh, ray_chunk)[:n]
    samples = jnp.moveaxis(
        radiance.reshape(cfg.spp, cfg.height, cfg.width, 3), 0, 2
    )
    return jnp.clip(jnp.mean(samples, axis=2), 0.0, 1.0)


@partial(jax.jit, static_argnums=(4, 5, 6))
def _trace_sharded(scene, origins, directions, uniforms, cfg, mesh,
                   ray_chunk):
    from light_transport_tpu.integrators.path_tracer import trace_paths

    def per_device(scene, o, d, u):
        radiance, _ = trace_paths(scene, cfg, o, d, u, ray_chunk=ray_chunk)
        return radiance

    return shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(BATCH), P(BATCH), P(BATCH)),
        out_specs=P(BATCH),
        check_vma=False,
    )(scene, origins, directions, uniforms)


def render_bdpt_sharded(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    mesh: Optional[Mesh] = None,
    ray_chunk: Optional[int] = None,
    light_tracing: bool = True,
):
    """BDPT render with camera AND light-subpath lanes sharded over the
    mesh (every (s, t) strategy, all three light-origin families:
    area / point / mixed).

    Lane uniforms are drawn at GLOBAL width with the single-device
    key-split sequence (``bdpt._bdpt_lane_uniforms``), so each lane's
    transport is bitwise-identical to the unsharded render.  Per-lane
    radiance shards over the batch axis like :func:`render_sharded`; the
    t=1 light-tracing splat plane is a per-device partial FILM that psums
    over the mesh (summation order differs from the single-device scatter, so
    splat pixels match to float tolerance, not bitwise).  Lanes padded to
    a device multiple carry ``mask=False``: their radiance rows are
    sliced away and their light walks are barred from splatting."""
    from light_transport_tpu.integrators import bdpt as B

    mode, q_point = B._light_family(scene)
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    n = cfg.height * cfg.width * cfg.spp
    pad = (-n) % n_dev

    lanes = B._bdpt_lane_uniforms(scene, cfg, key, mode)
    if pad:
        def padlane(x):
            widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, widths)  # mask pads False, uniforms pad 0

        lanes = {k: padlane(v) for k, v in lanes.items()}
        # keep pad-lane camera rays well-formed (unit direction, away
        # from the film) — their output is masked/sliced regardless
        lanes["d"] = lanes["d"].at[n:].set(
            jnp.asarray([0.0, 0.0, 1.0], lanes["d"].dtype))

    radiance, splat = _bdpt_sharded(scene, lanes, cfg, mesh, ray_chunk,
                                    light_tracing, mode, q_point)
    return B._bdpt_assemble(cfg, radiance[:n], splat)


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7))
def _bdpt_sharded(scene, lanes, cfg, mesh, ray_chunk, light_tracing, mode,
                  q_point):
    from light_transport_tpu.integrators import bdpt as B

    def per_device(scene, lane_shard):
        rad, splat = B._bdpt_body(scene, cfg, lane_shard, ray_chunk,
                                  light_tracing, mode, q_point)
        return rad, jax.lax.psum(splat, BATCH)

    return shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(BATCH)),
        out_specs=(P(BATCH), P()),
        check_vma=False,
    )(scene, lanes)
