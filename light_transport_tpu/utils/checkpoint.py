"""Checkpoint / resume for long photon runs.

The reference has no checkpointing; its one related primitive is
progressive image accumulation across repeated render calls
(src/path_tracing_fix1.py:166).  Here the complete checkpoint of a photon
run is tiny and exact (SURVEY.md §5): the tally arrays + the RNG seed + the
superstep/batch counters.  Snapshots are plain ``.npz`` files (orbax is
overkill for a dict of small arrays and keeps us dependency-light), written
atomically (tmp file + ``os.replace``) so a crash mid-save never corrupts
the previous snapshot.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import jax
import numpy as np

from light_transport_tpu.core.config import PhotonRunConfig
from light_transport_tpu.tally.tallies import PhotonTallies


def _norm(path: str) -> str:
    """np.savez appends '.npz' to suffix-less paths; normalize up front so
    save, load, and the resume existence check all agree on one filename."""
    return path if path.endswith(".npz") else path + ".npz"


def save_tallies(path: str, tallies: PhotonTallies, seed: int,
                 batches_done: int) -> None:
    path = _norm(path)
    arrays = {
        f.name: np.asarray(getattr(tallies, f.name))
        for f in dataclasses.fields(tallies)
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, seed=np.asarray(seed),
                 batches_done=np.asarray(batches_done), **arrays)
    os.replace(tmp, path)  # atomic: a crash mid-save leaves the old file


def load_tallies(path: str) -> Tuple[PhotonTallies, int, int]:
    with np.load(_norm(path)) as z:
        import jax.numpy as jnp

        tallies = PhotonTallies(
            **{
                f.name: jnp.asarray(z[f.name])
                for f in dataclasses.fields(PhotonTallies)
            }
        )
        return tallies, int(z["seed"]), int(z["batches_done"])


def accumulate(a: PhotonTallies, b: PhotonTallies) -> PhotonTallies:
    """Merge two tally partials (progressive refinement across runs —
    the functional form of fix1's ``image += 0.25*color`` accumulation).

    Uses the counter-aware ``PhotonTallies.merge``: the two-word exact
    counters (launched, steps) need their lo-word carry normalized on
    every merge — a plain elementwise add lets lo grow past 2^24 after
    ~256 accumulations and silently rounds the photon count."""
    return a.merge(b)


def simulate_resumable(
    medium,
    cfg: PhotonRunConfig,
    seed: int,
    checkpoint_path: str,
    n_batches: int = 10,
    lanes: int | None = None,
) -> PhotonTallies:
    """Run cfg.n_photons split into n_batches, checkpointing after each.
    ``lanes`` defaults to ``simulate_photons``'s choice for one batch.

    Restarting with the same arguments resumes from the last finished batch
    (same per-batch fold-in keys => the completed batches are bit-identical
    to an uninterrupted run's).
    """
    from light_transport_tpu.transport.photon import simulate_photons

    per_batch = cfg.n_photons // n_batches
    extra = cfg.n_photons - per_batch * n_batches
    start = 0
    total: Optional[PhotonTallies] = None
    if os.path.exists(_norm(checkpoint_path)):
        total, saved_seed, start = load_tallies(checkpoint_path)
        if saved_seed != seed:
            total, start = None, 0

    for b in range(start, n_batches):
        n_b = per_batch + (extra if b == 0 else 0)
        batch_cfg = dataclasses.replace(cfg, n_photons=n_b)
        key = jax.random.fold_in(jax.random.key(seed), b)
        part = simulate_photons(medium, batch_cfg, key, lanes=lanes)
        total = part if total is None else accumulate(total, part)
        save_tallies(checkpoint_path, total, seed, b + 1)
    return total
