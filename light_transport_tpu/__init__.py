"""light_transport_tpu — a JAX Monte Carlo light-transport framework.

A ground-up JAX/XLA rebuild of the capability surface of
``zhouyifan233/light-transport`` (a numba-JIT CPU path tracer; see SURVEY.md):

- triangle-mesh scenes (Cornell box, OBJ meshes, procedural glass demo)
- BVH acceleration (host build -> flat arrays -> device traversal)
- unidirectional path tracing with next-event estimation, cosine-weighted
  BSDF sampling, Fresnel reflect/refract, Russian roulette
- Whitted-style recursive ray tracing (Phong, hard/soft shadows)
- bidirectional path tracing with MIS
- control-variates variance reduction with per-bounce log-pdf gradients
  (exact autodiff, plus the reference's finite-difference mode)
- participating-media photon Monte Carlo (Henyey-Greenstein scattering,
  layered slabs, MCML-style reflectance/fluence tallies)

Design: SoA state arrays stepped in masked lockstep supersteps, counter-based
threefry RNG, scatter-add tallies, photon/pixel batches sharded over a device
mesh with psum-reduced tallies.  No per-ray Python objects anywhere.
"""

__version__ = "0.1.0"

from light_transport_tpu.api import render, simulate  # noqa: F401
