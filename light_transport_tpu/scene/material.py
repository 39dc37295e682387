"""Materials as an SoA table.

The reference stores a ``Material`` jitclass pointer on every triangle
(src/material.py:18-37, src/primitives.py:91); BSDF dispatch branches on its
``is_diffuse`` / ``is_mirror`` / ``transmission`` flags
(src/path_tracing.py:68,103,108).  Here materials are rows of a small
replicated table and each triangle carries an int32 ``mat_id``; dispatch is a
branchless select on an integer BSDF code.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import jax.numpy as jnp

from light_transport_tpu.core import struct

# BSDF dispatch codes — ordered to match the reference's if/elif chain
# (src/path_tracing.py:68-145): is_diffuse wins over is_mirror which wins
# over transmission > 0; anything else terminates the path.
BSDF_DIFFUSE = 0
BSDF_MIRROR = 1
BSDF_TRANSMISSIVE = 2
BSDF_NONE = 3
# Glossy (modified Phong): kd/pi diffuse lobe + ks (n+2)/(2 pi) cos^n
# specular lobe about the mirror direction — the reference's Phong
# specular term (src/brdf.py:36-48, Whitted-only there) promoted into a
# sampled, NEE/MIS-aware BSDF.  Opt-in via Material(is_glossy=True);
# reads color.diffuse (kd), color.specular (ks) and shininess (n).
BSDF_GLOSSY = 4


@dataclasses.dataclass(frozen=True)
class Color:
    """Host-side color triple (ambient, diffuse, specular) — mirrors the
    reference ``Color`` jitclass (src/material.py:4-13)."""

    ambient: tuple
    diffuse: tuple
    specular: tuple

    @staticmethod
    def of(ambient, diffuse, specular) -> "Color":
        return Color(tuple(ambient), tuple(diffuse), tuple(specular))


@dataclasses.dataclass(frozen=True)
class Material:
    """Host-side material description — the reference ``Material`` surface
    (src/material.py:29-37) with identical defaults."""

    color: Color
    shininess: float = 1.0
    reflection: float = 0.0
    ior: float = 1.0
    emission: float = 0.0
    # emitted-radiance tint: L_e = emission * emission_color.  A separate
    # spectrum from the reflectance ``color.diffuse`` — the reference ties
    # NEE radiance to the diffuse color (src/light_samples.py:55) but
    # scores the bare scalar at hits (src/path_tracing.py:60), splitting
    # one light into two radiances; here both estimators read this product
    # (README §Deviations), and emissive-but-non-reflective lights (black
    # diffuse) keep emitting.
    emission_color: tuple = (1.0, 1.0, 1.0)
    transmission: float = 0.0
    is_diffuse: bool = True
    is_mirror: bool = False
    # Interior participating medium (closed transmissive objects): RGB
    # absorption coefficient and scattering coefficient / HG anisotropy in
    # inverse scene units.  The reference's ``Medium`` enum + unused
    # ``henyey_greenstein`` (src/constants.py:17-24, src/medium_samples.py:
    # 14-16) gesture at this capability; here Beer-Lambert attenuation and
    # HG in-scattering run along every interior path segment.
    sigma_a: tuple = (0.0, 0.0, 0.0)
    sigma_s: float = 0.0
    medium_g: float = 0.0
    # Sampled glossy (modified Phong) surface: checked before the
    # reference flag chain because the reference has no such capability
    # (its Phong terms are Whitted-only, src/brdf.py:12-48); energy
    # conservation needs color.diffuse + color.specular <= 1 per channel.
    is_glossy: bool = False

    @property
    def bsdf(self) -> int:
        if self.is_glossy:
            return BSDF_GLOSSY
        if self.is_diffuse:
            return BSDF_DIFFUSE
        if self.is_mirror:
            return BSDF_MIRROR
        if self.transmission > 0.0:
            return BSDF_TRANSMISSIVE
        return BSDF_NONE


@struct.dataclass
class MaterialTable:
    """Device-side SoA material table; one row per distinct material."""

    ambient: np.ndarray  # (M, 3)
    diffuse: np.ndarray  # (M, 3)
    specular: np.ndarray  # (M, 3)
    shininess: np.ndarray  # (M,)
    reflection: np.ndarray  # (M,)
    ior: np.ndarray  # (M,)
    emission: np.ndarray  # (M,)
    emission_rgb: np.ndarray  # (M, 3) emitted radiance = emission * tint
    transmission: np.ndarray  # (M,)
    bsdf: np.ndarray  # (M,) int32 BSDF code
    sigma_a: np.ndarray  # (M, 3) interior RGB absorption coefficient
    sigma_s: np.ndarray  # (M,) interior scattering coefficient
    medium_g: np.ndarray  # (M,) interior HG anisotropy

    @staticmethod
    def build(materials: Sequence[Material], dtype=np.float32) -> "MaterialTable":
        def arr(f):
            return jnp.asarray(
                np.asarray([f(m) for m in materials], dtype=dtype)
            )

        return MaterialTable(
            ambient=arr(lambda m: m.color.ambient),
            diffuse=arr(lambda m: m.color.diffuse),
            specular=arr(lambda m: m.color.specular),
            shininess=arr(lambda m: m.shininess),
            reflection=arr(lambda m: m.reflection),
            ior=arr(lambda m: m.ior),
            emission=arr(lambda m: m.emission),
            emission_rgb=arr(
                lambda m: tuple(m.emission * c for c in m.emission_color)),
            transmission=arr(lambda m: m.transmission),
            bsdf=jnp.asarray([m.bsdf for m in materials], dtype=jnp.int32),
            sigma_a=arr(lambda m: m.sigma_a),
            sigma_s=arr(lambda m: m.sigma_s),
            medium_g=arr(lambda m: m.medium_g),
        )

    @property
    def num(self) -> int:
        return self.bsdf.shape[0]


class _Presets:
    """Named colors/materials mirroring the reference palette
    (src/constants.py:27-85)."""

    WHITE = Color.of((1, 1, 1), (1, 1, 1), (1, 1, 1))
    WHITE_2 = Color.of((0, 0, 0), (0.55, 0.55, 0.55), (0.7, 0.7, 0.7))
    RED = Color.of((0.1, 0, 0), (0.7, 0, 0), (1, 1, 1))
    PURPLE = Color.of((0.1, 0, 0.1), (0.7, 0, 0.7), (1, 1, 1))
    YELLOW = Color.of((0.05, 0.05, 0.0), (0.5, 0.5, 0.4), (0.7, 0.7, 0.04))
    SILVER = Color.of(
        (0.23125,) * 3, (0.2775,) * 3, (0.773911,) * 3
    )
    GREEN = Color.of((0, 0.1, 0), (0, 0.6, 0), (1, 1, 1))
    GREY = Color.of((0.1, 0.1, 0.1), (0.6, 0.6, 0.6), (1, 1, 1))
    TURQUOISE = Color.of(
        (0.1, 0.18725, 0.1745),
        (0.396, 0.74151, 0.69102),
        (0.297254, 0.30829, 0.306678),
    )
    BRONZE = Color.of(
        (0.2125, 0.1275, 0.054),
        (0.714, 0.4284, 0.18144),
        (0.393548, 0.271906, 0.166721),
    )
    GLASS = Color.of(
        (0.0, 0.0, 0.0), (0.588235, 0.670588, 0.729412), (0.9, 0.9, 0.9)
    )

    TURQUOISE_MAT = Material(color=TURQUOISE, shininess=0.1, reflection=2, ior=1.65)
    BRONZE_MAT = Material(
        color=PURPLE, shininess=10, reflection=0.75, ior=1.180,
        transmission=1.0, is_diffuse=False, is_mirror=True,
    )
    GLASS_MAT = Material(
        color=GLASS, shininess=96, reflection=0.2, ior=1.5,
        transmission=1.0, is_diffuse=False, is_mirror=False,
    )
    # sampled glossy (this framework's extension — the reference keeps
    # Phong terms Whitted-only, src/brdf.py:12-48); kd + ks <= 1
    GLOSSY_MAT = Material(
        color=Color.of((0.0, 0.0, 0.0), (0.25, 0.25, 0.30),
                       (0.65, 0.65, 0.60)),
        shininess=40.0, is_diffuse=False, is_glossy=True,
    )


presets = _Presets()
