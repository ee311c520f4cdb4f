"""MERL measured-BRDF importance sampling (tabulated half-angle CDF).

The reference samples measured BRDFs with a plain cosine hemisphere draw and
weights by ``24 * lookup`` (``/root/reference/cuda/src/PathTracer.cu:724-764``)
— glossy MERL materials (narrow ``theta_h`` lobes) therefore converge at
cosine-sampling variance.  This module adds the BASELINE north-star
"BRDF importance sampling": a tabulated inverse-CDF over the half-angle
``theta_h`` marginal of the measured lobe, mixed 50/50 with the cosine
strategy under the one-sample MIS balance heuristic.

Design (vectorized):

* The sampler is 90 numbers — the luminance mass of each MERL ``theta_h``
  bin (the table's own sqrt-warped binning, ops/brdf.py) times the bin's
  solid angle — normalised into a CDF.  Sampling is one ``searchsorted``
  over 90 entries plus elementwise math: no gathers wider than the lane
  batch, nothing data-dependent in control flow.
* A half-vector ``H`` is drawn with ``cos(theta_h)`` uniform inside the
  chosen bin and uniform azimuth, then reflected: ``out = 2(wi.H)H - wi``.
  The change of variables contributes the standard ``1/(4 wi.H)`` Jacobian.
* Estimator: ``(24/pi) * f * cos / p_mix`` with
  ``p_mix = 0.5 p_lobe + 0.5 p_cos`` — the same integral the reference's
  cosine estimator converges to (``E_cos[24 f] = (24/pi) int f cos``), so
  the two strategies produce the same image in the limit and differ only in
  variance.
* Detached-PDF convention (matching the repo's discrete-event rules): the
  CDF is built from ``stop_gradient(table)`` and every pdf factor is
  detached, so gradients w.r.t. the table flow only through the
  differentiable ``lookup_brdf`` factor — exactly the cosine path's
  gradient semantics.
* Half-vectors below the horizon or reflections into the surface get zero
  contribution (``cos <= 0`` clamps them) instead of a resample — unbiased,
  branch-free, and the lane keeps a well-defined (if wasted) continuation
  ray.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vrenderer_pathtracer.ops.brdf import (
    CHANNEL_SCALE, RES_PHI_D, RES_THETA_D, RES_THETA_H, lookup_brdf,
)

# theta_h bin edges under the MERL sqrt warp: bin i covers
# [ (i/90)^2, ((i+1)/90)^2 ] * pi/2  (ops/brdf.py idx_th inverse).
_THETA_EDGES = (np.arange(RES_THETA_H + 1, dtype=np.float64) / RES_THETA_H) ** 2 * (np.pi / 2)
_COS_EDGES = np.cos(_THETA_EDGES).astype(np.float32)          # [91], 1 -> 0
_BIN_DOMEGA = (2.0 * np.pi * (_COS_EDGES[:-1] - _COS_EDGES[1:])).astype(np.float32)

_MIX_Q = 0.5  # probability of drawing from the lobe strategy


class MerlSampler(NamedTuple):
    """Tabulated theta_h sampler for one MERL table (all leaves detached)."""

    mass: jnp.ndarray  # [90] per-bin probability mass (sums to 1)
    cdf: jnp.ndarray   # [90] inclusive cumulative mass


def build_merl_sampler(table) -> MerlSampler:
    """Build the half-angle CDF from a ``[3, TABLE_SIZE]`` MERL table.

    The target is the ``theta_h`` marginal of ``luminance(f)``: per-bin mean
    luminance (over ``theta_d`` x ``phi_d`` and channels, with the MERL
    channel scales) times the bin's half-vector solid angle.  A small floor
    keeps every bin sampleable (the cosine half of the mixture already
    guarantees estimator support; the floor is purely numerical).
    """
    table = jax.lax.stop_gradient(table)
    t = jnp.maximum(table, 0.0).reshape(3, RES_THETA_H, RES_THETA_D * RES_PHI_D)
    scale = jnp.asarray(CHANNEL_SCALE)[:, None, None]
    lum = jnp.mean(t * scale, axis=(0, 2))             # [90]
    mass = lum * jnp.asarray(_BIN_DOMEGA)
    mass = mass + 1e-4 * jnp.max(mass) + 1e-20
    mass = mass / jnp.sum(mass)
    return MerlSampler(mass=mass, cdf=jnp.cumsum(mass))


def _frame(normal):
    """Orthonormal frame about ``normal`` (cosine_hemisphere's construction)."""
    w = normal
    flip = jnp.abs(w[:, 0]) > 0.1
    axis = jnp.where(
        flip[:, None],
        jnp.array([0.0, 1.0, 0.0], w.dtype)[None, :],
        jnp.array([1.0, 0.0, 0.0], w.dtype)[None, :],
    )
    u = jnp.cross(axis, w)
    u = u / jnp.maximum(jnp.linalg.norm(u, axis=-1, keepdims=True), 1e-20)
    v = jnp.cross(w, u)
    return u, v, w


def _theta_h_bin(cos_th):
    """MERL theta_h bin index from cos(theta_h) (the lookup's own warp)."""
    th = jnp.arccos(jnp.clip(cos_th, 0.0, 1.0))
    idx = (jnp.sqrt(th * (2.0 / np.pi)) * RES_THETA_H).astype(jnp.int32)
    return jnp.clip(idx, 0, RES_THETA_H - 1)


def sample_lobe(sampler: MerlSampler, ray_d, normal, u_bin, u_cos, u_phi):
    """Draw scattered directions from the half-angle lobe strategy.

    Returns ``out [B,3]`` (unit, possibly below the horizon — contributions
    there are zeroed by the ``cos`` clamp in the estimator).
    """
    cos_e = jnp.asarray(_COS_EDGES)
    idx = jnp.clip(
        jnp.searchsorted(sampler.cdf, u_bin, side="right"), 0, RES_THETA_H - 1)
    c_lo = cos_e[idx]
    c_hi = cos_e[idx + 1]
    cos_th = c_lo - u_cos * (c_lo - c_hi)              # uniform in cos inside bin
    sin_th = jnp.sqrt(jnp.maximum(1.0 - cos_th * cos_th, 0.0))
    phi = 2.0 * np.pi * u_phi

    u, v, w = _frame(normal)
    h = (u * (jnp.cos(phi) * sin_th)[:, None]
         + v * (jnp.sin(phi) * sin_th)[:, None]
         + w * cos_th[:, None])
    wi = -ray_d
    wi_h = jnp.sum(wi * h, axis=-1, keepdims=True)
    out = 2.0 * wi_h * h - wi
    out = out / jnp.maximum(jnp.linalg.norm(out, axis=-1, keepdims=True), 1e-20)
    return out


def pdf_lobe(sampler: MerlSampler, ray_d, normal, out):
    """Solid-angle pdf of ``out`` under the lobe strategy (detached)."""
    wi = -ray_d
    h = wi + out
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-20)
    # The preimage of ``out`` under H -> 2(wi.H)H - wi is +-normalize(wi+out);
    # sample_lobe only ever draws UPPER-hemisphere half-vectors (including
    # ones with wi.H < 0, whose wi+out points along -H), so fold to the
    # upper preimage before binning.
    cos_th = jnp.sum(normal * h, axis=-1)
    h = jnp.where(cos_th[:, None] < 0.0, -h, h)
    cos_th = jnp.abs(cos_th)
    idx = _theta_h_bin(cos_th)
    dom = jnp.asarray(_BIN_DOMEGA)[idx]
    p_h = sampler.mass[idx] / dom
    wi_h = jnp.abs(jnp.sum(wi * h, axis=-1))
    p = p_h / jnp.maximum(4.0 * wi_h, 1e-6)
    return jax.lax.stop_gradient(p)


def pdf_cosine(normal, out):
    """Solid-angle pdf of the cosine strategy (detached)."""
    c = jnp.sum(normal * out, axis=-1)
    return jax.lax.stop_gradient(jnp.maximum(c, 0.0) / np.pi)


def sample_brdf_mis(sampler: MerlSampler, table, ray_d, normal, tangent,
                    cos_dir, u_select, u_bin, u_cos, u_phi):
    """One-sample MIS between the lobe and cosine strategies.

    ``cos_dir`` is the already-drawn cosine-hemisphere direction (shared with
    the diffuse path, ops/shading.py); lanes with ``u_select < q`` replace it
    with a lobe draw.  Returns ``(new_dir [B,3], weight [B,3])`` where weight
    is the full throughput multiplier ``(24/pi) f cos / p_mix`` — the same
    integral as the reference's cosine estimator, at lobe-aware variance.
    """
    lobe_dir = sample_lobe(sampler, ray_d, normal, u_bin, u_cos, u_phi)
    take_lobe = (u_select < _MIX_Q)[:, None]
    new_dir = jnp.where(take_lobe, lobe_dir, cos_dir)

    p_mix = (_MIX_Q * pdf_lobe(sampler, ray_d, normal, new_dir)
             + (1.0 - _MIX_Q) * pdf_cosine(normal, new_dir))
    cos_o = jnp.maximum(jnp.sum(normal * new_dir, axis=-1), 0.0)
    f = jnp.maximum(lookup_brdf(table, new_dir, ray_d, normal, tangent), 0.0)
    w = (24.0 / np.pi) * f * (cos_o / jnp.maximum(p_mix, 1e-8))[:, None]
    # Zero-pdf lanes (numerically possible at exact grazing) contribute 0.
    w = jnp.where((p_mix > 0.0)[:, None], w, 0.0)
    return new_dir, w
