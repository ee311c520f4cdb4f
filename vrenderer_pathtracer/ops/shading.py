"""Material scattering: mirror, diffuse-with-Fresnel, measured BRDF.

Re-derivation of the bounce-update logic in the reference's ``trace``
(``cuda/src/PathTracer.cu:666-764``), fully vectorized — each lane evaluates
every branch and selects with ``jnp.where`` (hit types are data, not control
flow, so XLA fuses this into one elementwise kernel):

* SPEC (type 0): pure mirror reflection, no throughput change, ray origin
  offset ``0.05 * n`` (``:671-676``).  Reference does *not* re-normalize here.
* DIFF (type 1): stochastic Fresnel mix (``:678-722``) —
  ``f = lerp((1-cos)^p, 1, c) * spec_color.x``; with probability ``f`` a
  normalized mirror reflection weighted by the specular colour, otherwise a
  cosine-weighted hemisphere sample weighted by ``albedo * cos * 2``.
* BRDF (type 2): cosine hemisphere sample; with a table loaded the weight is
  ``24 * max(merl_lookup, 0)`` (the ``dw = 24 |d|^-3`` solid-angle term with
  unit d, ``:743-752``), else it degrades to the diffuse weight.

The Fresnel comparison ``u < f`` is a discrete decision.  A naively detached
decision would make d(pixel)/d(fresnel_coef) identically zero (the branch
weights don't reference ``f``), so the chosen branch's throughput is scaled by
the *ratio trick* ``p / stop_grad(p)`` — forward value unchanged (ratio == 1),
backward pass carries the score-function estimator
``d/df E[I] = E[I_spec] - E[I_diff]`` in expectation.  Hit selection remains
detached (standard differentiable-rendering convention).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vrenderer_pathtracer.ops.brdf import lookup_brdf
from vrenderer_pathtracer.scene.spheres import SPEC, DIFF, BRDF

ORIGIN_OFFSET = 0.05  # reference offsets the next ray 0.05*n off the surface


def _norm(x):
    return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-20)


def reflect(d, n):
    return d - 2.0 * jnp.sum(d * n, axis=-1, keepdims=True) * n


def cosine_hemisphere(normal, u1, u2):
    """Cosine-weighted direction about ``normal`` from two uniforms.

    Matches the reference's frame construction (``:689-711``): the frame axis
    flips on |n.x| > 0.1, rand1 = 2*pi*u1 is the azimuth, sqrt(u2) the radius.
    """
    w = normal
    flip = jnp.abs(w[:, 0]) > 0.1
    axis = jnp.where(
        flip[:, None],
        jnp.array([0.0, 1.0, 0.0], w.dtype)[None, :],
        jnp.array([1.0, 0.0, 0.0], w.dtype)[None, :],
    )
    u = _norm(jnp.cross(axis, w))
    v = jnp.cross(w, u)
    phi = 2.0 * jnp.pi * u1
    r = jnp.sqrt(u2)
    d = (
        u * (jnp.cos(phi) * r)[:, None]
        + v * (jnp.sin(phi) * r)[:, None]
        + w * jnp.sqrt(jnp.maximum(1.0 - u2, 0.0))[:, None]
    )
    return _norm(d)


def scatter(
    ray_d,
    normal,
    tangent,
    color,
    spec_color,
    hit_type,
    u_reflect,
    u_phi,
    u_r,
    fresnel_coef,
    fresnel_pow,
    brdf_table=None,
    brdf_sampler=None,
    u_b1=None,
    u_b2=None,
):
    """One bounce of material interaction for a [B] lane batch.

    Returns ``(new_dir [B,3], mask_mult [B,3])``; the caller moves the origin
    to ``hit + ORIGIN_OFFSET * normal`` and multiplies throughput by
    ``mask_mult``.

    With ``brdf_sampler`` (ops/brdf_sampling.py) and two extra uniforms, BRDF
    lanes use one-sample MIS between the measured lobe and the cosine
    strategy instead of plain cosine sampling — same limit image, lower
    variance on glossy tables.  ``u_reflect`` doubles as the strategy
    selector on BRDF lanes (it is only consumed by DIFF lanes otherwise) and
    ``u_phi`` as the lobe azimuth (each lane takes exactly one branch).
    """
    mirror_dir = reflect(ray_d, normal)          # SPEC: not normalized (parity)
    fresnel_dir = _norm(mirror_dir)              # DIFF specular: normalized
    cos_dir = cosine_hemisphere(normal, u_phi, u_r)

    # --- DIFF: Fresnel estimate and branch weights -------------------------
    aoi = jnp.sum(normal * (-ray_d), axis=-1)
    grazing = jnp.power(jnp.maximum(1.0 - aoi, 0.0), fresnel_pow)
    fresnel = (grazing * (1.0 - fresnel_coef) + fresnel_coef) * spec_color[:, 0]
    take_reflect = u_reflect < fresnel

    # Ratio trick: value-preserving, gradient-carrying branch weights.
    p = jnp.clip(fresnel, 1e-6, 1.0 - 1e-6)
    w_reflect = p / jax.lax.stop_gradient(p)
    w_diffuse = (1.0 - p) / jax.lax.stop_gradient(1.0 - p)

    diffuse_weight = color * (jnp.sum(cos_dir * normal, axis=-1) * 2.0)[:, None]
    diff_dir = jnp.where(take_reflect[:, None], fresnel_dir, cos_dir)
    diff_mult = jnp.where(
        take_reflect[:, None],
        spec_color * w_reflect[:, None],
        diffuse_weight * w_diffuse[:, None],
    )

    # --- BRDF: measured reflectance about a cosine sample ------------------
    brdf_dir = cos_dir
    if brdf_table is not None and brdf_sampler is not None:
        from vrenderer_pathtracer.ops.brdf_sampling import sample_brdf_mis

        brdf_dir, brdf_mult = sample_brdf_mis(
            brdf_sampler, brdf_table, ray_d, normal, tangent, cos_dir,
            u_reflect, u_b1, u_b2, u_phi,
        )
    elif brdf_table is not None:
        brdf_val = lookup_brdf(brdf_table, cos_dir, ray_d, normal, tangent)
        brdf_mult = 24.0 * jnp.maximum(brdf_val, 0.0)
    else:
        brdf_mult = diffuse_weight

    is_spec = (hit_type == SPEC)[:, None]
    is_brdf = (hit_type == BRDF)[:, None]
    new_dir = jnp.where(is_spec, mirror_dir, jnp.where(is_brdf, brdf_dir, diff_dir))
    mask_mult = jnp.where(
        is_spec, jnp.ones_like(diff_mult), jnp.where(is_brdf, brdf_mult, diff_mult)
    )
    return new_dir, mask_mult
