"""Lat-long HDRI environment sampling, differentiable w.r.t. the map.

Re-derivation of the miss shader (``cuda/src/PathTracer.cu:632-647``):
``u = atan2(d.x, d.z)`` wrapped to [0,2pi) then /2pi; ``v = acos(d.y)/pi``;
nearest-texel fetch with a flat-index clamp; radiance contribution is
``mask * 2 * hdr[addr]``.

Two fetch modes:

* ``nearest`` — bit-parity with the reference (needed for allclose tests);
  gradients w.r.t. the env map flow through the gather (scatter-add in bwd).
* ``bilinear`` — smooth in *direction* as well, used when optimising the env
  map so d(pixel)/d(texel) is piecewise-linear instead of piecewise-constant.
"""

from __future__ import annotations

import jax.numpy as jnp

from vrenderer_pathtracer.ops.texture import gather_rows

ENV_SCALE = 2.0  # reference multiplies HDR radiance by 2 (PathTracer.cu:645)


def direction_to_latlong(ray_d):
    """[B,3] directions -> (u,v) in [0,1)x[0,1]."""
    u = jnp.arctan2(ray_d[:, 0], ray_d[:, 2])
    u = jnp.where(u < 0.0, u + 2.0 * jnp.pi, u) / (2.0 * jnp.pi)
    v = jnp.arccos(jnp.clip(ray_d[:, 1], -1.0, 1.0)) / jnp.pi
    return u, v


def sample_env_nearest(hdr, ray_d):
    """Reference-parity nearest fetch. hdr [H,W,3], ray_d [B,3] -> [B,3]."""
    height, width = hdr.shape[0], hdr.shape[1]
    u, v = direction_to_latlong(ray_d)
    x = (u * width).astype(jnp.int32)
    y = (v * height).astype(jnp.int32)
    addr = jnp.clip(x + y * width, 0, width * height - 1)
    return gather_rows(hdr.reshape(-1, 3), addr) * ENV_SCALE


def sample_env_bilinear(hdr, ray_d):
    """Bilinear fetch (wraps in u, clamps in v) for smooth env-map gradients."""
    height, width = hdr.shape[0], hdr.shape[1]
    u, v = direction_to_latlong(ray_d)
    fx = u * width - 0.5
    fy = v * height - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    wx = (fx - x0)[:, None]
    wy = (fy - y0)[:, None]
    x1 = (x0 + 1) % width
    x0 = x0 % width
    y1 = jnp.clip(y0 + 1, 0, height - 1)
    y0 = jnp.clip(y0, 0, height - 1)
    flat = hdr.reshape(-1, 3)
    c00 = gather_rows(flat, x0 + y0 * width)
    c10 = gather_rows(flat, x1 + y0 * width)
    c01 = gather_rows(flat, x0 + y1 * width)
    c11 = gather_rows(flat, x1 + y1 * width)
    top = c00 * (1 - wx) + c10 * wx
    bot = c01 * (1 - wx) + c11 * wx
    return (top * (1 - wy) + bot * wy) * ENV_SCALE
