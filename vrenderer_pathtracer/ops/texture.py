"""Surface texture fetches (diffuse / normal / specular maps).

Reference semantics (``cuda/src/PathTracer.cu:396-448``): integer texel
coordinates ``x = W*u``, ``y = H*v`` with a clamped flat index — i.e. nearest
fetch with *wrap-by-overflow* folded into the clamp.  ``fetch_nearest``
reproduces that exactly; ``fetch_bilinear`` is the differentiable variant used
for texture optimisation.

The v-flip (``1 - v``) the reference applies at mesh-load time
(``src/MeshLoader.cpp``) is an asset-pipeline concern handled by the loader,
not here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Pad narrow row gathers to this many lanes, as the mesh attribute gather
# in accel/traverse.py shade_mesh_hit does, for every small-table fetch
# (textures, env map, MERL).  Kept from the design's first target; whether
# the padding helps on a GPU is not measured yet.
_WIDE_LANES = 64
# Padding multiplies table memory by 64/C; skip it for big tables where the
# padded copy would not amortize (> ~128 MB padded).
_WIDE_MAX_ROWS = 512 * 1024


def gather_rows(flat, addr):
    """``flat [N,C]`` row gather at ``addr [B]``, padded to ``_WIDE_LANES``
    lanes.  Barriers on BOTH sides keep XLA from re-narrowing the gather
    (input: pad commutes out of gather; output: consumer slices push
    through)."""
    n, c = flat.shape
    if c >= _WIDE_LANES or n > _WIDE_MAX_ROWS:
        return flat[addr]
    wide = jnp.pad(flat, ((0, 0), (0, _WIDE_LANES - c)))
    wide = jax.lax.optimization_barrier(wide)
    rows = jax.lax.optimization_barrier(wide[addr])
    return rows[:, :c]


def fetch_nearest(tex, u, v):
    """tex [H,W,C]; u,v [B] -> [B,C] (reference-parity integer fetch)."""
    height, width, c = tex.shape
    x = (u * width).astype(jnp.int32)
    y = (v * height).astype(jnp.int32)
    addr = jnp.clip(x + y * width, 0, width * height - 1)
    return gather_rows(tex.reshape(-1, c), addr)


def fetch_maps(maps, u, v, filter_mode):
    """Fetch several maps at the SAME (u, v) with one combined gather.

    Fetching diffuse+normal+specular as one [B,9] gather issues a third
    of the row reads of three [B,3] gathers.  ``maps`` is a
    list of [H,W,3]-or-None; same-resolution present maps are fetched
    through a channel-concatenated table (bitwise-identical rows), the
    rest individually.  Returns a list aligned with ``maps`` (None where
    the input was None).
    """
    fetch = fetch_bilinear if filter_mode == "bilinear" else fetch_nearest
    live = [(i, m) for i, m in enumerate(maps) if m is not None]
    out = [None] * len(maps)
    shapes = {m.shape[:2] for _, m in live}
    if len(live) <= 1 or len(shapes) != 1:
        for i, m in live:
            out[i] = fetch(m, u, v)
        return out
    combined = jnp.concatenate([m for _, m in live], axis=2)
    texc = fetch(combined, u, v)
    # Split by each map's OWN channel count (cum-sum of live widths), so a
    # non-3-channel map (e.g. a scalar roughness map) reads its own lanes
    # rather than a neighbor's.
    off = 0
    for i, m in live:
        out[i] = texc[:, off:off + m.shape[2]]
        off += m.shape[2]
    return out


def fetch_bilinear(tex, u, v):
    """Clamped bilinear fetch ([H,W,C]) for smooth texture gradients."""
    height, width = tex.shape[0], tex.shape[1]
    fx = u * width - 0.5
    fy = v * height - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    wx = (fx - x0)[:, None]
    wy = (fy - y0)[:, None]
    x0c = jnp.clip(x0, 0, width - 1)
    x1c = jnp.clip(x0 + 1, 0, width - 1)
    y0c = jnp.clip(y0, 0, height - 1)
    y1c = jnp.clip(y0 + 1, 0, height - 1)
    flat = tex.reshape(-1, tex.shape[2])
    c00 = gather_rows(flat, x0c + y0c * width)
    c10 = gather_rows(flat, x1c + y0c * width)
    c01 = gather_rows(flat, x0c + y1c * width)
    c11 = gather_rows(flat, x1c + y1c * width)
    top = c00 * (1 - wx) + c10 * wx
    bot = c01 * (1 - wx) + c11 * wx
    return top * (1 - wy) + bot * wy


def decode_normal_map(texel):
    """Remap a normal-map texel to [-1,1] and normalize (PathTracer.cu:425)."""
    n = 2.0 * texel - 1.0
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def apply_tbn(normal, tangent, n_tangentspace):
    """World normal = TBN * tangent-space normal (PathTracer.cu:420-428).

    normal/tangent: [B,3] unit vectors; n_tangentspace: [B,3].
    bitangent = cross(normal, tangent), columns (tangent, bitangent, normal).
    """
    bitangent = jnp.cross(normal, tangent)
    world = (
        tangent * n_tangentspace[:, 0:1]
        + bitangent * n_tangentspace[:, 1:2]
        + normal * n_tangentspace[:, 2:3]
    )
    return world / jnp.linalg.norm(world, axis=-1, keepdims=True)
