"""Unit tests for the table-fetch helpers added in round 4
(ops/texture.py gather_rows / fetch_maps): the combined-map gather must
be bitwise-identical to per-map fetches in every configuration, and the
wide-row pad must not change values or break on big tables."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vrenderer_pathtracer.ops import texture as tex_ops


def _maps(rng, shapes):
    return [jnp.asarray(rng.uniform(0, 2, s + (3,)).astype(np.float32))
            for s in shapes]


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_fetch_maps_matches_individual_fetches(mode):
    rng = np.random.default_rng(0)
    maps = _maps(rng, [(16, 24), (16, 24), (16, 24)])
    u = jnp.asarray(rng.uniform(-0.2, 1.2, 257).astype(np.float32))
    v = jnp.asarray(rng.uniform(-0.2, 1.2, 257).astype(np.float32))
    fetch = (tex_ops.fetch_bilinear if mode == "bilinear"
             else tex_ops.fetch_nearest)
    combined = tex_ops.fetch_maps(maps, u, v, mode)
    for m, c in zip(maps, combined):
        np.testing.assert_array_equal(np.asarray(c), np.asarray(fetch(m, u, v)))


def test_fetch_maps_handles_none_and_mixed_resolutions():
    rng = np.random.default_rng(1)
    a, b = _maps(rng, [(8, 8), (16, 16)])  # different resolutions
    u = jnp.asarray(rng.uniform(0, 1, 64).astype(np.float32))
    v = jnp.asarray(rng.uniform(0, 1, 64).astype(np.float32))
    out = tex_ops.fetch_maps([a, None, b], u, v, "nearest")
    assert out[1] is None
    np.testing.assert_array_equal(
        np.asarray(out[0]), np.asarray(tex_ops.fetch_nearest(a, u, v)))
    np.testing.assert_array_equal(
        np.asarray(out[2]), np.asarray(tex_ops.fetch_nearest(b, u, v)))
    assert tex_ops.fetch_maps([None, None, None], u, v, "nearest") == \
        [None, None, None]


def test_gather_rows_wide_and_fallback_paths_agree():
    rng = np.random.default_rng(2)
    idx = jnp.asarray(rng.integers(0, 100, 300).astype(np.int32))
    small = jnp.asarray(rng.uniform(0, 1, (100, 3)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(tex_ops.gather_rows(small, idx)),
        np.asarray(small)[np.asarray(idx)])
    # Big-table fallback (rows > _WIDE_MAX_ROWS) takes the plain path.
    nbig = tex_ops._WIDE_MAX_ROWS + 7
    big = jnp.asarray(
        np.arange(nbig * 2, dtype=np.float32).reshape(nbig, 2))
    idx2 = jnp.asarray([0, 7, nbig - 1], jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(tex_ops.gather_rows(big, idx2)),
        np.asarray(big)[np.asarray(idx2)])


def test_gather_rows_table_gradients_flow():
    """Texture training relies on grads flowing through the padded gather
    (scatter-add in the backward)."""
    t = jnp.ones((10, 3))
    idx = jnp.asarray([1, 1, 4], jnp.int32)

    g = jax.grad(lambda tt: tex_ops.gather_rows(tt, idx).sum())(t)
    expect = np.zeros((10, 3))
    expect[1] = 2.0
    expect[4] = 1.0
    np.testing.assert_array_equal(np.asarray(g), expect)
