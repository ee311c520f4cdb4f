"""Threefry-2x32 correctness: known-answer vectors + JAX/NumPy cross-check."""

import numpy as np
import jax.numpy as jnp

from vrenderer_pathtracer.core import rng
from tests import reference_tracer as ref

# Known-answer tests from the Random123 distribution (threefry2x32, 20 rounds):
# (key0, key1, ctr0, ctr1) -> (out0, out1)
KAT = [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]


def test_threefry_kat_jax():
    for (k0, k1), (c0, c1), (e0, e1) in KAT:
        o0, o1 = rng.threefry2x32(
            jnp.uint32(k0), jnp.uint32(k1), jnp.uint32(c0), jnp.uint32(c1)
        )
        assert int(o0) == e0 and int(o1) == e1


def test_threefry_kat_numpy_reference():
    for (k0, k1), (c0, c1), (e0, e1) in KAT:
        o0, o1 = ref.threefry2x32_scalar(k0, k1, c0, c1)
        assert o0 == e0 and o1 == e1


def test_uniform2_matches_reference():
    ids = jnp.arange(64, dtype=jnp.uint32)
    stream = rng.make_stream(jnp.uint32(3), jnp.uint32(1), 2, 1)
    a, b = rng.uniform2(12345, ids, stream)
    exp = np.array([ref.uniform2(12345, i, ref.make_stream(3, 1, 2, 1)) for i in range(64)])
    np.testing.assert_array_equal(np.asarray(a), exp[:, 0].astype(np.float32))
    np.testing.assert_array_equal(np.asarray(b), exp[:, 1].astype(np.float32))


def test_uniform_range_and_spread():
    ids = jnp.arange(4096, dtype=jnp.uint32)
    a, b = rng.uniform2(0, ids, rng.make_stream(jnp.uint32(1), jnp.uint32(0), 0, 0))
    for u in (np.asarray(a), np.asarray(b)):
        assert (u >= 0).all() and (u < 1).all()
        assert abs(u.mean() - 0.5) < 0.02
        assert abs(u.std() - np.sqrt(1 / 12)) < 0.02


def test_streams_are_independent():
    ids = jnp.arange(1024, dtype=jnp.uint32)
    a, _ = rng.uniform2(0, ids, rng.make_stream(jnp.uint32(1), jnp.uint32(0), 0, 0))
    c, _ = rng.uniform2(0, ids, rng.make_stream(jnp.uint32(1), jnp.uint32(0), 1, 0))
    corr = np.corrcoef(np.asarray(a), np.asarray(c))[0, 1]
    assert abs(corr) < 0.1


def test_no_stream_collisions_at_high_sample_ids():
    """Round-1 bug: sample packed into 10 counter bits collided with frame
    bits at exactly 1024 spp (sample<<7 carried into frame<<17).  The key-salt
    scheme must keep every (frame, sample, bounce, slot) distinct."""
    seen = {}
    for frame in (1, 2, 1 << 20):
        for sample in (0, 1, 1023, 1024, 1025, 2048, 4095, 100_000):
            for bounce in (0, 4, 31):
                for slot in (0, 1):
                    key = ref.make_stream(frame, sample, bounce, slot)
                    assert key not in seen, (
                        f"collision: {(frame, sample, bounce, slot)} vs "
                        f"{seen[key]}")
                    seen[key] = (frame, sample, bounce, slot)


def test_high_spp_draws_stay_decorrelated():
    """Draws at sample 0 vs sample 1024 (the round-1 collision pair with
    frame 1) must now be independent streams."""
    ids = jnp.arange(2048, dtype=jnp.uint32)
    a, _ = rng.uniform2(0, ids, rng.make_stream(jnp.uint32(1), jnp.uint32(0), 0, 0))
    b, _ = rng.uniform2(0, ids, rng.make_stream(jnp.uint32(0), jnp.uint32(1024), 0, 0))
    assert not np.array_equal(np.asarray(a), np.asarray(b))
    corr = np.corrcoef(np.asarray(a), np.asarray(b))[0, 1]
    assert abs(corr) < 0.1
