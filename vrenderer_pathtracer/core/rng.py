"""Counter-based RNG for sharding-invariant, reproducible path tracing.

The reference seeds a per-pixel hash RNG from ``(x*frame, y*time_ms)``
(``cuda/src/PathTracer.cu:816-818,574-580``) — wall-clock seeded and therefore
*not* reproducible.  This design replaces it with a pure
counter-based Threefry-2x32 generator evaluated element-wise:
every uniform draw is a pure function of ``(pixel_id, stream)`` where the
stream packs (frame, sample, bounce, draw-slot).  Images are therefore
bitwise identical regardless of how rays are sharded across devices, which is
what makes the multi-host scaling tests meaningful.

Threefry-2x32 follows Salmon et al., "Parallel random numbers: as easy as
1, 2, 3" (SC'11) — 20 rounds, rotation schedule (13,15,26,6 / 17,29,16,24),
key-schedule constant 0x1BD11BDA.
"""

from __future__ import annotations

import jax.numpy as jnp

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl32(x, r):
    return (x << r) | (x >> (32 - r))


def threefry2x32(key0, key1, x0, x1):
    """Threefry-2x32 block cipher: 2 uint32 counter words -> 2 uint32 outputs.

    All arguments broadcast element-wise; dtype must be uint32.
    """
    ks0 = key0
    ks1 = key1
    ks2 = jnp.uint32(_PARITY) ^ key0 ^ key1

    x0 = x0 + ks0
    x1 = x1 + ks1

    def four_rounds(x0, x1, rots):
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl32(x1, r)
            x1 = x0 ^ x1
        return x0, x1

    # 20 rounds = 5 groups of 4, alternating rotation schedules, with a key
    # injection after each group.
    x0, x1 = four_rounds(x0, x1, _ROTATIONS[0])
    x0, x1 = x0 + ks1, x1 + ks2 + jnp.uint32(1)
    x0, x1 = four_rounds(x0, x1, _ROTATIONS[1])
    x0, x1 = x0 + ks2, x1 + ks0 + jnp.uint32(2)
    x0, x1 = four_rounds(x0, x1, _ROTATIONS[0])
    x0, x1 = x0 + ks0, x1 + ks1 + jnp.uint32(3)
    x0, x1 = four_rounds(x0, x1, _ROTATIONS[1])
    x0, x1 = x0 + ks1, x1 + ks2 + jnp.uint32(4)
    x0, x1 = four_rounds(x0, x1, _ROTATIONS[0])
    x0, x1 = x0 + ks2, x1 + ks0 + jnp.uint32(5)
    return x0, x1


def _bits_to_unit_float(bits):
    """uint32 -> float32 uniform in [0, 1) using the top 24 bits."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2.0 ** -24)


# Odd multiplier (2^32 / golden ratio) spreading sample ids across the key
# space: sample -> key salt is a bijection on uint32, so no two sample ids
# ever share a stream regardless of spp or shard offsets.
_SAMPLE_KEY_MULT = 0x9E3779B9


def uniform2(seed: int, pixel_ids, stream):
    """Two independent U[0,1) draws per element.

    ``pixel_ids`` — int32/uint32 array of ray identities (any shape).
    ``stream``    — ``(counter_salt, key_salt)`` pair from :func:`make_stream`
    (scalars or arrays); distinct streams give independent draws.
    """
    pixel_ids = pixel_ids.astype(jnp.uint32)
    counter_salt, key_salt = stream
    counter_salt = jnp.asarray(counter_salt, jnp.uint32)
    k0 = jnp.uint32(seed & 0xFFFFFFFF) ^ jnp.asarray(key_salt, jnp.uint32)
    k1 = jnp.uint32((seed >> 32) & 0xFFFFFFFF)
    b0, b1 = threefry2x32(
        k0, k1, pixel_ids, jnp.broadcast_to(counter_salt, pixel_ids.shape)
    )
    return _bits_to_unit_float(b0), _bits_to_unit_float(b1)


def make_stream(frame, sample, bounce, slot):
    """Derive the (counter_salt, key_salt) pair for one draw stream.

    Counter word: frame in bits 7.., bounce (5 bits), slot (2 bits) — these
    are all bounded, so the packing never overlaps (frames up to 2^25).
    The UNBOUNDED axis — the sample id, which grows with spp and with
    sample-shard offsets — perturbs the threefry *key* instead (multiplied
    into the full 32-bit key space), so 1024+ spp and shard offsets can
    never collide with frame bits.  Round-1 packed sample into 10 counter
    bits, which overflowed into the frame field at exactly 1024 spp.
    """
    frame = jnp.asarray(frame, jnp.uint32)
    sample = jnp.asarray(sample, jnp.uint32)
    counter_salt = (
        (frame << jnp.uint32(7))
        ^ (jnp.uint32(bounce) << jnp.uint32(2))
        ^ jnp.uint32(slot)
    )
    key_salt = sample * jnp.uint32(_SAMPLE_KEY_MULT)
    return counter_salt, key_salt
