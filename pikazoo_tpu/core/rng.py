"""Draw-slot RNG subsystem.

The reference threads a single ``np.random.Generator`` through physics, AI and
serve selection, drawing *conditionally* inside data-dependent branches
(SURVEY.md section 2.3 lists every draw site).  A traced XLA program evaluates
both sides of every branch, so conditional host-style consumption cannot be
expressed directly.  Instead each potential draw site evaluates a value from a
counted stream and advances the counter only when the reference would
actually have drawn:

    value_i = threefry2x32(env_key, (counter, SITE_TAG))[0] % upper
    counter += consume_i            # masked, per environment

The observable value *sequence* therefore depends only on the sequence of
draws actually consumed — exactly the reference's semantics, with an
explicitly-specified PRF in place of PCG64.

The PRF is implemented here from the Threefry-2x32 (20 round) specification
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11) rather
than through ``jax.random``, so that every backend — the JAX kernel, the
native C++ engine (``native/pika_engine.cc``), and any future Pallas step
kernel — produces bit-identical production streams.  Cross-implementation
equality is tested.

For bitwise trajectory parity against the reference (whose PCG64 stream we
cannot cheaply reproduce on-device), ``DrawState`` supports an *oracle* mode:
``oracle[counter]`` supplies each value from a pre-recorded stream of the
reference generator's outputs (see ``pikazoo_tpu.parity``).  Counter
semantics are identical in both modes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

# Word tag distinguishing draw-site streams from key-derivation streams.
SITE_TAG = 1
FOLD_TAG = 0

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY_CONST = 0x1BD11BDA


def _rotl(x: jnp.ndarray, r: int) -> jnp.ndarray:
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def threefry2x32(key: jnp.ndarray, c0: jnp.ndarray, c1: jnp.ndarray
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Threefry-2x32, 20 rounds.  ``key`` is a (2,) uint32 array; counters are
    uint32 scalars (or broadcastable arrays).  Returns two uint32 outputs."""
    k0 = key[..., 0].astype(jnp.uint32)
    k1 = key[..., 1].astype(jnp.uint32)
    k2 = k0 ^ k1 ^ jnp.uint32(_PARITY_CONST)
    ks = (k0, k1, k2)

    x0 = c0.astype(jnp.uint32) + k0
    x1 = c1.astype(jnp.uint32) + k1

    def four_rounds(x0, x1, rots):
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        return x0, x1

    for block in range(5):
        x0, x1 = four_rounds(x0, x1, _ROTATIONS[block % 2])
        inject = block + 1
        x0 = x0 + ks[inject % 3]
        x1 = x1 + ks[(inject + 1) % 3] + jnp.uint32(inject)
    return x0, x1


def fold_key(key: jnp.ndarray, data: jnp.ndarray) -> jnp.ndarray:
    """Derive a sub-key (e.g. per-environment) from a (2,) uint32 key."""
    a, b = threefry2x32(key, jnp.asarray(data).astype(jnp.uint32),
                        jnp.uint32(FOLD_TAG))
    return jnp.stack([a, b], axis=-1)


def key_from_jax(key: jax.Array) -> jnp.ndarray:
    """Accept a typed jax PRNG key, raw uint32 key data, or an int seed."""
    if isinstance(key, jax.Array) and jnp.issubdtype(key.dtype,
                                                     jax.dtypes.prng_key):
        return jax.random.key_data(key).astype(jnp.uint32)
    arr = jnp.asarray(key)
    if arr.ndim == 0:
        return jnp.stack([jnp.uint32(0), arr.astype(jnp.uint32)])
    return arr.astype(jnp.uint32)


def site_value(key: jnp.ndarray, counter: jnp.ndarray, upper: int
               ) -> jnp.ndarray:
    """Uniform integer in [0, upper) for draw slot ``counter``.

    Modulo mapping: bias is upper/2^32 (< 5e-9 for the largest site, 20) —
    negligible, and the simplicity is what makes the C++/Pallas
    implementations trivially bit-identical."""
    bits, _ = threefry2x32(key, counter.astype(jnp.uint32),
                           jnp.uint32(SITE_TAG))
    return (bits % jnp.uint32(upper)).astype(jnp.int32)


def site_value_host(key, counter: int, upper: int) -> int:
    """Pure-Python mirror of :func:`site_value` for host-side consumers (the
    render path's coupled cloud/wave draws) — bit-identical to the traced
    version, with no device dispatch per draw.  ``key`` is any (2,)-shaped
    uint32 array-like."""
    mask = 0xFFFFFFFF
    k0 = int(key[0]) & mask
    k1 = int(key[1]) & mask
    k2 = (k0 ^ k1 ^ _PARITY_CONST) & mask
    ks = (k0, k1, k2)
    x0 = (int(counter) + k0) & mask
    x1 = (SITE_TAG + k1) & mask
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & mask
            x1 = ((x1 << r) | (x1 >> (32 - r))) & mask
            x1 ^= x0
        inject = block + 1
        x0 = (x0 + ks[inject % 3]) & mask
        x1 = (x1 + ks[(inject + 1) % 3] + inject) & mask
    return x0 % upper


class DrawState(NamedTuple):
    """Carries the RNG stream through one step: the env's (2,) uint32 key
    (constant for the step), the masked cumulative draw counter, and an
    optional oracle buffer of pre-recorded draw values."""

    key: jnp.ndarray  # (2,) uint32
    counter: jnp.ndarray  # int32
    oracle: Optional[jax.Array] = None  # (capacity,) int32 or None


def draw(ds: DrawState, consume: jnp.ndarray, upper: int) -> Tuple[jnp.ndarray, DrawState]:
    """One potential draw site: uniform integer in ``[0, upper)``.

    ``consume`` is a traced bool/int mask; the counter advances only where it
    is set, and the returned value is 0 where it is not (callers gate use of
    the value on the same condition).  ``upper`` must be static.
    """
    consume = consume.astype(jnp.bool_)
    if ds.oracle is not None:
        cap = ds.oracle.shape[-1]
        idx = jnp.clip(ds.counter, 0, cap - 1)
        value = jax.lax.dynamic_index_in_dim(ds.oracle, idx, keepdims=False)
    else:
        value = site_value(ds.key, ds.counter, upper)
    value = jnp.where(consume, value, jnp.int32(0))
    return value, ds._replace(counter=ds.counter + consume.astype(jnp.int32))
