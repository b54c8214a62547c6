"""Action decoding and edge-detected input.

The env exposes ``Discrete(18)`` actions decoded through an 18x5 key table
(reference ``pikazoo_env.py:119-141``) into (x_direction, y_direction) in
{-1,0,1} and a rising-edge power-hit bit (``PikaUserInput.get_input``,
``physics.py:59-99``).  The latch ``power_hit_key_is_down_previous`` is part
of the observation (dims 12/25) and lives in env state.

The env only ever feeds 5-wide key rows, but the reference engine also
accepts a vestigial 6th ``down_right`` key (``physics.py:78-80``, a diagonal
combo key from the original game's keyboard layout): :func:`decode_keys`
supports both widths at the engine layer.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from pikazoo_tpu.core.state import PlayerInput

# [left, right, up, down, power_hit] per discrete action 0..17.
ACTION_KEY_TABLE = (
    (0, 0, 0, 0, 0),
    (0, 0, 0, 0, 1),
    (0, 0, 1, 0, 0),
    (0, 1, 0, 0, 0),
    (1, 0, 0, 0, 0),
    (0, 0, 0, 1, 0),
    (0, 1, 1, 0, 0),
    (1, 0, 1, 0, 0),
    (0, 1, 0, 1, 0),
    (1, 0, 0, 1, 0),
    (0, 0, 1, 0, 1),
    (0, 1, 0, 0, 1),
    (1, 0, 0, 0, 1),
    (0, 0, 0, 1, 1),
    (0, 1, 1, 0, 1),
    (1, 0, 1, 0, 1),
    (0, 1, 0, 1, 1),
    (1, 0, 0, 1, 1),
)

# Precomputed per-action decode: directions and the raw power-hit key bit.
# Folding the key table into direct lookup tables keeps the hot path at three
# gathers instead of five plus branch logic.
_XD = tuple(-1 if row[0] else (1 if row[1] else 0) for row in ACTION_KEY_TABLE)
_YD = tuple(-1 if row[2] else (1 if row[3] else 0) for row in ACTION_KEY_TABLE)
_PK = tuple(row[4] for row in ACTION_KEY_TABLE)

# numpy, so importing the package opens no device; jnp.asarray at the use.
ACTION_X_DIRECTION = np.asarray(_XD, np.int32)
ACTION_Y_DIRECTION = np.asarray(_YD, np.int32)
ACTION_POWER_KEY = np.asarray(_PK, np.int32)


def decode_action(action: jnp.ndarray, latch_prev: jnp.ndarray
                  ) -> Tuple[PlayerInput, jnp.ndarray]:
    """Decode one discrete action with rising-edge power-hit detection.

    Returns the decoded :class:`PlayerInput` and the new latch value
    (= raw power key state, becoming ``power_hit_key_is_down_previous``).
    """
    xd = jnp.asarray(ACTION_X_DIRECTION)[action]
    yd = jnp.asarray(ACTION_Y_DIRECTION)[action]
    power_key = jnp.asarray(ACTION_POWER_KEY)[action]
    power_hit = jnp.where((latch_prev == 0) & (power_key == 1),
                          jnp.int32(1), jnp.int32(0))
    return PlayerInput(xd, yd, power_hit), power_key


def decode_keys(keys: jnp.ndarray, latch_prev: jnp.ndarray
                ) -> Tuple[PlayerInput, jnp.ndarray]:
    """Engine-level key-vector decode (``PikaUserInput.get_input``,
    ``physics.py:59-99``): ``keys`` is ``[left, right, up, down, power_hit]``
    or the 6-wide variant with the vestigial ``down_right`` combo key
    (``physics.py:78-80``).  ``down_right`` acts as right+down, with left/up
    taking precedence — exactly the reference's elif chains
    (``physics.py:81-93``).  Rising-edge power-hit as in
    :func:`decode_action`."""
    keys = jnp.asarray(keys)
    assert keys.shape[-1] in (5, 6), "keys must be 5- or 6-wide"
    left, right, up, down, power_key = (keys[..., i] for i in range(5))
    down_right = keys[..., 5] if keys.shape[-1] == 6 else jnp.zeros_like(left)
    xd = jnp.where(left == 1, jnp.int32(-1),
                   jnp.where((right == 1) | (down_right == 1),
                             jnp.int32(1), jnp.int32(0)))
    yd = jnp.where(up == 1, jnp.int32(-1),
                   jnp.where((down == 1) | (down_right == 1),
                             jnp.int32(1), jnp.int32(0)))
    power_key = power_key.astype(jnp.int32)
    power_hit = jnp.where((latch_prev == 0) & (power_key == 1),
                          jnp.int32(1), jnp.int32(0))
    return PlayerInput(xd, yd, power_hit), power_key


# ---------------------------------------------------------------------------
# Gather-free decode for Pallas kernels (which cannot capture array
# constants): the three 18-entry tables are packed into Python-int bit
# fields at import time and unpacked with shifts at run time.  Directions
# are stored biased (+1, two bits each); actions 0-15 live in the low word,
# 16-17 in the high word.
def _pack2(table):
    lo = sum((v + 1) << (2 * a) for a, v in enumerate(table[:16]))
    hi = sum((v + 1) << (2 * a) for a, v in enumerate(table[16:]))
    return lo & 0xFFFFFFFF, hi & 0xFFFFFFFF


_XD_LO, _XD_HI = _pack2(_XD)
_YD_LO, _YD_HI = _pack2(_YD)
_PK_BITS = sum(v << a for a, v in enumerate(_PK))


def _unpack2(lo: int, hi: int, action: jnp.ndarray) -> jnp.ndarray:
    a = action.astype(jnp.uint32)
    low = (jnp.uint32(lo) >> (jnp.uint32(2) * a)) & jnp.uint32(3)
    high = (jnp.uint32(hi) >> (jnp.uint32(2) * (a - 16))) & jnp.uint32(3)
    return jnp.where(action < 16, low, high).astype(jnp.int32) - 1


def decode_action_arith(action: jnp.ndarray, latch_prev: jnp.ndarray
                        ) -> Tuple[PlayerInput, jnp.ndarray]:
    """Bit-arithmetic equivalent of :func:`decode_action` (any shape; safe
    inside Pallas kernels).  ``action`` must already be in [0, 18)."""
    xd = _unpack2(_XD_LO, _XD_HI, action)
    yd = _unpack2(_YD_LO, _YD_HI, action)
    power_key = ((jnp.uint32(_PK_BITS) >> action.astype(jnp.uint32))
                 & jnp.uint32(1)).astype(jnp.int32)
    power_hit = jnp.where((latch_prev == 0) & (power_key == 1),
                          jnp.int32(1), jnp.int32(0))
    return PlayerInput(xd, yd, power_hit), power_key
