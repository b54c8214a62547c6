"""Observation layout and bounds.

35-dim int32 observation per agent, mirrored: dims 0-12 describe "me",
13-25 the opponent, 26-34 the ball (reference layout documented at
``pikazoo_env.py:481-565`` / ``README.md:52-98``):

  per player (13): x, y, y_velocity, diving_direction,
      lying_down_duration_left, frame_number, delay_before_next_frame,
      one_hot(state, 5), power_hit_key_is_down_previous
  ball (9): x, y, previous_x, previous_y, previous_previous_x,
      previous_previous_y, x_velocity, y_velocity, is_power_hit

The one-hot is 5-wide on purpose: states 5/6 (win/lose poses) are unreachable
through the env, which terminates on the scoring frame.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from pikazoo_tpu.core import constants as C
from pikazoo_tpu.core.state import BallState, PlayerState

OBS_DIM = 35
NUM_ACTIONS = 18

# 108 = the highest point a player can reach (jump from y=244 with v=-16).
_PLAYER_LOW = [C.PLAYER_HALF_LENGTH, 108, -15, -1, -2, 0, 0,
               0, 0, 0, 0, 0, 0]
_PLAYER_HIGH = [C.GROUND_WIDTH - C.PLAYER_HALF_LENGTH,
                C.PLAYER_TOUCHING_GROUND_Y_COORD, 16, 1, 3, 4, 4,
                1, 1, 1, 1, 1, 1]
_BALL_LOW = [C.BALL_RADIUS, 0, 0, 0, 0, 0, -20, -124, 0]
_BALL_HIGH = [C.GROUND_WIDTH, C.BALL_TOUCHING_GROUND_Y_COORD,
              C.GROUND_WIDTH, C.BALL_TOUCHING_GROUND_Y_COORD,
              C.GROUND_WIDTH, C.BALL_TOUCHING_GROUND_Y_COORD,
              20, 124, 1]

OBS_LOW = np.asarray(_PLAYER_LOW + _PLAYER_LOW + _BALL_LOW, np.int32)
OBS_HIGH = np.asarray(_PLAYER_HIGH + _PLAYER_HIGH + _BALL_HIGH, np.int32)


def player_obs(p: PlayerState, power_latch: jnp.ndarray) -> jnp.ndarray:
    """13-dim per-player observation block."""
    one_hot = (jnp.arange(5, dtype=jnp.int32) == p.state).astype(jnp.int32)
    head = jnp.stack([
        p.x, p.y, p.y_velocity, p.diving_direction,
        p.lying_down_duration_left, p.frame_number,
        p.delay_before_next_frame,
    ])
    return jnp.concatenate([head, one_hot, power_latch[None]])


def ball_obs(b: BallState) -> jnp.ndarray:
    """9-dim ball observation block."""
    return jnp.stack([
        b.x, b.y, b.previous_x, b.previous_y,
        b.previous_previous_x, b.previous_previous_y,
        b.x_velocity, b.y_velocity, b.is_power_hit,
    ])


def assemble_obs(p1: PlayerState, p2: PlayerState, b: BallState,
                 latch: jnp.ndarray) -> jnp.ndarray:
    """(2, 35) mirrored observations: row 0 for player 1, row 1 for player 2."""
    o1 = player_obs(p1, latch[0])
    o2 = player_obs(p2, latch[1])
    ob = ball_obs(b)
    return jnp.stack([
        jnp.concatenate([o1, o2, ob]),
        jnp.concatenate([o2, o1, ob]),
    ])

# ---------------------------------------------------------------------------
# Learner fast path: normalized bf16 observation rows assembled DIRECTLY from
# batched state leaves.  The standard path materializes a per-frame
# (B, 2, 35) int32 tensor that the PPO rollout would pay for twice per frame
# (assembly write + normalize read).  Stacking per-field (B,) leaves straight
# into normalized rows writes the learner's bf16 layout once, with the
# normalization arithmetic fused into the stack.  Row layout is SEAT-BLOCKED:
# rows [0, B) are player 1's view, [B, 2B) player 2's.

_LOW_F = OBS_LOW.astype(np.float32)
_SPAN_F = (OBS_HIGH - OBS_LOW).astype(np.float32)


def _player_cols(p: PlayerState, latch: jnp.ndarray) -> list:
    """13 per-field (B,) columns in observation order (incl. 5-wide one-hot)."""
    return ([p.x, p.y, p.y_velocity, p.diving_direction,
             p.lying_down_duration_left, p.frame_number,
             p.delay_before_next_frame]
            + [(p.state == k).astype(jnp.int32) for k in range(5)]
            + [latch])


def _ball_cols(b: BallState) -> list:
    return [b.x, b.y, b.previous_x, b.previous_y,
            b.previous_previous_x, b.previous_previous_y,
            b.x_velocity, b.y_velocity, b.is_power_hit]


def assemble_norm_obs_blocked(p1: PlayerState, p2: PlayerState, b: BallState,
                              latch: jnp.ndarray) -> jnp.ndarray:
    """(2B, 35) bfloat16 normalized mirrored observations, seat-blocked.

    ``p1``/``p2``/``b`` are BATCHED state pytrees ((B,) leaves); ``latch`` is
    the (B, 2) power-hit latch.  Equals
    ``normalize(vmap(assemble_obs)(...))`` re-ordered seat-blocked.
    """
    def seat(me, opp, latch_me, latch_opp):
        cols = _player_cols(me, latch_me) + _player_cols(opp, latch_opp) \
            + _ball_cols(b)
        # Same expression as networks.normalize_obs (division, not
        # reciprocal-multiply) so the result is bit-identical per column.
        normed = [((c.astype(jnp.float32) - _LOW_F[i]) / _SPAN_F[i])
                  for i, c in enumerate(cols)]
        return jnp.stack(normed, axis=-1).astype(jnp.bfloat16)

    return jnp.concatenate([
        seat(p1, p2, latch[:, 0], latch[:, 1]),
        seat(p2, p1, latch[:, 1], latch[:, 0]),
    ], axis=0)


def assemble_norm_obs_fm(p1: PlayerState, p2: PlayerState, b: BallState,
                         latch: jnp.ndarray) -> jnp.ndarray:
    """(35, 2B) bfloat16 normalized mirrored observations, FEATURE-MAJOR.

    Same columns as :func:`assemble_norm_obs_blocked` but stacked on axis 0,
    so the env batch is the minor dimension and per-action reductions in the
    rollout run over the leading axis.  ``assemble_norm_obs_fm(...) ==
    assemble_norm_obs_blocked(...).T`` exactly (same per-column arithmetic).
    """
    def seat(me, opp, latch_me, latch_opp):
        cols = _player_cols(me, latch_me) + _player_cols(opp, latch_opp) \
            + _ball_cols(b)
        normed = [((c.astype(jnp.float32) - _LOW_F[i]) / _SPAN_F[i])
                  for i, c in enumerate(cols)]
        return jnp.stack(normed, axis=0).astype(jnp.bfloat16)   # (35, B)

    return jnp.concatenate([
        seat(p1, p2, latch[:, 0], latch[:, 1]),
        seat(p2, p1, latch[:, 1], latch[:, 0]),
    ], axis=1)
