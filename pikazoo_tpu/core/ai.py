"""Rule-based computer AI as a pure function.

Equivalent of the reference's ``let_computer_decide_user_input``
(``physics.py:689-771``) and ``decide_whether_input_power_hit``
(``physics.py:774-817``), re-designed for a traced program:

* RNG draws go through the draw-slot stream (``core.rng``) with the exact
  conditional-consumption structure of the reference: the reposition coin
  ``integers(0,20)`` only when NOT chasing, the stand-by draw ``integers(0,2)``
  only when that coin lands 0, and the smash-order coin ``integers(0,2)``
  only when airborne within 48px of the ball.
* The reference's early-exit double loop over six power-hit candidates
  becomes a first-accepted-index select over the precomputed 6 candidate
  landing points (``core.predict``): the coin picks one of two static
  enumeration orders, acceptance is evaluated for all six, and ``argmax``
  over the permuted boolean vector yields the reference's first hit.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

import jax

from pikazoo_tpu.core import constants as C
from pikazoo_tpu.core.rng import DrawState, draw
from pikazoo_tpu.core.state import BallState, PlayerInput, PlayerState


def computer_decide_input(p: PlayerState, other: PlayerState, ball: BallState,
                          candidate_landing_x: jnp.ndarray, is_player2: bool,
                          ds: DrawState
                          ) -> Tuple[PlayerInput, jnp.ndarray, DrawState]:
    """Decide this frame's input for a computer-controlled player.

    ``candidate_landing_x`` are the six power-hit landing points from
    :func:`pikazoo_tpu.core.predict.landing_sims` (ball-dependent only, so
    shared by both players within a frame).  Returns the decided input, the
    updated ``computer_where_to_stand_by``, and the advanced draw stream.
    """
    i32 = jnp.int32
    boldness = p.computer_boldness
    expected = ball.expected_landing_point_x
    left_boundary = i32(C.GROUND_HALF_WIDTH if is_player2 else 0)
    right_boundary = i32(C.GROUND_WIDTH if is_player2 else C.GROUND_HALF_WIDTH)
    # "Out of my side" threshold used by both reposition and smash acceptance:
    # expected <= is_p2*216  or  expected >= is_p2*432 + 216.
    far_side = i32((C.GROUND_WIDTH if is_player2 else 0) + C.GROUND_HALF_WIDTH)

    # Reposition target when the ball hangs around the other side.
    hanging = (jnp.abs(ball.x - p.x) > 100) & \
              (jnp.abs(ball.x_velocity) < boldness + 5)
    out_of_side = (expected <= left_boundary) | (expected >= far_side)
    use_midpoint = hanging & out_of_side & (p.computer_where_to_stand_by == 0)
    virtual_expected = jnp.where(
        use_midpoint, left_boundary + C.GROUND_HALF_WIDTH // 2, expected)

    chase = jnp.abs(virtual_expected - p.x) > boldness + 8
    xd = jnp.where(chase,
                   jnp.where(p.x < virtual_expected, i32(1), i32(-1)), i32(0))

    # Reposition coin + conditional stand-by draw (physics.py:728-729).
    coin20, ds = draw(ds, ~chase, 20)
    standby_consume = ~chase & (coin20 == 0)
    standby, ds = draw(ds, standby_consume, 2)
    where_to_stand_by = jnp.where(standby_consume, standby,
                                  p.computer_where_to_stand_by)

    yd = i32(0)
    power = i32(0)

    # --- grounded (state 0): jump timing and dive decision ---
    grounded = p.state == 0
    jump = (jnp.abs(ball.x_velocity) < boldness + 3) & \
           (jnp.abs(ball.x - p.x) < C.PLAYER_HALF_LENGTH) & \
           (ball.y > -36) & (ball.y < 10 * boldness + 84) & \
           (ball.y_velocity > 0)
    yd = jnp.where(grounded & jump, i32(-1), yd)

    dive = (expected > left_boundary) & (expected < right_boundary) & \
           (jnp.abs(ball.x - p.x) > boldness * 5 + C.PLAYER_LENGTH) & \
           (ball.x > left_boundary) & (ball.x < right_boundary) & \
           (ball.y > 174)
    power = jnp.where(grounded & dive, i32(1), power)
    xd = jnp.where(grounded & dive,
                   jnp.where(p.x < ball.x, i32(1), i32(-1)), xd)

    # --- airborne (state 1 or 2): chase and smash ---
    airborne = (p.state == 1) | (p.state == 2)
    xd = jnp.where(airborne & (jnp.abs(ball.x - p.x) > 8),
                   jnp.where(p.x < ball.x, i32(1), i32(-1)), xd)

    near = (jnp.abs(ball.x - p.x) < 48) & (jnp.abs(ball.y - p.y) < 48)
    smash_consume = airborne & near
    coin2, ds = draw(ds, smash_consume, 2)
    # First-accepted candidate under the coin-selected enumeration order.
    # Candidates carry canonical index c on axis 0 (order "A"); order "B" is
    # the involution c < 3 ? 2-c : 8-c (reference loops physics.py:796-816).
    # Shape-generic (works per-env under vmap AND on (R, L) leaves inside
    # Pallas kernels): rank the accepted candidates by their position in the
    # chosen order and argmin.
    shape = jnp.shape(p.x)
    lane_shape = (6,) + tuple(1 for _ in shape)
    if shape:
        c_idx = jax.lax.broadcasted_iota(jnp.int32, lane_shape, 0)
    else:
        c_idx = jnp.arange(6, dtype=jnp.int32)
    position = jnp.where(coin2 == 0, c_idx,
                         jnp.where(c_idx < 3, 2 - c_idx, 8 - c_idx))
    accepted = ((candidate_landing_x <= left_boundary) |
                (candidate_landing_x >= far_side)) & \
               (jnp.abs(candidate_landing_x - other.x) > C.PLAYER_LENGTH)
    # Min over (rank * 8 + canonical index) both finds the smallest rank and
    # carries its candidate index in the low bits: one min reduction instead
    # of argmin's value-and-index pair.
    encoded = jnp.where(accepted, position, i32(99)) * 8 + c_idx
    best = jnp.min(encoded, axis=0)
    found = (best >> 3) < 99
    first = best & 7
    will_power_hit = smash_consume & found
    cand_xd = (first < 3).astype(jnp.int32)
    cand_yd = (first % 3) - 1
    xd = jnp.where(will_power_hit, cand_xd, xd)
    yd = jnp.where(will_power_hit, cand_yd, yd)
    power = jnp.where(will_power_hit, i32(1), power)
    # Forced up-input when the opponent is close (physics.py:770-771).
    force_up = will_power_hit & (jnp.abs(other.x - p.x) < 80) & (cand_yd != -1)
    yd = jnp.where(force_up, i32(-1), yd)

    return PlayerInput(xd, yd, power), where_to_stand_by, ds
