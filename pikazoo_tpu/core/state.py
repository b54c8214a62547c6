"""State pytrees for the physics kernel.

Every leaf is an ``int32`` scalar (per environment); ``jax.vmap`` turns them
into ``(B,)`` lanes.  Booleans are stored as 0/1 int32 so the whole state is a
homogeneous integer pytree — cheap to checkpoint, shard, and ``jnp.where`` on.

Field meanings mirror the reference state classes (``Player`` at
``pikazoo/env/physics.py:140-218``, ``Ball`` at ``physics.py:221-277``) but the
representation — an immutable NamedTuple updated with ``_replace`` inside pure
functions — is built for jit/vmap, not a port of the mutable objects.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pikazoo_tpu.core import constants as C


def _i32(x) -> jnp.ndarray:
    return jnp.asarray(x, jnp.int32)


class PlayerInput(NamedTuple):
    """Decoded per-frame input: directions in {-1,0,1} and an edge-detected
    power-hit bit (``PikaUserInput`` semantics, ``physics.py:36-99``)."""

    x_direction: jnp.ndarray
    y_direction: jnp.ndarray
    power_hit: jnp.ndarray


class PlayerState(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    y_velocity: jnp.ndarray
    # 0 normal, 1 jumping, 2 jumping+power-hitting, 3 diving, 4 lying down,
    # 5 won, 6 lost (5/6 are dead code when driven through the env, which
    # terminates on the scoring frame — kept for engine completeness).
    state: jnp.ndarray
    frame_number: jnp.ndarray
    normal_status_arm_swing_direction: jnp.ndarray
    delay_before_next_frame: jnp.ndarray
    # -1 left / 0 none / 1 right.  NOT reset between rounds (reference quirk:
    # only Player.__init__ zeroes it, initialize_for_new_round does not).
    diving_direction: jnp.ndarray
    lying_down_duration_left: jnp.ndarray  # persists across rounds too
    is_collision_with_ball_happened: jnp.ndarray  # 0/1 edge latch
    computer_boldness: jnp.ndarray  # redrawn in [0,5) each round init
    computer_where_to_stand_by: jnp.ndarray  # 0 mid-court / 1 near net; persists
    is_winner: jnp.ndarray
    game_ended: jnp.ndarray


class BallState(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    x_velocity: jnp.ndarray
    y_velocity: jnp.ndarray
    # Two-frame position history for the power-hit trail; NOT reset between
    # rounds (reference quirk: Ball.initialize_for_new_round leaves them).
    previous_x: jnp.ndarray
    previous_y: jnp.ndarray
    previous_previous_x: jnp.ndarray
    previous_previous_y: jnp.ndarray
    is_power_hit: jnp.ndarray
    expected_landing_point_x: jnp.ndarray
    rotation: jnp.ndarray  # 0..5; 5 = hyper-ball glitch sprite
    fine_rotation: jnp.ndarray
    punch_effect_x: jnp.ndarray  # also the scoring-side witness on ground touch
    punch_effect_y: jnp.ndarray
    punch_effect_radius: jnp.ndarray


class SoundEvents(NamedTuple):
    """Per-frame audio event flags.

    The reference latches these on Player/Ball ``sound`` dicts and never clears
    or consumes them; here they are fresh per-step outputs (more useful to a
    consumer, no parity impact — they never enter observations)."""

    p1_chu: jnp.ndarray
    p1_pika: jnp.ndarray
    p1_pipikachu: jnp.ndarray
    p2_chu: jnp.ndarray
    p2_pika: jnp.ndarray
    p2_pipikachu: jnp.ndarray
    power_hit: jnp.ndarray
    ball_touches_ground: jnp.ndarray

    @classmethod
    def none(cls) -> "SoundEvents":
        z = _i32(0)
        return cls(z, z, z, z, z, z, z, z)


def init_player_construction(is_player2: bool) -> PlayerState:
    """Construction-time defaults (reference ``Player.__init__``), *before*
    the first round init.  Boldness is a placeholder until round init draws it."""
    return PlayerState(
        x=_i32(C.GROUND_WIDTH - 36 if is_player2 else 36),
        y=_i32(C.PLAYER_TOUCHING_GROUND_Y_COORD),
        y_velocity=_i32(0),
        state=_i32(0),
        frame_number=_i32(0),
        normal_status_arm_swing_direction=_i32(1),
        delay_before_next_frame=_i32(0),
        diving_direction=_i32(0),
        lying_down_duration_left=_i32(-1),
        is_collision_with_ball_happened=_i32(0),
        computer_boldness=_i32(0),
        computer_where_to_stand_by=_i32(0),
        is_winner=_i32(0),
        game_ended=_i32(0),
    )


def round_init_player(p: PlayerState, do: jnp.ndarray, boldness: jnp.ndarray,
                      is_player2: bool) -> PlayerState:
    """Masked per-round re-init (reference ``initialize_for_new_round``,
    ``physics.py:181-218``).  Only the listed fields reset; diving_direction,
    lying_down_duration_left, computer_where_to_stand_by, is_winner and
    game_ended deliberately persist."""
    w = lambda new, old: jnp.where(do, _i32(new), old)
    return p._replace(
        x=w(C.GROUND_WIDTH - 36 if is_player2 else 36, p.x),
        y=w(C.PLAYER_TOUCHING_GROUND_Y_COORD, p.y),
        y_velocity=w(0, p.y_velocity),
        is_collision_with_ball_happened=w(0, p.is_collision_with_ball_happened),
        state=w(0, p.state),
        frame_number=w(0, p.frame_number),
        normal_status_arm_swing_direction=w(1, p.normal_status_arm_swing_direction),
        delay_before_next_frame=w(0, p.delay_before_next_frame),
        computer_boldness=jnp.where(do, boldness, p.computer_boldness),
    )


def init_ball_construction() -> BallState:
    """Construction-time defaults (reference ``Ball.__init__``)."""
    return BallState(
        x=_i32(56),
        y=_i32(0),
        x_velocity=_i32(0),
        y_velocity=_i32(1),
        previous_x=_i32(0),
        previous_y=_i32(0),
        previous_previous_x=_i32(0),
        previous_previous_y=_i32(0),
        is_power_hit=_i32(0),
        expected_landing_point_x=_i32(0),
        rotation=_i32(0),
        fine_rotation=_i32(0),
        punch_effect_x=_i32(0),
        punch_effect_y=_i32(0),
        punch_effect_radius=_i32(0),
    )


def round_init_ball(b: BallState, do: jnp.ndarray,
                    is_player2_serve: jnp.ndarray) -> BallState:
    """Masked per-round ball re-init (reference ``physics.py:258-277``).
    Position history, rotation and punch-effect coordinates persist."""
    serve_x = jnp.where(is_player2_serve, _i32(C.GROUND_WIDTH - 56), _i32(56))
    w = lambda new, old: jnp.where(do, new, old)
    return b._replace(
        x=w(serve_x, b.x),
        y=w(_i32(0), b.y),
        x_velocity=w(_i32(0), b.x_velocity),
        y_velocity=w(_i32(1), b.y_velocity),
        punch_effect_radius=w(_i32(0), b.punch_effect_radius),
        is_power_hit=w(_i32(0), b.is_power_hit),
    )
