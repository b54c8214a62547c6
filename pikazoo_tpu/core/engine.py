"""One physics frame — the orchestrator.

Equivalent of the reference's ``physics_engine`` (``physics.py:280-337``),
preserving its strict sequential structure (which the RNG draw order and the
players' view of each other depend on):

  1. ball-world collision + integration;
  2. player 1: [AI decision] then movement; player 2: [AI decision — seeing
     player 1's already-updated position] then movement;
  3. collisions: player 1 test/response, then player 2 against the
     possibly-updated ball; each guarded by the per-player edge latch.

The landing predictor runs ONCE per frame as a 7-lane batched sim (see
``core.predict`` for why that is semantics-preserving) and only when a
computer player exists — ``is_*_computer`` are static config, so XLA prunes
the whole AI/predictor path for human-vs-human builds.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from pikazoo_tpu.core.ai import computer_decide_input
from pikazoo_tpu.core.ball import ball_world_step
from pikazoo_tpu.core.collision import ball_player_overlap, collision_response
from pikazoo_tpu.core.player import move_player
from pikazoo_tpu.core.predict import landing_sims
from pikazoo_tpu.core.rng import DrawState
from pikazoo_tpu.core.state import (BallState, PlayerInput, PlayerState,
                                    SoundEvents)


def physics_step(
    p1: PlayerState,
    p2: PlayerState,
    ball: BallState,
    inp1: PlayerInput,
    inp2: PlayerInput,
    ds: DrawState,
    is_player1_computer: bool,
    is_player2_computer: bool,
) -> Tuple[PlayerState, PlayerState, BallState, jnp.ndarray, DrawState,
           SoundEvents]:
    """Advance the physics one frame.  ``is_*_computer`` must be static."""
    any_computer = is_player1_computer or is_player2_computer

    ball, touched = ball_world_step(ball)
    sounds = SoundEvents.none()._replace(ball_touches_ground=touched)

    candidate_landing = None
    if any_computer:
        expected_x, candidate_landing = landing_sims(ball)
        ball = ball._replace(expected_landing_point_x=expected_x)

    # Player 1 (left): optional AI decision, then movement.
    if is_player1_computer:
        inp1, wtsb, ds = computer_decide_input(
            p1, p2, ball, candidate_landing, False, ds)
        p1 = p1._replace(computer_where_to_stand_by=wtsb)
    p1, chu1, pika1, pipi1 = move_player(p1, inp1, is_player2=False)

    # Player 2 (right): its AI sees player 1's post-move position.
    if is_player2_computer:
        inp2, wtsb, ds = computer_decide_input(
            p2, p1, ball, candidate_landing, True, ds)
        p2 = p2._replace(computer_where_to_stand_by=wtsb)
    p2, chu2, pika2, pipi2 = move_player(p2, inp2, is_player2=True)

    # Sequential collision handling, player 1 first.
    power_sound = jnp.int32(0)
    players = []
    for p, inp in ((p1, inp1), (p2, inp2)):
        overlap = ball_player_overlap(ball, p.x, p.y)
        fresh = overlap & (p.is_collision_with_ball_happened == 0)
        ball, ps, ds = collision_response(ball, p.x, inp, p.state, fresh, ds)
        power_sound = power_sound | ps
        players.append(p._replace(
            is_collision_with_ball_happened=overlap.astype(jnp.int32)))
    p1, p2 = players

    sounds = sounds._replace(
        p1_chu=chu1, p1_pika=pika1, p1_pipikachu=pipi1,
        p2_chu=chu2, p2_pika=pika2, p2_pipikachu=pipi2,
        power_hit=power_sound)
    return p1, p2, ball, touched, ds, sounds
