"""The functional Pikachu Volleyball environment.

This is the JAX counterpart of the reference's ``raw_env`` PettingZoo
class (``pikazoo_env.py:72-248``): ``reset`` and ``step`` are pure, jit-able
functions over an integer state pytree.  One call to :meth:`PikaZoo.step`
advances one frame for both agents; ``jax.vmap`` runs B independent matches in
lockstep and ``pikazoo_tpu.parallel`` shards them over a device mesh.

Reference semantics preserved exactly (all verified frame-by-frame by the
parity harness):

* **Lazy round reset** (``pikazoo_env.py:176-180``): the scoring frame returns
  the post-touch state; players/ball re-init at the *next* step's entry, which
  is also when the boldness draws (and the serve draw, for ``serve="random"``)
  are consumed.
* **Scoring** by ``punch_effect_x < 216`` (``pikazoo_env.py:191``), zero-sum
  +-1 rewards only on the scoring frame, termination when a score reaches
  ``winning_score``.
* **Persistent quirk fields**: diving_direction, lying_down_duration_left,
  computer_where_to_stand_by, ball position history, rotation and the input
  power-key latch all survive round (and full-game) resets, exactly like the
  reference's partially-reset mutable objects.
* **Auto reset** (batched-RL extension, on by default): when a game has
  terminated, the next step's entry performs the equivalent of the reference's
  ``reset()`` — scores zeroed, serve flag cleared — before stepping, so
  vmapped lanes never stall.  Set ``auto_reset=False`` for strict PettingZoo
  episode semantics (the compat layer does).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from pikazoo_tpu.core import constants as C
from pikazoo_tpu.core.engine import physics_step
from pikazoo_tpu.core.input import decode_action
from pikazoo_tpu.core.rng import (DrawState, draw, fold_key, key_from_jax)
from pikazoo_tpu.core.state import (BallState, PlayerState, SoundEvents,
                                    init_ball_construction,
                                    init_player_construction,
                                    round_init_ball, round_init_player)
from pikazoo_tpu.envs.observations import (assemble_norm_obs_blocked,
                                           assemble_norm_obs_fm,
                                           assemble_obs)

SERVE_MODES = ("winner", "alternate", "random")


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (hashable; safe as a jit closure).

    Mirrors the reference constructor kwargs (``pikazoo_env.py:79-86``) plus
    the batched-mode ``auto_reset`` switch."""

    winning_score: int = 15
    serve: str = "winner"
    is_player1_computer: bool = False
    is_player2_computer: bool = False
    auto_reset: bool = True

    def __post_init__(self):
        if self.serve not in SERVE_MODES:
            raise ValueError(f"serve must be one of {SERVE_MODES}")


class EnvState(NamedTuple):
    p1: PlayerState
    p2: PlayerState
    ball: BallState
    power_hit_key_down_prev: jnp.ndarray  # (2,) int32 input latches
    scores: jnp.ndarray  # (2,) int32
    is_player2_serve: jnp.ndarray
    round_ended: jnp.ndarray
    game_ended: jnp.ndarray
    step_count: jnp.ndarray
    rng_key: jnp.ndarray  # (2,) uint32 — explicit threefry2x32 stream key
    draw_counter: jnp.ndarray


class FrameResult(NamedTuple):
    """Output of :func:`env_frame` — shape-generic scalar leaves."""

    p1: PlayerState
    p2: PlayerState
    ball: BallState
    score1: jnp.ndarray
    score2: jnp.ndarray
    is_player2_serve: jnp.ndarray
    round_ended: jnp.ndarray
    game_ended: jnp.ndarray
    draw_counter: jnp.ndarray
    touched: jnp.ndarray
    reward_p1: jnp.ndarray
    sounds: SoundEvents


def env_frame(cfg: "EnvConfig", ds: DrawState, p1: PlayerState,
              p2: PlayerState, ball: BallState, score1, score2,
              is_player2_serve, round_ended, game_ended,
              inp1, inp2) -> FrameResult:
    """One full environment frame on scalar (or any-shaped) int32 leaves.

    The single source of truth for the env-level semantics — lazy round /
    auto game reset with its draw consumption (``pikazoo_env.py:176-180``),
    serve selection (``:242-248``), physics, scoring (``:190-210``) and the
    zero-sum reward — used by :meth:`PikaZoo.step` (scalar leaves under
    vmap).  Inputs must already be decoded
    (:func:`..core.input.decode_action`)."""
    i32 = jnp.int32

    game_reset = (game_ended == 1) if cfg.auto_reset \
        else jnp.zeros_like(game_ended, jnp.bool_)
    round_reset = (round_ended == 1) & (game_ended == 0)
    do_init = round_reset | game_reset

    score1 = jnp.where(game_reset, i32(0), score1)
    score2 = jnp.where(game_reset, i32(0), score2)
    is_player2_serve = jnp.where(game_reset, i32(0), is_player2_serve)
    game_ended = jnp.where(game_reset, i32(0), game_ended)
    # Reward guard for out-of-contract steps: with auto_reset=False a lane
    # that terminated keeps round_ended=1 (no lazy reset fires, since that
    # requires game_ended==0), so without this mask every further step would
    # re-emit the terminal +-1.  The reference never reaches this state (it
    # empties ``agents``, pikazoo_env.py:237-240), so parity is unaffected:
    # on the scoring frame itself game_ended is still 0 here.
    game_ended_at_entry = game_ended
    clear = lambda p: p._replace(
        is_winner=jnp.where(game_reset, i32(0), p.is_winner),
        game_ended=jnp.where(game_reset, i32(0), p.game_ended))
    p1, p2 = clear(p1), clear(p2)

    b1, ds = draw(ds, do_init, 5)
    b2, ds = draw(ds, do_init, 5)
    if cfg.serve == "winner":
        server = is_player2_serve
    elif cfg.serve == "alternate":
        server = ((score1 + score2) % 2 == 1).astype(i32)
    else:
        sv, ds = draw(ds, do_init, 2)
        server = (sv == 0).astype(i32)
    p1 = round_init_player(p1, do_init, b1, is_player2=False)
    p2 = round_init_player(p2, do_init, b2, is_player2=True)
    ball = round_init_ball(ball, do_init, server)
    round_ended = jnp.where(do_init, i32(0), round_ended)

    p1, p2, ball, touched, ds, sounds = physics_step(
        p1, p2, ball, inp1, inp2, ds,
        cfg.is_player1_computer, cfg.is_player2_computer)

    score_event = (touched == 1) & (round_ended == 0) & (game_ended == 0)
    p2_scored = ball.punch_effect_x < C.GROUND_HALF_WIDTH
    score1 = score1 + (score_event & ~p2_scored).astype(i32)
    score2 = score2 + (score_event & p2_scored).astype(i32)
    is_player2_serve = jnp.where(score_event, p2_scored.astype(i32),
                                 is_player2_serve)
    p1_won = score_event & (score1 >= cfg.winning_score) & ~p2_scored
    p2_won = score_event & (score2 >= cfg.winning_score) & p2_scored
    game_over = p1_won | p2_won
    game_ended = jnp.where(game_over, i32(1), game_ended)
    p1 = p1._replace(
        is_winner=jnp.where(game_over, p1_won.astype(i32), p1.is_winner),
        game_ended=jnp.where(game_over, i32(1), p1.game_ended))
    p2 = p2._replace(
        is_winner=jnp.where(game_over, p2_won.astype(i32), p2.is_winner),
        game_ended=jnp.where(game_over, i32(1), p2.game_ended))
    round_ended = jnp.where(score_event, i32(1), round_ended)

    reward_p1 = jnp.where((round_ended == 1) & (game_ended_at_entry == 0),
                          jnp.where(is_player2_serve == 1, i32(-1), i32(1)),
                          i32(0))
    return FrameResult(p1, p2, ball, score1, score2, is_player2_serve,
                       round_ended, game_ended, ds.counter, touched,
                       reward_p1, sounds)


class TimeStep(NamedTuple):
    obs: jnp.ndarray  # (2, 35) int32, row 0 = player 1's view
    rewards: jnp.ndarray  # (2,) int32, zero-sum
    terminated: jnp.ndarray  # 0/1
    round_ended: jnp.ndarray  # 0/1
    scores: jnp.ndarray  # (2,) int32
    touched_ground: jnp.ndarray  # 0/1
    sounds: SoundEvents


class PikaZoo:
    """Functional two-agent Pikachu Volleyball, batched with ``vmap``.

    >>> env = PikaZoo(EnvConfig())
    >>> state, ts = env.reset(jax.random.key(0))
    >>> state, ts = jax.jit(env.step)(state, jnp.zeros(2, jnp.int32))
    """

    def __init__(self, config: EnvConfig = EnvConfig()):
        self.config = config

    # ------------------------------------------------------------- reset --
    def reset(self, key: jax.Array, *, counter: int | jnp.ndarray = 0,
              oracle: Optional[jax.Array] = None,
              carry: Optional[EnvState] = None
              ) -> Tuple[EnvState, TimeStep]:
        """Start a new game.

        ``carry`` preserves the reference's construction-vs-reset split: a
        reference ``reset()`` re-initializes only part of the state, so fields
        like diving_direction, the ball position history and the input latches
        leak from the previous episode.  Pass the previous :class:`EnvState`
        to reproduce that; omit it for a fresh construction.  ``counter`` (and
        ``oracle``) seed the draw-slot stream — the parity harness uses them
        to align with a recorded reference RNG trace.
        """
        if carry is None:
            p1 = init_player_construction(is_player2=False)
            p2 = init_player_construction(is_player2=True)
            ball = init_ball_construction()
            latch = jnp.zeros((2,), jnp.int32)
        else:
            clear = lambda p: p._replace(is_winner=jnp.int32(0),
                                         game_ended=jnp.int32(0))
            p1, p2, ball = clear(carry.p1), clear(carry.p2), carry.ball
            latch = carry.power_hit_key_down_prev

        scores = jnp.zeros((2,), jnp.int32)
        is_player2_serve = jnp.int32(0)
        key = key_from_jax(key)
        ds = DrawState(key=key, counter=jnp.asarray(counter, jnp.int32),
                       oracle=oracle)

        true = jnp.bool_(True)
        b1, ds = draw(ds, true, 5)
        b2, ds = draw(ds, true, 5)
        # Serve at reset (pikazoo_env.py:149-164): is_player2_serve was just
        # cleared and scores zeroed, so winner/alternate both yield player 1;
        # random draws (after the boldness draws, as in the reference).
        if self.config.serve == "random":
            sv, ds = draw(ds, true, 2)
            server = (sv == 0).astype(jnp.int32)
        else:
            server = is_player2_serve

        p1 = round_init_player(p1, true, b1, is_player2=False)
        p2 = round_init_player(p2, true, b2, is_player2=True)
        ball = round_init_ball(ball, true, server)

        state = EnvState(
            p1=p1, p2=p2, ball=ball,
            power_hit_key_down_prev=latch,
            scores=scores,
            is_player2_serve=is_player2_serve,
            round_ended=jnp.int32(0),
            game_ended=jnp.int32(0),
            step_count=jnp.int32(0),
            rng_key=key,
            draw_counter=ds.counter,
        )
        zero2 = jnp.zeros((2,), jnp.int32)
        ts = TimeStep(
            obs=assemble_obs(p1, p2, ball, latch),
            rewards=zero2,
            terminated=jnp.int32(0),
            round_ended=jnp.int32(0),
            scores=scores,
            touched_ground=jnp.int32(0),
            sounds=SoundEvents.none(),
        )
        return state, ts

    # -------------------------------------------------------------- step --
    def _advance(self, state: EnvState, a1: jnp.ndarray, a2: jnp.ndarray,
                 oracle: Optional[jax.Array] = None
                 ) -> Tuple[EnvState, FrameResult]:
        """One frame of state evolution, per-seat scalar actions, no
        observation assembly (shared by ``step`` and the learner path)."""
        ds = DrawState(key=state.rng_key, counter=state.draw_counter,
                       oracle=oracle)

        # Decode actions with edge detection (the latch feeds obs 12/25).
        inp1, latch1 = decode_action(a1, state.power_hit_key_down_prev[0])
        inp2, latch2 = decode_action(a2, state.power_hit_key_down_prev[1])
        latch = jnp.stack([latch1, latch2])

        fr = env_frame(self.config, ds, state.p1, state.p2, state.ball,
                       state.scores[0], state.scores[1],
                       state.is_player2_serve, state.round_ended,
                       state.game_ended, inp1, inp2)

        scores = jnp.stack([fr.score1, fr.score2])
        new_state = EnvState(
            p1=fr.p1, p2=fr.p2, ball=fr.ball,
            power_hit_key_down_prev=latch,
            scores=scores,
            is_player2_serve=fr.is_player2_serve,
            round_ended=fr.round_ended,
            game_ended=fr.game_ended,
            step_count=state.step_count + 1,
            rng_key=state.rng_key,
            draw_counter=fr.draw_counter,
        )
        return new_state, fr

    def step(self, state: EnvState, actions: jnp.ndarray,
             oracle: Optional[jax.Array] = None
             ) -> Tuple[EnvState, TimeStep]:
        """Advance one frame.  ``actions`` is ``(2,)`` int32 in [0, 18)."""
        new_state, fr = self._advance(state, actions[0], actions[1], oracle)
        ts = TimeStep(
            obs=assemble_obs(fr.p1, fr.p2, fr.ball,
                             new_state.power_hit_key_down_prev),
            rewards=jnp.stack([fr.reward_p1, -fr.reward_p1]),
            terminated=fr.game_ended,
            round_ended=fr.round_ended,
            scores=new_state.scores,
            touched_ground=fr.touched,
            sounds=fr.sounds,
        )
        return new_state, ts

    # Batched convenience API ------------------------------------------------
    def reset_batch(self, key: jax.Array, batch_size: int
                    ) -> Tuple[EnvState, TimeStep]:
        """Reset ``batch_size`` independent matches with per-env folded keys."""
        base = key_from_jax(key)
        keys = jax.vmap(fold_key, in_axes=(None, 0))(
            base, jnp.arange(batch_size))
        return jax.vmap(lambda k: self.reset(k))(keys)

    def step_batch(self, state: EnvState, actions: jnp.ndarray
                   ) -> Tuple[EnvState, TimeStep]:
        """Step a batch: ``actions`` is ``(B, 2)`` int32."""
        return jax.vmap(self.step)(state, actions)

    def step_batch_learner(self, state: EnvState, a1: jnp.ndarray,
                           a2: jnp.ndarray
                           ) -> Tuple[EnvState, jnp.ndarray, jnp.ndarray,
                                      jnp.ndarray]:
        """Learner fast path: per-seat ``(B,)`` actions in, normalized
        observations out, no (B, 2, 35) int32 materialization.

        Returns ``(state, norm_obs, reward_p1, terminated)`` where
        ``norm_obs`` is (2B, 35) bfloat16 seat-BLOCKED (rows [0, B) are
        player 1's view — see ``assemble_norm_obs_blocked``), ``reward_p1``
        is (B,) int32 (player 2's reward is its negation) and ``terminated``
        is (B,) int32.  It skips the standard ``step_batch``'s (B, 2, 35)
        int32 obs tensor.
        """
        new_state, fr = jax.vmap(self._advance)(state, a1, a2)
        norm_obs = assemble_norm_obs_blocked(
            new_state.p1, new_state.p2, new_state.ball,
            new_state.power_hit_key_down_prev)
        return new_state, norm_obs, fr.reward_p1, fr.game_ended

    def step_batch_learner_fm(self, state: EnvState, a1: jnp.ndarray,
                              a2: jnp.ndarray
                              ) -> Tuple[EnvState, jnp.ndarray, jnp.ndarray,
                                         jnp.ndarray]:
        """Like :meth:`step_batch_learner` but the normalized observations
        come back FEATURE-MAJOR, (35, 2B) bfloat16 (seat-blocked columns:
        [0, B) are player 1's view) — the env batch as the minor dimension.
        This is the layout the PPO rollout stores; see
        ``assemble_norm_obs_fm``."""
        new_state, fr = jax.vmap(self._advance)(state, a1, a2)
        norm_obs = assemble_norm_obs_fm(
            new_state.p1, new_state.p2, new_state.ball,
            new_state.power_hit_key_down_prev)
        return new_state, norm_obs, fr.reward_p1, fr.game_ended
