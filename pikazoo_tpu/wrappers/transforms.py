"""Wrapper suite as traced transforms.

Functional counterparts of the six reference wrappers
(``pikazoo/wrappers/*.py``), each a thin composable layer over a
:class:`~pikazoo_tpu.envs.PikaZoo`-shaped object (same ``reset``/``step``
signature, fully jit/vmap-able).  Stateless wrappers pass the inner state
through untouched; stateful ones (:class:`RecordEpisodeStatistics`,
:class:`ConvertSingleAgent`) wrap it in their own NamedTuple.

Semantics notes (each verified by wrapper-stack parity tests):

* :class:`SimplifyAction` — 18 -> 13 actions through per-agent lookup tuples
  expressing FRONT/BACK relative to the net (``simplify_action.py:16-20``).
* :class:`RewardByBallPosition` — adds a per-quadrant shaping reward every
  step, quadrant derived from the ball position *as seen in player 1's
  observation dims 26/27* (``reward_by_ball_position.py:21-31``) — so it must
  sit below :class:`NormalizeObservation` in a stack, like the reference.
* :class:`RewardInNormalState` — replaces exact-zero rewards with a constant.
* :class:`NormalizeObservation` — min-max to [0,1] float32 using the Box
  bounds.
* :class:`RecordEpisodeStatistics` — accumulates per-agent return/length,
  reporting them on the termination frame (and, unlike the host-side
  reference, resetting its accumulators there so auto-reset batches keep
  correct per-episode stats).
* :class:`ConvertSingleAgent` — exposes one side as a single-agent env; the
  opponent plays uniform-random actions from a carried key
  (``convert_single_agent.py:17-21``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pikazoo_tpu.envs.observations import OBS_HIGH, OBS_LOW

# Per-agent 13 -> 18 action maps (reference simplify_action.py:16-20);
# numpy, so importing the package opens no device.
SIMPLIFY_P1 = np.asarray((0, 1, 2, 3, 4, 6, 7, 10, 11, 12, 13, 14, 16),
                         np.int32)
SIMPLIFY_P2 = np.asarray((0, 1, 2, 4, 3, 7, 6, 10, 12, 11, 13, 15, 17),
                         np.int32)


class _Wrapper:
    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, *args, **kwargs):
        return self.env.reset(*args, **kwargs)

    def step(self, state, actions, oracle=None):
        return self.env.step(state, actions, oracle)

    # Batched convenience mirroring PikaZoo's API so wrapped stacks drop into
    # the trainer unchanged (vmap runs over the whole wrapped step).  Key
    # derivation must match PikaZoo.reset_batch exactly so adding/removing a
    # stateless wrapper never changes the trajectory for a given seed.
    def reset_batch(self, key, batch_size: int):
        from pikazoo_tpu.core.rng import fold_key, key_from_jax
        keys = jax.vmap(fold_key, in_axes=(None, 0))(
            key_from_jax(key), jnp.arange(batch_size))
        return jax.vmap(lambda k: self.reset(k))(keys)

    def step_batch(self, state, actions):
        return jax.vmap(lambda s, a: self.step(s, a))(state, actions)


class SimplifyAction(_Wrapper):
    """Relative-direction 13-action space mapped onto the raw 18."""

    num_actions = 13

    def step(self, state, actions, oracle=None):
        mapped = jnp.stack([jnp.asarray(SIMPLIFY_P1)[actions[0]],
                            jnp.asarray(SIMPLIFY_P2)[actions[1]]])
        return self.env.step(state, mapped, oracle)


class RewardByBallPosition(_Wrapper):
    """Quadrant shaping reward from the ball position (8-tuple, 4 per agent)."""

    def __init__(self, env, additional_reward, x_line: int = 216,
                 y_line: int = 176):
        super().__init__(env)
        assert len(additional_reward) == 8
        self.additional_reward = jnp.asarray(additional_reward, jnp.float32)
        self.x_line = x_line
        self.y_line = y_line

    def step(self, state, actions, oracle=None):
        state, ts = self.env.step(state, actions, oracle)
        ball_x = ts.obs[0, 26]
        ball_y = ts.obs[0, 27]
        pos = (ball_y > self.y_line).astype(jnp.int32) + \
            2 * (ball_x >= self.x_line).astype(jnp.int32)
        bonus = jnp.stack([self.additional_reward[pos],
                           self.additional_reward[4 + pos]])
        rewards = ts.rewards.astype(jnp.float32) + bonus
        return state, ts._replace(rewards=rewards)


class RewardInNormalState(_Wrapper):
    """Replace zero (non-scoring-frame) rewards with a constant."""

    def __init__(self, env, reward):
        super().__init__(env)
        self.reward = reward

    def step(self, state, actions, oracle=None):
        state, ts = self.env.step(state, actions, oracle)
        r = ts.rewards
        fill = jnp.asarray(self.reward)
        out_dtype = jnp.promote_types(r.dtype, fill.dtype)
        rewards = jnp.where(r == 0, fill.astype(out_dtype), r.astype(out_dtype))
        return state, ts._replace(rewards=rewards)


class NormalizeObservation(_Wrapper):
    """Min-max normalize observations to [0, 1] float32."""

    _low = np.asarray(OBS_LOW, np.float32)
    _span = (np.asarray(OBS_HIGH) - np.asarray(OBS_LOW)).astype(np.float32)

    def _norm(self, ts):
        obs = (ts.obs.astype(jnp.float32) - self._low) / self._span
        return ts._replace(obs=obs)

    def reset(self, *args, **kwargs):
        state, ts = self.env.reset(*args, **kwargs)
        return state, self._norm(ts)

    def step(self, state, actions, oracle=None):
        state, ts = self.env.step(state, actions, oracle)
        return state, self._norm(ts)


class EpisodeStatsState(NamedTuple):
    inner: object
    episode_return: jnp.ndarray  # (2,) float32
    episode_length: jnp.ndarray  # (2,) int32


class EpisodeStats(NamedTuple):
    episode_return: jnp.ndarray
    episode_length: jnp.ndarray
    done: jnp.ndarray


class RecordEpisodeStatistics(_Wrapper):
    """Accumulate per-agent episode return/length; emit them on termination.

    ``step`` returns ``(state, ts, EpisodeStats)``; the stats fields are valid
    where ``done`` is set.  Accumulators zero on the termination frame so the
    wrapper composes with auto-reset batching."""

    def reset(self, *args, **kwargs):
        inner, ts = self.env.reset(*args, **kwargs)
        zeros_f = jnp.zeros((2,), jnp.float32)
        zeros_i = jnp.zeros((2,), jnp.int32)
        return EpisodeStatsState(inner, zeros_f, zeros_i), ts

    def step(self, state: EpisodeStatsState, actions, oracle=None):
        inner, ts = self.env.step(state.inner, actions, oracle)
        ep_ret = state.episode_return + ts.rewards.astype(jnp.float32)
        ep_len = state.episode_length + 1
        done = ts.terminated == 1
        stats = EpisodeStats(ep_ret, ep_len, done.astype(jnp.int32))
        ep_ret = jnp.where(done, 0.0, ep_ret)
        ep_len = jnp.where(done, 0, ep_len)
        return EpisodeStatsState(inner, ep_ret, ep_len), ts, stats


class SingleAgentState(NamedTuple):
    inner: object
    key: jax.Array


class ConvertSingleAgent(_Wrapper):
    """Single-agent view of one side; the opponent acts uniformly at random."""

    def __init__(self, env, side: str):
        super().__init__(env)
        assert side in ("player_1", "player_2")
        self.me = 0 if side == "player_1" else 1
        self.opponent = 1 - self.me
        self.opponent_actions = getattr(env, "num_actions", 18)

    def reset(self, key, **kwargs):
        key, inner_key = jax.random.split(key)
        inner, ts = self.env.reset(inner_key, **kwargs)
        return SingleAgentState(inner, key), self._view(ts)

    def step(self, state: SingleAgentState, action, oracle=None):
        key, sub = jax.random.split(state.key)
        opp = jax.random.randint(sub, (), 0, self.opponent_actions,
                                 dtype=jnp.int32)
        pair = jnp.zeros((2,), jnp.int32)
        pair = pair.at[self.me].set(action).at[self.opponent].set(opp)
        inner, ts = self.env.step(state.inner, pair, oracle)
        return SingleAgentState(inner, key), self._view(ts)

    def _view(self, ts):
        return ts._replace(obs=ts.obs[self.me], rewards=ts.rewards[self.me])
