"""Parity harness: record the reference env, replay on the JAX env.

The correctness gate (BASELINE.md) is bitwise trajectory parity at batch=1:
35-dim observations, rewards, terminations and serve rotation, frame by frame
over full 15-point games.  The reference draws from a PCG64
``np.random.Generator`` inside data-dependent branches; reproducing that
generator on-device is pointless, so parity splits into two halves:

1. **Record**: run the reference env with a :class:`SpyGenerator` spliced into
   every ``np_random`` reference (env, physics pack, both players), logging
   each ``integers`` draw in order alongside the full trajectory.
2. **Replay**: drive the JAX env in oracle mode (``core.rng``), feeding the
   recorded draw values through the draw-slot counter.  Equality of the
   per-frame draw *counter* with the recorded draw count proves the masked
   conditional-consumption machinery consumes exactly when the reference did;
   equality of obs/rewards/terminations proves the physics.

The reference package is imported from ``/root/reference`` (read-only); tests
skip gracefully when it is absent.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, List, Optional

import numpy as np

REFERENCE_PATH = os.environ.get("PIKAZOO_REFERENCE_PATH", "/root/reference")


def reference_available() -> bool:
    return os.path.isdir(os.path.join(REFERENCE_PATH, "pikazoo"))


def _import_reference():
    if REFERENCE_PATH not in sys.path:
        sys.path.insert(0, REFERENCE_PATH)
    from pikazoo import pikazoo_v0  # noqa: PLC0415
    return pikazoo_v0


class SpyGenerator:
    """Wraps an ``np.random.Generator``, logging every ``integers`` draw."""

    def __init__(self, seed: int):
        self._gen = np.random.default_rng(seed)
        self.log: List[int] = []

    def integers(self, low, high=None, **kwargs):
        value = self._gen.integers(low, high, **kwargs)
        self.log.append(int(value))
        return value

    def __getattr__(self, name):
        return getattr(self._gen, name)


@dataclasses.dataclass
class ReferenceTrace:
    """A recorded reference trajectory plus its RNG draw stream."""

    actions: np.ndarray  # (T, 2) int32 actions fed each step
    obs: np.ndarray  # (T+1, 2, 35) int32; index 0 is the reset obs
    rewards: np.ndarray  # (T, 2) float64 (int-valued unless a wrapper shapes them)
    terminations: np.ndarray  # (T,) bool
    scores: np.ndarray  # (T, 2) int32 (post-step)
    draws: np.ndarray  # (D,) int32 — every integers() result, in order
    draw_count_after_reset: int
    draw_count_after_step: np.ndarray  # (T,) int32 cumulative


def _splice_spy(env, spy: SpyGenerator) -> None:
    env.np_random = spy
    env.physics.np_random = spy
    env.physics.player1.np_random = spy
    env.physics.player2.np_random = spy


def record_reference_trace(
    seed: int,
    n_steps: int,
    action_fn: Callable[[int, np.random.Generator], np.ndarray],
    winning_score: int = 15,
    serve: str = "winner",
    is_player1_computer: bool = False,
    is_player2_computer: bool = False,
    stop_on_termination: bool = True,
    wrap: Optional[Callable] = None,
    render_each_step: bool = False,
) -> ReferenceTrace:
    """Run the reference env, recording trajectory and draw stream.

    ``action_fn(t, rng) -> (2,) int`` supplies actions (from a *separate*
    generator so it does not disturb the spied stream).  ``wrap`` optionally
    wraps the raw reference env (for wrapper-stack parity runs); recording
    always reads the *unwrapped* trajectory via the wrapper chain's returns.

    ``render_each_step`` constructs the env with ``render_mode="rgb_array"``
    and calls ``render()`` after reset and after every step, so the recorded
    draw stream includes the cloud/wave draws the reference render path
    consumes from the gameplay generator (``pikazoo_env.py:349``) — the spy
    is spliced after construction, so the 40 cloud-construction draws are
    NOT in the stream (they come from the pre-splice generator).
    """
    pikazoo_v0 = _import_reference()
    env = pikazoo_v0.env(
        winning_score=winning_score, serve=serve,
        is_player1_computer=is_player1_computer,
        is_player2_computer=is_player2_computer,
        render_mode="rgb_array" if render_each_step else None)
    spy = SpyGenerator(seed)
    _splice_spy(env, spy)
    raw = env
    if render_each_step:
        # The reference constructs clouds from its construction-time
        # (unseeded) generator; rebuild them from the spy so the cloud state
        # — and hence the data-dependent respawn draw schedule — is part of
        # the recorded stream and reproducible by the replayer.
        from pikazoo.env.cloud_and_wave import Cloud, Wave  # noqa: PLC0415
        raw.cloud_array = [Cloud(spy) for _ in range(raw.NUM_OF_CLOUDS)]
        raw.wave_ = Wave()
    if wrap is not None:
        env = wrap(env)

    action_rng = np.random.default_rng(seed + 1_000_003)

    obs_list, rew_list, term_list, score_list, act_list, dc_list = \
        [], [], [], [], [], []
    obs, _ = env.reset()
    if render_each_step:
        raw.render()
    obs_list.append(np.stack([obs["player_1"], obs["player_2"]]))
    draw_count_after_reset = len(spy.log)

    for t in range(n_steps):
        a = np.asarray(action_fn(t, action_rng), np.int32)
        act_list.append(a)
        obs, rew, term, _trunc, info = env.step(
            {"player_1": int(a[0]), "player_2": int(a[1])})
        if render_each_step:
            raw.render()
        obs_list.append(np.stack([obs["player_1"], obs["player_2"]]))
        rew_list.append([rew["player_1"], rew["player_2"]])
        term_list.append(bool(term["player_1"]))
        score_list.append(list(info["player_1"]["score"]))
        dc_list.append(len(spy.log))
        if stop_on_termination and term["player_1"]:
            break

    return ReferenceTrace(
        actions=np.asarray(act_list, np.int32),
        # dtype inferred: int64 for the raw env, float when a wrapper (e.g.
        # NormalizeObservation) transforms observations.
        obs=np.asarray(obs_list),
        rewards=np.asarray(rew_list, np.float64),
        terminations=np.asarray(term_list, bool),
        scores=np.asarray(score_list, np.int32),
        draws=np.asarray(spy.log, np.int32),
        draw_count_after_reset=draw_count_after_reset,
        draw_count_after_step=np.asarray(dc_list, np.int32),
    )
