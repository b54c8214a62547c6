"""Evaluation harness: win rate of a policy against the built-in rule AI.

The classic pika-zoo benchmark of progress: seat the learned policy as
player 1 and let the reference's rule-based computer control player 2
(``is_player2_computer=True`` makes physics overwrite player 2's input, so the
action fed for that seat is irrelevant).  Batched, auto-resetting, fully
jitted: one scan plays ``num_envs`` matches for ``max_frames`` and tallies
terminations by winner.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from pikazoo_tpu.envs import EnvConfig, PikaZoo


class EvalResult(NamedTuple):
    games: jnp.ndarray
    policy_wins: jnp.ndarray
    win_rate: jnp.ndarray
    mean_score_diff: jnp.ndarray  # policy score - AI score at terminations


def evaluate_vs_computer(network, params, *, num_envs: int = 512,
                         max_frames: int = 20_000, winning_score: int = 5,
                         greedy: bool = True, seed: int = 0,
                         simplify_actions: bool = False,
                         env_config: Optional[EnvConfig] = None) -> EvalResult:
    """Play policy (seat 1) vs rule AI (seat 2); returns aggregate stats.

    Set ``simplify_actions=True`` for policies trained on the 13-action
    SimplifyAction space — their outputs are mapped through the seat-1
    action table before hitting the raw 18-action env."""
    cfg = env_config or EnvConfig(winning_score=winning_score,
                                  is_player2_computer=True, auto_reset=True)
    env = PikaZoo(cfg)
    from pikazoo_tpu.wrappers.transforms import SIMPLIFY_P1

    def run(key):
        ekey, akey = jax.random.split(jax.random.fold_in(key, 1))
        state, ts = env.reset_batch(ekey, num_envs)

        def body(carry, _):
            state, obs, key = carry
            key, sub = jax.random.split(key)
            logits, _ = network.apply(params, obs[:, 0])
            if greedy:
                a1 = jnp.argmax(logits, -1).astype(jnp.int32)
            else:
                a1 = jax.random.categorical(sub, logits).astype(jnp.int32)
            if simplify_actions:
                a1 = jnp.asarray(SIMPLIFY_P1)[a1]
            actions = jnp.stack([a1, jnp.zeros_like(a1)], axis=1)
            state, ts = env.step_batch(state, actions)
            done = ts.terminated == 1
            p1_won = done & (ts.scores[:, 0] > ts.scores[:, 1])
            diff = jnp.where(done, ts.scores[:, 0] - ts.scores[:, 1], 0)
            return (state, ts.obs, key), (done.astype(jnp.int32),
                                          p1_won.astype(jnp.int32), diff)

        (_, _, _), (dones, wins, diffs) = jax.lax.scan(
            body, (state, ts.obs, akey), None, length=max_frames)
        games = dones.sum()
        policy_wins = wins.sum()
        return EvalResult(
            games=games,
            policy_wins=policy_wins,
            win_rate=policy_wins / jnp.maximum(games, 1),
            mean_score_diff=diffs.sum() / jnp.maximum(games, 1),
        )

    return jax.jit(run)(jax.random.key(seed))


def evaluate_head_to_head(network_a, params_a, network_b, params_b, *,
                          num_envs: int = 512, max_frames: int = 20_000,
                          winning_score: int = 5, greedy: bool = True,
                          seed: int = 0, simplify_actions_a: bool = False,
                          simplify_actions_b: bool = False) -> EvalResult:
    """Play policy A (seat 1) vs policy B (seat 2); stats are from A's side.

    The env mirrors observations per seat (``obs[:, 0]`` is seat 1's view,
    ``obs[:, 1]`` seat 2's; reference `pikazoo_env.py:576-588`).  This is
    the building block for checkpoint ladders / league-style strength
    tracking; ``EvalResult.win_rate`` is A's.  ``simplify_actions_*`` map
    13-action SimplifyAction policies through the per-seat
    relative-direction tables.

    Seat caveat: raw-env actions use ABSOLUTE directions and observations
    carry absolute coordinates, so seats are distinguishable and a policy
    trained on one seat only (e.g. ``learner_seats="p1"``) is
    out-of-distribution on the other — the committed vs-AI artifact wins
    ~95% of its own mirror match from seat 1 for exactly this reason.
    The harness itself is unbiased (a seat-agnostic random policy's mirror
    match measures 50.7% over ~490 games, pinned in
    ``tests/test_trained_artifact.py``).  Compare seat specialists
    same-seat (two calls with seats swapped); symmetric self-play
    checkpoints (``learner_seats="both"``) compare directly.

    Near-peer note (round 5, hardware-measured): games between two strong
    policies average ~2k frames per point, so ``max_frames``/``num_envs``
    must be generous for enough games to finish (128 envs x 24k frames ->
    ~20 games at winning_score=3); and at peak level the matchup itself
    can be seat-sensitive (between the 4000- and 8000-update flagships the
    seat-2 defender won BOTH seat orders, 83%/60%) — always evaluate both
    orders before calling a winner.
    """
    cfg = EnvConfig(winning_score=winning_score, auto_reset=True)
    env = PikaZoo(cfg)
    from pikazoo_tpu.wrappers.transforms import SIMPLIFY_P1, SIMPLIFY_P2

    def run(key):
        ekey, akey = jax.random.split(jax.random.fold_in(key, 2))
        state, ts = env.reset_batch(ekey, num_envs)

        def act(net, prm, obs_side, sub, table):
            logits, _ = net.apply(prm, obs_side)
            if greedy:
                a = jnp.argmax(logits, -1).astype(jnp.int32)
            else:
                a = jax.random.categorical(sub, logits).astype(jnp.int32)
            return jnp.asarray(table)[a] if table is not None else a

        def body(carry, _):
            state, obs, key = carry
            key, s1, s2 = jax.random.split(key, 3)
            a1 = act(network_a, params_a, obs[:, 0], s1,
                     SIMPLIFY_P1 if simplify_actions_a else None)
            a2 = act(network_b, params_b, obs[:, 1], s2,
                     SIMPLIFY_P2 if simplify_actions_b else None)
            state, ts = env.step_batch(state, jnp.stack([a1, a2], axis=1))
            done = ts.terminated == 1
            a_won = done & (ts.scores[:, 0] > ts.scores[:, 1])
            diff = jnp.where(done, ts.scores[:, 0] - ts.scores[:, 1], 0)
            return (state, ts.obs, key), (done.astype(jnp.int32),
                                          a_won.astype(jnp.int32), diff)

        (_, _, _), (dones, wins, diffs) = jax.lax.scan(
            body, (state, ts.obs, akey), None, length=max_frames)
        games = dones.sum()
        a_wins = wins.sum()
        return EvalResult(
            games=games,
            policy_wins=a_wins,
            win_rate=a_wins / jnp.maximum(games, 1),
            mean_score_diff=diffs.sum() / jnp.maximum(games, 1),
        )

    return jax.jit(run)(jax.random.key(seed))


def bradley_terry_elo(wins, games, anchor: int = -1,
                      anchor_elo: float = 1000.0, prior_games: float = 1.0,
                      iters: int = 500, tol: float = 1e-10):
    """Fit Bradley-Terry strengths to a league result matrix, as Elo.

    ``wins[i][j]`` = games i beat j, ``games[i][j]`` = games i played j
    (symmetric).  Standard MM fixed point (Hunter 2004) with a light prior
    (``prior_games`` pseudo-games at 50% vs the field mean) so undefeated /
    never-winning members stay finite.  Returns a numpy array of Elo
    ratings (400*log10 scale) with member ``anchor`` pinned at
    ``anchor_elo`` — e.g. the rule AI as a fixed yardstick, so ratings are
    comparable across leagues that share the anchor.  The building block
    behind ``tools/selfplay_league.py`` / ``artifacts/selfplay_league.json``.
    """
    import numpy as np

    wins = np.asarray(wins, dtype=np.float64)
    games = np.asarray(games, dtype=np.float64)
    n = wins.shape[0]
    assert wins.shape == (n, n) and games.shape == (n, n)
    p = np.ones(n)
    half = prior_games / 2.0
    for _ in range(iters):
        p_new = np.empty(n)
        mean = p.mean()
        for i in range(n):
            num = wins[i].sum() + half
            den = prior_games / (p[i] + mean)
            for j in range(n):
                if j != i and games[i, j] > 0:
                    den += games[i, j] / (p[i] + p[j])
            p_new[i] = num / den
        p_new /= np.exp(np.mean(np.log(p_new)))  # fix the scale each sweep
        done = np.max(np.abs(np.log(p_new) - np.log(p))) < tol
        p = p_new
        if done:
            break
    return anchor_elo + 400.0 * (np.log10(p) - np.log10(p[anchor]))
