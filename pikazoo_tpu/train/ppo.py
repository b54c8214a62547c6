"""Self-play PPO actor-learner on the sharded env batch (SURVEY.md N7).

One ``train_step`` = rollout ``T`` frames on ``B`` vmapped envs (both seats
share the policy; each seat contributes a trajectory, so the learner batch is
``T x 2B``), GAE, and several clipped-PPO epochs — all inside a single
``jit``.  Sharding: env state / trajectories are split along the batch axis
of the device mesh; parameters and optimizer state are replicated.  The
rollout runs under ``shard_map`` with a device-LOCAL seat-blocked layout,
so the rollout has no collectives and the train step's only collectives
are the gradient/loss all-reduces XLA inserts (asserted from the compiled
HLO in ``tests/test_perf_contract.py``); meshed action sampling slices
each shard's columns out of the global uniform row, so meshed and
single-device training are bit-matched.

Layout: the learner tensors fold the seat axis into the batch axis and keep
that batch axis minor-most (see ``Transition``).

Minibatches are formed by shuffling and splitting the TIME axis while keeping
the (sharded) batch axis intact, so the update phase needs no resharding
communication; the per-minibatch sample diversity comes from the thousands of
independent env lanes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from pikazoo_tpu.envs.pika_volley import EnvState, PikaZoo
from pikazoo_tpu.parallel.mesh import env_sharding, replicated_sharding
from pikazoo_tpu.train.networks import ActorCritic


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 4096
    rollout_length: int = 128
    num_actions: int = 18  # 13 when trained through SimplifyAction
    learning_rate: float = 3e-4
    # Linear LR anneal to 0 over this many updates (None = constant LR).
    anneal_updates: Optional[int] = None
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    update_epochs: int = 4
    num_minibatches: int = 4  # splits the time axis
    hidden: Tuple[int, ...] = (256, 256)
    activation: str = "tanh"  # or "relu" (see networks.ActorCritic)
    # "both": symmetric self-play, both seats feed the learner.
    # "p1": only seat 1's trajectory trains (e.g. vs the rule AI on seat 2 —
    # pass an env with is_player2_computer=True; the AI ignores seat-2 input).
    learner_seats: str = "both"
    # Shuffle the trajectory's time axis before the minibatch split.  Each
    # minibatch already mixes T_mb frames x 2B env-seats (millions of
    # near-i.i.d. rows), so the frame-level shuffle adds no measurable
    # decorrelation at this scale — vs-AI training reaches the same 100%
    # win rate by update 250 with or without it (artifacts/
    # fm_vs_ai_training.jsonl vs noshuffle run) — while its gather
    # materializes a full trajectory copy (~1.5 GB at 65536 envs).  Default
    # OFF; turn on for textbook-PPO epoch semantics.
    shuffle_minibatches: bool = False


class Transition(NamedTuple):
    """Per-frame learner record with the SEAT DIMENSION FOLDED INTO BATCH:
    leaves are (2B,) / (2B, 35), seat-BLOCKED (rows [0, B) are seat 1,
    [B, 2B) seat 2 — the layout ``env.step_batch_learner`` emits; on a
    mesh the blocking is per DEVICE SHARD, since the rollout runs under
    shard_map — every consumer is column-order-agnostic)."""

    obs: jnp.ndarray       # (35, 2B) normalized bfloat16, FEATURE-MAJOR
    action: jnp.ndarray    # (2B,)
    log_prob: jnp.ndarray  # (2B,)
    value: jnp.ndarray     # (2B,)
    reward: jnp.ndarray    # (2B,) float32
    done: jnp.ndarray      # (2B,) float32 (episode end, repeated per seat)


class PPORunnerState(NamedTuple):
    params: dict
    opt_state: optax.OptState
    env_state: EnvState
    last_obs: jnp.ndarray  # (B, 2, 35)
    key: jax.Array
    update_index: jnp.ndarray


class TrainMetrics(NamedTuple):
    total_loss: jnp.ndarray
    policy_loss: jnp.ndarray
    value_loss: jnp.ndarray
    entropy: jnp.ndarray
    approx_kl: jnp.ndarray
    mean_reward: jnp.ndarray
    episodes_finished: jnp.ndarray
    env_steps: jnp.ndarray


def gae_associative(value: jnp.ndarray, reward: jnp.ndarray,
                    done: jnp.ndarray, last_value: jnp.ndarray,
                    gamma: float, lam: float
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """GAE advantages/targets over leading time axis T.

    GAE is the first-order linear recurrence
      ``gae_t = delta_t + (gamma * lam * not_done_t) * gae_{t+1}``,
    evaluated with an ASSOCIATIVE scan: a sequential lax.scan issues T tiny
    kernels over the (2B,) learner batch; the associative form is O(log T)
    full-buffer passes.  Float reassociation makes it differ from the
    sequential scan only at rounding level (tested to 1e-5 in test_train_ppo.py, which
    exercises THIS function)."""
    not_done = 1.0 - done                                  # (T, 2B)
    next_value = jnp.concatenate([value[1:], last_value[None]], axis=0)
    delta = reward + gamma * next_value * not_done - value
    coef = gamma * lam * not_done
    # Last element's recurrence term is gae_{T} = 0, so coef_T is unused;
    # flip to run the suffix recurrence as a prefix scan.
    a = jnp.flip(coef, axis=0)
    b = jnp.flip(delta, axis=0)

    def combine(left, right):
        a_l, b_l = left
        a_r, b_r = right
        return a_l * a_r, a_r * b_l + b_r

    _, y = jax.lax.associative_scan(combine, (a, b), axis=0)
    advantages = jnp.flip(y, axis=0)
    return advantages, advantages + value


def reference_loss(params, batch: Transition, advantages, targets,
                   cfg: PPOConfig):
    """Float32 transcription of the trainer's minibatch loss — the plain
    reference its bf16 XLA gradient is checked against.

    Written independently of ``networks.ActorCritic``: float32 operands and
    activations, matmuls at ``highest`` precision (no TF32), a gather for
    the action log-prob.  Returns the total loss."""
    with jax.default_matmul_precision("highest"):
        dense = params["params"]
        names = sorted(dense, key=lambda s: int(s.rsplit("_", 1)[1]))
        h = jnp.swapaxes(batch.obs, -2, -1).astype(jnp.float32)
        act = jax.nn.relu if cfg.activation == "relu" else jnp.tanh
        for n in names[:-2]:
            h = act(h @ dense[n]["kernel"] + dense[n]["bias"])
        logits = h @ dense[names[-2]]["kernel"] + dense[names[-2]]["bias"]
        value = (h @ dense[names[-1]]["kernel"]
                 + dense[names[-1]]["bias"])[..., 0]
    log_probs = jax.nn.log_softmax(logits)
    log_prob = jnp.take_along_axis(log_probs, batch.action[..., None],
                                   axis=-1)[..., 0]
    ratio = jnp.exp(log_prob - batch.log_prob)
    adv = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
    policy_loss = -jnp.minimum(
        ratio * adv,
        jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv).mean()
    value_clipped = batch.value + jnp.clip(value - batch.value,
                                           -cfg.clip_eps, cfg.clip_eps)
    value_loss = 0.5 * jnp.maximum((value - targets) ** 2,
                                   (value_clipped - targets) ** 2).mean()
    entropy = -(jnp.exp(log_probs) * log_probs).sum(-1).mean()
    return policy_loss + cfg.value_coef * value_loss \
        - cfg.entropy_coef * entropy


def make_ppo_trainer(env: PikaZoo, cfg: PPOConfig = PPOConfig(),
                     mesh: Optional[Mesh] = None):
    """Build ``(init_fn, train_step_fn, network)``.

    ``init_fn(key) -> PPORunnerState`` and
    ``train_step_fn(runner) -> (runner, TrainMetrics)`` (jit-able; pass
    ``mesh`` to get sharding constraints for multi-device execution).
    """
    network = ActorCritic(num_actions=cfg.num_actions, hidden=cfg.hidden,
                          activation=cfg.activation)
    if cfg.anneal_updates:
        steps_per_update = cfg.update_epochs * cfg.num_minibatches
        lr = optax.linear_schedule(
            cfg.learning_rate, 0.0, cfg.anneal_updates * steps_per_update)
    else:
        lr = cfg.learning_rate
    tx = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adam(lr),
    )

    def _constrain(tree, sharded: bool):
        if mesh is None:
            return tree
        s = env_sharding(mesh) if sharded else replicated_sharding(mesh)
        return jax.lax.with_sharding_constraint(tree, s)

    # ---------------------------------------------------------------- init --
    def init_fn(key: jax.Array) -> PPORunnerState:
        key, net_key, env_key = jax.random.split(key, 3)
        env_state, ts = env.reset_batch(env_key, cfg.num_envs)
        params = network.init(net_key, ts.obs)
        opt_state = tx.init(params)
        return PPORunnerState(params, opt_state, env_state, ts.obs, key,
                              jnp.int32(0))

    # ------------------------------------------------------------- rollout --
    def policy_sample(params, norm_obs_fm, u):
        # FEATURE-MAJOR policy step: obs (F, 2B) -> logits (A, 2B), so all
        # per-action math (softmax, sampling, log-prob select) reduces over
        # the leading axis.
        from pikazoo_tpu.train.networks import apply_fm

        logits, value = apply_fm(params, norm_obs_fm,
                                 activation=cfg.activation)
        log_probs = jax.nn.log_softmax(logits, axis=0)     # (A, 2B)
        # Inverse-CDF sampling with ONE uniform per column instead of
        # jax.random.categorical's (A, 2B) gumbel tensor (18x the bits).
        p = jnp.exp(log_probs.astype(jnp.float32))
        # Prefix-sum over the A=18 actions as a tiny triangular matmul
        # ((A, A) @ (A, 2B)) instead of jnp.cumsum's reduce-window.
        tri = jnp.tril(jnp.ones((cfg.num_actions, cfg.num_actions),
                                jnp.float32))
        cdf = jax.lax.dot_general(tri, p, (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.float32)
        # ``u`` is the (1, 2B) per-column uniform row, drawn by the caller
        # (on a mesh each shard slices its columns out of the GLOBAL row so
        # meshed and single-device sampling are bit-identical).
        # Scale by the column total (~1.0) so bf16 rounding in the logits
        # can never push u past the last bucket.
        action = jnp.sum(cdf < u * cdf[-1:, :], axis=0)
        one_hot = (jax.lax.broadcasted_iota(jnp.int32, log_probs.shape, 0)
                   == action[None, :]).astype(log_probs.dtype)
        log_prob = (log_probs * one_hot).sum(axis=0)       # (2B,)
        return action.astype(jnp.int32), log_prob, value

    def _rollout_body(params, env_state, obs, key, axis=None):
        from pikazoo_tpu.train.networks import normalize_obs

        # Learner fast path (env.step_batch_learner): the env hands back
        # normalized bf16 seat-BLOCKED (2B, 35) rows directly (stored as-is
        # in the trajectory, so update-phase log-probs recompute from
        # bit-identical network inputs) without materializing the standard
        # step's (B, 2, 35) int32 obs tensor.
        num_envs = obs.shape[0]
        norm0 = jnp.concatenate(
            [normalize_obs(obs[:, 0]).T, normalize_obs(obs[:, 1]).T],
            axis=1).astype(jnp.bfloat16)                   # (35, 2B)

        def step(carry, _):
            env_state, norm_obs, key = carry
            key, akey = jax.random.split(key)
            if axis is None:
                u = jax.random.uniform(akey, (1, norm_obs.shape[1]),
                                       jnp.float32)
            else:
                # Every shard draws the GLOBAL uniform row from the
                # replicated key (2B floats — trivially cheap) and slices
                # its own seat-blocked columns, so meshed sampling is
                # bit-identical to the single-device run and the carry key
                # stays replicated.  Global seat-blocked layout: seat-1
                # columns [0, B) then seat-2 [B, 2B); this shard holds
                # local envs [i*b, (i+1)*b) of each seat block.
                n = mesh.shape[axis]  # static: shapes must be concrete
                b = num_envs  # local envs per shard
                u_full = jax.random.uniform(akey, (1, 2 * b * n),
                                            jnp.float32)
                i = jax.lax.axis_index(axis)
                u = jnp.concatenate([
                    jax.lax.dynamic_slice(u_full, (0, i * b), (1, b)),
                    jax.lax.dynamic_slice(u_full, (0, (n + i) * b), (1, b)),
                ], axis=1)
            action, log_prob, value = policy_sample(params, norm_obs, u)
            env_state, next_norm, reward1, terminated = \
                env.step_batch_learner_fm(env_state, action[:num_envs],
                                          action[num_envs:])
            done = (terminated == 1).astype(jnp.float32)
            reward1 = reward1.astype(jnp.float32)
            tr = Transition(obs=norm_obs, action=action, log_prob=log_prob,
                            value=value,
                            reward=jnp.concatenate([reward1, -reward1]),
                            done=jnp.concatenate([done, done]))
            return (env_state, next_norm, key), tr

        return jax.lax.scan(step, (env_state, norm0, key), None,
                            length=cfg.rollout_length)

    if mesh is None:
        rollout = _rollout_body
    else:
        # The rollout runs UNDER shard_map: each device steps its own env
        # shard with a device-local seat-blocked (35, 2B_local) layout, so
        # the program contains ZERO rollout collectives by construction.
        # (Under plain GSPMD the global seat-blocked layout put an env's
        # two seats on different devices — the [p1 | p2] column halves vs
        # the contiguous env sharding — and the compiler inserted 21
        # all-gathers + 6 collective-permutes per train step to
        # redistribute at every seat-pairing op; a 27x rollout slowdown at
        # 2 processes on the localhost CPU mesh.)  Globally the
        # learner columns become per-DEVICE-blocked; every consumer
        # (GAE, loss means) is column-order-agnostic, and
        # the seat() selector below is shard_map'd to match.
        _ax = mesh.axis_names[0]
        from jax.sharding import PartitionSpec as _P

        def rollout(params, env_state, obs, key):
            return jax.shard_map(
                functools.partial(_rollout_body, axis=_ax), mesh=mesh,
                in_specs=(_P(), _P(_ax), _P(_ax), _P()),
                out_specs=((_P(_ax), _P(None, _ax), _P()),
                           Transition(obs=_P(None, None, _ax),
                                      action=_P(None, _ax),
                                      log_prob=_P(None, _ax),
                                      value=_P(None, _ax),
                                      reward=_P(None, _ax),
                                      done=_P(None, _ax))),
                check_vma=False)(params, env_state, obs, key)

    # ----------------------------------------------------------------- GAE --
    def compute_gae(traj: Transition, last_value: jnp.ndarray):
        return gae_associative(traj.value, traj.reward, traj.done,
                               last_value, cfg.gamma, cfg.gae_lambda)

    # ---------------------------------------------------------------- loss --
    def _select_log_prob(log_probs, action):
        # One-hot contraction instead of take_along_axis, whose backward is
        # a scatter.
        one_hot = jax.nn.one_hot(action, cfg.num_actions,
                                 dtype=log_probs.dtype)
        return (log_probs * one_hot).sum(-1)

    def loss_fn(params, batch: Transition, advantages, targets):
        # The production minibatch loss (XLA autodiff).  batch.obs is
        # feature-major (..., 35, 2B) and the network wants the feature dim
        # minor, so every minibatch is transposed here; what that costs on
        # the GPU is measured in PERF.md.
        logits, value = network.apply(params,
                                      jnp.swapaxes(batch.obs, -2, -1),
                                      pre_normalized=True)
        log_probs = jax.nn.log_softmax(logits)
        log_prob = _select_log_prob(log_probs, batch.action)
        ratio = jnp.exp(log_prob - batch.log_prob)
        adv = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
        unclipped = ratio * adv
        clipped = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        policy_loss = -jnp.minimum(unclipped, clipped).mean()
        value_clipped = batch.value + jnp.clip(
            value - batch.value, -cfg.clip_eps, cfg.clip_eps)
        value_loss = 0.5 * jnp.maximum(
            (value - targets) ** 2, (value_clipped - targets) ** 2).mean()
        entropy = -(jnp.exp(log_probs) * log_probs).sum(-1).mean()
        total = policy_loss + cfg.value_coef * value_loss \
            - cfg.entropy_coef * entropy
        approx_kl = ((ratio - 1) - jnp.log(ratio)).mean()
        return total, (policy_loss, value_loss, entropy, approx_kl)

    def minibatch_grads(params, mtraj, madv, mtarget):
        """The exact minibatch-gradient program train_step runs.  Returns
        ``(grads, losses[5])``."""
        (total, aux), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, mtraj, madv, mtarget)
        return grads, jnp.stack([total, *aux])

    # ---------------------------------------------------------- train step --
    def train_step(runner: PPORunnerState
                   ) -> Tuple[PPORunnerState, TrainMetrics]:
        from pikazoo_tpu.envs.observations import assemble_obs

        (env_state, last_norm, key), traj = rollout(
            jax.lax.stop_gradient(runner.params), runner.env_state,
            runner.last_obs, runner.key)

        # Raw-obs view of the final state for PPORunnerState.last_obs (one
        # assembly per train step; the rollout itself never builds it).
        # Carrying the (35, 2B) bf16 last_norm in the runner instead would
        # also skip the next rollout's re-normalization, but
        # it changes the checkpoint pytree and breaks restore of existing
        # artifacts — deliberately not done.
        last_obs = jax.vmap(assemble_obs)(
            env_state.p1, env_state.p2, env_state.ball,
            env_state.power_hit_key_down_prev)

        from pikazoo_tpu.train.networks import apply_fm
        _, last_value = apply_fm(runner.params, last_norm,
                                 activation=cfg.activation)  # (2B,)
        advantages, targets = compute_gae(traj, last_value)

        if cfg.learner_seats == "p1":
            # Keep only seat 1's trajectory for the update phase (seat-
            # BLOCKED flat layout: seat 1 is the first half of the env
            # axis, which is the LAST dim of every leaf — (T, 2B) scalars
            # and (T, 35, 2B) feature-major obs alike).  On a mesh the
            # blocking is per DEVICE (the rollout runs under shard_map),
            # so the selector must slice each local shard, not the global
            # column range.
            def _first_half(v):
                return v[..., :v.shape[-1] // 2]

            def seat(x):
                if mesh is None:
                    return _first_half(x)
                from jax.sharding import PartitionSpec as P
                spec = P(*([None] * (x.ndim - 1)), mesh.axis_names[0])
                return jax.shard_map(_first_half, mesh=mesh, in_specs=spec,
                                     out_specs=spec, check_vma=False)(x)

            traj = Transition(*[seat(leaf) for leaf in traj])
            advantages, targets = seat(advantages), seat(targets)

        # Minibatch over the time axis: shuffle T, split into chunks.
        key, perm_key = jax.random.split(key)
        batch = (traj, advantages, targets)
        if cfg.shuffle_minibatches:
            perm = jax.random.permutation(perm_key, cfg.rollout_length)
            batch = jax.tree.map(lambda x: x[perm], batch)

        def epoch(carry, _):
            params, opt_state = carry

            def minibatch(carry, mb):
                params, opt_state = carry
                mtraj, madv, mtarget = mb
                grads, losses = minibatch_grads(params, mtraj, madv, mtarget)
                total, aux = losses[0], tuple(losses[1:])
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), (total, *aux)

            mbs = jax.tree.map(
                lambda x: x.reshape(cfg.num_minibatches,
                                    cfg.rollout_length // cfg.num_minibatches,
                                    *x.shape[1:]),
                batch)
            carry, losses = jax.lax.scan(minibatch, carry, mbs)
            return carry, losses

        (params, opt_state), losses = jax.lax.scan(
            epoch, (runner.params, runner.opt_state), None,
            length=cfg.update_epochs)
        params = _constrain(params, sharded=False)

        total, policy_loss, value_loss, entropy, approx_kl = \
            [x.mean() for x in losses]
        metrics = TrainMetrics(
            total_loss=total, policy_loss=policy_loss, value_loss=value_loss,
            entropy=entropy, approx_kl=approx_kl,
            mean_reward=traj.reward.mean(),
            # done is stored once per (env, seat); episodes are per env.
            episodes_finished=traj.done.sum() /
            (2 if cfg.learner_seats == "both" else 1),
            env_steps=jnp.int32(cfg.rollout_length * cfg.num_envs),
        )
        runner = PPORunnerState(params, opt_state, env_state, last_obs, key,
                                runner.update_index + 1)
        return runner, metrics

    # Phase probes for the measurement tools (tools/gpu_phases.py,
    # tools/multihost_scale.py): the exact rollout and minibatch-gradient
    # programs train_step runs, exposed as attributes so a harness can time
    # each phase without duplicating the trainer internals.
    train_step.rollout_fn = rollout
    train_step.minibatch_grads_fn = minibatch_grads
    train_step.tx = tx
    return init_fn, train_step, network
