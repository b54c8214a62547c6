"""The PPO minibatch gradient (XLA autodiff of ``loss_fn``, bf16 operands)
against ``reference_loss``, a float32 transcription at ``highest`` matmul
precision — on one device and on a 4-device env mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pikazoo_tpu.envs import EnvConfig, PikaZoo
from pikazoo_tpu.train import PPOConfig, make_ppo_trainer
from pikazoo_tpu.train.ppo import Transition, gae_associative, reference_loss

# bf16 keeps 8 significant bits; three layers forward and backward.
GRAD_RTOL, MIN_COS = 0.05, 0.995


def real_minibatch(mesh=None, num_envs=64, rollout=16):
    """One minibatch of a real rollout, the way train_step builds it."""
    from pikazoo_tpu.parallel import env_sharding, shard_batch

    cfg = PPOConfig(num_envs=num_envs, rollout_length=rollout,
                    hidden=(64, 64))
    init_fn, train_step, _ = make_ppo_trainer(
        PikaZoo(EnvConfig(auto_reset=True)), cfg, mesh=mesh)
    runner = init_fn(jax.random.key(0))
    if mesh is not None:
        runner = runner._replace(
            env_state=shard_batch(runner.env_state, mesh),
            last_obs=jax.device_put(runner.last_obs, env_sharding(mesh)))
    (_, _, _), traj = jax.jit(train_step.rollout_fn)(
        runner.params, runner.env_state, runner.last_obs, runner.key)
    adv, tgt = gae_associative(traj.value, traj.reward, traj.done,
                               jnp.zeros_like(traj.value[0]), cfg.gamma,
                               cfg.gae_lambda)
    t_mb = rollout // cfg.num_minibatches
    mb = (Transition(*[leaf[:t_mb] for leaf in traj]), adv[:t_mb],
          tgt[:t_mb])
    return cfg, train_step, runner.params, mb


def assert_grads_track_reference(grads, ref):
    assert jax.tree.structure(grads) == jax.tree.structure(ref)
    for (path, g), r in zip(jax.tree_util.tree_leaves_with_path(grads),
                            jax.tree.leaves(ref)):
        g = np.asarray(g, np.float64).ravel()
        r = np.asarray(r, np.float64).ravel()
        rel = np.linalg.norm(g - r) / np.linalg.norm(r)
        cos = g @ r / (np.linalg.norm(g) * np.linalg.norm(r))
        assert rel < GRAD_RTOL and cos > MIN_COS, (path, rel, cos)


def test_xla_gradient_matches_float32_reference():
    cfg, train_step, params, mb = real_minibatch()
    grads, losses = jax.jit(train_step.minibatch_grads_fn)(params, *mb)
    ref = jax.jit(jax.grad(lambda p, *b: reference_loss(p, *b, cfg)))(
        params, *mb)
    assert_grads_track_reference(grads, ref)


def test_xla_losses_match_float32_reference():
    cfg, train_step, params, mb = real_minibatch()
    _, losses = jax.jit(train_step.minibatch_grads_fn)(params, *mb)
    total = reference_loss(params, *mb, cfg)
    assert losses.shape == (5,) and np.isfinite(np.asarray(losses)).all()
    np.testing.assert_allclose(float(losses[0]), float(total), rtol=0.02,
                               atol=2e-3)


def test_meshed_gradient_matches_float32_reference():
    """The same check with the minibatch sharded over 4 virtual devices:
    the gradient's cross-device all-reduce changes nothing beyond
    rounding."""
    from pikazoo_tpu.parallel import make_env_mesh

    if len(jax.devices()) < 4:
        pytest.fail("conftest should provide 8 virtual devices")
    mesh = make_env_mesh(jax.devices()[:4])
    cfg, train_step, params, mb = real_minibatch(mesh)
    assert len(mb[0].obs.sharding.device_set) == 4
    grads, _ = jax.jit(train_step.minibatch_grads_fn)(params, *mb)
    local = jax.device_get((params, mb))
    ref = jax.jit(jax.grad(lambda p, *b: reference_loss(p, *b, cfg)))(
        local[0], *local[1])
    assert_grads_track_reference(grads, ref)
