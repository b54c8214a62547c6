"""Multi-device sharding on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pikazoo_tpu.envs import EnvConfig, PikaZoo
from pikazoo_tpu.parallel import (env_sharding, make_env_mesh, shard_batch)
from pikazoo_tpu.train import PPOConfig, make_ppo_trainer


def test_eight_virtual_devices_present():
    assert len(jax.devices()) == 8, \
        "conftest should provide 8 virtual CPU devices"


def test_sharded_rollout_matches_unsharded():
    env = PikaZoo(EnvConfig(auto_reset=True))
    B, T = 64, 200
    state, _ = env.reset_batch(jax.random.key(0), B)

    def make_rollout(sharding):
        def rollout(state, key):
            def body(carry, _):
                st, key = carry
                key, sub = jax.random.split(key)
                acts = jax.random.randint(sub, (B, 2), 0, 18, jnp.int32)
                if sharding is not None:
                    acts = jax.lax.with_sharding_constraint(acts, sharding)
                st, ts = env.step_batch(st, acts)
                return (st, key), ts.obs

            return jax.lax.scan(body, (state, key), None, length=T)

        return rollout

    (plain_state, _), plain_obs = jax.jit(make_rollout(None))(
        state, jax.random.key(1))

    mesh = make_env_mesh()
    sharded_state = shard_batch(state, mesh)
    rollout_sharded = jax.jit(make_rollout(env_sharding(mesh)),
                              in_shardings=(env_sharding(mesh), None))
    (shard_state, _), shard_obs = rollout_sharded(sharded_state,
                                                  jax.random.key(1))
    # Output really is sharded over the env axis.
    assert len(shard_state.scores.sharding.device_set) == 8

    np.testing.assert_array_equal(np.asarray(plain_obs), np.asarray(shard_obs))
    np.testing.assert_array_equal(np.asarray(plain_state.scores),
                                  np.asarray(shard_state.scores))


def test_ppo_train_step_on_mesh():
    mesh = make_env_mesh()
    env = PikaZoo(EnvConfig(winning_score=2))
    cfg = PPOConfig(num_envs=32, rollout_length=16, num_minibatches=2,
                    update_epochs=2, hidden=(32, 32))
    init_fn, train_step, _ = make_ppo_trainer(env, cfg, mesh=mesh)
    runner = init_fn(jax.random.key(5))
    runner = runner._replace(
        env_state=shard_batch(runner.env_state, mesh),
        last_obs=jax.device_put(runner.last_obs, env_sharding(mesh)))
    step = jax.jit(train_step)
    for _ in range(2):
        runner, metrics = step(runner)
    assert np.isfinite(float(metrics.total_loss))
    # Env state stayed sharded across the whole train step.
    assert len(runner.env_state.scores.sharding.device_set) == 8


@pytest.mark.parametrize("error, tolerated", [
    (RuntimeError("distributed.initialize should only be called once."),
     True),
    (RuntimeError("jax.distributed.initialize() must be called before any "
                  "JAX computations are executed."), False),
    (ValueError("coordinator_address should be defined."), False),
])
def test_init_distributed_tolerates_only_a_second_call(monkeypatch, error,
                                                       tolerated):
    """A failed multi-process start raises; only "already initialized" is
    a no-op, so a run never falls back to a single process unnoticed."""
    from pikazoo_tpu.parallel import init_distributed

    seen = []

    def fake_initialize(**kwargs):
        seen.append(kwargs)
        raise error

    monkeypatch.setattr(jax.distributed, "initialize", fake_initialize)
    kwargs = dict(coordinator_address="localhost:1234", num_processes=2,
                  process_id=0)
    if tolerated:
        init_distributed(**kwargs)
    else:
        with pytest.raises(type(error)):
            init_distributed(**kwargs)
    assert seen == [kwargs]
