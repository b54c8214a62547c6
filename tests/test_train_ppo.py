"""PPO trainer: smoke, determinism, learning signal, checkpoint round-trip."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pikazoo_tpu.envs import EnvConfig, PikaZoo
from pikazoo_tpu.train import PPOConfig, make_ppo_trainer
from pikazoo_tpu.train import checkpoint as ckpt


def tiny_cfg(**kw):
    base = dict(num_envs=16, rollout_length=16, num_minibatches=2,
                update_epochs=2, hidden=(32, 32))
    base.update(kw)
    return PPOConfig(**base)


def test_ppo_train_step_runs_and_is_finite():
    env = PikaZoo(EnvConfig(winning_score=2))
    init_fn, train_step, _ = make_ppo_trainer(env, tiny_cfg())
    runner = init_fn(jax.random.key(0))
    step = jax.jit(train_step)
    for _ in range(3):
        runner, metrics = step(runner)
    assert np.isfinite(float(metrics.total_loss))
    assert np.isfinite(float(metrics.entropy))
    assert float(metrics.entropy) > 0
    assert int(metrics.env_steps) == 16 * 16
    # Env actually advanced.
    assert int(np.asarray(runner.env_state.step_count).min()) == 3 * 16


def test_ppo_deterministic_given_key():
    env = PikaZoo(EnvConfig())
    init_fn, train_step, _ = make_ppo_trainer(env, tiny_cfg())
    step = jax.jit(train_step)

    r1, m1 = step(init_fn(jax.random.key(1)))
    r2, m2 = step(init_fn(jax.random.key(1)))
    assert float(m1.total_loss) == float(m2.total_loss)
    l1 = jax.tree.leaves(r1.params)
    l2 = jax.tree.leaves(r2.params)
    for a, b in zip(l1, l2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ppo_entropy_decreases_with_training():
    """A crude learning signal: after some updates the policy should move off
    uniform (entropy drops) without diverging."""
    env = PikaZoo(EnvConfig(winning_score=2))
    cfg = tiny_cfg(num_envs=64, rollout_length=32, entropy_coef=0.0)
    init_fn, train_step, _ = make_ppo_trainer(env, cfg)
    runner = init_fn(jax.random.key(2))
    step = jax.jit(train_step)
    runner, m0 = step(runner)
    first_entropy = float(m0.entropy)
    for _ in range(15):
        runner, m = step(runner)
    assert np.isfinite(float(m.total_loss))
    assert float(m.entropy) < first_entropy


def test_checkpoint_roundtrip(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    env = PikaZoo(EnvConfig())
    init_fn, train_step, _ = make_ppo_trainer(env, tiny_cfg())
    runner = init_fn(jax.random.key(3))
    runner, _ = jax.jit(train_step)(runner)

    path = str(tmp_path / "ckpt")
    ckpt.save(path, runner)
    restored = ckpt.restore(path, init_fn(jax.random.key(4)))

    # Bit-exact resume: one more step from each must agree.
    r1, m1 = jax.jit(train_step)(runner)
    r2, m2 = jax.jit(train_step)(restored)
    assert float(m1.total_loss) == float(m2.total_loss)
    np.testing.assert_array_equal(np.asarray(r1.env_state.scores),
                                  np.asarray(r2.env_state.scores))


def test_checkpoint_recovers_finalized_stale_new(tmp_path, monkeypatch):
    """A crash between save()'s two renames leaves the NEWEST finalized
    checkpoint at ``path.new`` with ``path`` absent; both save() and
    latest_restorable() must promote it rather than delete/ignore it
    (advisor round-3 finding: the old save() rmtree'd it, silently losing
    one checkpoint interval)."""
    pytest.importorskip("orbax.checkpoint")
    import os

    import orbax.checkpoint as ocp

    env = PikaZoo(EnvConfig())
    init_fn, train_step, _ = make_ppo_trainer(env, tiny_cfg())
    runner = init_fn(jax.random.key(3))
    runner, _ = jax.jit(train_step)(runner)
    runner2, _ = jax.jit(train_step)(runner)

    path = str(tmp_path / "ckpt")
    ckpt.save(path, runner)
    ckpt.save(path, runner2)
    # Simulate the crash window: the newest finalized checkpoint stranded
    # at .new, nothing at path.
    os.rename(path, path + ".new")

    assert ckpt.latest_restorable(path) == path  # promoted, not ignored
    restored = ckpt.restore(path, init_fn(jax.random.key(4)))
    np.testing.assert_array_equal(np.asarray(restored.env_state.scores),
                                  np.asarray(runner2.env_state.scores))
    assert int(restored.update_index) == int(runner2.update_index)

    # save() itself must promote (not rmtree) a stranded finalized .new:
    # strand again, make the orbax write crash, and verify the stranded
    # state survived as the restorable checkpoint.
    os.rename(path, path + ".new")

    def boom(self, *a, **kw):
        raise RuntimeError("simulated mid-save crash")

    monkeypatch.setattr(ocp.PyTreeCheckpointer, "save", boom)
    with pytest.raises(RuntimeError, match="simulated"):
        ckpt.save(path, runner2)
    assert ckpt.latest_restorable(path) == path
    survived = ckpt.restore(path, init_fn(jax.random.key(4)))
    assert int(survived.update_index) == int(runner2.update_index)


def test_associative_gae_matches_sequential():
    """compute_gae uses an associative scan (O(log T) passes); its result
    must match the defining sequential recurrence to rounding tolerance."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pikazoo_tpu.train.ppo import Transition

    T, n = 37, 64
    gamma, lam = 0.99, 0.95
    k = jax.random.split(jax.random.key(7), 4)
    reward = jax.random.normal(k[0], (T, n))
    value = jax.random.normal(k[1], (T, n))
    done = (jax.random.uniform(k[2], (T, n)) < 0.1).astype(jnp.float32)
    last_value = jax.random.normal(k[3], (n,))

    not_done = 1.0 - done
    next_value = jnp.concatenate([value[1:], last_value[None]], axis=0)
    delta = reward + gamma * next_value * not_done - value
    coef = gamma * lam * not_done

    def seq(carry, t):
        gae = delta[t] + coef[t] * carry
        return gae, gae

    gae_ref = np.zeros((T, n), np.float32)
    carry = jnp.zeros((n,))
    for t in range(T - 1, -1, -1):
        carry, g = seq(carry, t)
        gae_ref[t] = np.asarray(g)

    # The PRODUCTION implementation (what the trainer's compute_gae calls),
    # not a local transcription of it.
    from pikazoo_tpu.train.ppo import gae_associative

    adv, targets = gae_associative(value, reward, done, last_value,
                                   gamma, lam)
    np.testing.assert_allclose(np.asarray(adv), gae_ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(targets),
                               gae_ref + np.asarray(value), rtol=1e-5,
                               atol=1e-5)


def test_inverse_cdf_sampling_distribution():
    """The one-uniform CDF walk samples the same distribution as
    jax.random.categorical (which burns a (2B, A) gumbel tensor)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    logits = jnp.asarray([[2.0, 0.0, -1.0, 0.5] * 2] * 1, jnp.float32)
    logits = jnp.tile(logits, (200_000, 1))                # (N, 8)
    log_probs = jax.nn.log_softmax(logits)
    p = jnp.exp(log_probs.astype(jnp.float32))
    cdf = jnp.cumsum(p, axis=-1)
    u = jax.random.uniform(jax.random.key(0), (logits.shape[0], 1),
                           jnp.float32)
    action = np.asarray(jnp.sum(cdf < u * cdf[:, -1:], axis=-1))
    counts = np.bincount(action, minlength=8) / action.shape[0]
    expect = np.asarray(p[0]) / float(np.asarray(cdf[0, -1]))
    np.testing.assert_allclose(counts, expect, atol=0.004)
    assert action.min() >= 0 and action.max() < 8


def test_apply_fm_matches_module_apply():
    """Feature-major forward == ActorCritic.apply (same bf16 operands;
    only the matmul accumulation order differs)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pikazoo_tpu.train.networks import ActorCritic, apply_fm

    net = ActorCritic(num_actions=18, hidden=(32, 32))
    params = net.init(jax.random.key(0), jnp.zeros((4, 35), jnp.int32))
    x = jax.random.uniform(jax.random.key(1), (512, 35)).astype(jnp.bfloat16)
    logits_rm, value_rm = net.apply(params, x, pre_normalized=True)
    logits_fm, value_fm = apply_fm(params, x.T)
    np.testing.assert_allclose(np.asarray(logits_fm), np.asarray(logits_rm).T,
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(np.asarray(value_fm), np.asarray(value_rm),
                               rtol=1e-2, atol=1e-2)
