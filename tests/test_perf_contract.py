"""Structural performance contracts (VERDICT r2 item 5).

Throughput is only defended by re-benching on the card; these tests pin
the *compiled program shape* on CPU so a refactor cannot silently
reintroduce the known perf-bug classes:

* a padded/materialized obs tensor in the env or learner path (the 15x
  blowup class documented in ``envs/observations.py``) — caught by the
  bytes-accessed envelopes;
* accidental per-frame collectives in the rollout (the design claim in
  ``parallel/mesh.py:4-10`` is that the env axis is embarrassingly parallel
  and the *only* collectives in the system are the learner's gradient
  all-reduces) — caught by grepping the compiled HLO.

Baselines measured 2026-08-19 on CPU XLA (jax 0.9.0); bounds are ~1.4x so
legitimate small changes don't trip them, with a 0.25x floor so the test
fails loudly if the lowering path ever stops measuring what it should.
"""

import jax
import jax.numpy as jnp
import pytest

from pikazoo_tpu.envs import EnvConfig, PikaZoo


def _cost(fn, *args):
    compiled = jax.jit(fn).lower(*args).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return ca.get("bytes accessed", 0.0), ca.get("flops", 0.0)


def _assert_envelope(value, baseline, what, hi=1.4, lo=0.25):
    assert value <= baseline * hi, (
        f"{what} regressed: {value:.0f} > {hi}x baseline {baseline:.0f} — "
        "a layout/materialization blowup or new redundant work")
    assert value >= baseline * lo, (
        f"{what} imploded: {value:.0f} < {lo}x baseline {baseline:.0f} — "
        "the measurement (or the program) no longer covers the real work")


B = 1024


def test_step_batch_cost_envelope():
    env = PikaZoo(EnvConfig(auto_reset=True))
    state, _ = env.reset_batch(jax.random.key(0), B)
    acts = jnp.zeros((B, 2), jnp.int32)
    by, fl = _cost(env.step_batch, state, acts)
    _assert_envelope(by / B, 3553.0, "step_batch bytes/env")
    _assert_envelope(fl / B, 2783.0, "step_batch flops/env")


def test_learner_fast_path_cost_envelope():
    """The PPO rollout's env step: obs comes back (35, 2B) bf16 — if someone
    reroutes it through the (B, 2, 35) int32 assembly the bytes jump ~3x."""
    env = PikaZoo(EnvConfig(auto_reset=True))
    state, _ = env.reset_batch(jax.random.key(0), B)
    a = jnp.zeros((B,), jnp.int32)
    by, fl = _cost(env.step_batch_learner_fm, state, a, a)
    _assert_envelope(by / B, 4389.0, "step_batch_learner_fm bytes/env")
    _assert_envelope(fl / B, 2741.0, "step_batch_learner_fm flops/env")


def test_ai_step_cost_envelope():
    """Computer self-play step (BASELINE config 2): the landing sims are
    while-loops whose flops cost_analysis counts once per trip body; a
    carry-widening or a third sim loop shows up as bytes/flops growth.

    flops baseline re-pinned after the landing-sim unroll default moved
    8 -> 32 (each trip's unrolled body counts 4x the flops; runtime work
    per reference iteration is unchanged — see core/predict.py)."""
    env = PikaZoo(EnvConfig(auto_reset=True, is_player1_computer=True,
                            is_player2_computer=True))
    state, _ = env.reset_batch(jax.random.key(0), B)
    acts = jnp.zeros((B, 2), jnp.int32)
    by, fl = _cost(env.step_batch, state, acts)
    _assert_envelope(by / B, 5757.0, "AI step_batch bytes/env")
    _assert_envelope(fl / B, 34916.0, "AI step_batch flops/env")


def test_train_step_cost_envelope():
    """Full PPO train step (rollout, GAE and the XLA autodiff update)."""
    from pikazoo_tpu.train import PPOConfig, make_ppo_trainer

    env = PikaZoo(EnvConfig(auto_reset=True))
    cfg = PPOConfig(num_envs=256, rollout_length=16)
    init_fn, train_step, _ = make_ppo_trainer(env, cfg)
    runner = init_fn(jax.random.key(0))
    compiled = jax.jit(train_step).lower(runner).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    n = 256 * 16
    _assert_envelope(ca["bytes accessed"] / n, 27621.0,
                     "train_step bytes/env-step")
    _assert_envelope(ca["flops"] / n, 285919.0, "train_step flops/env-step")


_COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
                "reduce-scatter", "all-to-all")


def _hlo_collectives(compiled_text):
    return [op for op in _COLLECTIVES if op in compiled_text]


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_env_rollout_has_zero_collectives():
    """The design claim of parallel/mesh.py: the env step is embarrassingly
    parallel over the env axis, so a T-frame rollout scan compiled over an
    8-device mesh must contain NO collectives at all."""
    from pikazoo_tpu.parallel import env_sharding, make_env_mesh, shard_batch

    env = PikaZoo(EnvConfig(auto_reset=True))
    mesh = make_env_mesh()
    state, _ = env.reset_batch(jax.random.key(0), 64)
    state = shard_batch(state, mesh)

    def roll(state, key):
        def body(carry, _):
            st, key = carry
            key, sub = jax.random.split(key)
            acts = jax.random.randint(sub, (64, 2), 0, 18, jnp.int32)
            st, ts = env.step_batch(st, acts)
            return (st, key), ts.rewards
        (state, _), rews = jax.lax.scan(body, (state, key), None, length=8)
        return state, rews

    compiled = jax.jit(roll).lower(state, jax.random.key(1)).compile()
    text = compiled.as_text()
    found = _hlo_collectives(text)
    assert not found, f"env rollout compiled with collectives: {found}"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_meshed_ppo_rollout_has_zero_collectives():
    """The PPO rollout runs under shard_map with a device-local seat-blocked
    layout, so it must compile with NO collectives on the mesh.  (Before
    round 5 the GSPMD-propagated global seat-blocked layout split each
    env's two seats across devices and the compiler inserted 21 all-gathers
    + 6 collective-permutes per train step — a 27x rollout slowdown at 2
    real processes.)"""
    from pikazoo_tpu.parallel import env_sharding, make_env_mesh, shard_batch
    from pikazoo_tpu.train import PPOConfig, make_ppo_trainer

    env = PikaZoo(EnvConfig(auto_reset=True))
    mesh = make_env_mesh()
    cfg = PPOConfig(num_envs=64, rollout_length=8, num_minibatches=2,
                    update_epochs=1)
    init_fn, train_step, _ = make_ppo_trainer(env, cfg, mesh=mesh)
    runner = init_fn(jax.random.key(0))
    runner = runner._replace(
        env_state=shard_batch(runner.env_state, mesh),
        last_obs=jax.device_put(runner.last_obs, env_sharding(mesh)))
    roll = jax.jit(lambda p, st, obs, key:
                   train_step.rollout_fn(p, st, obs, key))
    text = roll.lower(runner.params, runner.env_state, runner.last_obs,
                      runner.key).compile().as_text()
    found = _hlo_collectives(text)
    assert not found, f"PPO rollout compiled with collectives: {found}"
    # And the FULL train step may contain only all-reduces (gradient sync
    # + scalar loss/advantage reductions) — any all-gather or
    # collective-permute means a sharded tensor is being redistributed.
    step_text = jax.jit(train_step).lower(runner).compile().as_text()
    redistributions = [op for op in _hlo_collectives(step_text)
                       if op != "all-reduce"]
    assert not redistributions, \
        f"train step redistributes sharded tensors: {redistributions}"


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_meshed_train_step_has_gradient_allreduce():
    """Positive control for the grep above: the mesh-compiled PPO train step
    MUST contain an all-reduce (the gradient sync) — if it doesn't, the
    params went env-sharded (wrong) or the grep no longer sees collectives."""
    from pikazoo_tpu.parallel import make_env_mesh, shard_batch
    from pikazoo_tpu.train import PPOConfig, make_ppo_trainer

    env = PikaZoo(EnvConfig(auto_reset=True))
    mesh = make_env_mesh()
    cfg = PPOConfig(num_envs=64, rollout_length=8, num_minibatches=2,
                    update_epochs=1)
    init_fn, train_step, _ = make_ppo_trainer(env, cfg, mesh=mesh)
    runner = init_fn(jax.random.key(0))
    runner = runner._replace(env_state=shard_batch(runner.env_state, mesh))
    compiled = jax.jit(train_step).lower(runner).compile()
    assert "all-reduce" in compiled.as_text(), \
        "no gradient all-reduce found in the meshed train step"
