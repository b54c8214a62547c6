"""The plain-JAX actor-critic: parameter layout against the committed
checkpoints, arithmetic against a float64 numpy reference, initialiser."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pikazoo_tpu.train.networks import ActorCritic, normalize_obs

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts")
CHECKPOINTS = ["vs_ai_policy", "selfplay_policy", "selfplay_policy_xl",
               "selfplay_policy_xxl", "selfplay_policy_8000"]


def numpy_forward(params, obs, activation="tanh"):
    """float64 reference of ActorCritic.apply on raw observations."""
    dense = params["params"]
    names = sorted(dense, key=lambda s: int(s.rsplit("_", 1)[1]))
    h = np.asarray(normalize_obs(jnp.asarray(obs)), np.float64)
    w = [np.asarray(dense[n]["kernel"], np.float64) for n in names]
    b = [np.asarray(dense[n]["bias"], np.float64) for n in names]
    for l in range(len(names) - 2):
        h = h @ w[l] + b[l]
        h = np.maximum(h, 0) if activation == "relu" else np.tanh(h)
    return h @ w[-2] + b[-2], (h @ w[-1] + b[-1])[..., 0]


def random_obs(n=256, seed=0):
    from pikazoo_tpu.envs import EnvConfig, PikaZoo

    env = PikaZoo(EnvConfig())
    _, ts = env.reset_batch(jax.random.key(seed), n)
    noise = jax.random.randint(jax.random.key(seed + 1), ts.obs.shape, -40, 40)
    return np.asarray(ts.obs + noise)


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_committed_checkpoint_restores_into_the_network(name):
    """Each committed policy restores into the trainer's runner template
    unchanged: the same parameter tree, shapes and dtypes the network
    builds, and finite outputs through ``apply``."""
    ocp = pytest.importorskip("orbax.checkpoint")
    from pikazoo_tpu.envs import EnvConfig, PikaZoo
    from pikazoo_tpu.train import PPOConfig, make_ppo_trainer
    from pikazoo_tpu.train import checkpoint as ckpt

    path = os.path.join(ARTIFACTS, name)
    with ocp.PyTreeCheckpointer() as c:
        saved = c.metadata(path).item_metadata.tree
    num_envs = saved["env_state"]["scores"].shape[0]
    env = PikaZoo(EnvConfig(auto_reset=True))
    init_fn, _, network = make_ppo_trainer(env, PPOConfig(num_envs=num_envs))
    template = init_fn(jax.random.key(0))
    shapes = jax.tree.map(lambda m: (tuple(m.shape), np.dtype(m.dtype).name),
                          saved["params"])
    assert shapes == jax.tree.map(
        lambda a: (a.shape, a.dtype.name), template.params)

    runner = ckpt.restore(path, template)
    obs = random_obs(64)
    logits, value = network.apply(runner.params, obs)
    assert logits.shape == (64, 2, 18) and value.shape == (64, 2)
    assert np.isfinite(np.asarray(logits)).all()
    ref_logits, _ = numpy_forward(runner.params, obs)
    # A trained policy's logits, bf16 operands: loose but meaningful.
    np.testing.assert_allclose(np.asarray(logits), ref_logits,
                               atol=0.05 * np.abs(ref_logits).max())


@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_float32_apply_matches_float64_reference(activation):
    net = ActorCritic(hidden=(64, 32), compute_dtype=jnp.float32,
                      activation=activation)
    obs = random_obs()
    params = net.init(jax.random.key(3), obs)
    with jax.default_matmul_precision("highest"):
        logits, value = net.apply(params, obs)
    ref_logits, ref_value = numpy_forward(params, obs, activation)
    # float32 rounding of sums whose terms are up to max|ref| in size.
    for got, want in ((logits, ref_logits), (value, ref_value)):
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_bf16_apply_tracks_float64_reference():
    """Production arithmetic (bf16 operands and activations) stays within
    bf16 rounding of the exact forward pass."""
    net = ActorCritic()
    obs = random_obs()
    params = net.init(jax.random.key(4), obs)
    logits, value = net.apply(params, obs)
    assert logits.dtype == jnp.float32 and value.dtype == jnp.float32
    ref_logits, ref_value = numpy_forward(params, obs)
    for got, want in ((logits, ref_logits), (value, ref_value)):
        err = np.abs(np.asarray(got, np.float64) - want).max()
        assert err <= 0.02 * np.abs(want).max() + 1e-3, err


@pytest.mark.parametrize("layer, gain", [(0, np.sqrt(2)), (1, np.sqrt(2)),
                                         (2, 0.01), (3, 1.0)])
def test_kernels_are_scaled_orthogonal(layer, gain):
    net = ActorCritic()
    params = net.init(jax.random.key(5), jnp.zeros((1, 35), jnp.int32))
    w = np.asarray(params["params"][f"Dense_{layer}"]["kernel"], np.float64)
    # Orthonormal columns (fan_in >= fan_out) or rows, times the gain.
    gram = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
    np.testing.assert_allclose(gram, gain ** 2 * np.eye(len(gram)),
                               atol=1e-5 * max(gain ** 2, 1))


def test_init_is_float32_zero_bias_and_seeded():
    net = ActorCritic(hidden=(32, 32))
    obs = jnp.zeros((4, 35), jnp.int32)
    p1, p2 = net.init(jax.random.key(1), obs), net.init(jax.random.key(1), obs)
    p3 = net.init(jax.random.key(2), obs)
    assert sorted(p1["params"]) == ["Dense_0", "Dense_1", "Dense_2",
                                    "Dense_3"]
    for layer in p1["params"].values():
        assert layer["kernel"].dtype == jnp.float32
        assert not np.asarray(layer["bias"]).any()
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(p1["params"]["Dense_0"]["kernel"]),
                              np.asarray(p3["params"]["Dense_0"]["kernel"]))


def test_init_matches_the_flax_module_it_replaced():
    """Same seed, same weights as ``flax.linen`` Dense layers built the
    committed policies with (checked where flax is installed)."""
    nn = pytest.importorskip("flax.linen")

    class FlaxActorCritic(nn.Module):
        @nn.compact
        def __call__(self, x):
            for width in (256, 256):
                x = nn.tanh(nn.Dense(
                    width, kernel_init=nn.initializers.orthogonal(np.sqrt(2)),
                    bias_init=nn.initializers.zeros)(x))
            return (nn.Dense(18, kernel_init=nn.initializers.orthogonal(0.01),
                             bias_init=nn.initializers.zeros)(x),
                    nn.Dense(1, kernel_init=nn.initializers.orthogonal(1.0),
                             bias_init=nn.initializers.zeros)(x))

    x = jnp.zeros((4, 35), jnp.float32)
    want = FlaxActorCritic().init(jax.random.key(11), x)
    got = ActorCritic().init(jax.random.key(11), x)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

