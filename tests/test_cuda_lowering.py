"""The main path lowers for CUDA (``lowering_platforms=("cuda",)``), which
needs no GPU: the landing kernel through Triton at several block sizes, the
rule-AI step with the kernel selected, and the PPO train step.  What the
GPU's compiler then does with the module shows only on the card
(``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import pytest

from pikazoo_tpu.core import predict
from pikazoo_tpu.core.predict_pallas import landing_sims_batched
from pikazoo_tpu.envs import EnvConfig, PikaZoo


def _cuda_text(fn, *args):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("block", [128, 256, 512])
def test_landing_kernel_lowers_through_triton(block):
    x = jnp.zeros((1000,), jnp.int32)
    text = _cuda_text(
        lambda a, b, c, d: landing_sims_batched(a, b, c, d, block=block),
        x, x, x, x)
    assert "triton" in text


def test_ai_step_with_kernel_lowers_for_cuda(monkeypatch):
    monkeypatch.delenv("PIKAZOO_PREDICTOR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    env = PikaZoo(EnvConfig(auto_reset=True, is_player1_computer=True,
                            is_player2_computer=True))
    state, _ = env.reset_batch(jax.random.key(0), 512)
    text = _cuda_text(env.step_batch, state, jnp.zeros((512, 2), jnp.int32))
    assert predict.dispatch_provenance()["predictor"] == "pallas"
    assert "triton" in text


def test_ppo_train_step_lowers_for_cuda():
    from pikazoo_tpu.train import PPOConfig, make_ppo_trainer

    cfg = PPOConfig(num_envs=64, rollout_length=8, num_minibatches=2,
                    update_epochs=1)
    init_fn, train_step, _ = make_ppo_trainer(
        PikaZoo(EnvConfig(auto_reset=True)), cfg)
    text = _cuda_text(train_step, init_fn(jax.random.key(0)))
    assert "stablehlo.dot_general" in text
    assert "triton" not in text  # the update is XLA autodiff, no kernel
