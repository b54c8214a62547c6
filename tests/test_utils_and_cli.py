"""Utils (throughput/logging) and the training CLI entry point."""

import json

import jax
import jax.numpy as jnp
import numpy as np

from pikazoo_tpu.envs import EnvConfig, PikaZoo
from pikazoo_tpu.train import PPOConfig, make_ppo_trainer
from pikazoo_tpu.utils import MetricsLogger, Throughput
from pikazoo_tpu.wrappers import SimplifyAction


def test_ppo_through_simplify_action_wrapper():
    env = SimplifyAction(PikaZoo(EnvConfig(winning_score=2)))
    cfg = PPOConfig(num_envs=16, rollout_length=16, num_minibatches=2,
                    update_epochs=1, hidden=(32,), num_actions=13)
    init_fn, train_step, _ = make_ppo_trainer(env, cfg)
    runner, metrics = jax.jit(train_step)(init_fn(jax.random.key(0)))
    assert np.isfinite(float(metrics.total_loss))


def test_throughput_meter():
    meter = Throughput(unit_steps=100)
    meter.tick()  # starts clock
    meter.tick()
    assert meter.steps_per_s > 0


def test_metrics_logger_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    logger = MetricsLogger(path, print_every=0)
    logger.log(0, {"loss": jnp.float32(1.5)})
    logger.log(1, {"loss": 2.0})
    logger.close()
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["loss"] == 1.5 and lines[1]["step"] == 1


def test_train_cli_smoke(tmp_path):
    from pikazoo_tpu.train import run as train_run
    metrics_path = str(tmp_path / "metrics.jsonl")
    final = train_run.main([
        "--num-envs", "8", "--rollout-length", "8", "--updates", "2",
        "--simplify-actions", "--metrics", metrics_path,
    ])
    lines = [json.loads(line) for line in open(metrics_path)]
    # One header (resolved predictor dispatch, device fields, compile time
    # and memory) followed by one metrics record per update.
    assert len(lines) == 3
    assert lines[0]["provenance"]["platform"] == "cpu"
    assert lines[0]["provenance"]["device_count"] == len(jax.devices())
    assert "predictor" in lines[0]["provenance"]
    assert lines[0]["compile_s"] > 0
    assert lines[0]["memory"]["temp_bytes"] >= 0
    assert np.isfinite(lines[-1]["loss"])
    # main() hands back the last update's metrics as host numbers.
    assert float(final.total_loss) == lines[-1]["loss"]


def test_train_cli_checkpoint_resume(tmp_path):
    import pytest
    pytest.importorskip("orbax.checkpoint")
    from pikazoo_tpu.train import run as train_run
    ckpt_dir = str(tmp_path / "ckpt")
    args = ["--num-envs", "8", "--rollout-length", "8",
            "--checkpoint-dir", ckpt_dir, "--checkpoint-every", "2"]
    train_run.main(args + ["--updates", "2"])
    # Second invocation must resume from update 2.
    train_run.main(args + ["--updates", "1"])
