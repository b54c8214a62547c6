"""Self-play PPO training CLI (BASELINE config 5 single-host entry point).

Usage:
    python -m pikazoo_tpu.train.run --num-envs 4096 --updates 200 \
        --checkpoint-dir /tmp/pika_ckpt --metrics out.jsonl

Runs the full actor-learner on the device mesh (all local devices; across
several processes call with ``--distributed`` and the coordinator options on
every process so the env batch shards over the global mesh).  Resumes from
the newest checkpoint when ``--checkpoint-dir`` already holds one.

``main(argv)`` returns the last update's metrics (a ``TrainMetrics`` of
host numbers), so a caller in the same process can check them.
"""

from __future__ import annotations

import argparse
import os
import time

import jax
import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--rollout-length", type=int, default=128)
    p.add_argument("--updates", type=int, default=100)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--winning-score", type=int, default=15)
    p.add_argument("--serve", default="winner",
                   choices=("winner", "alternate", "random"))
    p.add_argument("--simplify-actions", action="store_true",
                   help="train on the 13-action SimplifyAction space")
    p.add_argument("--vs-ai", action="store_true",
                   help="train seat 1 against the built-in rule AI on seat 2 "
                        "instead of symmetric self-play")
    p.add_argument("--ball-shaping", type=float, nargs=8, default=None,
                   metavar="R", help="RewardByBallPosition 8-tuple")
    p.add_argument("--shuffle", action="store_true",
                   help="textbook-PPO trajectory time-axis shuffle before "
                        "the minibatch split (costs a full-trajectory "
                        "gather; no measured quality effect at this scale)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--distributed", action="store_true",
                   help="initialize the multi-process JAX runtime first")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of process 0 (with --distributed)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--profile-dir", default=None,
                   help="capture a profiler trace of update 3 into this dir")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from pikazoo_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    from pikazoo_tpu.envs import EnvConfig, PikaZoo
    from pikazoo_tpu.parallel import (env_sharding, init_distributed,
                                      make_env_mesh, replicated_sharding,
                                      shard_batch)
    from pikazoo_tpu.train import PPOConfig, make_ppo_trainer
    from pikazoo_tpu.train import checkpoint as ckpt
    from pikazoo_tpu.utils import MetricsLogger, Throughput, profile_trace
    from pikazoo_tpu.wrappers import RewardByBallPosition, SimplifyAction

    if args.distributed:
        init_distributed(coordinator_address=args.coordinator_address,
                         num_processes=args.num_processes,
                         process_id=args.process_id)

    env = PikaZoo(EnvConfig(winning_score=args.winning_score,
                            serve=args.serve, auto_reset=True,
                            is_player2_computer=args.vs_ai))
    num_actions = 18
    if args.ball_shaping is not None:
        env = RewardByBallPosition(env, tuple(args.ball_shaping))
    if args.simplify_actions:
        env = SimplifyAction(env)
        num_actions = 13

    mesh = make_env_mesh()
    cfg = PPOConfig(num_envs=args.num_envs,
                    rollout_length=args.rollout_length,
                    num_actions=num_actions,
                    learning_rate=args.learning_rate,
                    learner_seats="p1" if args.vs_ai else "both",
                    shuffle_minibatches=args.shuffle)
    init_fn, train_step, _ = make_ppo_trainer(env, cfg, mesh=mesh)

    runner = init_fn(jax.random.key(args.seed))
    start_update = 0
    restorable = args.checkpoint_dir and ckpt.latest_restorable(
        os.path.join(args.checkpoint_dir, "latest"))
    if restorable:
        runner = ckpt.restore(restorable, runner)
        start_update = int(np.asarray(runner.update_index))
        print(f"resumed from update {start_update}", flush=True)
    # Replicate everything onto the mesh first (a restored checkpoint comes
    # back on a single device, which would conflict), then shard the env axis.
    runner = jax.device_put(runner, replicated_sharding(mesh))
    runner = runner._replace(
        env_state=shard_batch(runner.env_state, mesh),
        last_obs=jax.device_put(runner.last_obs, env_sharding(mesh)))

    # Donating the runner lets XLA update params/opt/env state in place
    # instead of copying the full buffers every update.  Compiled ahead of
    # the loop so compile time (set-up) and device memory are reported
    # apart from the training rate.
    t0 = time.perf_counter()
    step = jax.jit(train_step, donate_argnums=0).lower(runner).compile()
    compile_s = time.perf_counter() - t0
    mem = step.memory_analysis()
    logger = MetricsLogger(args.metrics, print_every=10)
    meter = Throughput(unit_steps=cfg.num_envs * cfg.rollout_length)
    from pikazoo_tpu.core.predict import dispatch_provenance
    from pikazoo_tpu.utils.device import device_info

    logger.header({
        "provenance": {"predictor": dispatch_provenance(),
                       **device_info()},
        "compile_s": compile_s,
        "memory": None if mem is None else {
            "argument_bytes": mem.argument_size_in_bytes,
            "output_bytes": mem.output_size_in_bytes,
            "temp_bytes": mem.temp_size_in_bytes,
            "alias_bytes": mem.alias_size_in_bytes},
    })

    for update in range(start_update, start_update + args.updates):
        if args.profile_dir and update == start_update + 3:
            with profile_trace(args.profile_dir):
                runner, metrics = step(runner)
                jax.block_until_ready(metrics)
        else:
            runner, metrics = step(runner)
        # ONE host transfer for the whole metrics tuple instead of one
        # round trip per field.
        metrics = jax.device_get(metrics)
        meter.tick()
        logger.log(update, {
            "loss": metrics.total_loss,
            "policy_loss": metrics.policy_loss,
            "value_loss": metrics.value_loss,
            "entropy": metrics.entropy,
            "approx_kl": metrics.approx_kl,
            "episodes": metrics.episodes_finished,
            "env_steps_per_s": meter.steps_per_s,
        })
        if args.checkpoint_dir and (update + 1) % args.checkpoint_every == 0:
            ckpt.save(os.path.join(args.checkpoint_dir, "latest"), runner)
            print(f"checkpointed at update {update}", flush=True)

    logger.close()
    print(f"done: {args.updates} updates, "
          f"{meter.steps_per_s / 1e6:.2f}M env-steps/s sustained", flush=True)
    return metrics


if __name__ == "__main__":
    main()
