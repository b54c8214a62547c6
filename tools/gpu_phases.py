"""Phase measurements on one GPU: the landing kernel and the PPO update.

    python tools/gpu_phases.py landing [--batch 65536] [--frames 200]
    python tools/gpu_phases.py ppo [--num-envs 65536] [--rollout-length 128]

``landing``: collects live ball states from a rule-AI self-play rollout,
checks the Triton landing kernel bit for bit against the lax path on all of
them, times the kernel alone over a sweep of block size, warps and unroll,
then times the full AI step (kernel against lax, same process, interleaved)
with the fastest kernel configuration.

``ppo``: compiles the self-play train step, prints its memory analysis,
and times the train step, the rollout alone, one minibatch gradient with
its optimizer update, and a large device copy; the update phase's share
and its achieved bytes/s follow from those.

Every line is one JSON object carrying the device fields.  The script
fails without a GPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _emit(info, **fields):
    print(json.dumps({**fields, **info}), flush=True)


def _time(fn, *args, reps=3):
    """Median seconds of ``reps`` calls after one warm call."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def landing(args, info):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pikazoo_tpu.core import predict, predict_pallas
    from pikazoo_tpu.envs import EnvConfig, PikaZoo

    B, F = args.batch, args.frames
    env = PikaZoo(EnvConfig(auto_reset=True, is_player1_computer=True,
                            is_player2_computer=True))
    state, _ = env.reset_batch(jax.random.key(0), B)

    def make_roll(predictor, frames, collect):
        os.environ["PIKAZOO_PREDICTOR"] = predictor

        def body(carry, _):
            st, key = carry
            key, sub = jax.random.split(key)
            acts = jax.random.randint(sub, (B, 2), 0, 18, jnp.int32)
            st, _ = env.step_batch(st, acts)
            b = st.ball
            out = (b.x, b.y, b.x_velocity, b.y_velocity) if collect else None
            return (st, key), out

        fn = jax.jit(lambda s, k: jax.lax.scan(body, (s, k), None,
                                               length=frames))
        fn = fn.lower(state, jax.random.key(1)).compile()
        assert predict.dispatch_provenance()["predictor"] == (
            "pallas" if predictor == "pallas" else "lax")
        return fn

    # Live states: past the opening serves, then F frames of balls.
    warm = make_roll("lax", 300, False)
    (state, key), _ = warm(state, jax.random.key(1))
    (_, _), balls = make_roll("lax", F, True)(state, key)
    x, y, vx, vy = (a.reshape(-1) for a in balls)

    lax_fn = jax.jit(jax.vmap(lambda *s: predict.landing_sims_any(*s)))
    exp_l, cand_l = lax_fn(x, y, vx, vy)
    exp_l, cand_l = np.asarray(exp_l), np.asarray(cand_l)  # (N,), (N, 6)

    def per_frame(fn):
        return jax.jit(lambda xs: jax.lax.map(lambda s: fn(*s), xs))

    frames = tuple(a for a in balls)
    t_lax = _time(per_frame(jax.vmap(
        lambda *s: predict.landing_sims_any(*s))), frames)
    _emit(info, phase="landing_lax", batch=B, frames=F,
          ms_per_frame=t_lax / F * 1e3)

    results = []
    for block, warps, unroll in itertools.product(
            (128, 256, 512), (2, 4, 8), (4, 8, 16, 32)):
        def kern(a, b, c, d, block=block, warps=warps, unroll=unroll):
            return predict_pallas.landing_sims_batched(
                a, b, c, d, block=block, num_warps=warps, unroll=unroll)
        try:
            exp_k, cand_k = jax.jit(kern)(x, y, vx, vy)
            exact = bool((np.asarray(exp_k) == exp_l).all()
                         and (np.asarray(cand_k) == cand_l).all())
            t = _time(per_frame(kern), frames)
        except Exception as e:  # report the configuration the compiler refused
            _emit(info, phase="landing_kernel", block=block, warps=warps,
                  unroll=unroll, error=repr(e)[:300])
            continue
        results.append((t, block, warps, unroll))
        _emit(info, phase="landing_kernel", block=block, warps=warps,
              unroll=unroll, exact=exact, ms_per_frame=t / F * 1e3)
        if not exact:
            raise SystemExit("landing kernel differs from the lax path")

    t, block, warps, unroll = min(results)
    _emit(info, phase="landing_best", block=block, warps=warps,
          unroll=unroll, ms_per_frame=t / F * 1e3,
          lax_ms_per_frame=t_lax / F * 1e3)
    predict_pallas.BLOCK, predict_pallas.NUM_WARPS = block, warps
    predict_pallas.UNROLL = unroll

    # Full AI step, kernel against lax, interleaved.
    steps = args.step_frames
    rolls = {p: make_roll(p, steps, False) for p in ("lax", "pallas")}
    finals = {p: rolls[p](state, key)[0][0] for p in rolls}
    same = all(bool((np.asarray(a) == np.asarray(b)).all()) for a, b in zip(
        jax.tree.leaves(finals["lax"]), jax.tree.leaves(finals["pallas"])))
    runs = {"lax": [], "pallas": []}
    for r in range(args.reps):
        for p in (("lax", "pallas") if r % 2 == 0 else ("pallas", "lax")):
            t0 = time.perf_counter()
            jax.block_until_ready(rolls[p](state, key))
            runs[p].append(B * steps / (time.perf_counter() - t0))
    _emit(info, phase="ai_step", batch=B, frames=steps, states_equal=same,
          lax_env_steps_per_s=runs["lax"],
          pallas_env_steps_per_s=runs["pallas"])


def ppo(args, info):
    import jax
    import jax.numpy as jnp
    import optax

    from pikazoo_tpu.envs import EnvConfig, PikaZoo
    from pikazoo_tpu.train import PPOConfig, make_ppo_trainer
    from pikazoo_tpu.train.ppo import Transition, gae_associative

    cfg = PPOConfig(num_envs=args.num_envs,
                    rollout_length=args.rollout_length)
    env = PikaZoo(EnvConfig(auto_reset=True))
    init_fn, train_step, _ = make_ppo_trainer(env, cfg)
    runner = init_fn(jax.random.key(0))

    t0 = time.perf_counter()
    step = jax.jit(train_step).lower(runner).compile()
    compile_s = time.perf_counter() - t0
    mem = step.memory_analysis()
    _emit(info, phase="ppo_compile", compile_s=compile_s,
          temp_bytes=mem.temp_size_in_bytes,
          argument_bytes=mem.argument_size_in_bytes,
          output_bytes=mem.output_size_in_bytes)
    t_step = _time(lambda r: step(r)[1], runner)

    rollout = jax.jit(train_step.rollout_fn)
    t_roll = _time(rollout, runner.params, runner.env_state,
                   runner.last_obs, runner.key)
    (_, _, _), traj = rollout(runner.params, runner.env_state,
                              runner.last_obs, runner.key)
    adv, tgt = gae_associative(traj.value, traj.reward, traj.done,
                               jnp.zeros_like(traj.value[0]), cfg.gamma,
                               cfg.gae_lambda)
    t_mb = cfg.rollout_length // cfg.num_minibatches
    mb = (Transition(*[leaf[:t_mb] for leaf in traj]), adv[:t_mb],
          tgt[:t_mb])
    tx = train_step.tx

    def grad_and_update(params, opt_state, mtraj, madv, mtarget):
        grads, losses = train_step.minibatch_grads_fn(params, mtraj, madv,
                                                      mtarget)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, losses

    gu = jax.jit(grad_and_update).lower(runner.params, runner.opt_state,
                                        *mb).compile()
    ca = gu.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    t_gu = _time(gu, runner.params, runner.opt_state, *mb)

    big = jnp.ones((512 * 1024 * 1024,), jnp.float32)  # 2 GiB
    copy = jax.jit(lambda a: a + 1.0)
    t_copy = _time(copy, big)
    copy_rate = 2 * big.nbytes / t_copy
    n_mb = cfg.update_epochs * cfg.num_minibatches
    _emit(info, phase="ppo", num_envs=cfg.num_envs,
          rollout_length=cfg.rollout_length,
          train_step_s=t_step,
          env_steps_per_s=cfg.num_envs * cfg.rollout_length / t_step,
          rollout_s=t_roll, minibatch_update_s=t_gu,
          update_phase_s=n_mb * t_gu,
          update_share=n_mb * t_gu / t_step,
          minibatch_bytes=ca.get("bytes accessed"),
          minibatch_flops=ca.get("flops"),
          minibatch_bytes_per_s=ca.get("bytes accessed", 0.0) / t_gu,
          copy_bytes_per_s=copy_rate)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("what", choices=("landing", "ppo"), nargs="+")
    p.add_argument("--batch", type=int, default=65_536)
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--step-frames", type=int, default=200)
    p.add_argument("--reps", type=int, default=6)
    p.add_argument("--num-envs", type=int, default=65_536)
    p.add_argument("--rollout-length", type=int, default=128)
    args = p.parse_args(argv)

    from pikazoo_tpu.utils.device import (device_info, enable_compile_cache,
                                          require_gpu)

    enable_compile_cache()
    require_gpu()
    info = device_info()
    for what in args.what:
        {"landing": landing, "ppo": ppo}[what](args, info)


if __name__ == "__main__":
    main()
