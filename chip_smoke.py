#!/usr/bin/env python
"""Run the main path once on one GPU, at full width, and check it.

    python chip_smoke.py          # one card: phases 4, 0, 1, 2, 3
    python chip_smoke.py --four   # four cards: data-parallel PPO vs one card

Phases (one process holds the card; phase 4 runs first, in a child, before
this process opens it):

4. The ``chip``-marked tests (kernel against lax at B = 65,536, the golden
   trajectory, GPU against the C++ engine), one pytest process, no workers.
0. JAX's default device must be a GPU; prints the card's name and power
   limit, the JAX version and the compile-cache directory.
1. Config 4: ``PikaZoo.step_batch`` scanned at B = 262,144 with random
   actions; sampled lanes bit-equal to the C++ engine (``NativeEngine``)
   started from the same packed state with the same actions.
2. Config 2: both seats rule AI at B = 65,536.  The Triton landing kernel
   bit-equal to the lax path on the rollout's live ball states; the full AI
   step with the kernel bit-equal to the lax step; sampled lanes bit-equal
   to the C++ engine.
3. Config 5: ``python -m pikazoo_tpu.train.run`` at 65,536 envs x 128
   frames for 3 updates, then ``--vs-ai`` at 8,192 envs for 2, both through
   ``main(argv)`` in this process, with finite losses; then the production
   XLA minibatch gradient against a float32 transcription of the loss at
   ``highest`` matmul precision on one real minibatch.

Every phase prints its wall time; compile time is reported apart as
set-up.  Any failure exits non-zero.  The last line of standard output is
one JSON object, ``{"ok": true, "device": {...}}``, printed only when every
phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# Relative error allowed between the production minibatch gradient (bf16
# matmul operands and activations, networks.py) and the float32 reference
# at "highest" precision: bf16 keeps 8 significant bits (~0.4% per
# rounding), compounded over three layers forward and backward.
GRAD_RTOL = 0.05
GRAD_MIN_COS = 0.995
# Losses of the four-card steps against the one-card steps.  The first
# step sees the same trajectory (meshed sampling is bit-matched) and differs
# only by reduction order; later steps sample with parameters that differ in
# the last bits, so a few sampled actions, and the trajectories after them,
# can differ too.  Total losses are O(0.01-0.1).
FOUR_CARD_RTOL, FOUR_CARD_ATOL = 1e-3, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def result_line(devices) -> str:
    """The final line: platform, kind and count as JAX reports them."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


class Phase:
    """Times one phase and prints its name, wall time and set-up time."""

    def __init__(self, name: str):
        self.name, self.setup_s = name, 0.0

    def __enter__(self):
        log(f"== phase {self.name}")
        self.t0 = time.perf_counter()
        return self

    def compile(self, lowered):
        t0 = time.perf_counter()
        compiled = lowered.compile()
        self.setup_s += time.perf_counter() - t0
        return compiled

    def __exit__(self, *exc):
        if exc[0] is None:
            wall = time.perf_counter() - self.t0
            log(f"== phase {self.name} ok: {wall:.1f} s wall, "
                f"{self.setup_s:.1f} s of it compiling")
        return False


def _check_lanes_vs_native(env_cfg, state0, actions, final, lanes, label):
    """Sampled lanes of a JAX rollout against the C++ engine: same packed
    start state, same actions, production RNG; exact."""
    import jax
    import numpy as np

    from pikazoo_tpu.native.engine import NativeEngine

    eng = NativeEngine(winning_score=env_cfg.winning_score,
                       serve=env_cfg.serve,
                       is_player1_computer=env_cfg.is_player1_computer,
                       is_player2_computer=env_cfg.is_player2_computer,
                       auto_reset=env_cfg.auto_reset)

    def pick(tree):
        return jax.tree.map(lambda x: np.asarray(x)[lanes], tree)

    packed = NativeEngine.pack(pick(state0))
    eng.run(packed, np.ascontiguousarray(np.asarray(actions)[:, lanes]))
    expect = NativeEngine.pack(pick(final))
    if not np.array_equal(packed, expect):
        bad = int((packed != expect).any(axis=1).sum())
        raise AssertionError(f"{label}: {bad} of {len(lanes)} sampled lanes "
                             "differ from the C++ engine")
    log(f"{label}: {len(lanes)} sampled lanes bit-equal to the C++ engine")


def _rollout(env, state, actions, ph):
    """Scan ``env.step_batch`` over (T, B, 2) actions; returns the final
    state, the summed rewards, and env-steps/s of a second, timed call."""
    import jax

    def run(st, acts):
        def body(s, a):
            s, ts = env.step_batch(s, a)
            return s, ts.rewards.sum(0)
        s, rewards = jax.lax.scan(body, st, acts)
        return s, rewards.sum(0)

    fn = ph.compile(jax.jit(run).lower(state, actions))
    jax.block_until_ready(fn(state, actions))
    t0 = time.perf_counter()
    final, rewards = jax.block_until_ready(fn(state, actions))
    rate = actions.shape[0] * actions.shape[1] / (time.perf_counter() - t0)
    return final, rewards, rate


def phase_env(batch=262_144, frames=300, lanes=64):
    import jax
    import numpy as np

    from pikazoo_tpu.envs import EnvConfig, PikaZoo

    with Phase("1: config 4 env step") as ph:
        cfg = EnvConfig(auto_reset=True)
        env = PikaZoo(cfg)
        state, _ = env.reset_batch(jax.random.key(SEED), batch)
        actions = jax.random.randint(jax.random.key(SEED + 1),
                                     (frames, batch, 2), 0, 18)
        final, _, rate = _rollout(env, state, actions, ph)
        log(f"step_batch B={batch} x {frames} frames: {rate:,.0f} "
            f"env-steps/s")
        scores = np.asarray(final.scores)
        assert scores.shape == (batch, 2) and (scores >= 0).all()
        pick = np.random.default_rng(SEED).choice(batch, lanes, replace=False)
        _check_lanes_vs_native(cfg, state, actions, final, pick,
                               "config 4")


def phase_ai(batch=65_536, frames=300, lanes=64):
    import jax
    import numpy as np

    from pikazoo_tpu.core import predict
    from pikazoo_tpu.core.predict_pallas import landing_sims_batched
    from pikazoo_tpu.envs import EnvConfig, PikaZoo

    with Phase("2: config 2 rule-AI self-play") as ph:
        cfg = EnvConfig(auto_reset=True, is_player1_computer=True,
                        is_player2_computer=True)
        env = PikaZoo(cfg)
        state, _ = env.reset_batch(jax.random.key(SEED), batch)
        actions = jax.random.randint(jax.random.key(SEED + 2),
                                     (frames, batch, 2), 0, 18)
        finals, rates = {}, {}
        for predictor in ("pallas", "lax"):
            os.environ["PIKAZOO_PREDICTOR"] = predictor
            final, rewards, rates[predictor] = _rollout(env, state, actions,
                                                        ph)
            assert predict.dispatch_provenance()["predictor"] == predictor
            finals[predictor] = (final, rewards)
        os.environ.pop("PIKAZOO_PREDICTOR")
        log(f"AI step B={batch} x {frames} frames: kernel "
            f"{rates['pallas']:,.0f}, lax {rates['lax']:,.0f} env-steps/s")
        for a, b in zip(jax.tree.leaves(finals["pallas"]),
                        jax.tree.leaves(finals["lax"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        log("AI step with the kernel bit-equal to the lax step "
            f"after {frames} frames")

        # The kernel on the rollout's live ball states, every frame.
        def balls(st, acts):
            def body(s, a):
                s, _ = env.step_batch(s, a)
                b = s.ball
                return s, (b.x, b.y, b.x_velocity, b.y_velocity)
            return jax.lax.scan(body, st, acts)[1]

        live = ph.compile(jax.jit(balls).lower(state, actions))(state,
                                                                actions)
        flat = [a.reshape(-1) for a in live]
        kern = ph.compile(jax.jit(landing_sims_batched).lower(*flat))
        ref = ph.compile(jax.jit(jax.vmap(
            lambda *s: predict.landing_sims_any(*s))).lower(*flat))
        for a, b in zip(kern(*flat), ref(*flat)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        log(f"landing kernel bit-equal to lax on {flat[0].size:,} live "
            f"ball states (B={batch} x {frames} frames, integer, exact)")

        pick = np.random.default_rng(SEED).choice(batch, lanes, replace=False)
        _check_lanes_vs_native(cfg, state, actions, finals["pallas"][0],
                               pick, "config 2")
        del live, flat, finals


def phase_train(num_envs=65_536, rollout=128, updates=3, vs_ai_envs=8_192,
                vs_ai_updates=2):
    import numpy as np

    from pikazoo_tpu.train import run

    with Phase("3: config 5 PPO through train/run.py"):
        for argv in (["--num-envs", str(num_envs), "--rollout-length",
                      str(rollout), "--updates", str(updates)],
                     ["--vs-ai", "--num-envs", str(vs_ai_envs),
                      "--rollout-length", str(rollout), "--updates",
                      str(vs_ai_updates)]):
            log("train/run.py " + " ".join(argv))
            m = run.main(argv)
            losses = [float(x) for x in (m.total_loss, m.policy_loss,
                                         m.value_loss, m.entropy)]
            if not np.isfinite(losses).all():
                raise AssertionError(f"non-finite losses {losses}")
            log(f"final losses finite: {losses}")


def grad_check(num_envs=65_536, rollout=128):
    """Production XLA minibatch gradient vs the float32 reference on one
    real minibatch; returns the worst per-leaf relative error."""
    import jax
    import numpy as np

    from pikazoo_tpu.envs import EnvConfig, PikaZoo
    from pikazoo_tpu.train import PPOConfig, make_ppo_trainer
    from pikazoo_tpu.train.ppo import (Transition, gae_associative,
                                       reference_loss)

    with Phase("3b: minibatch gradient vs float32 reference") as ph:
        cfg = PPOConfig(num_envs=num_envs, rollout_length=rollout)
        init_fn, train_step, _ = make_ppo_trainer(
            PikaZoo(EnvConfig(auto_reset=True)), cfg)
        runner = init_fn(jax.random.key(SEED))
        args = (runner.params, runner.env_state, runner.last_obs, runner.key)
        roll = ph.compile(jax.jit(train_step.rollout_fn).lower(*args))
        (_, last_norm, _), traj = roll(*args)
        from pikazoo_tpu.train.networks import apply_fm

        _, last_value = apply_fm(runner.params, last_norm)
        adv, tgt = gae_associative(traj.value, traj.reward, traj.done,
                                   last_value, cfg.gamma, cfg.gae_lambda)
        t_mb = cfg.rollout_length // cfg.num_minibatches
        mb = (Transition(*[leaf[:t_mb] for leaf in traj]), adv[:t_mb],
              tgt[:t_mb])
        del traj
        grads = ph.compile(jax.jit(train_step.minibatch_grads_fn).lower(
            runner.params, *mb))(runner.params, *mb)[0]
        ref_fn = jax.jit(jax.grad(lambda p, *b: reference_loss(p, *b, cfg)))
        ref = ph.compile(ref_fn.lower(runner.params, *mb))(runner.params,
                                                             *mb)
        worst = 0.0
        for (path, g), r in zip(jax.tree_util.tree_leaves_with_path(grads),
                                jax.tree.leaves(ref)):
            g = np.asarray(g, np.float64).ravel()
            r = np.asarray(r, np.float64).ravel()
            rel = np.linalg.norm(g - r) / (np.linalg.norm(r) + 1e-30)
            cos = g @ r / (np.linalg.norm(g) * np.linalg.norm(r) + 1e-30)
            worst = max(worst, rel)
            name = jax.tree_util.keystr(path)
            if not (rel < GRAD_RTOL and cos > GRAD_MIN_COS):
                raise AssertionError(f"gradient {name}: relative error "
                                     f"{rel:.4f}, cosine {cos:.5f}")
        log(f"minibatch gradient ({t_mb} x {2 * num_envs:,} rows) vs float32 "
            f"reference: worst leaf relative error {worst:.4f} "
            f"(limit {GRAD_RTOL}), bf16 operands")
    return worst


def run_chip_tests() -> None:
    with Phase("4: chip-marked tests (child process)"):
        env = dict(os.environ, JAX_PLATFORMS="cuda")
        out = subprocess.run(
            [sys.executable, "-m", "pytest", "-m", "chip", "-q", "-rs",
             "-p", "no:cacheprovider", "-p", "no:xdist", "tests"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
        lines = out.stdout.strip().splitlines()
        for line in lines:
            if line.startswith("SKIPPED"):
                log(line)
        log(lines[-1] if lines else "(no pytest output)")
        if out.returncode != 0:
            log(out.stdout[-4000:] + out.stderr[-2000:])
            raise AssertionError("chip-marked tests failed")


def four_cards(num_envs=65_536, rollout=128, steps=2, n=4):
    """The data-parallel PPO step over an n-card env mesh against the same
    seed on one card, in this process."""
    import jax
    import numpy as np

    from pikazoo_tpu.envs import EnvConfig, PikaZoo
    from pikazoo_tpu.parallel import env_sharding, make_env_mesh, shard_batch
    from pikazoo_tpu.train import PPOConfig, make_ppo_trainer

    devices = jax.devices()
    if len(devices) < n:
        raise SystemExit(f"--four needs {n} devices, JAX sees {len(devices)}")
    cfg = PPOConfig(num_envs=num_envs, rollout_length=rollout)
    env = PikaZoo(EnvConfig(auto_reset=True))
    losses = {}
    with Phase(f"four: PPO over a {n}-card env mesh") as ph:
        mesh = make_env_mesh(devices[:n])
        init_fn, train_step, _ = make_ppo_trainer(env, cfg, mesh=mesh)
        runner = init_fn(jax.random.key(SEED))
        runner = runner._replace(
            env_state=shard_batch(runner.env_state, mesh),
            last_obs=jax.device_put(runner.last_obs, env_sharding(mesh)))
        step = ph.compile(jax.jit(train_step).lower(runner))
        losses["mesh"] = []
        t0 = time.perf_counter()
        for _ in range(steps):
            runner, m = step(runner)
            losses["mesh"].append(float(m.total_loss))
        dt = time.perf_counter() - t0
        shards = len(runner.env_state.scores.sharding.device_set)
        assert shards == n, f"env state sharded over {shards} devices"
        log(f"{n} cards, {num_envs // n:,} envs each: env state sharded "
            f"over {shards} devices; {steps} steps in {dt:.2f} s; "
            f"losses {losses['mesh']}")
    with Phase("four: the same seed on one card") as ph:
        init_fn, train_step, _ = make_ppo_trainer(env, cfg)
        runner = init_fn(jax.random.key(SEED))
        step = ph.compile(jax.jit(train_step).lower(runner))
        losses["one"] = []
        for _ in range(steps):
            runner, m = step(runner)
            losses["one"].append(float(m.total_loss))
        log(f"one card: losses {losses['one']}")
    np.testing.assert_allclose(losses["mesh"], losses["one"],
                               rtol=FOUR_CARD_RTOL, atol=FOUR_CARD_ATOL)
    log(f"{n}-card losses match one card within rtol {FOUR_CARD_RTOL}, "
        f"atol {FOUR_CARD_ATOL}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--four", action="store_true",
                   help="run only the four-card PPO path and its one-card "
                        "comparison")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    from pikazoo_tpu.utils.device import (enable_compile_cache, nvidia_smi,
                                          require_gpu)

    smi = nvidia_smi()
    if smi is None:
        raise SystemExit("no GPU: nvidia-smi finds no card")
    t_start = time.perf_counter()
    if not args.four:
        run_chip_tests()

    with Phase("0: device"):
        cache = enable_compile_cache()
        import jax

        require_gpu()
        devices = jax.devices()
        log(smi)
        log(f"jax {jax.__version__}; devices {devices}; compile cache "
            f"{cache}")

    if args.four:
        four_cards()
    else:
        phase_env()
        phase_ai()
        phase_train()
        grad_check()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(smi.splitlines()[0])
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
