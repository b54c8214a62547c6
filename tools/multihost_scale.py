"""Multi-process scaling on the CPU: aggregate env-steps/s vs process count.

One command emits a scaling table over N-process virtual clusters on the
CPU (each process = one simulated host with D local devices, joined through
the REAL ``jax.distributed`` runtime over localhost, SURVEY N3/N4):

    python tools/multihost_scale.py                 # 1 and 2 "hosts"
    python tools/multihost_scale.py --procs 1 2 4   # custom ladder
    python tools/multihost_scale.py --mode ppo      # full PPO train step

The env step is embarrassingly parallel over the ``env`` mesh axis, so the
expected scaling is linear; the parent prints per-rung aggregate steps/s and
the efficiency vs linear extrapolation of the 1-process rung.  CPU rungs
share physical cores, so the efficiency is a *correctness* signal — the
mesh machinery adds no cross-host traffic to the env step — not a device
measurement.
"""

import argparse
import json
import os
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(process_id: int, num_processes: int, port: int,
          devices_per_proc: int, batch_per_device: int, steps: int,
          mode: str = "env") -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={devices_per_proc}")
    sys.path.insert(0, _REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_processes, process_id=process_id)

    import jax.numpy as jnp

    from pikazoo_tpu.envs import EnvConfig, PikaZoo
    from pikazoo_tpu.parallel import make_env_mesh, shard_batch

    devices = jax.devices()
    mesh = make_env_mesh(devices)
    batch = batch_per_device * len(devices)

    env = PikaZoo(EnvConfig(auto_reset=True))

    if mode in ("ppo", "ppo_phases"):
        # Full actor-learner train step over the mesh (config-5 shape):
        # env-axis-sharded rollout, psum'd minibatch gradients.
        from pikazoo_tpu.parallel import env_sharding
        from pikazoo_tpu.train import PPOConfig, make_ppo_trainer

        cfg = PPOConfig(num_envs=batch, rollout_length=max(steps, 8),
                        num_minibatches=2, update_epochs=2, hidden=(64, 64))
        init_fn, train_step, _ = make_ppo_trainer(env, cfg, mesh=mesh)
        runner = init_fn(jax.random.key(0))
        runner = runner._replace(
            env_state=shard_batch(runner.env_state, mesh),
            last_obs=jax.device_put(runner.last_obs, env_sharding(mesh)))
        step = jax.jit(train_step, donate_argnums=0)
        runner, metrics = step(runner)  # compile
        jax.block_until_ready(metrics.total_loss)

        def timed(fn, *args, reps=3):
            out = fn(*args)  # warm (and compile on first use)
            jax.block_until_ready(out)
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                out = fn(*args)
                jax.block_until_ready(out)
                best = min(best, time.perf_counter() - t0)
            return best

        t0 = time.perf_counter()
        runner, metrics = step(runner)
        jax.block_until_ready(metrics.total_loss)
        dt = time.perf_counter() - t0
        result = {
            "procs": jax.process_count(),
            "devices": len(devices),
            "batch": batch,
            "steps_per_s": round(batch * cfg.rollout_length / dt),
        }

        if mode == "ppo_phases":
            # Per-phase breakdown with the trainer's own phase programs
            # (train_step.rollout_fn / minibatch_grads_fn): where does the
            # time go as the process count grows?
            roll = jax.jit(lambda p, st, obs, key:
                           train_step.rollout_fn(p, st, obs, key))
            result["rollout_s"] = timed(
                roll, runner.params, runner.env_state, runner.last_obs,
                runner.key)

            # One minibatch of the trainer's own update program (grads with
            # the all-reduce GSPMD inserts).
            (_, traj) = roll(runner.params, runner.env_state,
                             runner.last_obs, runner.key)
            t_mb = cfg.rollout_length // cfg.num_minibatches
            mb = jax.tree.map(lambda x: x[:t_mb], traj)
            adv = traj.reward[:t_mb]
            tgt = traj.value[:t_mb]
            grads_fn = jax.jit(lambda p, m, a, t:
                               train_step.minibatch_grads_fn(p, m, a, t))
            result["minibatch_grad_s"] = timed(
                grads_fn, runner.params, mb, adv, tgt)
            n_mb = cfg.update_epochs * cfg.num_minibatches
            result["update_s_est"] = result["minibatch_grad_s"] * n_mb

            # The collective alone: psum of a gradient-sized pytree.
            from jax.sharding import PartitionSpec as P
            grads, _ = grads_fn(runner.params, mb, adv, tgt)

            @jax.jit
            def psum_only(g):
                return jax.shard_map(
                    lambda t: jax.tree.map(
                        lambda x: jax.lax.psum(x, "env"), t),
                    mesh=mesh, in_specs=P(), out_specs=P(),
                    check_vma=False)(g)

            result["grad_psum_s"] = timed(psum_only, grads)

        if jax.process_index() == 0:
            print(json.dumps(result), flush=True)
        return

    state, _ = env.reset_batch(jax.random.key(0), batch)
    state = shard_batch(state, mesh)

    def body(carry, _):
        st, key = carry
        key, sub = jax.random.split(key)
        acts = jax.random.randint(sub, (batch, 2), 0, 18, jnp.int32)
        st, _ts = env.step_batch(st, acts)
        return (st, key), None

    @jax.jit
    def rollout(carry):
        return jax.lax.scan(body, carry, None, length=steps)[0]

    carry = rollout((state, jax.random.key(1)))  # compile
    jax.block_until_ready(carry[0].scores)
    t0 = time.perf_counter()
    carry = rollout(carry)
    jax.block_until_ready(carry[0].scores)
    dt = time.perf_counter() - t0

    if jax.process_index() == 0:
        print(json.dumps({
            "procs": jax.process_count(),
            "devices": len(devices),
            "batch": batch,
            "steps_per_s": round(batch * steps / dt),
        }), flush=True)


def run_rung(num_processes: int, args, port: int) -> dict | None:
    ncores = os.cpu_count() or 1
    procs = []
    for pid in range(num_processes):
        cmd = [sys.executable, os.path.abspath(__file__), "--_child",
               str(pid), str(num_processes), str(port),
               "--devices-per-proc", str(args.devices_per_proc),
               "--batch-per-device", str(args.batch_per_device),
               "--steps", str(args.steps), "--mode", args.mode]
        if args.pin_cores:
            # One physical core per process: without pinning, every child's
            # XLA-CPU thread pool spans all cores, so rungs beyond
            # ncores/threads measured core CONTENTION, not mesh overhead
            # (the round-4 4-proc confound).  With procs x 1 device pinned
            # to distinct cores there is no oversubscription and efficiency
            # is a real mesh measurement.
            cmd = ["taskset", "-c", str(pid % ncores)] + cmd
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True))
    # A hung child (e.g. its peer died before jax.distributed.initialize so
    # it waits on the coordinator forever) must fail THIS rung, not crash
    # the ladder and orphan the remaining children.
    try:
        outs = [p.communicate(timeout=args.timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        return None
    if any(p.returncode != 0 for p in procs):
        return None
    for out in outs:
        for line in out.splitlines():
            if line.startswith("{"):
                return json.loads(line)
    return None


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--procs", type=int, nargs="+", default=[1, 2],
                        help="process-count ladder (virtual hosts)")
    parser.add_argument("--devices-per-proc", type=int, default=4)
    parser.add_argument("--batch-per-device", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--mode", choices=("env", "ppo", "ppo_phases"),
                        default="env",
                        help="env = pure stepping; ppo = full train step "
                             "(rollout + GAE + update with psum'd grads)")
    parser.add_argument("--timeout", type=int, default=600)
    parser.add_argument("--port", type=int, default=12357)
    parser.add_argument("--pin-cores", action="store_true",
                        help="taskset each child to its own physical core "
                             "(clean CPU scaling: no core oversubscription)")
    parser.add_argument("--_child", nargs=3, type=int, metavar="X",
                        help="internal: process_id num_processes port")
    args = parser.parse_args()

    if args._child is not None:
        pid, nproc, port = args._child
        child(pid, nproc, port, args.devices_per_proc,
              args.batch_per_device, args.steps, mode=args.mode)
        return

    results = []
    for i, n in enumerate(args.procs):
        r = run_rung(n, args, args.port + i)
        if r is None:
            print(f"rung procs={n}: FAILED", file=sys.stderr)
            continue
        results.append(r)
        print(json.dumps(r), flush=True)

    if results:
        base = results[0]
        print("\nprocs  devices  batch     steps/s       efficiency")
        for r in results:
            linear = base["steps_per_s"] * r["devices"] / base["devices"]
            eff = r["steps_per_s"] / linear
            print(f"{r['procs']:>5}  {r['devices']:>7}  {r['batch']:>8}  "
                  f"{r['steps_per_s']:>11,}  {eff:>9.2f}x")


if __name__ == "__main__":
    main()
