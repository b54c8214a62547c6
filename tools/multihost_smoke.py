"""Two-process multi-host smoke: the real jax.distributed path on CPU.

Launched once per "host" (see tests/test_multihost.py): each process forces
the CPU backend with 4 local virtual devices, joins a 2-process distributed
runtime over localhost, builds the global 8-device env mesh, and runs one
sharded PPO train step — exercising cross-process gradient all-reduces and
global-mesh sharding as a multi-process GPU run would (SURVEY N3/N4), not
just the single-process dry run.
"""

import os
import sys

_DEVICES = int(os.environ.get("PIKAZOO_SMOKE_DEVICES", "4"))
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={_DEVICES}")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main(process_id: int, num_processes: int, port: int) -> None:
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )
    assert jax.process_count() == num_processes
    global_devices = jax.devices()
    assert len(global_devices) == _DEVICES * num_processes, \
        len(global_devices)

    import numpy as np

    from pikazoo_tpu.envs import EnvConfig, PikaZoo
    from pikazoo_tpu.parallel import make_env_mesh
    from pikazoo_tpu.train import PPOConfig, make_ppo_trainer

    mesh = make_env_mesh(global_devices)
    cfg = PPOConfig(num_envs=4 * len(global_devices), rollout_length=8,
                    num_minibatches=2, update_epochs=1, hidden=(32,))
    env = PikaZoo(EnvConfig(winning_score=2))
    init_fn, train_step, _ = make_ppo_trainer(env, cfg, mesh=mesh)

    # Build the global sharded runner: every process computes the same init
    # (same key), then device_put onto the global mesh.
    from pikazoo_tpu.parallel import env_sharding
    runner = init_fn(jax.random.key(0))
    sharding = env_sharding(mesh)

    def to_global(x):
        # Host-local construction of a globally-sharded array.
        return jax.make_array_from_callback(
            x.shape, sharding, lambda idx: np.asarray(x)[idx])

    runner = runner._replace(
        env_state=jax.tree.map(to_global, runner.env_state),
        last_obs=to_global(runner.last_obs))

    runner, metrics = jax.jit(train_step)(runner)
    jax.block_until_ready(metrics.total_loss)
    loss = float(metrics.total_loss)
    assert np.isfinite(loss)
    n_dev = len(runner.env_state.scores.sharding.device_set)
    assert n_dev == len(global_devices), n_dev
    print(f"process {process_id}: loss={loss:.6f} "
          f"sharded_over={n_dev} devices OK", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
