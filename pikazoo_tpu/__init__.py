"""pikazoo_tpu — a Pikachu Volleyball multi-agent RL framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of ``helpingstar/pika-zoo``
(reference mounted read-only at ``/root/reference``): the per-frame Python game
loop becomes a pure-functional, jit-able step over an integer-typed state
pytree, vmapped to thousands of lockstep matches and sharded over a device
mesh.  See ``SURVEY.md`` for the component inventory this implements.

Layers (bottom up):
  core/         physics kernel: ball/world, player FSM, collisions, landing
                predictor, rule-based computer AI, draw-slot RNG
  envs/         the functional ParallelEnv-equivalent (reset/step pure fns)
  wrappers/     traced wrapper transforms (SimplifyAction, reward shaping, ...)
  compat/       PettingZoo ParallelEnv adapter with the reference's exact API
  render/       host-side rgb_array renderer (outside jit)
  parallel/     device-mesh sharding of the env batch (shard_map / pjit)
  train/        self-play PPO actor-learner on the sharded batch
  parity/       frame-by-frame comparison harness against the reference env
"""

from pikazoo_tpu.version import __version__
from pikazoo_tpu.envs import EnvConfig, PikaZoo, TimeStep

__all__ = ["__version__", "EnvConfig", "PikaZoo", "TimeStep"]
