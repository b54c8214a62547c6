"""Device-mesh sharding of the environment batch.

The env step is embarrassingly parallel over matches, so the scaling design
is one named mesh axis, ``env``: the batch dimension of every state leaf is
sharded across all devices (every card of a host reaches every other over
NVLink), parameters are replicated, and the only collectives in the system are
the gradient all-reduces XLA inserts for the learner (see ``train/ppo.py``).
No hand-written transport: ``jax.distributed.initialize`` + ``Mesh`` +
``NamedSharding`` under ``jit`` is the whole communication backend (the
reference is single-process Python and has no counterpart — SURVEY.md N3/N4).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENV_AXIS = "env"


def init_distributed(**kwargs) -> None:
    """Initialize the multi-process JAX runtime.

    Call once at program start in every process, before any device is
    used.  ``kwargs`` go to ``jax.distributed.initialize``: on a machine
    that tells JAX of no cluster, pass ``coordinator_address``
    (``host:port`` of process 0), ``num_processes`` and ``process_id``.
    A second call in the same process is a no-op; any other failure
    raises, so a failed start never runs single-process."""
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "should only be called once" not in str(e):
            raise


def make_env_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D mesh over all (global) devices with the ``env`` axis."""
    devices = list(devices) if devices is not None else jax.devices()
    # Auto axis type = classic GSPMD: sharding constraints are hints and the
    # compiler propagates/inserts collectives (jax>=0.9 defaults to Explicit).
    return jax.make_mesh((len(devices),), (ENV_AXIS,), devices=devices,
                         axis_types=(jax.sharding.AxisType.Auto,))


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for batch-leading arrays: dim 0 split over the env axis."""
    return NamedSharding(mesh, P(ENV_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh):
    """Place a batch-leading pytree (EnvState, actions, ...) onto the mesh,
    sharded along dim 0 of every leaf."""
    sharding = env_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
