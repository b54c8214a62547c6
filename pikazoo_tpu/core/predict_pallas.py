"""Pallas (Triton route) kernel for the batched landing simulation.

Why: under ``vmap``, the ``lax.while_loop`` landing sim keeps its carry in
device memory and runs every lane to the *batch-max* iteration count, with a
predicate round trip on every trip.  This kernel gives each block of
``block`` envs its own loop: the carry stays in registers, device-memory
traffic drops to 4 input and 7 output words per env, and each block stops at
its OWN block-max iteration count.

The simulation body is the SAME shape-generic function the lax path uses
(``core.predict.landing_sims_any``), so kernel and fallback cannot drift;
equality is tested in interpret mode on the CPU and at full width on the
card.  Two Triton constraints shape the call: reductions need a
power-of-two element count, so the six candidate lanes are padded to eight
(the pad lanes start with ``vx == 0`` and are done on entry), and the
padding envs of the last block start below the ground, so they are done on
their first iteration.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from pikazoo_tpu.core.predict import landing_sims_any

# Envs per Triton program, warps per program and frame iterations per while
# trip: the fastest of a 36-point sweep on live self-play states at
# B = 65,536 on an H100 (tools/gpu_phases.py landing; PERF.md).
BLOCK = 128
NUM_WARPS = 4
UNROLL = 8
# Candidate lanes inside the kernel: the six power-hit candidates padded to
# the next power of two.
CAND_LANES = 8
# Algorithms the kernel body accepts (``PIKAZOO_SIM_ALGO``).
KERNEL_ALGOS = ("iter",)


def _landing_kernel(unroll, x_ref, y_ref, vx_ref, vy_ref, exp_ref, cand_ref):
    expected, candidates = landing_sims_any(
        x_ref[...], y_ref[...], vx_ref[...], vy_ref[...], unroll=unroll,
        algo="iter", split="none", cand_lanes=CAND_LANES)
    exp_ref[...] = expected
    cand_ref[...] = candidates


@functools.partial(jax.jit, static_argnames=("interpret", "block",
                                              "num_warps", "unroll"))
def landing_sims_batched(x: jnp.ndarray, y: jnp.ndarray, vx: jnp.ndarray,
                         vy: jnp.ndarray, interpret: bool = False,
                         block: int | None = None,
                         num_warps: int | None = None,
                         unroll: int | None = None
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(B,) ball state -> (expected (B,), candidates (B, 6)).

    ``block`` (a power of two, default ``BLOCK``) is the number of envs per
    program: programs run in parallel and each runs its while loops to its
    own block-max iteration count.  ``interpret=True`` runs the kernel on
    the CPU (tests only)."""
    block = block or BLOCK
    num_warps = num_warps or NUM_WARPS
    unroll = unroll or UNROLL
    if block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    B = x.shape[0]
    padded = -(-B // block) * block

    def prep(a, fill):
        return jnp.pad(a.astype(jnp.int32), (0, padded - B),
                       constant_values=fill)

    # Padding envs start beyond the ground (y > 252): done on iteration 1.
    xp, yp = prep(x, 216), prep(y, 10_000)
    vxp, vyp = prep(vx, 0), prep(vy, 0)

    env_spec = pl.BlockSpec((block,), lambda i: (i,))
    exp, cand = pl.pallas_call(
        functools.partial(_landing_kernel, unroll),
        grid=(padded // block,),
        in_specs=[env_spec] * 4,
        out_specs=[env_spec,
                   pl.BlockSpec((CAND_LANES, block), lambda i: (0, i))],
        out_shape=[jax.ShapeDtypeStruct((padded,), jnp.int32),
                   jax.ShapeDtypeStruct((CAND_LANES, padded), jnp.int32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                    num_stages=1),
        interpret=interpret,
        name="landing_sims",
    )(xp, yp, vxp, vyp)
    return exp[:B], jnp.moveaxis(cand[:6, :B], 0, 1)
