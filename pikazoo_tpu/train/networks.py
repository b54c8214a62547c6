"""Actor-critic network for self-play PPO, in plain JAX.

A small MLP over the 35-dim integer observation (normalized to [0,1] with the
env's Box bounds).  Both seats share one policy: observations are mirrored
per agent by the env, so a single network plays either side — self-play comes
free.  Matmul operands are bfloat16 with float32 parameters and outputs.

The parameter tree is ``{"params": {"Dense_i": {"kernel", "bias"}}}`` with
the hidden layers first, then the policy head, then the value head — the
layout the committed checkpoints were saved in.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pikazoo_tpu.envs.observations import OBS_HIGH, OBS_LOW

_LOW = np.asarray(OBS_LOW, np.float32)
_SPAN = (np.asarray(OBS_HIGH) - np.asarray(OBS_LOW)).astype(np.float32)


def normalize_obs(obs: jnp.ndarray) -> jnp.ndarray:
    return (obs.astype(jnp.float32) - _LOW) / _SPAN


def _fold_in_name(key: jax.Array, name: str, counter: int) -> jax.Array:
    """Per-parameter key: ``key`` folded with the SHA-1 of (layer name,
    parameter counter), the derivation the checkpointed policies were
    initialised with, so a seed gives the same initial weights."""
    m = hashlib.sha1()
    m.update(name.encode("utf-8"))
    m.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(key, jnp.uint32(
        int.from_bytes(m.digest()[:4], "big")))


def _dense(x: jnp.ndarray, layer: dict, dtype) -> jnp.ndarray:
    """``x @ kernel + bias`` with operands and result in ``dtype``."""
    y = jax.lax.dot_general(x.astype(dtype), layer["kernel"].astype(dtype),
                            (((x.ndim - 1,), (0,)), ((), ())))
    return y + layer["bias"].astype(dtype)


@dataclasses.dataclass(frozen=True)
class ActorCritic:
    num_actions: int = 18
    hidden: Sequence[int] = (256, 256)
    compute_dtype: jnp.dtype = jnp.bfloat16
    activation: str = "tanh"  # "tanh" (PPO convention) or "relu"

    def init(self, key: jax.Array, obs: jnp.ndarray) -> dict:
        """Parameters for inputs shaped like ``obs`` (..., F): orthogonal
        kernels (gain sqrt(2) hidden, 0.01 policy head, 1 value head) and
        zero biases, all float32."""
        fan_in = [jnp.shape(obs)[-1], *self.hidden]
        shapes = list(zip(fan_in, self.hidden)) + [
            (fan_in[-1], self.num_actions), (fan_in[-1], 1)]
        gains = [np.sqrt(2)] * len(self.hidden) + [0.01, 1.0]
        params = {}
        for i, (shape, gain) in enumerate(zip(shapes, gains)):
            name = f"Dense_{i}"
            kernel = jax.nn.initializers.orthogonal(gain)(
                _fold_in_name(key, name, 1), shape, jnp.float32)
            params[name] = {"kernel": kernel,
                            "bias": jnp.zeros(shape[1:], jnp.float32)}
        return {"params": params}

    def apply(self, params: dict, obs: jnp.ndarray,
              pre_normalized: bool = False
              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """obs: (..., 35) raw int32 -> (logits (..., A), value (...,)).

        ``pre_normalized=True`` accepts already-normalized (e.g. bfloat16)
        observations — the PPO update phase stores those in its trajectory
        buffer to halve device-memory traffic and keep rollout/update
        log-probs computed from bit-identical inputs."""
        _, L, _, _ = dense_layers(params)
        dense = params["params"]
        x = obs if pre_normalized else normalize_obs(obs)
        x = x.astype(self.compute_dtype)
        for i in range(L):
            x = _dense(x, dense[f"Dense_{i}"], self.compute_dtype)
            x = jnp.maximum(x, 0) if self.activation == "relu" \
                else jnp.tanh(x)
        # Heads compute in bf16 too: upcasting the (..., 256) hidden state
        # to f32 first would materialize two full-width f32 copies of the
        # activations (gigabytes per PPO minibatch at learner scale); the
        # (..., 18)/(..., 1) head OUTPUTS are what need f32 (softmax/GAE
        # numerics).
        logits = _dense(x, dense[f"Dense_{L}"], self.compute_dtype)
        value = _dense(x, dense[f"Dense_{L + 1}"], self.compute_dtype)
        return logits.astype(jnp.float32), \
            jnp.squeeze(value, -1).astype(jnp.float32)


def dense_layers(params):
    """ActorCritic layer-ordering contract, in one place: returns
    ``(names, L, kernels, biases)`` where the first L entries are the hidden
    layers in order, entry L is the policy head and entry L+1 the value
    head (Dense_0..Dense_{L+1}).  Shared by both forward passes so a
    renaming/reordering breaks one helper."""
    dense = params["params"]
    names = sorted(dense, key=lambda s: int(s.rsplit("_", 1)[1]))
    w = [dense[n]["kernel"] for n in names]
    b = [dense[n]["bias"] for n in names]
    return names, len(names) - 2, w, b


def apply_fm(params, x_fm: jnp.ndarray, activation: str = "tanh"
             ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """FEATURE-MAJOR forward pass: ``x_fm`` (F, N) normalized bf16 ->
    ``(logits (A, N) f32, value (N,) f32)``.

    Same parameters and same bf16-operand arithmetic as
    ``ActorCritic.apply`` but every matmul runs transposed
    (``h = act(W^T x)``): the rollout keeps the env batch as the minor
    dimension, so per-action reductions downstream (softmax, sampling,
    log-prob select) reduce over the leading axis.
    """
    _, L, w, b = dense_layers(params)
    bf, f32 = jnp.bfloat16, jnp.float32
    c00 = (((0,), (0,)), ((), ()))  # contract the input-feature dims
    h = x_fm.astype(bf)
    for l in range(L):
        pre = jax.lax.dot_general(w[l].astype(bf), h, c00,
                                  preferred_element_type=bf) \
            + b[l].astype(bf)[:, None]
        h = jnp.maximum(pre, 0) if activation == "relu" else jnp.tanh(pre)
    # Merged policy+value head: one (H, A+1) matmul instead of a separate
    # one-row value product.  Per-column accumulation is unchanged, so
    # logits and value are bit-identical to the split form.
    wpv = jnp.concatenate([w[L].astype(bf), w[L + 1].astype(bf)], axis=1)
    bpv = jnp.concatenate([b[L].astype(bf), b[L + 1].astype(bf)])
    heads = jax.lax.dot_general(wpv, h, c00,
                                preferred_element_type=bf) + bpv[:, None]
    return heads[:-1].astype(f32), heads[-1].astype(f32)
