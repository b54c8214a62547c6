"""Shared test utilities: oracle replay of a recorded reference trace."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pikazoo_tpu.envs import EnvConfig, PikaZoo
from pikazoo_tpu.parity import ReferenceTrace

ORACLE_CAPACITY = 1 << 15


def pad_oracle(draws: np.ndarray, capacity: int = ORACLE_CAPACITY) -> jnp.ndarray:
    assert draws.shape[0] <= capacity, "oracle capacity too small for trace"
    buf = np.zeros((capacity,), np.int32)
    buf[: draws.shape[0]] = draws
    return jnp.asarray(buf)


def replay_and_compare(trace: ReferenceTrace, config: EnvConfig,
                       check_draw_counts: bool = True,
                       env: PikaZoo | None = None) -> None:
    """Replay a reference trace through the JAX env in oracle mode and assert
    frame-by-frame equality of obs, rewards, terminations and draw counters.

    Pass ``env`` to reuse one PikaZoo instance (and its jit cache) across
    many traces of the same config — the fuzz corpus replays dozens of seeds
    per config and a fresh instance would recompile ``step`` every time."""
    assert not config.auto_reset, "parity replay needs PettingZoo semantics"
    if env is None:
        env = PikaZoo(config)
    else:
        assert env.config == config
    oracle = pad_oracle(trace.draws)
    state, ts = env.reset(jax.random.key(0), oracle=oracle)
    step = jax.jit(env.step)

    np.testing.assert_array_equal(np.asarray(ts.obs), trace.obs[0],
                                  err_msg="reset obs mismatch")
    if check_draw_counts:
        assert int(state.draw_counter) == trace.draw_count_after_reset

    n_steps = trace.actions.shape[0]
    for t in range(n_steps):
        state, ts = step(state, jnp.asarray(trace.actions[t]), oracle)
        obs = np.asarray(ts.obs)
        if not np.array_equal(obs, trace.obs[t + 1]):
            diff = np.argwhere(obs != trace.obs[t + 1])
            raise AssertionError(
                f"obs mismatch at step {t}: dims {diff.tolist()} "
                f"ref={trace.obs[t + 1][tuple(diff[0])]} "
                f"got={obs[tuple(diff[0])]}")
        np.testing.assert_array_equal(np.asarray(ts.rewards), trace.rewards[t],
                                      err_msg=f"reward mismatch at step {t}")
        assert bool(ts.terminated) == bool(trace.terminations[t]), \
            f"termination mismatch at step {t}"
        np.testing.assert_array_equal(np.asarray(ts.scores), trace.scores[t],
                                      err_msg=f"score mismatch at step {t}")
        if check_draw_counts:
            assert int(state.draw_counter) == int(trace.draw_count_after_step[t]), \
                (f"draw counter mismatch at step {t}: "
                 f"ref={trace.draw_count_after_step[t]} got={int(state.draw_counter)}")
