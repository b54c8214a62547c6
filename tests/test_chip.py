"""Correctness on the card: each test needs a GPU and skips without one.

Run on the chip with one process and no workers, so the card has one user:

    JAX_PLATFORMS=cuda python -m pytest -m chip -p no:xdist tests

(``chip_smoke.py`` does this as its first phase.)
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.chip


def test_landing_kernel_matches_lax_at_full_width(gpu):
    """The compiled Triton kernel against the lax path, B = 65,536 random
    ball states plus the net-trap states: integer outputs, exact."""
    from pikazoo_tpu.core.predict import landing_sims_any
    from pikazoo_tpu.core.predict_pallas import landing_sims_batched

    n = 65_536
    rng = np.random.default_rng(0)
    x = rng.integers(20, 433, n).astype(np.int32)
    y = rng.integers(0, 253, n).astype(np.int32)
    vx = rng.integers(-20, 21, n).astype(np.int32)
    vy = rng.integers(-60, 61, n).astype(np.int32)
    traps = np.array([[216, 180, 0, 1], [216, 192, 0, 0], [200, 177, 3, 10],
                      [230, 190, -1, -5], [56, 0, 0, 1], [432, 100, 20, -60]],
                     np.int32)
    x[:6], y[:6], vx[:6], vy[:6] = traps.T
    args = [jax.device_put(a, gpu) for a in (x, y, vx, vy)]
    got = jax.jit(landing_sims_batched)(*args)
    want = jax.jit(jax.vmap(lambda *s: landing_sims_any(*s)))(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_golden_trajectory_on_card(gpu, monkeypatch):
    """The committed 400-frame golden trajectory (rule AI on both seats, so
    the landing kernel serves) reproduced bit for bit on the GPU."""
    import test_golden_trajectory as golden

    from pikazoo_tpu.core import predict

    monkeypatch.delenv("PIKAZOO_PREDICTOR", raising=False)
    golden.test_golden_production_trajectory()
    assert predict.dispatch_provenance()["predictor"] == "pallas"


def test_gpu_matches_cpp_engine_on_sampled_lanes(gpu):
    """Rule-AI self-play on the GPU at B = 16,384 for 400 frames: 64
    sampled lanes bit-equal to the C++ engine from the same packed state
    with the same actions (production RNG)."""
    from pikazoo_tpu.envs import EnvConfig, PikaZoo
    from pikazoo_tpu.native.engine import NativeEngine, native_available

    if not native_available():
        pytest.fail("the C++ engine did not build on this machine")
    B, T = 16_384, 400
    cfg = EnvConfig(auto_reset=True, winning_score=3, is_player1_computer=True,
                    is_player2_computer=True)
    env = PikaZoo(cfg)
    state, _ = env.reset_batch(jax.random.key(7), B)
    actions = jax.random.randint(jax.random.key(8), (T, B, 2), 0, 18)
    final = jax.jit(lambda s, a: jax.lax.scan(
        lambda s, a: (env.step_batch(s, a)[0], None), s, a)[0])(state,
                                                              actions)
    lanes = np.random.default_rng(1).choice(B, 64, replace=False)
    pick = lambda tree: jax.tree.map(lambda v: np.asarray(v)[lanes], tree)
    packed = NativeEngine.pack(pick(state))
    NativeEngine(winning_score=3, is_player1_computer=True,
                 is_player2_computer=True).run(
        packed, np.ascontiguousarray(np.asarray(actions)[:, lanes]))
    np.testing.assert_array_equal(packed, NativeEngine.pack(pick(final)))
    assert int(jnp.asarray(final.step_count).min()) == T
