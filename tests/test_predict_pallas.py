"""Triton-route landing kernel == lax reference (interpret mode on the CPU),
and the predictor dispatch rules."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pikazoo_tpu.core import predict
from pikazoo_tpu.core.predict import _landing_sims_impl, landing_sims_any
from pikazoo_tpu.core.predict_pallas import landing_sims_batched
from pikazoo_tpu.core.state import init_ball_construction


def random_ball_states(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(20, 433, n).astype(np.int32),
            rng.integers(0, 253, n).astype(np.int32),
            rng.integers(-20, 21, n).astype(np.int32),
            rng.integers(-60, 61, n).astype(np.int32))


def lax_reference(x, y, vx, vy):
    base = init_ball_construction()
    balls = jax.tree.map(
        lambda leaf: jnp.broadcast_to(leaf, (len(x),)), base)._replace(
            x=jnp.asarray(x), y=jnp.asarray(y),
            x_velocity=jnp.asarray(vx), y_velocity=jnp.asarray(vy))
    return jax.jit(jax.vmap(_landing_sims_impl))(balls)


def assert_kernel_matches_lax(x, y, vx, vy, block):
    exp_p, cand_p = landing_sims_batched(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(vx), jnp.asarray(vy),
        interpret=True, block=block)
    exp_l, cand_l = lax_reference(x, y, vx, vy)
    assert exp_p.shape == (len(x),) and cand_p.shape == (len(x), 6)
    np.testing.assert_array_equal(np.asarray(exp_p), np.asarray(exp_l))
    np.testing.assert_array_equal(np.asarray(cand_p), np.asarray(cand_l))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n, block", [
    (1, 128),      # batch 1: one program, 127 padding envs
    (300, 128),    # not a multiple of the block
    (256, 256),    # exactly one block
    (401, 128),    # several blocks plus a remainder
])
def test_pallas_kernel_matches_lax_reference(n, block, seed):
    assert_kernel_matches_lax(*random_ball_states(n, seed), block)


def test_pallas_kernel_net_trap_states():
    """Adversarial states: net-column, vx=0 fast-exit, cap-hitting cycles."""
    cases = np.array([
        [216, 180, 0, 1],    # pure net trap (fast exit)
        [216, 192, 0, 0],    # boundary of the strict < 192 band
        [200, 177, 3, 10],   # in-column moving
        [230, 190, -1, -5],
        [56, 0, 0, 1],       # fresh serve
        [432, 100, 20, -60],  # wall-hugging lob
    ], np.int32)
    assert_kernel_matches_lax(*cases.T, 128)


def test_padded_candidate_lanes_are_inert():
    """The kernel's two extra candidate lanes start at vx == 0: they never
    iterate (result = start x), and lanes 0-5 are bit-identical to the
    6-lane loop."""
    x, y, vx, vy = map(jnp.asarray, random_ball_states(200, 3))
    exp6, cand6 = landing_sims_any(x, y, vx, vy)
    exp8, cand8 = landing_sims_any(x, y, vx, vy, cand_lanes=8)
    assert cand6.shape == (6, 200) and cand8.shape == (8, 200)
    np.testing.assert_array_equal(np.asarray(exp8), np.asarray(exp6))
    np.testing.assert_array_equal(np.asarray(cand8[:6]), np.asarray(cand6))
    np.testing.assert_array_equal(np.asarray(cand8[6:]),
                                  np.broadcast_to(np.asarray(x), (2, 200)))


def test_block_must_be_power_of_two():
    x = jnp.zeros((4,), jnp.int32)
    with pytest.raises(ValueError, match="power of two"):
        landing_sims_batched(x, x, x, x, interpret=True, block=96)


# ------------------------------------------------------------- dispatch --

def test_auto_picks_kernel_on_gpu_and_lax_elsewhere(monkeypatch):
    monkeypatch.delenv("PIKAZOO_PREDICTOR", raising=False)
    assert predict.resolve_predictor("gpu") == (True, "backend")
    assert predict.resolve_predictor("cpu") == (False, "backend")


def test_forced_predictor_and_unreachable_knobs_raise(monkeypatch):
    monkeypatch.setenv("PIKAZOO_PREDICTOR", "lax")
    assert predict.resolve_predictor("gpu") == (False, "env")
    monkeypatch.setenv("PIKAZOO_PREDICTOR", "pallas")
    assert predict.resolve_predictor("gpu") == (True, "env")
    # Never an interpreted kernel outside tests: a forced kernel off the GPU
    # raises instead of running.
    with pytest.raises(ValueError, match="needs a GPU"):
        predict.resolve_predictor("cpu")
    monkeypatch.setenv("PIKAZOO_PREDICTOR", "bogus")
    with pytest.raises(ValueError, match="PIKAZOO_PREDICTOR"):
        predict.resolve_predictor("gpu")


@pytest.mark.parametrize("algo, split", [("leap", "none"), ("hyb", "none"),
                                         ("iter,leap", "none"),
                                         ("iter", "ydir")])
def test_kernel_refuses_algorithms_it_cannot_run(monkeypatch, algo, split):
    monkeypatch.delenv("PIKAZOO_PREDICTOR", raising=False)
    monkeypatch.setattr(predict, "_ALGO", algo)
    monkeypatch.setattr(predict, "_SPLIT", split)
    with pytest.raises(ValueError, match="PIKAZOO_PREDICTOR=lax"):
        predict.resolve_predictor("gpu")
    # The lax path still runs them.
    assert predict.resolve_predictor("cpu") == (False, "backend")


def test_ai_step_on_cpu_records_lax_provenance(monkeypatch):
    from pikazoo_tpu.envs import EnvConfig, PikaZoo

    monkeypatch.delenv("PIKAZOO_PREDICTOR", raising=False)
    env = PikaZoo(EnvConfig(is_player1_computer=True,
                            is_player2_computer=True))
    state, _ = env.reset_batch(jax.random.key(0), 8)
    jax.jit(env.step_batch).lower(state, jnp.zeros((8, 2), jnp.int32))
    assert predict.dispatch_provenance() == {"predictor": "lax",
                                             "source": "backend"}
