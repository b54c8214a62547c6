"""Property tests pinning the reference's deliberate physics quirks.

These guard the parity-critical oddities (SURVEY.md section 7 "hard parts")
against future refactors, independently of the recorded-trace tests.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pikazoo_tpu.core import constants as C
from pikazoo_tpu.core.ball import ball_world_step
from pikazoo_tpu.core.predict import landing_sims
from pikazoo_tpu.core.state import init_ball_construction


def make_ball(**kw):
    b = init_ball_construction()
    return b._replace(**{k: jnp.int32(v) for k, v in kw.items()})


def test_floor_division_negative_velocity_rotation():
    """fine_rotation += x_velocity // 2 uses Python floor semantics: -3 // 2
    == -2, so a ball with vx=-3 from fine_rotation=0 wraps to 48."""
    b = make_ball(x=200, y=100, x_velocity=-3, y_velocity=0, fine_rotation=0)
    nb, _ = jax.jit(ball_world_step)(b)
    assert int(nb.fine_rotation) == 48  # 0 + (-2) -> -2 -> +50
    assert int(nb.rotation) == 4


def test_hyper_ball_glitch_fine_rotation_50():
    """fine_rotation hitting exactly 50 passes the wrap (only >50 wraps) and
    yields rotation 5 — the hyper-ball sprite glitch."""
    b = make_ball(x=200, y=100, x_velocity=10, y_velocity=0, fine_rotation=45)
    nb, _ = jax.jit(ball_world_step)(b)
    assert int(nb.fine_rotation) == 50
    assert int(nb.rotation) == 5


def test_wall_bound_asymmetry():
    """Right wall bounce at future_x > 432 (not 432 - radius): a ball at
    x=430 moving +1 does NOT bounce (future 431 <= 432) while at x=18 moving
    -1 (future 17 < 20) it does."""
    right = make_ball(x=430, y=100, x_velocity=1, y_velocity=0)
    nb, _ = jax.jit(ball_world_step)(right)
    assert int(nb.x_velocity) == 1 and int(nb.x) == 431

    left = make_ball(x=18, y=100, x_velocity=-1, y_velocity=0)
    nb, _ = jax.jit(ball_world_step)(left)
    assert int(nb.x_velocity) == 1 and int(nb.x) == 19


def test_net_top_band_boundary_le_192():
    """World step bounces off the pillar top for y <= 192 (inclusive!) when
    moving down; at y=193 it pushes out sideways instead."""
    on_top = make_ball(x=216, y=192, x_velocity=3, y_velocity=5)
    nb, _ = jax.jit(ball_world_step)(on_top)
    assert int(nb.y_velocity) < 0  # bounced up (then gravity applied)

    below = make_ball(x=210, y=193, x_velocity=3, y_velocity=5)
    nb, _ = jax.jit(ball_world_step)(below)
    assert int(nb.x_velocity) == -3  # pushed toward the left side


def test_predictor_net_band_boundary_strict_192():
    """The landing predictor uses a STRICT y < 192 for the top band
    (physics.py:670) unlike the world step's <= — a ball resting exactly at
    y=192 above the pillar is pushed out sideways in the prediction."""
    b = make_ball(x=216, y=192, x_velocity=0, y_velocity=0)
    expected, _ = jax.jit(landing_sims)(b)
    # Side push-out with |vx|=0 keeps vx 0; ball falls straight down onto the
    # pillar — predictor loops bouncing until the iteration cap, then reports
    # current x. The point: it terminates and stays at the pillar x.
    assert int(expected) == 216


def test_ground_touch_pins_y_and_does_not_advance_x():
    b = make_ball(x=100, y=250, x_velocity=7, y_velocity=10)
    nb, touched = jax.jit(ball_world_step)(b)
    assert int(touched) == 1
    assert int(nb.y) == C.BALL_TOUCHING_GROUND_Y_COORD
    assert int(nb.x) == 100  # x frozen on the touching frame
    assert int(nb.y_velocity) == -10  # bounce recorded
    assert int(nb.punch_effect_x) == 100


def test_landing_sim_terminates_at_cap():
    """A ball trapped bouncing on the net pillar top must hit the 1000
    iteration cap, not loop forever (INFINITE_LOOP_LIMIT)."""
    b = make_ball(x=216, y=180, x_velocity=0, y_velocity=1)
    expected, cands = jax.jit(landing_sims)(b)
    assert int(expected) == 216  # never left the pillar column


def test_candidate_landings_depend_on_side():
    """Power-hit candidates launch toward the opponent side: from the left
    half they fly right, so every candidate landing x is right of the ball
    (modulo wall bounces)."""
    b = make_ball(x=100, y=150, x_velocity=2, y_velocity=-30)
    _, cands = jax.jit(landing_sims)(b)
    cands = np.asarray(cands)
    assert cands.shape == (6,)
    assert (cands >= C.BALL_RADIUS).all()


def test_vmapped_landing_sims_match_scalar():
    balls = [make_ball(x=60 + 37 * i, y=10 + 23 * i, x_velocity=i - 3,
                       y_velocity=2 * i - 5) for i in range(8)]
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *balls)
    be, bc = jax.jit(jax.vmap(landing_sims))(batched)
    for i, b in enumerate(balls):
        e, c = jax.jit(landing_sims)(b)
        assert int(e) == int(be[i])
        np.testing.assert_array_equal(np.asarray(c), np.asarray(bc)[i])


def test_landing_sim_unroll_invariance():
    """The while-trip unroll factor groups masked sub-iterations; finished
    lanes are frozen, so every unroll must produce bit-identical landing
    points (the perf sweeps rely on this)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pikazoo_tpu.core.predict import landing_sims_any

    rng = np.random.default_rng(3)
    n = 256
    x = jnp.asarray(rng.integers(20, 413, n), jnp.int32)
    y = jnp.asarray(rng.integers(-200, 252, n), jnp.int32)
    vx = jnp.asarray(rng.integers(-20, 21, n), jnp.int32)
    vy = jnp.asarray(rng.integers(-30, 31, n), jnp.int32)
    ref_e, ref_c = jax.jit(lambda *a: landing_sims_any(*a, unroll=1))(
        x, y, vx, vy)
    # 100+ skipped: XLA's CPU backend takes minutes to compile a while body
    # with ~100 unrolled sub-iterations; 32 is the lax path's default.
    for unroll in (3, 8, 32):
        e, c = jax.jit(lambda *a, u=unroll: landing_sims_any(*a, unroll=u))(
            x, y, vx, vy)
        np.testing.assert_array_equal(np.asarray(e), np.asarray(ref_e))
        np.testing.assert_array_equal(np.asarray(c), np.asarray(ref_c))
