"""Landing-point forward simulation — the hot loop of the computer AI.

The reference runs up to ~16 sequential Python while-loops per frame
(``calculate_expected_landing_point_x_for`` at ``physics.py:643-686``, called
from the movement loop and after each collision, plus up to 6
``expected_landing_point_x_when_power_hit`` sims per airborne computer,
``physics.py:820-884``).  Two structural observations collapse all of that
into ONE vectorized 7-lane loop per frame:

1. The ball does not change during the player-movement loop, so the two
   movement-loop predictor calls (``physics.py:313-316``) compute the same
   value, and both players' power-hit candidate sims see the same ball —
   and the candidate landing point depends only on (|x_dir|, y_dir, ball),
   not on the player.  One 6-candidate sim serves both players.
2. The post-collision recomputes (``physics.py:330-332``) write
   ``expected_landing_point_x``, which is *always* overwritten by the next
   frame's movement-loop recompute before any read (it appears in no
   observation and the AI only reads it inside the movement loop).  They are
   pure redundancy and are elided here.  Parity tests confirm this.

Lane 0 simulates the full net rule of the main predictor (note: strict
``y < 192`` top test, unlike the world step's ``<=``); lanes 1-6 simulate the
power-hit variant whose net model only flips y_velocity — the original game's
intentional "computer makes mistakes" physics (``physics.py:856-866``).

The loop is a ``lax.while_loop`` over int32 vectors with an explicit done
mask, so it vectorizes cleanly under vmap (iterations = max over the batch;
typical trajectories land in ~25 iterations, hard cap 1000).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from pikazoo_tpu.core import constants as C
from pikazoo_tpu.core.state import BallState

# Sub-iterations per while-loop trip in the lax path (see body()); tunable
# via PIKAZOO_SIM_UNROLL.  Fewer while trips (each pays a carry round trip
# through device memory) trade against masked extra sub-iterations.
import os as _os

_UNROLL = int(_os.environ.get("PIKAZOO_SIM_UNROLL", "32"))

# Landing-loop algorithm: "iter" = the reference's frame-by-frame loop;
# "leap" = the event-leaping loop (_leap_loop) advancing in closed form over
# provably trigger-free spans; "hyb" = one leap jump + unrolled frame
# iterations per trip (_hyb_loop); "A,B" mixes (true ball A, candidates B).
# All bit-identical (differential fuzz in tests/test_leap_sim.py).  "auto"
# resolves to "iter"; the alternatives stay as validated options.
_ALGO = _os.environ.get("PIKAZOO_SIM_ALGO", "auto")
_LEAP_UNROLL = int(_os.environ.get("PIKAZOO_LEAP_UNROLL", "1"))
_HYB_UNROLL = int(_os.environ.get("PIKAZOO_HYB_UNROLL", "32"))
# Candidate-loop grouping: "none" (default) keeps one 6-lane loop; "ydir"
# runs three 2-lane loops grouped by launch y-direction.
_SPLIT = _os.environ.get("PIKAZOO_SIM_SPLIT", "none")


def _sim_loop(x, y, vx, vy, full_rule: bool, unroll: int = 0):
    """Bounded landing loop over any-shaped int32 state; ``full_rule`` is a
    STATIC flag selecting the main predictor's two-branch net model (strict
    top test + side push-out, ``physics.py:665-676``) vs the power-hit
    variant's flip-only mistake model (``physics.py:856-866``).

    Slim carry (x, y, vx, vy, count): the while-loop round-trips its carry
    through device memory every trip under vmap, so the carry IS the
    bandwidth bill.
    Two invariants make the usual done/result arrays redundant:
      * a live lane's vx never becomes 0 (the wall and net rules only
        negate it), so vx == 0 exactly encodes "finished or never-live";
      * x is not advanced on the finishing iteration (the reference breaks
        before the x update), so a finished lane's frozen x IS its result.
    Booleans stay out of the carry, so the same body lowers inside the
    Pallas kernel.
    """

    def cond(carry):
        # A max of |vx| rather than jnp.any: the Pallas Triton lowering has
        # no boolean or-reduction.
        _, _, vx, _, _ = carry
        return jnp.max(jnp.abs(vx)) > 0

    def one_iteration(carry):
        x, y, vx, vy, count = carry
        live = vx != 0
        # The iteration counter is a SCALAR: every still-live lane has been
        # live since iteration 0, so its private loop_counter equals the
        # global iteration index; finished lanes no longer read it.
        count1 = count + 1

        future_x = x + vx
        vx1 = jnp.where((future_x < C.BALL_RADIUS) | (future_x > C.GROUND_WIDTH),
                        -vx, vx)
        vy1 = jnp.where(y + vy < 0, jnp.int32(1), vy)

        at_net = (jnp.abs(x - C.GROUND_HALF_WIDTH) < C.NET_PILLAR_HALF_WIDTH) & \
                 (y > C.NET_PILLAR_TOP_TOP_Y_COORD)
        if full_rule:
            # Main predictor: strict < on the top band, side push-out below.
            on_top = y < C.NET_PILLAR_TOP_BOTTOM_Y_COORD
            vy2 = jnp.where(at_net & (vy1 > 0) & on_top, -vy1, vy1)
            side_vx = jnp.where(x < C.GROUND_HALF_WIDTH,
                                -jnp.abs(vx1), jnp.abs(vx1))
            vx2 = jnp.where(at_net & ~on_top, side_vx, vx1)
        else:
            vy2 = jnp.where(at_net & (vy1 > 0), -vy1, vy1)
            vx2 = vx1

        y1 = y + vy2
        finished = (y1 > C.BALL_TOUCHING_GROUND_Y_COORD) | \
                   (count1 >= C.INFINITE_LOOP_LIMIT)
        advance = live & ~finished
        x = jnp.where(advance, x + vx2, x)
        y = jnp.where(live, y1, y)
        vx = jnp.where(advance, vx2, jnp.int32(0))
        vy = jnp.where(advance, vy2 + 1, vy)
        return x, y, vx, vy, count1

    def body(carry):
        # Manual unroll: under vmap, XLA materializes while-loop carries in
        # device memory each trip, so batching several masked iterations per
        # trip cuts that traffic proportionally.  Finished lanes are frozen by the
        # masks, so running a few extra sub-iterations past a lane's exit is
        # a no-op; live lanes see exactly the reference iteration sequence.
        for _ in range(unroll or _UNROLL):
            carry = one_iteration(carry)
        return carry

    # Fast exit baked into the vx == 0 encoding: a lane starting with vx == 0
    # can never change x, so its result is its start x and it never iterates.
    # This removes the worst case where a ball trapped bouncing on the
    # net-pillar top (necessarily vx == 0) would drag every batch lane
    # through the full 1000-iteration cap; it also short-circuits the common
    # just-served state.  Power-hit lanes always have |vx| >= 10.
    init = (x, y, vx, vy, jnp.int32(0))
    result, *_ = jax.lax.while_loop(cond, body, init)
    return result


def _make_leap_step(full_rule: bool):
    """Build the event-leaping primitives over carry (x, y, vx, vy, c):
    returns ``(one_leap, jump, exact_iteration)``.

    Factored out of :func:`_leap_loop` / :func:`_hyb_loop` so tools/tests
    can drive trips one at a time (trip-count instrumentation,
    partial-progress invariants).

    Safety argument (under-estimating ``k`` is always safe; over-estimating
    never happens):

    * wall / band-entry spans are divisions, re-verified and adjusted with
      exact multiply-back checks;
    * every y-hazard (ground ``y > 252``, ceiling ``y + vy < 0``, the net
      band's 176/192 lines) uses the displacement bound
      ``|y_j - y| <= j*|vy| + j(j+1)/2`` — monotone in ``j``, so the largest
      ``k`` with bound <= distance-to-hazard is quiet; its float32 root is
      fixed up by exact re-evaluation (all quantities are integers < 2^24,
      exactly representable in f32, so the root is recovered exactly);
    * ``vy_j <= 0`` spans (``j <= -vy``) are exact; quiet-OR combinations
      take ``max`` of per-condition spans (each alone proves quietness);
    * the iteration-cap family ``k <= 999 - c`` needs a PER-LANE counter
      ``c`` (lanes leap unevenly), unlike _sim_loop's scalar count.

    The ENTIRE carry is integer-valued float32, so the jump arithmetic uses
    float mul/div/sqrt/floor instead of emulated int32 division.  Exactness
    is preserved because every value and product here is an integer of
    magnitude < 2^24 (k <= 1000 by the iteration cap, |vy| <= |vy0| + 1000,
    coordinates a few hundred), all exactly representable in f32; division
    and sqrt roots are re-verified with exact f32 integer arithmetic and
    adjusted downward, so a rounding wobble can never overestimate a span.
    """
    BR = float(C.BALL_RADIUS)
    GW = float(C.GROUND_WIDTH)
    GHW = float(C.GROUND_HALF_WIDTH)
    NPHW = float(C.NET_PILLAR_HALF_WIDTH)
    TOP = float(C.NET_PILLAR_TOP_TOP_Y_COORD)       # 176
    BOT = float(C.NET_PILLAR_TOP_BOTTOM_Y_COORD)    # 192
    GND = float(C.BALL_TOUCHING_GROUND_Y_COORD)     # 252
    CAP = float(C.INFINITE_LOOP_LIMIT)              # 1000
    BIGF = float(1 << 20)

    def k_disp(avy, d):
        """Largest k >= 0 with k*|vy| + k(k+1)/2 <= d (0 when d <= 0).

        The f32 root is within +-1 of the true integer; one exact downward
        fixup removes any overestimate (a residual underestimate only costs
        an extra trip, never correctness)."""
        b = 2.0 * avy + 1.0
        disc = b * b + 8.0 * jnp.maximum(d, 0.0)
        k = jnp.floor((jnp.sqrt(disc) - b) * 0.5)
        k = jnp.where(k * avy + 0.5 * k * (k + 1.0) <= d, k, k - 1.0)
        return jnp.maximum(k, 0.0)

    def div_floor(a, b):
        """floor(a/b), never above it, for integer-valued a >= 0, b >= 1."""
        q = jnp.floor(a / b)
        return jnp.where(q * b > a, q - 1.0, q)

    def safe_jump(x, y, vx, vy, c):
        pos = vx > 0.0
        neg = ~pos
        avx = jnp.abs(vx)
        avy = jnp.abs(vy)
        # Boolean-valued selects are written as mask arithmetic
        # ((pos & a) | (~pos & b)) rather than selects on booleans.
        # Wall family: first iteration j where x + (j+1)*vx leaves [20, 432].
        hit_near = (pos & (x + vx < BR)) | (neg & (x + vx > GW))
        wall_num = jnp.where(pos, GW - x, x - BR)
        k_wall = jnp.where(hit_near, 0.0,
                           div_floor(jnp.maximum(wall_num, 0.0), avx))

        # Net family.  In the x-band (192 <= x <= 240) quietness is a y/vy
        # condition; outside it, the span to band entry bounds the jump.
        lo, hi = GHW - NPHW + 1.0, GHW + NPHW - 1.0
        in_band = (x >= lo) & (x <= hi)
        toward = (pos & (x < lo)) | (neg & (x > hi))
        dist = jnp.where(pos, lo - x, x - hi)
        # ceil(d/b) = floor((d-1)/b) + 1 for integer d >= 1
        k_entry = jnp.where(
            toward, div_floor(jnp.maximum(dist, 1.0) - 1.0, avx) + 1.0,
            BIGF)
        k_vy = jnp.maximum(-vy, 0.0)        # j <= -vy  =>  vy_j <= 0
        k_176 = k_disp(avy, TOP - y)
        if full_rule:
            # Below the top band (y >= 192) the side push-out assigns
            # vx = -|vx| (left) / |vx| (right) — a no-op while vx already
            # points away from the net, which x-monotonicity reduces to a
            # check on the current x side.
            left = x < GHW
            away = (left & (vx < 0.0)) | (~left & (vx > 0.0))
            k_192 = k_disp(avy, y - BOT)
            k_under = k_disp(avy, (BOT - 1.0) - y)
            k_net_stay = jnp.maximum(k_176, jnp.minimum(k_vy, k_under))
            k_net_away = jnp.maximum(jnp.maximum(k_176, k_vy), k_192)
            k_net = jnp.where(away, k_net_away, k_net_stay)
        else:
            k_net = jnp.maximum(k_176, k_vy)
        k_band = jnp.where(in_band, k_net, k_entry)

        # Ground (always) and ceiling.  For vy >= 0 the ceiling test
        # y_j + vy_j < 0 is monotonically receding (q increasing), so it is
        # either immediate (y + vy < 0, possible when y itself is negative)
        # or never; for vy < 0 the displacement bound D(k) <= y keeps
        # y_j + vy_j = q(j+1) >= 0 quiet.
        d_ceil = jnp.where(vy >= 0.0,
                           jnp.where(y + vy < 0.0, -1.0, BIGF), y)
        d = jnp.minimum(GND - y, d_ceil)
        k_y = k_disp(avy, d)

        k = jnp.minimum(jnp.minimum(k_wall, k_band), k_y)
        return jnp.minimum(k, jnp.maximum((CAP - 1.0) - c, 0.0))

    def jump(carry):
        # Closed-form quiet advance over k reference iterations (the k*vy
        # and k*(k-1)/2 products are integers < 2^24 — exact in f32).
        x, y, vx, vy, c = carry
        live = vx != 0.0
        k = jnp.where(live, safe_jump(x, y, vx, vy, c), 0.0)
        x = x + k * vx
        y = y + k * vy + 0.5 * k * (k - 1.0)
        return x, y, vx, vy + k, c + k

    def exact_iteration(carry):
        x, y, vx, vy, c = carry
        live = vx != 0.0
        count1 = c + 1.0
        future_x = x + vx
        vx1 = jnp.where((future_x < BR) | (future_x > GW), -vx, vx)
        vy1 = jnp.where(y + vy < 0.0, 1.0, vy)
        at_net = (jnp.abs(x - GHW) < NPHW) & (y > TOP)
        if full_rule:
            on_top = y < BOT
            vy2 = jnp.where(at_net & (vy1 > 0.0) & on_top, -vy1, vy1)
            side_vx = jnp.where(x < GHW, -jnp.abs(vx1), jnp.abs(vx1))
            vx2 = jnp.where(at_net & ~on_top, side_vx, vx1)
        else:
            vy2 = jnp.where(at_net & (vy1 > 0.0), -vy1, vy1)
            vx2 = vx1
        y1 = y + vy2
        finished = (y1 > GND) | (count1 >= CAP)
        advance = live & ~finished
        x = jnp.where(advance, x + vx2, x)
        y = jnp.where(live, y1, y)
        vx = jnp.where(advance, vx2, 0.0)
        vy = jnp.where(advance, vy2 + 1.0, vy)
        c = jnp.where(live, count1, c)
        return x, y, vx, vy, c

    def one_leap(carry):
        # One trip: jump over the quiet span, then realize the event with
        # one exact reference iteration.
        return exact_iteration(jump(carry))

    return one_leap, jump, exact_iteration


def _leap_loop(x, y, vx, vy, full_rule: bool, unroll: int = 0):
    """Event-leaping landing loop — bit-identical to :func:`_sim_loop`.

    The reference iteration (``physics.py:655-685``) is free flight except on
    *event* frames: wall reflection, ceiling clamp, net interaction, ground
    break.  Between events x is linear and y is an integer parabola, so each
    while-trip (see :func:`_make_leap_step`) (1) computes a span length ``k``
    PROVEN to contain no event, (2) advances the state over it in closed
    form (``x += k*vx; y += k*vy + k(k-1)/2; vy += k``), and (3) executes
    ONE exact reference iteration, which realizes the event.  This needs
    far fewer trips than the frame loop, each costing more arithmetic.
    ``unroll`` = leap-steps per while trip.
    """
    one_leap, _, _ = _make_leap_step(full_rule)
    f32 = jnp.float32

    def cond(carry):
        return jnp.any(carry[2] != 0.0)

    def body(carry):
        for _ in range(unroll or _LEAP_UNROLL):
            carry = one_leap(carry)
        return carry

    xf = jnp.asarray(x).astype(f32)
    init = (xf, jnp.asarray(y).astype(f32), jnp.asarray(vx).astype(f32),
            jnp.asarray(vy).astype(f32), jnp.zeros_like(xf))
    result, *_ = jax.lax.while_loop(cond, body, init)
    return result.astype(jnp.int32)


def _hyb_loop(x, y, vx, vy, full_rule: bool, unroll: int = 0):
    """Hybrid landing loop — bit-identical to :func:`_sim_loop`.

    Each while-trip is ONE closed-form jump (absorbs the long quiet spans —
    a smash candidate's launch arc alone is ~30-60 frames) followed by
    ``unroll`` exact frame iterations (absorb event-dense stretches like
    net-top bounce cycles, where jump arithmetic per event would cost more
    than the frames it skips).  Pays the expensive jump once per trip
    instead of once per event, and the cheap frame loop everywhere else.
    """
    _, jump, exact_iteration = _make_leap_step(full_rule)
    f32 = jnp.float32

    def cond(carry):
        return jnp.any(carry[2] != 0.0)

    def body(carry):
        carry = jump(carry)
        for _ in range(unroll or _HYB_UNROLL):
            carry = exact_iteration(carry)
        return carry

    xf = jnp.asarray(x).astype(f32)
    init = (xf, jnp.asarray(y).astype(f32), jnp.asarray(vx).astype(f32),
            jnp.asarray(vy).astype(f32), jnp.zeros_like(xf))
    result, *_ = jax.lax.while_loop(cond, body, init)
    return result.astype(jnp.int32)


def _sim(x, y, vx, vy, full_rule: bool, unroll: int, algo: str):
    if algo == "leap":
        return _leap_loop(x, y, vx, vy, full_rule,
                          unroll=unroll or _LEAP_UNROLL)
    if algo == "hyb":
        return _hyb_loop(x, y, vx, vy, full_rule, unroll=unroll)
    return _sim_loop(x, y, vx, vy, full_rule, unroll=unroll or _UNROLL)


def landing_sims_any(ball_x: jnp.ndarray, ball_y: jnp.ndarray,
                     ball_vx: jnp.ndarray, ball_vy: jnp.ndarray,
                     unroll: int = 0, algo: str | None = None,
                     split: str | None = None, cand_lanes: int = 6
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Shape-generic 7-lane landing simulation.

    Inputs may be scalars or arrays of any shape S; returns
    ``(expected_landing_point_x with shape S, candidates with shape
    (cand_lanes,)+S)``.  ``cand_lanes > 6`` pads the single candidate loop
    with lanes that start at ``vx == 0`` (done on entry, result = start x),
    for the Triton kernel, whose reductions need a power-of-two width.
    Uses only iota-built constants and elementwise ops, so the same function
    runs under jit/vmap AND inside Pallas kernels (which cannot capture array
    constants).

    The true-ball lane and the six power-hit candidate lanes run in SEPARATE
    while loops: the candidates launch at |vx| in {10, 20} and land within a
    few dozen iterations, while the true ball's tail (low |vx| net-band
    bounce cycles) runs ~150-220 iterations per frame at large batch — split
    loops keep the six wide lanes from paying for that tail, cutting the
    dominant while-loop carry traffic ~4x.  Per-lane iteration sequences are
    unchanged (each lane is independent), so results are bit-identical.
    """
    algo = algo if algo is not None else _ALGO
    if algo == "auto":
        algo = "iter"  # lax path default; the Pallas kernel picks its own
    # "A,B" runs the true-ball loop with A and the candidate loops with B.
    algo_true, _, algo_cand = algo.partition(",")
    algo_cand = algo_cand or algo_true
    shape = jnp.shape(ball_x)
    lane_shape = (cand_lanes,) + tuple(1 for _ in shape)
    if shape:
        lane = jax.lax.broadcasted_iota(jnp.int32, lane_shape, 0)
    else:
        # 1-D iota is fine outside pallas; scalars never occur inside it.
        lane = jnp.arange(cand_lanes, dtype=jnp.int32).reshape(lane_shape)
    bx = jnp.asarray(ball_x).astype(jnp.int32)
    by = jnp.asarray(ball_y).astype(jnp.int32)

    # True-ball lane: full net rule, shape S.
    expected = _sim(bx, by,
                    jnp.asarray(ball_vx).astype(jnp.int32),
                    jnp.asarray(ball_vy).astype(jnp.int32),
                    full_rule=True, unroll=unroll, algo=algo_true)

    abs_vy = jnp.abs(jnp.asarray(ball_vy).astype(jnp.int32))
    split = split if split is not None else _SPLIT
    if split == "ydir":
        # The candidate loops are grouped BY LAUNCH y-direction: iteration
        # counts differ ~15x between y_dir = 1 (smash straight down, lands
        # in a few frames) and y_dir = -1 (launch upward, full ceiling arc),
        # and every loop below runs to the max over its lanes — one 6-lane
        # loop makes the four fast lanes pay the slow pair's tax on every
        # trip.  Three 2-lane loops cut that wasted work ~2.3x; per-lane
        # iteration sequences are untouched, so results are bit-identical.
        lane2_shape = (2,) + tuple(1 for _ in shape)
        if shape:
            lane2 = jax.lax.broadcasted_iota(jnp.int32, lane2_shape, 0)
        else:
            lane2 = jnp.arange(2, dtype=jnp.int32).reshape(lane2_shape)
        x2 = jnp.broadcast_to(bx, (2,) + shape)
        y2 = jnp.broadcast_to(by, (2,) + shape)
        # Group lane 0 is |x_dir| = 1 (speed 20), lane 1 is 0 (speed 10)
        # (physics.py:841-845).
        speed2 = 20 - 10 * lane2
        gvx = jnp.where(bx < C.GROUND_HALF_WIDTH, speed2, -speed2)
        groups = []
        for ydir in (-1, 0, 1):
            gvy = jnp.broadcast_to(abs_vy * ydir * 2, (2,) + shape)
            groups.append(_sim(x2, y2, gvx, gvy, full_rule=False,
                               unroll=unroll, algo=algo_cand))
        # Reassemble in canonical lane order k = (|x_dir| ? 0 : 3) +
        # (y_dir + 1): [(1,-1),(1,0),(1,1),(0,-1),(0,0),(0,1)].
        candidates = jnp.concatenate(
            [g[a:a + 1] for a in (0, 1) for g in groups], axis=0)
    else:
        # Single 6-lane candidate loop; lane k has |x_dir| = (k < 3) and
        # y_dir = (k % 3) - 1 (canonical order "A").  Pad lanes k >= 6
        # start with vx == 0, so they never iterate.
        cand_abs_xd = (lane < 3).astype(jnp.int32)
        cand_yd = (lane % 3) - 1
        x = jnp.broadcast_to(bx, (cand_lanes,) + shape)
        y = jnp.broadcast_to(by, (cand_lanes,) + shape)
        # Power-hit candidate initial velocities (physics.py:841-845).
        speed = jnp.where(lane < 6, (cand_abs_xd + 1) * 10, 0)
        cand_vx = jnp.where(bx < C.GROUND_HALF_WIDTH, speed, -speed)
        cand_vy = abs_vy * cand_yd * 2
        candidates = _sim(x, y, cand_vx, cand_vy, full_rule=False,
                          unroll=unroll, algo=algo_cand)

    return expected, candidates


def _landing_sims_impl(ball: BallState) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """7-lane landing simulation for one (scalar) env's ball."""
    return landing_sims_any(ball.x, ball.y, ball.x_velocity, ball.y_velocity)


@jax.custom_batching.custom_vmap
def landing_sims(ball: BallState) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """7-lane landing simulation; the scalar path uses the lax while-loop,
    the vmapped path dispatches to the Pallas (Triton) kernel on a GPU
    (see ``core.predict_pallas``).  Override with
    PIKAZOO_PREDICTOR=lax|pallas."""
    return _landing_sims_impl(ball)


# Resolved dispatch of the most recent batched landing_sims trace — the
# provenance bench.py records, so "which predictor served this number" is
# answerable from the artifact.
_RESOLVED: dict = {"predictor": None, "source": None}


def dispatch_provenance() -> dict:
    """``{"predictor": "pallas"|"lax"|None, "source": "env"|"backend"|None}``
    for the most recent batched trace in this process."""
    return dict(_RESOLVED)


def resolve_predictor(backend: str) -> Tuple[bool, str]:
    """``(use_kernel, source)`` for a batched trace on ``backend``.

    ``auto`` picks the Triton kernel on ``gpu`` and the lax path elsewhere;
    ``PIKAZOO_PREDICTOR=lax|pallas`` forces one.  The kernel runs only
    compiled for the GPU (never interpreted outside tests), and its body is
    the frame loop with one candidate loop, so a forced kernel off the GPU,
    or a ``PIKAZOO_SIM_ALGO`` / ``PIKAZOO_SIM_SPLIT`` it cannot run, raises
    instead of falling back."""
    import os

    impl = os.environ.get("PIKAZOO_PREDICTOR", "auto")
    if impl not in ("auto", "lax", "pallas"):
        raise ValueError(f"PIKAZOO_PREDICTOR={impl!r}: expected auto, lax "
                         "or pallas")
    if impl == "auto":
        use_kernel, source = backend == "gpu", "backend"
    else:
        use_kernel, source = impl == "pallas", "env"
    if not use_kernel:
        return False, source
    if backend != "gpu":
        raise ValueError(f"PIKAZOO_PREDICTOR=pallas needs a GPU backend, "
                         f"not {backend!r}")
    if _ALGO not in ("auto", "iter") or _SPLIT != "none":
        raise ValueError(
            f"the landing kernel runs PIKAZOO_SIM_ALGO=iter with "
            f"PIKAZOO_SIM_SPLIT=none, not {_ALGO!r}/{_SPLIT!r}; set "
            f"PIKAZOO_PREDICTOR=lax to run those on the lax path")
    return True, source


@landing_sims.def_vmap
def _landing_sims_vmap_rule(axis_size, in_batched, ball: BallState):
    del axis_size
    assert all(jax.tree.leaves(in_batched)), \
        "landing_sims expects a fully batched BallState under vmap"
    use_kernel, source = resolve_predictor(jax.default_backend())
    _RESOLVED.update(predictor="pallas" if use_kernel else "lax",
                     source=source)
    if use_kernel:
        from pikazoo_tpu.core.predict_pallas import landing_sims_batched
        expected, candidates = landing_sims_batched(
            ball.x, ball.y, ball.x_velocity, ball.y_velocity)
    else:
        expected, candidates = jax.vmap(_landing_sims_impl)(ball)
    return (expected, candidates), (True, True)
