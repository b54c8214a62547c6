// pika_engine.cc — native host engine for pikazoo_tpu.
//
// A from-scratch C++ implementation of the same per-frame environment step as
// the JAX kernel (see pikazoo_tpu/core/*.py for the authoritative semantics
// and the reference citations).  Used as (1) a high-throughput multicore CPU
// engine and (2) an independent second implementation for fuzz-parity testing
// against the JAX env: both consume identical oracle draw streams, so any
// state divergence is a logic bug in one of them.
//
// Build: g++ -O3 -march=native -shared -fPIC [-fopenmp] pika_engine.cc
// ABI: plain C, batch-major int32 state rows (layout in native/__init__.py).

#include <cstdint>
#include <cstdlib>
#include <initializer_list>

namespace {

constexpr int32_t kGroundWidth = 432;
constexpr int32_t kHalfWidth = 216;
constexpr int32_t kPlayerHalf = 32;
constexpr int32_t kPlayerGroundY = 244;
constexpr int32_t kBallRadius = 20;
constexpr int32_t kBallGroundY = 252;
constexpr int32_t kNetPillarHalf = 25;
constexpr int32_t kNetTopTop = 176;
constexpr int32_t kNetTopBottom = 192;
constexpr int32_t kLoopLimit = 1000;

// State row layout (must match native/__init__.py FIELDS).
enum Field {
  // player 1
  P1_X, P1_Y, P1_VY, P1_STATE, P1_FRAME, P1_ARM, P1_DELAY, P1_DIVE,
  P1_LYING, P1_LATCH, P1_BOLD, P1_STAND, P1_WINNER, P1_GAMEEND,
  // player 2
  P2_X, P2_Y, P2_VY, P2_STATE, P2_FRAME, P2_ARM, P2_DELAY, P2_DIVE,
  P2_LYING, P2_LATCH, P2_BOLD, P2_STAND, P2_WINNER, P2_GAMEEND,
  // ball
  B_X, B_Y, B_VX, B_VY, B_PX, B_PY, B_PPX, B_PPY, B_POWER, B_EXPECTED,
  B_ROT, B_FINEROT, B_PUNCHX, B_PUNCHY, B_PUNCHR,
  // game
  KEY1, KEY2, SCORE1, SCORE2, P2SERVE, ROUND_END, GAME_END, STEPS, DRAWS,
  // threefry2x32 stream key (uint32 bit patterns stored in int32 slots)
  RNG_LO, RNG_HI,
  NFIELDS
};

inline int32_t fdiv(int32_t a, int32_t b) {
  // Python floor division for possibly-negative numerators.
  int32_t q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

inline int32_t iabs(int32_t v) { return v < 0 ? -v : v; }

inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds — bit-identical to pikazoo_tpu.core.rng (and to
// jax's threefry2x32); returns the first output word.
inline uint32_t threefry2x32_first(uint32_t k0, uint32_t k1, uint32_t c0,
                                   uint32_t c1) {
  static const int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  for (int block = 0; block < 5; ++block) {
    const int* rot = kRot[block % 2];
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rot[i]);
      x1 ^= x0;
    }
    int inject = block + 1;
    x0 += ks[inject % 3];
    x1 += ks[(inject + 1) % 3] + (uint32_t)inject;
  }
  return x0;
}

constexpr uint32_t kSiteTag = 1;

struct Draws {
  // Oracle mode when cap > 0; otherwise production threefry draws keyed by
  // the state's RNG_LO/RNG_HI and the running counter.
  const int32_t* oracle;
  int32_t cap;
  int32_t* counter;
  uint32_t key_lo, key_hi;
  int32_t next(int32_t upper) {
    int32_t c = (*counter)++;
    if (cap > 0) {
      int32_t idx = c;
      if (idx >= cap) idx = cap - 1;
      return oracle[idx];
    }
    uint32_t bits = threefry2x32_first(key_lo, key_hi, (uint32_t)c, kSiteTag);
    return (int32_t)(bits % (uint32_t)upper);
  }
};

struct Input {
  int32_t xd, yd, power;
};

// Action decode tables (same 18x5 key map as envs; see core/input.py).
constexpr int32_t kActXd[18] = {0, 0, 0, 1, -1, 0, 1, -1, 1,
                                -1, 0, 1, -1, 0, 1, -1, 1, -1};
constexpr int32_t kActYd[18] = {0, 0, -1, 0, 0, 1, -1, -1, 1,
                                1, -1, 0, 0, 1, -1, -1, 1, 1};
constexpr int32_t kActPw[18] = {0, 1, 0, 0, 0, 0, 0, 0, 0,
                                0, 1, 1, 1, 1, 1, 1, 1, 1};

// Landing predictor (full two-branch net rule, strict y<192 top band).
int32_t expected_landing(int32_t x, int32_t y, int32_t vx, int32_t vy) {
  for (int32_t i = 1;; ++i) {
    int32_t fx = x + vx;
    if (fx < kBallRadius || fx > kGroundWidth) vx = -vx;
    if (y + vy < 0) vy = 1;
    if (iabs(x - kHalfWidth) < kNetPillarHalf && y > kNetTopTop) {
      if (y < kNetTopBottom) {
        if (vy > 0) vy = -vy;
      } else {
        vx = (x < kHalfWidth) ? -iabs(vx) : iabs(vx);
      }
    }
    y += vy;
    if (y > kBallGroundY || i >= kLoopLimit) return x;
    x += vx;
    ++vy;
  }
}

// Power-hit landing sim (mistake net rule: vy flip only).
int32_t power_hit_landing(int32_t x, int32_t y, int32_t vx0, int32_t vy0,
                          int32_t cand_xd, int32_t cand_yd) {
  int32_t vx = (x < kHalfWidth) ? (iabs(cand_xd) + 1) * 10
                                : -(iabs(cand_xd) + 1) * 10;
  int32_t vy = iabs(vy0) * cand_yd * 2;
  (void)vx0;
  for (int32_t i = 1;; ++i) {
    int32_t fx = x + vx;
    if (fx < kBallRadius || fx > kGroundWidth) vx = -vx;
    if (y + vy < 0) vy = 1;
    if (iabs(x - kHalfWidth) < kNetPillarHalf && y > kNetTopTop) {
      if (vy > 0) vy = -vy;
    }
    y += vy;
    if (y > kBallGroundY || i >= kLoopLimit) return x;
    x += vx;
    ++vy;
  }
}

void computer_ai(int32_t* s, bool is_p2, Input* inp, Draws* draws) {
  const int off = is_p2 ? P2_X - P1_X : 0;
  const int other = is_p2 ? 0 : P2_X - P1_X;
  int32_t px = s[P1_X + off], py = s[P1_Y + off];
  int32_t bold = s[P1_BOLD + off];
  int32_t bx = s[B_X], by = s[B_Y], bvx = s[B_VX], bvy = s[B_VY];
  int32_t expected = s[B_EXPECTED];
  int32_t lb = is_p2 ? kHalfWidth : 0;
  int32_t rb = lb + kHalfWidth;
  int32_t far_side = (is_p2 ? kGroundWidth : 0) + kHalfWidth;

  inp->xd = 0; inp->yd = 0; inp->power = 0;

  int32_t virt = expected;
  if (iabs(bx - px) > 100 && iabs(bvx) < bold + 5) {
    if ((expected <= lb || expected >= far_side) && s[P1_STAND + off] == 0)
      virt = lb + kHalfWidth / 2;
  }
  if (iabs(virt - px) > bold + 8) {
    inp->xd = (px < virt) ? 1 : -1;
  } else if (draws->next(20) == 0) {
    s[P1_STAND + off] = draws->next(2);
  }

  int32_t state = s[P1_STATE + off];
  if (state == 0) {
    if (iabs(bvx) < bold + 3 && iabs(bx - px) < kPlayerHalf && by > -36 &&
        by < 10 * bold + 84 && bvy > 0)
      inp->yd = -1;
    if (expected > lb && expected < rb &&
        iabs(bx - px) > bold * 5 + 2 * kPlayerHalf && bx > lb && bx < rb &&
        by > 174) {
      inp->power = 1;
      inp->xd = (px < bx) ? 1 : -1;
    }
  } else if (state == 1 || state == 2) {
    if (iabs(bx - px) > 8) inp->xd = (px < bx) ? 1 : -1;
    if (iabs(bx - px) < 48 && iabs(by - py) < 48) {
      int32_t coin = draws->next(2);
      // Enumerate candidates in coin-selected order; accept the first whose
      // simulated landing is on the opponent side and away from them.
      static const int32_t xs[2] = {1, 0};
      static const int32_t ysA[3] = {-1, 0, 1};
      static const int32_t ysB[3] = {1, 0, -1};
      const int32_t* ys = (coin == 0) ? ysA : ysB;
      int32_t ox = s[P1_X + other];
      for (int xi = 0; xi < 2 && !inp->power; ++xi) {
        for (int yi = 0; yi < 3; ++yi) {
          int32_t land = power_hit_landing(bx, by, bvx, bvy, xs[xi], ys[yi]);
          if ((land <= lb || land >= far_side) &&
              iabs(land - ox) > 2 * kPlayerHalf) {
            inp->xd = xs[xi];
            inp->yd = ys[yi];
            inp->power = 1;
            if (iabs(ox - px) < 80 && inp->yd != -1) inp->yd = -1;
            break;
          }
        }
      }
    }
  }
}

void move_player(int32_t* s, bool is_p2, const Input& inp) {
  const int off = is_p2 ? P2_X - P1_X : 0;
  if (s[P1_STATE + off] == 4) {
    if (--s[P1_LYING + off] < -1) s[P1_STATE + off] = 0;
    return;
  }
  int32_t vx = 0;
  if (s[P1_STATE + off] < 5)
    vx = (s[P1_STATE + off] < 3) ? inp.xd * 6 : s[P1_DIVE + off] * 8;
  int32_t fx = s[P1_X + off] + vx;
  int32_t lo = is_p2 ? kHalfWidth + kPlayerHalf : kPlayerHalf;
  int32_t hi = is_p2 ? kGroundWidth - kPlayerHalf : kHalfWidth - kPlayerHalf;
  s[P1_X + off] = fx < lo ? lo : (fx > hi ? hi : fx);

  if (s[P1_STATE + off] < 3 && inp.yd == -1 &&
      s[P1_Y + off] == kPlayerGroundY) {
    s[P1_VY + off] = -16;
    s[P1_STATE + off] = 1;
    s[P1_FRAME + off] = 0;
  }
  int32_t fy = s[P1_Y + off] + s[P1_VY + off];
  s[P1_Y + off] = fy;
  if (fy < kPlayerGroundY) {
    ++s[P1_VY + off];
  } else if (fy > kPlayerGroundY) {
    s[P1_VY + off] = 0;
    s[P1_Y + off] = kPlayerGroundY;
    s[P1_FRAME + off] = 0;
    if (s[P1_STATE + off] == 3) {
      s[P1_STATE + off] = 4;
      s[P1_LYING + off] = 3;
    } else {
      s[P1_STATE + off] = 0;
    }
  }
  if (inp.power == 1) {
    if (s[P1_STATE + off] == 1) {
      s[P1_DELAY + off] = 5;
      s[P1_FRAME + off] = 0;
      s[P1_STATE + off] = 2;
    } else if (s[P1_STATE + off] == 0 && inp.xd != 0) {
      s[P1_STATE + off] = 3;
      s[P1_FRAME + off] = 0;
      s[P1_DIVE + off] = inp.xd;
      s[P1_VY + off] = -5;
    }
  }
  switch (s[P1_STATE + off]) {
    case 1:
      s[P1_FRAME + off] = (s[P1_FRAME + off] + 1) % 3;
      break;
    case 2:
      if (s[P1_DELAY + off] < 1) {
        if (++s[P1_FRAME + off] > 4) {
          s[P1_FRAME + off] = 0;
          s[P1_STATE + off] = 1;
        }
      } else {
        --s[P1_DELAY + off];
      }
      break;
    case 0:
      if (++s[P1_DELAY + off] > 3) {
        s[P1_DELAY + off] = 0;
        int32_t future = s[P1_FRAME + off] + s[P1_ARM + off];
        if (future < 0 || future > 4) s[P1_ARM + off] = -s[P1_ARM + off];
        s[P1_FRAME + off] += s[P1_ARM + off];
      }
      break;
    default:
      break;
  }
  if (s[P1_GAMEEND + off]) {
    if (s[P1_STATE + off] == 0) {
      s[P1_STATE + off] = s[P1_WINNER + off] ? 5 : 6;
      s[P1_DELAY + off] = 0;
      s[P1_FRAME + off] = 0;
    }
    if (s[P1_FRAME + off] < 4 && ++s[P1_DELAY + off] > 4) {
      s[P1_DELAY + off] = 0;
      ++s[P1_FRAME + off];
    }
  }
}

// Returns touched_ground.
bool ball_world(int32_t* s) {
  s[B_PPX] = s[B_PX];
  s[B_PPY] = s[B_PY];
  s[B_PX] = s[B_X];
  s[B_PY] = s[B_Y];

  int32_t fr = s[B_FINEROT] + fdiv(s[B_VX], 2);
  if (fr < 0) fr += 50; else if (fr > 50) fr -= 50;
  s[B_FINEROT] = fr;
  s[B_ROT] = fr / 10;

  int32_t fx = s[B_X] + s[B_VX];
  if (fx < kBallRadius || fx > kGroundWidth) s[B_VX] = -s[B_VX];
  if (s[B_Y] + s[B_VY] < 0) s[B_VY] = 1;
  if (iabs(s[B_X] - kHalfWidth) < kNetPillarHalf && s[B_Y] > kNetTopTop) {
    if (s[B_Y] <= kNetTopBottom) {
      if (s[B_VY] > 0) s[B_VY] = -s[B_VY];
    } else {
      s[B_VX] = (s[B_X] < kHalfWidth) ? -iabs(s[B_VX]) : iabs(s[B_VX]);
    }
  }
  int32_t fy = s[B_Y] + s[B_VY];
  if (fy > kBallGroundY) {
    s[B_VY] = -s[B_VY];
    s[B_PUNCHX] = s[B_X];
    s[B_Y] = kBallGroundY;
    s[B_PUNCHR] = kBallRadius;
    s[B_PUNCHY] = kBallGroundY + kBallRadius;
    return true;
  }
  s[B_Y] = fy;
  s[B_X] += s[B_VX];
  ++s[B_VY];
  return false;
}

void collide(int32_t* s, bool is_p2, const Input& inp, Draws* draws) {
  const int off = is_p2 ? P2_X - P1_X : 0;
  int32_t px = s[P1_X + off];
  int32_t diff = s[B_X] - px;
  if (diff < 0) s[B_VX] = -(iabs(diff) / 3);
  else if (diff > 0) s[B_VX] = iabs(diff) / 3;
  if (s[B_VX] == 0) s[B_VX] = draws->next(3) - 1;
  int32_t avy = iabs(s[B_VY]);
  s[B_VY] = (avy < 15) ? -15 : -avy;
  if (s[P1_STATE + off] == 2) {
    s[B_VX] = (s[B_X] < kHalfWidth) ? (iabs(inp.xd) + 1) * 10
                                    : -(iabs(inp.xd) + 1) * 10;
    s[B_PUNCHX] = s[B_X];
    s[B_PUNCHY] = s[B_Y];
    s[B_VY] = iabs(s[B_VY]) * inp.yd * 2;
    s[B_PUNCHR] = kBallRadius;
    s[B_POWER] = 1;
  } else {
    s[B_POWER] = 0;
  }
}

void round_init(int32_t* s, Draws* draws, int serve_mode) {
  // Boldness draws p1 then p2, then the serve decision.
  for (int off : {0, P2_X - P1_X}) {
    s[P1_X + off] = off ? kGroundWidth - 36 : 36;
    s[P1_Y + off] = kPlayerGroundY;
    s[P1_VY + off] = 0;
    s[P1_LATCH + off] = 0;
    s[P1_STATE + off] = 0;
    s[P1_FRAME + off] = 0;
    s[P1_ARM + off] = 1;
    s[P1_DELAY + off] = 0;
    s[P1_BOLD + off] = draws->next(5);
  }
  bool p2_serve;
  if (serve_mode == 0) p2_serve = s[P2SERVE] != 0;           // winner
  else if (serve_mode == 1)
    p2_serve = ((s[SCORE1] + s[SCORE2]) % 2) == 1;            // alternate
  else p2_serve = draws->next(2) == 0;                         // random
  s[B_X] = p2_serve ? kGroundWidth - 56 : 56;
  s[B_Y] = 0;
  s[B_VX] = 0;
  s[B_VY] = 1;
  s[B_PUNCHR] = 0;
  s[B_POWER] = 0;
}

void step_one(int32_t* s, const int32_t* actions, const int32_t* oracle,
              int32_t* rewards, uint8_t* flags, int winning_score,
              int serve_mode, bool p1_cpu, bool p2_cpu, bool auto_reset,
              int oracle_cap) {
  Draws draws{oracle, oracle_cap, &s[DRAWS],
              (uint32_t)s[RNG_LO], (uint32_t)s[RNG_HI]};

  bool game_reset = auto_reset && s[GAME_END];
  if (game_reset) {
    s[SCORE1] = s[SCORE2] = 0;
    s[P2SERVE] = 0;
    s[GAME_END] = 0;
    s[P1_WINNER] = s[P2_WINNER] = 0;
    s[P1_GAMEEND] = s[P2_GAMEEND] = 0;
  }
  // Reward guard for out-of-contract steps (mirrors env_frame's
  // game_ended_at_entry mask): with auto_reset off, a terminated state
  // keeps ROUND_END=1, so without this every further step would re-emit
  // the terminal +-1.  The scoring frame itself has GAME_END==0 here.
  bool game_ended_at_entry = s[GAME_END] != 0;
  if ((s[ROUND_END] && !s[GAME_END]) || game_reset) {
    round_init(s, &draws, serve_mode);
    s[ROUND_END] = 0;
  }

  // Edge-detected inputs from raw actions; AI overwrites below.
  Input inputs[2];
  for (int i = 0; i < 2; ++i) {
    int32_t a = actions[i];
    if (a < 0) a = 0; else if (a > 17) a = 17;  // gather-clamp semantics
    int32_t latch = s[KEY1 + i];
    inputs[i].xd = kActXd[a];
    inputs[i].yd = kActYd[a];
    inputs[i].power = (!latch && kActPw[a]) ? 1 : 0;
    s[KEY1 + i] = kActPw[a];
  }

  bool touched = ball_world(s);
  if (p1_cpu || p2_cpu) s[B_EXPECTED] = expected_landing(s[B_X], s[B_Y], s[B_VX], s[B_VY]);
  if (p1_cpu) computer_ai(s, false, &inputs[0], &draws);
  move_player(s, false, inputs[0]);
  if (p2_cpu) computer_ai(s, true, &inputs[1], &draws);
  move_player(s, true, inputs[1]);

  for (int i = 0; i < 2; ++i) {
    const int off = i ? P2_X - P1_X : 0;
    bool overlap = iabs(s[B_X] - s[P1_X + off]) <= kPlayerHalf &&
                   iabs(s[B_Y] - s[P1_Y + off]) <= kPlayerHalf;
    if (overlap && !s[P1_LATCH + off]) collide(s, i, inputs[i], &draws);
    s[P1_LATCH + off] = overlap ? 1 : 0;
  }

  if (touched && !s[ROUND_END] && !s[GAME_END]) {
    bool p2_scored = s[B_PUNCHX] < kHalfWidth;
    if (p2_scored) {
      s[P2SERVE] = 1;
      if (++s[SCORE2] >= winning_score) {
        s[GAME_END] = 1;
        s[P2_WINNER] = 1;
        s[P1_WINNER] = 0;
        s[P1_GAMEEND] = s[P2_GAMEEND] = 1;
      }
    } else {
      s[P2SERVE] = 0;
      if (++s[SCORE1] >= winning_score) {
        s[GAME_END] = 1;
        s[P1_WINNER] = 1;
        s[P2_WINNER] = 0;
        s[P1_GAMEEND] = s[P2_GAMEEND] = 1;
      }
    }
    s[ROUND_END] = 1;
  }
  int32_t r1 = (s[ROUND_END] && !game_ended_at_entry)
                   ? (s[P2SERVE] ? -1 : 1) : 0;
  rewards[0] = r1;
  rewards[1] = -r1;
  flags[0] = (s[GAME_END] ? 1 : 0) | (s[ROUND_END] ? 2 : 0) |
             (touched ? 4 : 0);
  ++s[STEPS];
}

// Mirrored 35-dim observation assembly — same layout as
// pikazoo_tpu/envs/observations.py (reference pikazoo_env.py:481-565):
// per player (13): x, y, vy, diving_direction, lying, frame, delay,
// one_hot(state, 5), power_hit_key_down_prev; ball (9): x, y, prev_x,
// prev_y, prev_prev_x, prev_prev_y, vx, vy, is_power_hit.
inline int32_t* write_player_obs(const int32_t* s, bool is_p2, int32_t* o) {
  const int off = is_p2 ? P2_X - P1_X : 0;
  *o++ = s[P1_X + off];
  *o++ = s[P1_Y + off];
  *o++ = s[P1_VY + off];
  *o++ = s[P1_DIVE + off];
  *o++ = s[P1_LYING + off];
  *o++ = s[P1_FRAME + off];
  *o++ = s[P1_DELAY + off];
  int32_t st = s[P1_STATE + off];
  for (int k = 0; k < 5; ++k) *o++ = (st == k) ? 1 : 0;
  *o++ = s[is_p2 ? KEY2 : KEY1];
  return o;
}

inline int32_t* write_ball_obs(const int32_t* s, int32_t* o) {
  *o++ = s[B_X];
  *o++ = s[B_Y];
  *o++ = s[B_PX];
  *o++ = s[B_PY];
  *o++ = s[B_PPX];
  *o++ = s[B_PPY];
  *o++ = s[B_VX];
  *o++ = s[B_VY];
  *o++ = s[B_POWER];
  return o;
}

}  // namespace

extern "C" {

int pika_nfields() { return NFIELDS; }

void pika_obs_batch(const int32_t* state, int32_t* obs, int batch) {
  // obs laid out [batch][2][35]: row 0 = player 1's view, row 1 mirrored.
#pragma omp parallel for schedule(static)
  for (int b = 0; b < batch; ++b) {
    const int32_t* s = state + (size_t)b * NFIELDS;
    int32_t* o = obs + (size_t)b * 70;
    o = write_ball_obs(s, write_player_obs(s, true,
                                           write_player_obs(s, false, o)));
    write_ball_obs(s, write_player_obs(s, false,
                                       write_player_obs(s, true, o)));
  }
}

void pika_step_obs_batch(int32_t* state, const int32_t* actions,
                         const int32_t* oracle, int32_t* rewards,
                         uint8_t* flags, int32_t* obs, int batch,
                         int winning_score, int serve_mode,
                         int is_p1_computer, int is_p2_computer,
                         int auto_reset, int oracle_cap) {
  // step + mirrored obs in one foreign call — the interactive (batch=1)
  // serving path, where per-call overhead dominates the physics.
#pragma omp parallel for schedule(static)
  for (int b = 0; b < batch; ++b) {
    int32_t* s = state + (size_t)b * NFIELDS;
    step_one(s, actions + (size_t)b * 2, oracle + (size_t)b * oracle_cap,
             rewards + (size_t)b * 2, flags + b, winning_score, serve_mode,
             is_p1_computer != 0, is_p2_computer != 0, auto_reset != 0,
             oracle_cap);
    int32_t* o = obs + (size_t)b * 70;
    o = write_ball_obs(s, write_player_obs(s, true,
                                           write_player_obs(s, false, o)));
    write_ball_obs(s, write_player_obs(s, false,
                                       write_player_obs(s, true, o)));
  }
}

void pika_reset_batch(int32_t* state, const int32_t* oracle, int batch,
                      int serve_mode, int oracle_cap) {
  // New-game reset, mirroring the JAX env's reset-with-carry
  // (envs/pika_volley.py; reference pikazoo_env.py:149-173): zero scores and
  // flags, clear winner/game-ended, then round_init (boldness draws p1, p2,
  // then the serve draw for serve=random).  The caller sets DRAWS/RNG_LO/
  // RNG_HI beforehand; everything not touched here leaks across the reset
  // exactly like the reference's partially-reset objects.
#pragma omp parallel for schedule(static)
  for (int b = 0; b < batch; ++b) {
    int32_t* s = state + (size_t)b * NFIELDS;
    Draws draws{oracle + (size_t)b * oracle_cap, oracle_cap, &s[DRAWS],
                (uint32_t)s[RNG_LO], (uint32_t)s[RNG_HI]};
    s[SCORE1] = s[SCORE2] = 0;
    s[P2SERVE] = 0;
    s[GAME_END] = 0;
    s[ROUND_END] = 0;
    s[STEPS] = 0;
    s[P1_WINNER] = s[P2_WINNER] = 0;
    s[P1_GAMEEND] = s[P2_GAMEEND] = 0;
    round_init(s, &draws, serve_mode);
  }
}

void pika_step_batch(int32_t* state, const int32_t* actions,
                     const int32_t* oracle, int32_t* rewards, uint8_t* flags,
                     int batch, int winning_score, int serve_mode,
                     int is_p1_computer, int is_p2_computer, int auto_reset,
                     int oracle_cap) {
#pragma omp parallel for schedule(static)
  for (int b = 0; b < batch; ++b) {
    step_one(state + (size_t)b * NFIELDS, actions + (size_t)b * 2,
             oracle + (size_t)b * oracle_cap, rewards + (size_t)b * 2,
             flags + b, winning_score, serve_mode, is_p1_computer != 0,
             is_p2_computer != 0, auto_reset != 0, oracle_cap);
  }
}

void pika_run_batch(int32_t* state, const int32_t* actions,
                    const int32_t* oracle, int32_t* rewards, uint8_t* flags,
                    int batch, int frames, int winning_score, int serve_mode,
                    int is_p1_computer, int is_p2_computer, int auto_reset,
                    int oracle_cap) {
  // Multi-frame variant: actions laid out [frames][batch][2]; rewards/flags
  // report the LAST frame only (throughput/bench path).
#pragma omp parallel for schedule(static)
  for (int b = 0; b < batch; ++b) {
    for (int t = 0; t < frames; ++t) {
      step_one(state + (size_t)b * NFIELDS,
               actions + ((size_t)t * batch + b) * 2,
               oracle + (size_t)b * oracle_cap, rewards + (size_t)b * 2,
               flags + b, winning_score, serve_mode, is_p1_computer != 0,
               is_p2_computer != 0, auto_reset != 0, oracle_cap);
    }
  }
}

}  // extern "C"
