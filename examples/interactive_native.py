"""Interactive single-match serving from the native C++ engine.

Two ways to run a single match at host speed (an accelerator round trip per
frame is pure dispatch latency, so batch=1 belongs on the host):

1. the PettingZoo dict API, drop-in for the reference (``backend="native"``)
2. the raw ``SingleStepper`` for the tightest dict-free loop

(With the C fast path built, the dict API itself runs the whole step in one
native call — see ``pikazoo_tpu/native/fastpath.c``.)

Usage: python examples/interactive_native.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")  # host-side serving, no device

import numpy as np  # noqa: E402

from pikazoo_tpu import compat  # noqa: E402
from pikazoo_tpu.envs import EnvConfig, PikaZoo  # noqa: E402
from pikazoo_tpu.native import NativeEngine  # noqa: E402


def pettingzoo_match(seed: int = 7) -> None:
    env = compat.env(seed=seed, backend="native",
                     is_player2_computer=True)  # you vs the rule AI
    obs, infos = env.reset()
    rng = np.random.default_rng(seed)
    frames = 0
    while env.agents:
        # (a real client would read keys; random actions here)
        actions = {a: int(rng.integers(0, 18)) for a in env.agents}
        obs, rewards, terms, truncs, infos = env.step(actions)
        frames += 1
    print(f"PettingZoo native match: {frames} frames, "
          f"final score {env.scores}")


def raw_stepper_match(seed: int = 7) -> None:
    env = PikaZoo(EnvConfig(auto_reset=False, is_player2_computer=True))
    state, _ = env.reset(jax.random.key(seed))
    eng = NativeEngine(is_player2_computer=True, auto_reset=False)
    stepper = eng.single_stepper(NativeEngine.pack(state))
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    frames = 0
    while True:
        obs, rewards, flags = stepper.step_obs(int(rng.integers(0, 18)), 0)
        frames += 1
        if flags & 1:  # terminated
            break
    dt = time.perf_counter() - t0
    print(f"raw stepper match: {frames} frames in {dt * 1e3:.1f} ms "
          f"({frames / dt:,.0f} steps/s incl. obs)")


if __name__ == "__main__":
    pettingzoo_match()
    raw_stepper_match()
