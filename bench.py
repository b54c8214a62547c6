#!/usr/bin/env python
"""Benchmark: aggregate env-steps/s of the batched self-play env on a GPU.

Default run measures BASELINE config 4 (vectorized self-play with auto-reset,
random 18-way actions, single card) and prints ONE JSON line
``{"metric", "value", "unit", "vs_baseline"[, "provenance"], <device>}``
where ``vs_baseline`` divides by the reference implementation's SAME-RUN
measured single-env CPU throughput (re-measured at start; the recorded
round-1 values are only the no-reference fallback — see BASELINE.md),
values are the BEST of the rung's timed windows (min-of-N), ``provenance``
records which engine/predictor served (configs 1/2/5), and the device
fields (``platform``, ``device_kind``, ``device_count``, ``card``,
``power_limit``) say where the number was taken.  Device rungs fail
without a GPU; config 1 (batch=1) is a host-engine rung and says so.

Run-safety contract (``python bench.py`` may run under a hard timeout):

* TOTAL wall time is bounded by ``PIKAZOO_BENCH_BUDGET_S`` (default 440 s).
  Every subprocess timeout is clamped to the remaining budget.
* Rungs run SMALL FIRST: a cheap rung locks in a valid measurement before any
  big compile is attempted.
* The best-so-far result is printed to stdout (flushed) the moment it exists
  and re-printed on SIGTERM/SIGINT.
* Measurements run in subprocesses, one at a time, so the card has one
  process; the orchestrating parent never imports JAX.  A run in which no
  rung lands exits non-zero.

Flags: ``--all`` (all five BASELINE configs, one JSON line each),
``--computer`` (rule-AI path), ``--ppo`` (full actor-learner train step),
``--config NAME`` with ``--batch/--steps/--iters`` (single direct run).
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Reference-env denominators for vs_baseline.  The recorded values are the
# round-1 measurements on this host, but the host CPU's effective speed
# drifts day to day (observed 53k -> 76k steps/s for the same loop), so
# every bench run RE-MEASURES the reference when /root/reference is present
# (refresh_baselines) and falls back to the recorded values otherwise.
# Subprocess rungs inherit the parent's fresh measurement via env vars.
BASELINES = {
    "human": float(os.environ.get("PIKAZOO_BASELINE_HUMAN", 53_237.0)),
    "ai": float(os.environ.get("PIKAZOO_BASELINE_AI", 19_742.0)),
}
REFERENCE_CPU_STEPS_PER_S = BASELINES["human"]
REFERENCE_CPU_STEPS_PER_S_AI = BASELINES["ai"]
_REFERENCE_PATH = os.environ.get("PIKAZOO_REFERENCE_PATH", "/root/reference")


def refresh_baselines(seconds: float = 3.0) -> dict:
    """Measure the reference env's per-step CPU rate on THIS host, now.

    Runs the reference ``raw_env.step`` loop for ``seconds`` per seat mode
    (human random actions / both-computer AI).  No-op when the reference
    repo is absent.  Results land in ``BASELINES`` and the PIKAZOO_BASELINE_*
    env vars so orchestrated subprocess rungs compute vs_baseline against
    the same fresh denominators."""
    if not os.path.isdir(os.path.join(_REFERENCE_PATH, "pikazoo")):
        print("bench: reference repo absent — vs_baseline uses the RECORDED "
              "round-1 denominators", file=sys.stderr, flush=True)
        return BASELINES
    if _REFERENCE_PATH not in sys.path:
        sys.path.insert(0, _REFERENCE_PATH)
    try:
        import numpy as _np
        from pikazoo import pikazoo_v0
    except Exception as e:
        print(f"bench: reference import failed ({e!r}) — vs_baseline uses "
              "the RECORDED round-1 denominators", file=sys.stderr,
              flush=True)
        return BASELINES

    def _rate(**kwargs):
        # Best of 3 windows: this host's effective CPU speed wobbles +-20%
        # between seconds-apart windows, and the numerators are themselves
        # best-effort measurements — both sides get their best window.
        env = pikazoo_v0.env(**kwargs)
        env.reset()
        rng = _np.random.default_rng(0)
        acts = rng.integers(0, 18, size=(4096, 2))
        best = 0.0
        for _ in range(3):
            n = 0
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds / 3:
                a = {"player_1": int(acts[n % 4096, 0]),
                     "player_2": int(acts[n % 4096, 1])}
                env.step(a)
                n += 1
                if not env.agents:
                    env.reset()
            best = max(best, n / (time.perf_counter() - t0))
        return best

    try:
        # Measure both BEFORE assigning: a failure mid-way must not leave a
        # fresh human denominator paired with a stale AI one.
        human = _rate()
        ai = _rate(is_player1_computer=True, is_player2_computer=True)
    except Exception as e:
        print(f"bench: reference measurement failed ({e!r}) — vs_baseline "
              "uses the RECORDED round-1 denominators", file=sys.stderr,
              flush=True)
        return BASELINES
    BASELINES["human"] = human
    BASELINES["ai"] = ai
    os.environ["PIKAZOO_BASELINE_HUMAN"] = repr(human)
    os.environ["PIKAZOO_BASELINE_AI"] = repr(ai)
    return BASELINES

_T0 = time.monotonic()
_BUDGET_S = float(os.environ.get("PIKAZOO_BENCH_BUDGET_S", "440"))
_DEADLINE = _T0 + _BUDGET_S
_EXIT_RESERVE_S = 10.0  # always keep this much to emit results and exit

HEADLINE_METRIC = "env_steps_per_s_aggregate_1chip"

# Orchestrated rungs for the default (config 4) run, small first.
_DEFAULT_RUNGS = [
    dict(config="batch", batch=16_384, steps=200, iters=2),
    dict(config="batch", batch=262_144, steps=1000, iters=6),
]
if os.environ.get("PIKAZOO_BENCH_SMALL") == "1":  # smoke-test sizes
    _DEFAULT_RUNGS = [dict(r, batch=min(r["batch"], 1024),
                           steps=min(r["steps"], 50)) for r in _DEFAULT_RUNGS]


def _remaining() -> float:
    return _DEADLINE - time.monotonic()


def _emit(result: dict) -> None:
    print(json.dumps(result), flush=True)


def _mk(metric: str, steps_per_s: float, baseline: float,
        provenance: dict | None = None) -> dict:
    result = {
        "metric": metric,
        "value": round(steps_per_s),
        "unit": "env-steps/s",
        "vs_baseline": round(steps_per_s / baseline, 2),
    }
    if provenance is not None:
        # Which engine/predictor actually served this number.
        result["provenance"] = provenance
    return result


# --------------------------------------------------------------------------
# Direct (in-process) measurements — one per BASELINE config.
# --------------------------------------------------------------------------

def _device_rung() -> None:
    """Start of every device rung: the shared compile cache, and a GPU or
    nothing (a device number is never taken on the CPU)."""
    from pikazoo_tpu.utils.device import enable_compile_cache, require_gpu

    enable_compile_cache()
    require_gpu()


def _time_calls(fn, state, iters: int, block: bool = True) -> float:
    """Time ``iters`` sequential calls of a jitted ``state -> state`` step
    after one untimed compile call; returns ``iters * min(per-call time)``
    so callers' ``work * iters / dt`` math reports the BEST window.
    ``block=False`` for host-native (non-JAX) callables."""
    import jax

    state = fn(state)  # compile, not timed
    if block:
        jax.block_until_ready(state)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        state = fn(state)
        if block:
            jax.block_until_ready(state)
        best = min(best, time.perf_counter() - t0)
    return best * iters


def measure_env(batch: int, steps: int, iters: int, computer: bool):
    """Config 4 (and config 2 with ``computer``): scanned batched rollout.
    Returns ``(steps_per_s, provenance)``; for config 2 the provenance is
    the resolved landing-predictor dispatch (pallas/lax)."""
    _device_rung()
    import jax
    import jax.numpy as jnp

    from pikazoo_tpu.envs import EnvConfig, PikaZoo

    env = PikaZoo(EnvConfig(auto_reset=True,
                            is_player1_computer=computer,
                            is_player2_computer=computer))
    state, _ = env.reset_batch(jax.random.key(0), batch)
    # Unrolling the frame scan lets XLA fuse `unroll` consecutive frames
    # instead of round-tripping the ~50-leaf int32 carry through device
    # memory every frame.
    unroll = int(os.environ.get("PIKAZOO_SCAN_UNROLL", "4"))

    def body(carry, _):
        st, key = carry
        key, sub = jax.random.split(key)
        acts = jax.random.randint(sub, (batch, 2), 0, 18, jnp.int32)
        st, _ts = env.step_batch(st, acts)
        return (st, key), None

    @jax.jit
    def rollout(carry):
        return jax.lax.scan(body, carry, None, length=steps, unroll=unroll)[0]

    dt = _time_calls(rollout, (state, jax.random.key(1)), iters)
    prov = None
    if computer:
        from pikazoo_tpu.core.predict import dispatch_provenance
        prov = dispatch_provenance()
    return batch * steps * iters / dt, prov


def measure_batch1(steps: int, iters: int) -> float:
    """Config 1: single env (batch=1), defaults, human agents, PER-STEP loop.

    Measures the PettingZoo DICT API of ``compat.raw_env(backend="native")``
    — the exact drop-in surface the reference benchmark exercises (dict
    actions in, per-agent obs/reward/termination dicts out, every frame), so
    vs_baseline is apples-to-apples.  Batch=1 is latency-bound, not
    throughput-bound, so the adapter serves it from the native C++ host
    engine's SingleStepper (bit-identical to the JAX env — fuzz-parity in
    test_native_engine.py); the GPU is the engine for the batched axes
    (configs 2-5).  This is a HOST rung: its provenance names the host
    engine.  PIKAZOO_BATCH1_ENGINE: ``native`` (default; dict API),
    ``stepper`` (raw SingleStepper loop), ``xla-cpu`` (scanned host XLA),
    ``device`` (scanned on the GPU, one dispatch per frame).
    """
    sel = os.environ.get("PIKAZOO_BATCH1_ENGINE", "native")
    if sel == "native":
        import numpy as np

        import jax

        jax.config.update("jax_platforms", "cpu")

        from pikazoo_tpu.compat import parallel_env
        from pikazoo_tpu.native import engine as native_engine

        # The C dict-API fast path is the measured surface (~3.3x the
        # same-run reference); the pure-Python assembly fallback lands in
        # the ~1.7-2x band.  Round 4 benched the fallback WITHOUT saying so
        # (a silent try/except in the adapter) and the 26% regression was
        # unattributable from the artifact.  Now: retry the build once,
        # then FAIL LOUDLY unless the fallback is explicitly allowed — and
        # either way the serving engine + any build error ride the JSON.
        if not native_engine.fastpath_available():
            native_engine.retry_build()
        fast_ok = native_engine.fastpath_available()
        if not fast_ok and \
                os.environ.get("PIKAZOO_BATCH1_ALLOW_FALLBACK") != "1":
            raise RuntimeError(
                "batch1 C fast path failed to build (would silently bench "
                f"the ~1.7-2x Python-assembly fallback): "
                f"{native_engine.build_errors()}; set "
                "PIKAZOO_BATCH1_ALLOW_FALLBACK=1 to bench it anyway")
        env = parallel_env.env(backend="native", seed=0)
        served_fast = getattr(env, "_fast", None) is not None
        prov = {"engine": "fastpath-c" if served_fast else "python-assembly",
                "host_path": True}
        if not served_fast:
            prov["build_errors"] = native_engine.build_errors()
        env.reset()
        acts = np.random.default_rng(0).integers(0, 18, (steps, 2))
        acts = [{"player_1": int(a), "player_2": int(b)} for a, b in acts]

        def run_once(_arg):
            step = env.step
            for a in acts:
                step(a)
                if not env.agents:
                    env.reset()
            return None

        run_once(None)  # warm
        dt = _time_calls(run_once, None, iters, block=False)
        return steps * iters / dt, prov

    if sel == "stepper":
        import numpy as np

        import jax

        jax.config.update("jax_platforms", "cpu")

        from pikazoo_tpu.envs import EnvConfig, PikaZoo
        from pikazoo_tpu.native.engine import NativeEngine

        env = PikaZoo(EnvConfig(auto_reset=True))
        state, _ = env.reset(jax.random.key(0))
        eng = NativeEngine(auto_reset=True)
        stepper = eng.single_stepper(NativeEngine.pack(state))
        acts = np.random.default_rng(0).integers(0, 18, (steps, 2))
        acts = [(int(a), int(b)) for a, b in acts]

        def run_once(_arg):
            step_obs = stepper.step_obs
            for a, b in acts:
                step_obs(a, b)
            return stepper.state

        stepper.step_obs(0, 0)  # warm the .so
        dt = _time_calls(run_once, None, iters, block=False)
        return steps * iters / dt, {"engine": "stepper", "host_path": True}

    if sel == "device":
        _device_rung()
    import jax

    if sel != "device":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pikazoo_tpu.envs import EnvConfig, PikaZoo

    env = PikaZoo(EnvConfig(auto_reset=True))
    state, _ = env.reset(jax.random.key(0))

    def body(carry, _):
        st, key = carry
        key, sub = jax.random.split(key)
        acts = jax.random.randint(sub, (2,), 0, 18, jnp.int32)
        st, _ts = env.step(st, acts)
        return (st, key), None

    @jax.jit
    def rollout(carry):
        return jax.lax.scan(body, carry, None, length=steps)[0]

    dt = _time_calls(rollout, (state, jax.random.key(1)), iters)
    return steps * iters / dt, {"engine": sel, "host_path": sel != "device"}


def measure_wrappers(batch: int, steps: int, iters: int) -> float:
    """Config 3: SimplifyAction + RewardByBallPosition stack, serve=random."""
    _device_rung()
    import jax
    import jax.numpy as jnp

    from pikazoo_tpu.envs import EnvConfig, PikaZoo
    from pikazoo_tpu.wrappers import RewardByBallPosition, SimplifyAction

    env = SimplifyAction(RewardByBallPosition(
        PikaZoo(EnvConfig(auto_reset=True, serve="random")),
        additional_reward=(0.01, 0.02, -0.01, -0.02,
                           -0.01, -0.02, 0.01, 0.02)))
    state, _ = env.reset_batch(jax.random.key(0), batch)

    def body(carry, _):
        st, key = carry
        key, sub = jax.random.split(key)
        acts = jax.random.randint(sub, (batch, 2), 0, 13, jnp.int32)
        st, _ts = env.step_batch(st, acts)
        return (st, key), None

    @jax.jit
    def rollout(carry):
        return jax.lax.scan(body, carry, None, length=steps)[0]

    dt = _time_calls(rollout, (state, jax.random.key(1)), iters)
    return batch * steps * iters / dt, None


def measure_ppo(batch: int, iters: int):
    """Config 5 single-host path: full PPO train step on the device mesh."""
    _device_rung()
    import jax

    from pikazoo_tpu.envs import EnvConfig, PikaZoo
    from pikazoo_tpu.parallel import env_sharding, make_env_mesh, shard_batch
    from pikazoo_tpu.train import PPOConfig, make_ppo_trainer

    cfg = PPOConfig(
        num_envs=min(batch, 65_536),
        rollout_length=int(os.environ.get("PIKAZOO_PPO_T", "128")),
        num_minibatches=int(os.environ.get("PIKAZOO_PPO_MBS", "4")),
        update_epochs=int(os.environ.get("PIKAZOO_PPO_EPOCHS", "4")),
        activation=os.environ.get("PIKAZOO_PPO_ACT", "tanh"),
        shuffle_minibatches=os.environ.get("PIKAZOO_PPO_SHUFFLE", "0") == "1")
    # On a single device the mesh only adds GSPMD partitioning overhead
    # (no sharding to express); use it when there is something to shard,
    # or when forced for testing via PIKAZOO_PPO_MESH=1.
    use_mesh = (len(jax.devices()) > 1
                or os.environ.get("PIKAZOO_PPO_MESH") == "1")
    mesh = make_env_mesh() if use_mesh else None
    env = PikaZoo(EnvConfig(auto_reset=True))
    init_fn, train_step, _ = make_ppo_trainer(env, cfg, mesh=mesh)
    runner = init_fn(jax.random.key(0))
    if mesh is not None:
        runner = runner._replace(
            env_state=shard_batch(runner.env_state, mesh),
            last_obs=jax.device_put(runner.last_obs, env_sharding(mesh)))
    step = jax.jit(train_step, donate_argnums=0)

    runner, metrics = step(runner)  # compile
    jax.block_until_ready(metrics.total_loss)
    best = float("inf")  # min-of-iters windows (see _time_calls)
    for _ in range(iters):
        t0 = time.perf_counter()
        runner, metrics = step(runner)
        jax.block_until_ready(metrics.total_loss)
        best = min(best, time.perf_counter() - t0)
    rate = cfg.num_envs * cfg.rollout_length / best
    return rate, {"update": "xla", "mesh": mesh is not None}


_CONFIGS = {
    # name -> (measure fn from argparse args, metric, baseline denominator)
    "batch": (lambda a: measure_env(a.batch, a.steps, a.iters, False),
              HEADLINE_METRIC, "human"),
    "computer": (lambda a: measure_env(a.batch, a.steps, a.iters, True),
                 "env_steps_per_s_aggregate_1chip_computer_ai", "ai"),
    "batch1": (lambda a: measure_batch1(a.steps, a.iters),
               "env_steps_per_s_batch1_1chip", "human"),
    "wrappers": (lambda a: measure_wrappers(a.batch, a.steps, a.iters),
                 "env_steps_per_s_aggregate_1chip_wrapper_stack", "human"),
    "ppo": (lambda a: measure_ppo(a.batch, a.iters),
            "ppo_env_steps_per_s_full_train_step_1chip", "human"),
}


def _resolve_baseline(key_or_value):
    return BASELINES[key_or_value] if isinstance(key_or_value, str) \
        else key_or_value


def _run_direct(args) -> None:
    if args.iters is None:
        args.iters = 3
    if "PIKAZOO_BASELINE_HUMAN" not in os.environ:
        refresh_baselines()  # direct invocation: measure our own denominator
    fn, metric, baseline = _CONFIGS[args.config]
    value, provenance = fn(args)
    from pikazoo_tpu.utils.device import device_info

    _emit({**_mk(metric, value, _resolve_baseline(baseline), provenance),
           **device_info()})


# --------------------------------------------------------------------------
# Orchestration: subprocess rungs under the global budget.
# --------------------------------------------------------------------------

def _attempt(rung: dict, iters_override: int | None) -> dict | None:
    """Run one rung in a killable child; returns its parsed JSON or None.
    An explicit ``--iters`` on the orchestrator overrides every rung's own
    iteration count (so a tight timeout can shorten all rungs)."""
    timeout = min(300.0, _remaining() - _EXIT_RESERVE_S)
    if timeout < 45:
        return None
    iters = iters_override if iters_override is not None \
        else rung.get("iters", 3)
    cmd = [sys.executable, os.path.abspath(__file__),
           "--config", rung["config"],
           "--batch", str(rung.get("batch", 1)),
           "--steps", str(rung.get("steps", 200)),
           "--iters", str(iters)]
    try:
        out = subprocess.run(cmd, timeout=timeout, capture_output=True,
                             text=True)
    except subprocess.TimeoutExpired:
        return None
    if out.returncode != 0:
        print(f"bench: rung {rung['config']} failed:\n{out.stderr[-2000:]}",
              file=sys.stderr, flush=True)
    result = None
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            result = json.loads(line)
    return result


class _Best:
    """Best-so-far tracker that prints to stdout on every improvement and can
    re-emit from a signal handler."""

    def __init__(self):
        self.result = None

    def offer(self, result: dict | None) -> None:
        if result is None:
            return
        if self.result is None or result["value"] > self.result["value"]:
            self.result = result
            _emit(result)

    def emit_final(self) -> None:
        """Re-print the best result as the last line; with none, exit
        non-zero and print no result."""
        if self.result is None:
            print("bench: no rung produced a measurement", file=sys.stderr,
                  flush=True)
            sys.exit(1)
        _emit(self.result)


_BEST = _Best()


def _sig_handler(signum, frame):
    del signum, frame
    _BEST.emit_final()
    os._exit(0)


def _orchestrate(args) -> None:
    signal.signal(signal.SIGTERM, _sig_handler)
    signal.signal(signal.SIGINT, _sig_handler)
    refresh_baselines()
    for rung in _DEFAULT_RUNGS:
        if _remaining() < 60:
            break
        _BEST.offer(_attempt(rung, args.iters))
    _BEST.emit_final()


def _orchestrate_all(args) -> None:
    """All five BASELINE configs, one JSON line each; the headline (config 4)
    runs first so a truncated run still reports it.  Results are also written
    to artifacts/bench_all.json."""
    signal.signal(signal.SIGTERM, _sig_handler)
    signal.signal(signal.SIGINT, _sig_handler)
    refresh_baselines()
    # iters = timed windows per rung; _time_calls reports the BEST window.
    plan = [
        dict(config="batch", batch=262_144, steps=1000, iters=6),
        dict(config="computer", batch=65_536, steps=500, iters=4),
        dict(config="wrappers", batch=262_144, steps=1000, iters=5),
        dict(config="batch1", steps=1000, iters=5),
        dict(config="ppo", batch=65_536, iters=6),
    ]
    # A failed rung is retried while budget remains, at most
    # PIKAZOO_BENCH_MAX_ATTEMPTS times: a deterministic failure (e.g. an
    # OOM at the rung's fixed batch) must not eat the whole budget.
    max_attempts = int(os.environ.get("PIKAZOO_BENCH_MAX_ATTEMPTS", "3"))
    results: dict = {}
    attempts: dict = {}
    while _remaining() >= 60:
        runnable = [r for r in plan if r["config"] not in results
                    and attempts.get(r["config"], 0) < max_attempts]
        if not runnable:
            break
        for rung in runnable:
            if _remaining() < 60:
                break
            attempts[rung["config"]] = attempts.get(rung["config"], 0) + 1
            result = _attempt(rung, args.iters)
            if result is None:
                continue
            result = dict(result, config=rung["config"])
            results[rung["config"]] = result
            _emit(result)
            if rung["config"] == "batch":
                _BEST.offer({k: v for k, v in result.items()
                             if k != "config"})
    ordered = [results[r["config"]] for r in plan if r["config"] in results]
    try:
        os.makedirs("artifacts", exist_ok=True)
        with open("artifacts/bench_all.json", "w") as f:
            json.dump(ordered, f, indent=1)
    except OSError:
        pass
    _BEST.emit_final()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=262_144)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--iters", type=int, default=None,
                        help="timed iterations; in orchestrated modes an "
                             "explicit value overrides every rung's own "
                             "count (direct --config runs default to 3)")
    parser.add_argument("--all", action="store_true",
                        help="measure all five BASELINE configs")
    parser.add_argument("--computer", action="store_true",
                        help="bench computer-AI self-play (config 2 path)")
    parser.add_argument("--ppo", action="store_true",
                        help="bench the full PPO actor-learner train step")
    parser.add_argument("--config", choices=sorted(_CONFIGS),
                        help="run ONE measurement in-process (no orchestration)")
    args = parser.parse_args()
    if args.config:
        _run_direct(args)
    elif args.all:
        _orchestrate_all(args)
    elif args.computer:
        signal.signal(signal.SIGTERM, _sig_handler)
        refresh_baselines()
        for rung in [dict(config="computer", batch=16_384, steps=200, iters=2),
                     dict(config="computer", batch=65_536, steps=500,
                          iters=2)]:
            if _remaining() < 60:
                break
            _BEST.offer(_attempt(rung, args.iters))
        _BEST.emit_final()
    elif args.ppo:
        signal.signal(signal.SIGTERM, _sig_handler)
        refresh_baselines()
        _BEST.offer(_attempt(dict(config="ppo", batch=65_536, iters=3),
                             args.iters))
        _BEST.emit_final()
    else:
        _orchestrate(args)


if __name__ == "__main__":
    main()
