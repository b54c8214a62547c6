"""Contract of bench.py's orchestration layer.

A caller collects the LAST JSON line of `python bench.py` under a hard
timeout; these tests pin the pieces that protect that contract (best-so-far
tracking, device fields on every line, no CPU fallback, the attempt cap)
without touching a device.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BENCH = os.path.join(_REPO, "bench.py")


def _load_bench():
    spec = importlib.util.spec_from_file_location("bench_under_test", _BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_best_tracker_offers_and_fallback_metric():
    bench = _load_bench()
    best = bench._Best()
    assert best.result is None
    best.offer(None)  # failed rung: ignored
    assert best.result is None
    best.offer({"metric": "m", "value": 5, "unit": "u", "vs_baseline": 1})
    best.offer({"metric": "m", "value": 3, "unit": "u", "vs_baseline": 1})
    assert best.result["value"] == 5  # lower later result never demotes
    best.offer({"metric": "m", "value": 9, "unit": "u", "vs_baseline": 1})
    assert best.result["value"] == 9


def test_no_result_exits_nonzero_without_fallback(capsys):
    """No rung landed: no zero or CPU number stands in for a device one —
    the run prints no result line and exits non-zero."""
    bench = _load_bench()
    with pytest.raises(SystemExit) as exc:
        bench._Best().emit_final()
    assert exc.value.code == 1
    assert capsys.readouterr().out == ""


def test_orchestrate_fails_when_no_rung_lands(monkeypatch, capsys):
    import argparse

    bench = _load_bench()
    monkeypatch.setattr(bench, "refresh_baselines", lambda *a, **k: None)
    ran = []
    monkeypatch.setattr(bench, "_attempt",
                        lambda rung, iters: ran.append(rung) or None)
    with pytest.raises(SystemExit) as exc:
        bench._orchestrate(argparse.Namespace(iters=None))
    assert exc.value.code == 1
    assert [r["config"] for r in ran] == ["batch", "batch"]
    assert not hasattr(bench, "_cpu_fallback_attempt")
    assert capsys.readouterr().out == ""


def test_direct_line_carries_device_fields(monkeypatch, capsys):
    import argparse

    from pikazoo_tpu.utils import device

    bench = _load_bench()
    monkeypatch.setenv("PIKAZOO_BASELINE_HUMAN", "1000")
    monkeypatch.setitem(bench._CONFIGS, "batch", (
        lambda a: (123456.0, {"engine": "stub"}), bench.HEADLINE_METRIC,
        "human"))
    monkeypatch.setattr(device, "device_info", lambda: {
        "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
        "device_count": 1, "card": "NVIDIA H100 80GB HBM3",
        "power_limit": "700.00 W"})
    bench._run_direct(argparse.Namespace(config="batch", iters=1))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 123456 and line["provenance"] == {
        "engine": "stub"}
    for key in ("platform", "device_kind", "device_count", "card",
                "power_limit"):
        assert key in line


def test_direct_device_rung_fails_without_gpu():
    """A device rung on the CPU backend fails instead of measuring the
    CPU."""
    out = subprocess.run(
        [sys.executable, _BENCH, "--config", "batch", "--batch", "256",
         "--steps", "5", "--iters", "1"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


def test_mk_rounds_and_scales():
    bench = _load_bench()
    r = bench._mk("m", 123456.7, 1000.0)
    assert r == {"metric": "m", "value": 123457, "unit": "env-steps/s",
                 "vs_baseline": 123.46}


def test_batch1_rung_carries_engine_provenance():
    """Config 1's JSON must say WHICH engine served (round-5 contract: a
    silent fallback can never again ship an unattributable number) — and
    with the toolchain present that engine must be the C fast path."""
    from pikazoo_tpu.native import engine as ne

    if not ne.fastpath_available():
        pytest.skip("toolchain unavailable")
    out = subprocess.run(
        [sys.executable, _BENCH, "--config", "batch1",
         "--steps", "200", "--iters", "1"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    parsed = json.loads(lines[-1])
    assert parsed["provenance"] == {"engine": "fastpath-c",
                                    "host_path": True}
    assert parsed["platform"] == "cpu"  # a host rung says where it ran


def test_batch1_rung_fails_loudly_without_fastpath():
    """When the C fast path cannot build, the rung must ERROR (not bench
    the Python fallback unlabeled) unless explicitly allowed — and the
    allowed fallback must be labeled with the build error."""
    env = dict(os.environ,
               PIKAZOO_NATIVE_CACHE="/tmp/pikazoo_no_toolchain_test",
               PATH="/nonexistent")  # no gcc/g++ resolvable
    out = subprocess.run(
        [sys.executable, _BENCH, "--config", "batch1",
         "--steps", "50", "--iters", "1"],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert "fast path failed to build" in (out.stderr + out.stdout)


def test_refresh_baselines_updates_denominators(monkeypatch):
    """vs_baseline must divide by a same-run reference measurement when the
    reference repo is present, and propagate to subprocess rungs via env."""
    bench = _load_bench()
    monkeypatch.delenv("PIKAZOO_BASELINE_HUMAN", raising=False)
    monkeypatch.delenv("PIKAZOO_BASELINE_AI", raising=False)
    before = dict(bench.BASELINES)
    out = bench.refresh_baselines(seconds=0.3)
    if not os.path.isdir("/root/reference/pikazoo"):
        assert out == before  # graceful no-op without the reference
        return
    assert out["human"] > 1000, "reference human loop should measure"
    assert out["ai"] > 500, "reference AI loop should measure"
    # Subprocess rungs inherit the fresh numbers through the environment.
    assert float(os.environ["PIKAZOO_BASELINE_HUMAN"]) == out["human"]
    assert float(os.environ["PIKAZOO_BASELINE_AI"]) == out["ai"]
    # The AI loop does strictly more work per step than the human loop, but
    # both sides are ~0.3 s wall-clock windows on a noisy shared host — allow
    # generous jitter rather than asserting a strict ordering of two tiny
    # timing samples (flaky otherwise).
    assert out["ai"] < 1.5 * out["human"]


def test_orchestrate_all_attempt_cap_and_artifact(tmp_path, monkeypatch):
    """--all control flow with _attempt stubbed: rungs that succeed land in
    the artifact in plan order with their config tag; a rung that fails
    DETERMINISTICALLY is retried at most PIKAZOO_BENCH_MAX_ATTEMPTS times
    (unbounded retries could eat the whole budget); the final stdout line
    re-emits the headline."""
    import importlib

    monkeypatch.setenv("PIKAZOO_BENCH_MAX_ATTEMPTS", "2")
    import bench as bench_mod
    bench = importlib.reload(bench_mod)
    monkeypatch.setattr(bench, "refresh_baselines", lambda *a, **k: None)
    monkeypatch.chdir(tmp_path)

    attempts = {}

    def fake_attempt(rung, iters):
        cfg = rung["config"]
        attempts[cfg] = attempts.get(cfg, 0) + 1
        if cfg == "ppo":
            return None  # deterministic failure
        return {"metric": f"m_{cfg}" if cfg != "batch"
                else bench.HEADLINE_METRIC,
                "value": {"batch": 100, "computer": 50, "wrappers": 70,
                          "batch1": 1}[cfg],
                "unit": "env-steps/s", "vs_baseline": 1.0,
                "provenance": {"engine": "stub"}}

    monkeypatch.setattr(bench, "_attempt", fake_attempt)

    import argparse
    import json as _json
    bench._orchestrate_all(argparse.Namespace(iters=None))

    assert attempts["ppo"] == 2          # capped, not budget-unbounded
    assert attempts["batch"] == 1
    rows = _json.load(open(tmp_path / "artifacts" / "bench_all.json"))
    assert [r["config"] for r in rows] == ["batch", "computer",
                                           "wrappers", "batch1"]
    assert rows[0]["provenance"] == {"engine": "stub"}
