"""Elastic-recovery restart drill (VERDICT r2 "what's missing" #2).

The in-process checkpoint round-trip is bit-exact
(test_train_ppo.py::test_checkpoint_roundtrip); this drill exercises the
operational path: a live ``train/run.py`` process is SIGKILLed mid-run after
its first checkpoint, then relaunched with identical arguments — it must
resume from the checkpoint (not restart from scratch) and finish the
remaining updates.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(tmp_path, updates):
    cmd = [
        sys.executable, "-m", "pikazoo_tpu.train.run",
        "--num-envs", "64", "--rollout-length", "8",
        "--updates", str(updates),
        "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--checkpoint-every", "2",
        "--metrics", str(tmp_path / f"metrics_{updates}.jsonl"),
        "--seed", "3",
    ]
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        cmd, cwd=_REPO, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


@pytest.mark.slow
def test_kill_and_resume_via_cli(tmp_path):
    # Phase 1: run until the first checkpoint lands, then SIGKILL mid-run.
    proc = _launch(tmp_path, updates=50)
    ckpt_marker = tmp_path / "ckpt" / "latest"
    deadline = time.time() + 600
    try:
        while time.time() < deadline:
            time.sleep(0.2)  # don't busy-spin against the child we await
            if proc.poll() is not None:
                out = proc.stdout.read()
                raise AssertionError(f"run exited before checkpoint:\n{out}")
            if ckpt_marker.is_dir() and any(ckpt_marker.iterdir()):
                time.sleep(1.0)  # let the write finish (orbax is atomic,
                break             # the pause just avoids racing update 3)
        else:
            raise AssertionError("no checkpoint within 600s")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.communicate()

    # Phase 2: relaunch with the same checkpoint dir; it must RESUME.
    proc = _launch(tmp_path, updates=3)
    # 900s: the resume run is ~150s alone, but CI-style full-suite
    # runs oversubscribe the host and queue the XLA compile.
    out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, f"resume run failed:\n{out}"
    assert "resumed from update" in out, \
        f"expected a resume, got a cold start:\n{out}"
    resumed_at = int(out.split("resumed from update")[1].split()[0])
    assert resumed_at >= 2, out
    assert "done: 3 updates" in out, out

    # The metrics of the second run continue AFTER the resume point.
    lines = [json.loads(l) for l in
             (tmp_path / "metrics_3.jsonl").read_text().splitlines()]
    lines = [l for l in lines if "step" in l]  # skip provenance headers
    updates_logged = [l["step"] for l in lines]
    assert min(updates_logged) == resumed_at
    assert len(updates_logged) == 3
    assert np.isfinite([l["loss"] for l in lines]).all()
