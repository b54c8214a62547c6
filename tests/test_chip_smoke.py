"""chip_smoke.py's contract where there is no GPU: it fails, and never
prints a result."""

import json
import os
import shutil
import subprocess
import sys

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SMOKE = os.path.join(_REPO, "chip_smoke.py")


def _run(script, cwd, **env):
    return subprocess.run([sys.executable, script], cwd=cwd,
                          env=dict(os.environ, **env), capture_output=True,
                          text=True, timeout=300)


def test_fails_without_a_gpu():
    out = _run(_SMOKE, _REPO, JAX_PLATFORMS="cpu")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_fails_alone_in_a_directory(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(_SMOKE, alone)
    out = _run(str(alone), str(tmp_path), JAX_PLATFORMS="cpu",
               PYTHONPATH="")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_result_line_is_exactly_the_contract():
    sys.path.insert(0, _REPO)
    import chip_smoke

    line = chip_smoke.result_line(jax.devices()[:1])
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": 1}}
    assert json.loads(chip_smoke.result_line(jax.devices()))["device"][
        "count"] == len(jax.devices())
