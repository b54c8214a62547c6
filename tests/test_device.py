"""Device fields, the nvidia-smi parser and the compile-cache rules."""

import os

import jax
import pytest

from pikazoo_tpu.utils import device


def test_cache_dir_honours_environment(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the cache goes there and the
    code sets no other directory."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert device.compile_cache_dir() == "/elsewhere/cache"
    assert device.enable_compile_cache() == "/elsewhere/cache"
    assert calls == []


def test_cache_dir_defaults_to_fixed_repo_path(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert path == device.enable_compile_cache()  # no pid, time or temp name
    assert calls == [("jax_compilation_cache_dir", path)] * 2
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_nvidia_smi_parser_on_stubbed_output():
    text = ("NVIDIA H100 80GB HBM3, 700.00 W\n"
            "NVIDIA H100 80GB HBM3, 650.00 W\n\n")
    assert device.parse_nvidia_smi(text) == [
        ("NVIDIA H100 80GB HBM3", "700.00 W"),
        ("NVIDIA H100 80GB HBM3", "650.00 W")]
    with pytest.raises(ValueError):
        device.parse_nvidia_smi("no comma here")


def test_device_info_names_the_backend(monkeypatch):
    monkeypatch.setattr(device, "nvidia_smi",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    info = device.device_info()
    assert info == {"platform": "cpu", "device_kind": "cpu",
                    "device_count": len(jax.devices()),
                    "card": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
    with pytest.raises(SystemExit, match="no GPU"):
        device.require_gpu()


def test_importing_the_package_opens_no_device():
    """Importing the entry points' modules creates no JAX backend, so
    ``jax.distributed.initialize`` can still run after the imports
    (``train/run.py --distributed``) and ``chip_smoke.py`` can hand the card
    to its test child before it opens the card itself."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import pikazoo_tpu, pikazoo_tpu.train.run, pikazoo_tpu.compat, "
        "pikazoo_tpu.train.evaluate, pikazoo_tpu.core.predict_pallas, "
        "pikazoo_tpu.utils.device, chip_smoke\n"
        "from jax._src import xla_bridge\n"
        "print(xla_bridge.backends_are_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "False"
