"""Where a run happened and where it keeps its compiled programs.

Every measurement this repository prints names the device it ran on: JAX's
platform, device kind and device count, plus the card's name and power
limit as ``nvidia-smi`` reports them (a card set below its maximum power
runs slower under load).  ``enable_compile_cache`` gives every entry point
the same persistent compilation cache.
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Optional, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")
NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``.

    The path is fixed: it is part of the cache's key, so a directory built
    from a temp name, a pid or the time would never hit."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    (JAX reads ``$JAX_COMPILATION_CACHE_DIR`` itself; otherwise this sets
    the repo default).  Call before the first compile; returns the path."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def parse_nvidia_smi(text: str) -> List[Tuple[str, str]]:
    """``name, power.limit`` CSV lines -> ``[(name, power_limit), ...]``."""
    cards = []
    for line in text.splitlines():
        if not line.strip():
            continue
        name, _, limit = line.rpartition(",")
        if not name:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def nvidia_smi() -> Optional[str]:
    """Raw output of the name/power-limit query, or None where
    ``nvidia-smi`` is missing or fails."""
    try:
        out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def device_info() -> dict:
    """The device fields every measurement line carries."""
    import jax

    devices = jax.devices()
    info = {"platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices)}
    smi = nvidia_smi()
    if smi:
        name, limit = parse_nvidia_smi(smi)[0]
        info.update(card=name, power_limit=limit)
    return info


def require_gpu() -> None:
    """Fail unless JAX's default device is a GPU (measurements never fall
    back to the CPU)."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {platform!r}")
