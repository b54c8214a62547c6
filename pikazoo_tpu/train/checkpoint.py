"""Checkpoint / resume via orbax (SURVEY.md aux-subsystem plan).

The whole training state — parameters, optimizer state, the full env batch
(a small int32 pytree), PRNG keys and counters — round-trips losslessly, so
resume is bit-exact: the env step is pure and the RNG is a counted key.
Typed PRNG keys are converted to raw ``uint32`` key data for serialization.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import jax.numpy as jnp


def _encode(tree: Any) -> Any:
    def enc(x):
        if isinstance(x, jax.Array) and jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            return {"__prng_key_data__": jax.random.key_data(x)}
        return x
    return jax.tree.map(enc, tree,
                        is_leaf=lambda x: isinstance(x, jax.Array))


def _decode(tree: Any) -> Any:
    def is_enc(x):
        return isinstance(x, dict) and "__prng_key_data__" in x

    def dec(x):
        if is_enc(x):
            return jax.random.wrap_key_data(x["__prng_key_data__"])
        return x
    return jax.tree.map(dec, tree, is_leaf=is_enc)


def _recover_swap(path: str) -> None:
    """Promote a finalized stale ``path.new`` left by a crash inside
    :func:`save`'s swap window.  Orbax finalizes a checkpoint by renaming its
    own ``*.orbax-checkpoint-tmp-*`` staging dir into place, so ``path.new``
    existing as a directory means it is complete — and it was written AFTER
    whatever sits at ``path``, so it is always the newest recovery point."""
    import shutil  # noqa: PLC0415

    tmp, old = path + ".new", path + ".old"
    if not os.path.isdir(tmp):
        return
    if os.path.exists(path):
        shutil.rmtree(old, ignore_errors=True)
        os.rename(path, old)
    os.rename(tmp, path)


def save(path: str, state: Any) -> None:
    """Crash-safe overwrite: orbax's ``force=True`` DELETES the existing
    checkpoint before finalizing the new one, so a crash mid-save would lose
    the only recovery point (found by the SIGKILL restart drill).  Write the
    new checkpoint fully to ``path.new`` first, then swap; at every instant
    a finalized checkpoint exists at ``path`` or ``path.old`` (the restore
    side falls back to ``.old``).  A finalized ``.new`` from a prior crash is
    promoted, never deleted — it is the newest recovery point."""
    import shutil  # noqa: PLC0415

    import orbax.checkpoint as ocp  # noqa: PLC0415
    path = os.path.abspath(path)
    tmp, old = path + ".new", path + ".old"
    _recover_swap(path)  # a finalized stale .new is newer than path: keep it
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(tmp, _encode(state), force=True)
    shutil.rmtree(old, ignore_errors=True)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def latest_restorable(path: str) -> str | None:
    """The finalized checkpoint to restore from: a promoted ``path.new``
    (crash inside :func:`save`'s swap window), ``path``, or ``path.old``."""
    path = os.path.abspath(path)
    try:
        _recover_swap(path)
    except OSError:
        pass  # read-only filesystem etc.: fall through to what exists
    for candidate in (path, path + ".old"):
        if os.path.isdir(candidate):
            return candidate
    return None


def restore(path: str, like: Any) -> Any:
    """Restore a checkpoint; ``like`` provides the pytree structure AND the
    target shardings (e.g. the output of ``init_fn``) — so a checkpoint saved
    on one topology (a GPU) restores onto another (CPU) without relying on the
    recorded device layout."""
    import orbax.checkpoint as ocp  # noqa: PLC0415
    path = os.path.abspath(path)
    template = _encode(like)
    restore_args = ocp.checkpoint_utils.construct_restore_args(template)
    with ocp.PyTreeCheckpointer() as ckptr:
        restored = ckptr.restore(path, item=template,
                                 restore_args=restore_args)
    return _decode(restored)
