"""Checkpoint / resume — one pytree, one file per step.

The reference keeps three overlapping mechanisms (SURVEY §5.4): TF Saver
checkpoints, pickled python state, and Keras h5 weights
(``gauge_model.py:429-556``).  Here there is ONE source of truth: a numpy
``.npz`` of the flattened train-state pytree {params, opt_state, chain
state, step} per step (``step_00000100.npz``), plus a JSON sidecar for the
static config.  The arrays are stored byte for byte and restored into the
structure of a template, so resume is bit-exact.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

_STEP_FILE = re.compile(r"step_(\d+)\.npz$")


def _steps(ckpt_dir: Path):
    if not ckpt_dir.exists():
        return []
    return sorted(int(m.group(1)) for p in ckpt_dir.iterdir()
                  if (m := _STEP_FILE.match(p.name)))


def _step_file(ckpt_dir: Path, step: int) -> Path:
    return ckpt_dir / f"step_{step:08d}.npz"


def save_checkpoint(ckpt_dir: str | Path, state, step: int, config=None, keep: int = 3):
    """Write checkpoint at ``step``; prune to the newest ``keep``
    (reference ``max_to_keep=3``, ``gauge_model.py:506``)."""
    ckpt_dir = Path(ckpt_dir).absolute()
    leaves = [np.asarray(jax.device_get(x)) for x in jax.tree.leaves(state)]
    if jax.process_index() != 0:
        return
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if config is not None:
        cfg_file = ckpt_dir / "config.json"
        if not cfg_file.exists():
            cfg_file.write_text(json.dumps(dataclasses.asdict(config), indent=2))
    target = _step_file(ckpt_dir, step)
    partial = target.with_name(target.name + ".partial")
    with open(partial, "wb") as f:
        np.savez(f, **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    os.replace(partial, target)
    for old in _steps(ckpt_dir)[:-keep]:
        _step_file(ckpt_dir, old).unlink()


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = _steps(Path(ckpt_dir).absolute())
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str | Path, template, step: Optional[int] = None):
    """Restore into the structure of ``template`` (an abstract or concrete
    train-state pytree); leaves land on the template's sharding when it has
    one.  Returns the restored state."""
    ckpt_dir = Path(ckpt_dir).absolute()
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    leaves, treedef = jax.tree.flatten(template)
    with np.load(_step_file(ckpt_dir, step)) as data:
        if len(data.files) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(data.files)} arrays, template "
                f"{len(leaves)}")
        restored = []
        for i, t in enumerate(leaves):
            x = data[f"leaf_{i}"]
            if x.shape != tuple(t.shape) or x.dtype != t.dtype:
                raise ValueError(
                    f"leaf {i}: checkpoint {x.shape} {x.dtype}, template "
                    f"{tuple(t.shape)} {t.dtype}")
            sharding = getattr(t, "sharding", None)
            restored.append(jax.device_put(x, sharding) if sharding is not None
                            else jnp.asarray(x))
    return jax.tree.unflatten(treedef, restored)


def load_config_dict(ckpt_dir: str | Path) -> Optional[dict]:
    f = Path(ckpt_dir).absolute() / "config.json"
    return json.loads(f.read_text()) if f.exists() else None
