"""The pieces that let the system start on a GPU machine: the smoke script's
CPU rehearsal and its refusals, the compile-cache placement, the numpy
checkpoint format, and a main path free of orbax and flax."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from l2hmc.train import checkpoint as ckpt

REPO = Path(__file__).resolve().parent.parent


def _run(args, env_extra=None, cwd=REPO, unset=(), timeout=600):
    env = {k: v for k, v in os.environ.items() if k not in unset}
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _last_json(stdout):
    lines = [ln for ln in stdout.strip().splitlines() if ln.strip()]
    return json.loads(lines[-1]) if lines else None


def test_chip_smoke_rehearsal_runs_every_phase_on_cpu():
    proc = _run(["chip_smoke.py", "--rehearse"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in ("device", "train", "hmc"):
        assert f"== {name}: ok" in proc.stdout
    assert "resumed from step 10" in proc.stdout
    assert _last_json(proc.stdout) == {
        "ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 1}}


def test_chip_smoke_refuses_a_cpu_platform():
    proc = _run(["chip_smoke.py"], timeout=120)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], cwd=tmp_path, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


_CACHE_PROBE = (
    "import jax, jax.numpy as jnp\n"
    "from l2hmc.utils.compile_cache import setup_compile_cache\n"
    "path = setup_compile_cache()\n"
    "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)\n"
    "jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)\n"
    "{compile}"
    "print(path, jax.config.jax_compilation_cache_dir)\n"
)


def test_compile_cache_lands_in_the_env_directory(tmp_path):
    cache = tmp_path / "cache"
    code = _CACHE_PROBE.format(
        compile="jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()\n")
    proc = _run(["-c", code], env_extra={
        "JAX_COMPILATION_CACHE_DIR": str(cache), "PYTHONPATH": str(REPO)},
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == [str(cache), str(cache)]
    assert cache.is_dir() and any(cache.iterdir())


def test_compile_cache_defaults_to_the_repo():
    code = _CACHE_PROBE.format(compile="")
    proc = _run(["-c", code], env_extra={"PYTHONPATH": str(REPO)},
                unset=("JAX_COMPILATION_CACHE_DIR",), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    expected = str(REPO / ".jax_cache")
    assert proc.stdout.split() == [expected, expected]


def test_main_path_imports_no_orbax_and_no_flax():
    code = (
        "import sys\n"
        "from cli import train_gauge, train_sampler\n"
        "from l2hmc.train import checkpoint, gauge\n"
        "from l2hmc.targets import distributions\n"
        "from l2hmc.dynamics import hmc\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('orbax', 'flax', 'tensorstore'))\n"
        "print(bad)\n"
    )
    proc = _run(["-c", code], env_extra={"PYTHONPATH": str(REPO)},
                timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


def _state(seed=0):
    k = jax.random.PRNGKey(seed)
    return {"w": jax.random.normal(k, (3, 4)),
            "opt": (jnp.arange(5, dtype=jnp.int32), jnp.float32(2.5)),
            "mask": jnp.array([True, False])}


def test_checkpoint_npz_roundtrip_prunes_and_is_bit_exact(tmp_path):
    d = tmp_path / "ck"
    state = _state()
    for step in (10, 20, 30, 40):
        ckpt.save_checkpoint(d, state, step, keep=2)
    assert ckpt.latest_step(d) == 40
    assert sorted(p.name for p in d.glob("*.npz")) == [
        "step_00000030.npz", "step_00000040.npz"]
    assert not list(d.glob("*.partial"))
    restored = ckpt.restore_checkpoint(d, _state(seed=1))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            state)
    restored30 = ckpt.restore_checkpoint(d, abstract, step=30)
    np.testing.assert_array_equal(restored30["w"], state["w"])


def test_checkpoint_refuses_a_mismatched_template(tmp_path):
    d = tmp_path / "ck"
    ckpt.save_checkpoint(d, _state(), 1)
    wrong = _state()
    wrong["w"] = jnp.zeros((4, 3))
    with pytest.raises(ValueError, match="leaf"):
        ckpt.restore_checkpoint(d, wrong)
    with pytest.raises(ValueError, match="arrays"):
        ckpt.restore_checkpoint(d, {"w": wrong["w"]})
    assert ckpt.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path / "none", _state())
