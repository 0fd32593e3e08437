"""Float-precision switch.

Rebuild of the reference's global dtype switch (``utils/config.py:26-27``:
``TF_FLOAT = tf.float32 / NP_FLOAT = np.float32``, flipped to float64 by
editing the file).  Here the switch is the ``L2HMC_FLOAT`` environment
variable read once at import ("float32" default, "float64" / "f64" to run
the whole framework in double precision), because under JAX the choice
must be made before tracing: float64 additionally requires the
``jax_enable_x64`` flag, which :func:`enable_x64` sets.

Usage::

    from l2hmc.utils.dtypes import FLOAT, NP_FLOAT
    x = jnp.zeros(n, FLOAT)

Everything in the framework defaults to float32 (an accelerator's float64
rate is a fraction of its float32 rate), so f64 is a debugging
mode (e.g. tightening the reversibility/log-Jacobian property tests), not
a production path.
"""

from __future__ import annotations

import os

import jax
import numpy as np


def _from_env() -> str:
    name = os.environ.get("L2HMC_FLOAT", "float32").lower()
    if name in ("float64", "f64", "double"):
        return "float64"
    if name in ("float32", "f32", "single", ""):
        return "float32"
    raise ValueError(f"L2HMC_FLOAT={name!r}: expected float32 or float64")


def enable_x64(enable: bool = True) -> None:
    """Turn on JAX double-precision support (required before using f64)."""
    jax.config.update("jax_enable_x64", enable)


_NAME = _from_env()
if _NAME == "float64":
    enable_x64()

#: numpy dtype used for host-side buffers (reference ``NP_FLOAT``).
NP_FLOAT = np.dtype(_NAME)

#: jnp dtype used for device arrays (reference ``TF_FLOAT``).
FLOAT = NP_FLOAT  # jnp accepts numpy dtypes directly
