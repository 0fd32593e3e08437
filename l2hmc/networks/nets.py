"""Scale/translation/transformation (S, T, Q) networks.

Rebuild of the reference's network layer (L2 of SURVEY §1):

- :func:`make_mlp_net` — GenericNet parity (``network/generic_net.py:20-161``):
  per-input dense embeddings with factor-scaled variance-scaling init, summed,
  ReLU, hidden dense, ReLU, then three heads:
  ``scale = tanh(dense) * exp(coeff_scale)``, ``translation = dense``,
  ``transformation = dense * exp(coeff_transformation)`` (note: the reference
  applies **no** tanh to the transformation head despite its docstring —
  ``generic_net.py:141-146``, ``conv_net.py:270-276``; we reproduce the code,
  not the docstring.  ``bounded_q=True`` restores the original
  brain-research ScaleTanh head, ``utils/network.py:89-114``).

- :func:`make_conv_net` — redesign of ConvNet3D
  (``network/conv_net.py:57-310``).  The reference reshapes the ``(L, L, 2)``
  link field to a depth-2 3-D volume with one channel and runs Conv3D with
  zero 'same' padding (its periodic-padding helper is broken and never called,
  ``conv_net.py:22-53``).  Here the two link directions are **channels** of a
  2-D field — the natural mapping onto XLA's conv lowering — and padding is
  **correctly periodic** (toroidal).

**Fused layouts.**  At small batch the L2HMC hot loop issues ~40 small ops
per leapfrog step, so the networks minimize op count, not FLOPs:

- MLP: the three input embeddings (v, x, t[, aux]) are ONE matmul over the
  concatenated input — weights stored pre-concatenated ``(d_v+d_x+2[+d_aux],
  h)`` with per-block init factors; the three heads are ONE matmul
  ``(h, 3*x_dim)`` split afterwards.
- CNN: the x/v conv stacks stay SEPARATE (a grouped-conv fusion adds a
  channel concat); only the heads are fused.

Semantics and initialization statistics are identical to the unfused form.

All networks are pure ``init``/``apply`` pairs over plain dict pytrees.
Call contract (L2->L3, SURVEY §1):
``apply(params, v, x, t, aux=None) -> (S, T, Q)`` with ``v, x`` of shape
``(batch, x_dim)`` and ``t (batch, 2)``.  For the position net ("XNet"):
``v = momentum``, ``x = masked position``; for the momentum net ("VNet"):
``v = position``, ``x = potential gradient`` (reference order
``net([v, x, t])`` — ``generic_net.py:130-136``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Params = Dict[str, jax.Array]
NetApply = Callable[..., Tuple[jax.Array, jax.Array, jax.Array]]


def _variance_scaling(key, shape, factor: float, dtype=jnp.float32):
    """Truncated-normal variance scaling, fan-in mode.

    Parity with TF1 ``variance_scaling_initializer(factor=2*f, FAN_IN,
    uniform=False)`` used by ``_custom_dense`` (``generic_net.py:149-161``):
    stddev = sqrt(1.3 * 2*f / fan_in) accounting for truncation at 2 sigma.
    """
    fan_in = shape[0]
    stddev = np.sqrt(1.3 * 2.0 * factor / fan_in)
    return stddev * jax.random.truncated_normal(key, -2.0, 2.0, shape, dtype)


def _dense_init(key, in_dim: int, out_dim: int, factor: float) -> Params:
    return {
        "w": _variance_scaling(key, (in_dim, out_dim), factor),
        "b": jnp.zeros((out_dim,), jnp.float32),
    }


def _dense(p: Params, x: jax.Array, compute_dtype=None) -> jax.Array:
    """Dense layer; optionally bfloat16 matmul with f32 accumulation."""
    w = p["w"]
    if compute_dtype is not None and compute_dtype != jnp.float32:
        x = x.astype(compute_dtype)
        w = w.astype(compute_dtype)
    y = jax.lax.dot_general(
        x, w, (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return y + p["b"]


def _matmul(x, w, compute_dtype=None):
    if compute_dtype is not None and compute_dtype != jnp.float32:
        x = x.astype(compute_dtype)
        w = w.astype(compute_dtype)
    return jax.lax.dot_general(
        x, w, (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


@dataclasses.dataclass(frozen=True)
class MLPNetSpec:
    """Static architecture spec for the GenericNet-parity MLP.

    ``bounded_q=False`` reproduces the gauge fork's GenericNet (no tanh on
    the transformation head); ``bounded_q=True`` the original ScaleTanh head
    (keeps ``exp(eps*q)`` bounded — the unbounded variant can blow up at
    aggressive learning rates).
    """

    x_dim: int
    num_hidden: int
    factor: float = 1.0  # 2.0 for XNet, 1.0 for VNet (gauge_dynamics.py:169-187)
    use_bf16: bool = False
    bounded_q: bool = False
    aux_dim: int = 0  # conditioning input (VAE data batch, utils/dynamics.py:120-170)
    # input dims when they differ from x_dim (e.g. periodic cos/sin position
    # features in the U(1) kernel double the position slot); 0 -> x_dim
    v_in_dim: int = 0
    x_in_dim: int = 0


def make_mlp_net(spec: MLPNetSpec):
    """Build (init, apply) for the fused GenericNet-parity MLP."""

    compute_dtype = jnp.bfloat16 if spec.use_bf16 else None
    d, h, da = spec.x_dim, spec.num_hidden, spec.aux_dim
    dv = spec.v_in_dim or d
    dx = spec.x_in_dim or d

    def init(key: jax.Array) -> Params:
        ks = jax.random.split(key, 8)
        # fused input embedding: rows [v (1/3) | x (factor/3) | t (1/3) | aux]
        in_w = jnp.concatenate(
            [
                _variance_scaling(ks[0], (dv, h), 1.0 / 3.0),
                _variance_scaling(ks[1], (dx, h), spec.factor / 3.0),
                _variance_scaling(ks[2], (2, h), 1.0 / 3.0),
            ]
            + (
                [_variance_scaling(ks[6], (da, h), 1.0 / 3.0)] if da > 0 else []
            ),
            axis=0,
        )
        # fused heads: columns [scale | translation | transformation], 0.001
        head_w = jnp.concatenate(
            [
                _variance_scaling(ks[3], (h, d), 0.001),
                _variance_scaling(ks[4], (h, d), 0.001),
                _variance_scaling(ks[5], (h, d), 0.001),
            ],
            axis=1,
        )
        return {
            "in_w": in_w,
            "in_b": jnp.zeros((h,), jnp.float32),
            "h_layer": _dense_init(ks[7], h, h, 1.0),
            "head_w": head_w,
            "head_b": jnp.zeros((3 * d,), jnp.float32),
            "coeff_scale": jnp.zeros((1, d), jnp.float32),
            "coeff_transformation": jnp.zeros((1, d), jnp.float32),
        }

    def apply(params: Params, v: jax.Array, x: jax.Array, t: jax.Array, aux=None):
        parts = [v, x, t]
        if da > 0 and aux is not None:
            parts.append(aux)
        inp = jnp.concatenate(parts, axis=-1)
        hh = _matmul(inp, params["in_w"], compute_dtype) + params["in_b"]
        hh = jax.nn.relu(hh)
        hh = jax.nn.relu(_dense(params["h_layer"], hh, compute_dtype))
        heads = _matmul(hh, params["head_w"], compute_dtype) + params["head_b"]
        s_raw, translation, q_raw = jnp.split(heads, 3, axis=-1)
        scale = jnp.tanh(s_raw) * jnp.exp(params["coeff_scale"])
        if spec.bounded_q:
            q_raw = jnp.tanh(q_raw)
        transformation = q_raw * jnp.exp(params["coeff_transformation"])
        return scale, translation, transformation

    return init, apply


# ---------------------------------------------------------------------------
# Periodic (toroidal) CNN — ConvNet3D equivalent
# ---------------------------------------------------------------------------


def periodic_pad_2d(x: jax.Array, kernel: int) -> jax.Array:
    """Wrap-pad the two spatial axes of an NHWC tensor for a ``kernel``-wide
    conv: total pad ``kernel - 1`` split (k-1)//2 left, k//2 right, so a
    VALID conv yields exactly L (stride 1) or ceil(L/s) (stride s) outputs.

    Correct toroidal geometry — what ``conv_net.py:22-53`` intended but never
    shipped (it is buggy and unused; the reference silently zero-pads).
    """
    pl, pr = (kernel - 1) // 2, kernel // 2
    if pl == 0 and pr == 0:
        return x

    def cat(a, axis):
        parts = []
        if pl:
            parts.append(jax.lax.slice_in_dim(a, a.shape[axis] - pl, a.shape[axis], axis=axis))
        parts.append(a)
        if pr:
            parts.append(jax.lax.slice_in_dim(a, 0, pr, axis=axis))
        return jnp.concatenate(parts, axis=axis)

    return cat(cat(x, 1), 2)


def _conv_init(key, kh: int, kw: int, cin: int, cout: int) -> Params:
    # He-normal: conv feeds ReLU.
    fan_in = kh * kw * cin
    w = jax.random.normal(key, (kh, kw, cin, cout)) * np.sqrt(2.0 / fan_in)
    return {"w": w, "b": jnp.zeros((cout,), jnp.float32)}


def _conv2d_periodic(p: Params, x: jax.Array, compute_dtype=None, stride: int = 1) -> jax.Array:
    """kxk conv, periodic padding, NHWC, f32 accumulation."""
    k = p["w"].shape[0]
    x = periodic_pad_2d(x, k)
    w = p["w"]
    if compute_dtype is not None and compute_dtype != jnp.float32:
        x = x.astype(compute_dtype)
        w = w.astype(compute_dtype)
    y = jax.lax.conv_general_dilated(
        x, w,
        window_strides=(stride, stride),
        padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )
    return y + p["b"]


def _grouped_conv(x, w, b, stride: int, compute_dtype=None):
    """Periodic conv used by tests; groups inferred from channel counts."""
    return _conv2d_periodic({"w": w, "b": b}, x, compute_dtype, stride)


def local_response_norm(
    x: jax.Array, n: int = 5, k: float = 2.0, alpha: float = 1e-4, beta: float = 0.75
) -> jax.Array:
    """``tf.nn.local_response_normalization`` semantics on NHWC
    (ConvNet2D parity, ``conv_net.py:466-478``): divide by
    ``(k + alpha * sum_{c window} x^2)^beta`` over a channel window of
    ``n`` on each side.  Implemented as shifted sums (channel counts are
    tiny here, so this is a handful of fused adds)."""
    sq = x * x
    c = x.shape[-1]
    total = sq
    for off in range(1, n + 1):
        if off < c:
            z = jnp.zeros_like(sq[..., :off])
            total = total + jnp.concatenate([sq[..., off:], z], axis=-1)
            total = total + jnp.concatenate([z, sq[..., :-off]], axis=-1)
    return x / jnp.power(k + alpha * total, beta)


@dataclasses.dataclass(frozen=True)
class ConvNetSpec:
    """Static spec for the periodic-CNN S/T/Q network.

    Redesign of ConvNet3D (``conv_net.py:57-310``): the reference's
    (conv3d -> maxpool3d) x2 stacks become (periodic conv2d -> relu) x2 with
    stride-2 spatial reduction fused into the second conv (a strided conv
    instead of a separate pool op).  The x/v stacks stay separate.
    """

    time_size: int
    space_size: int
    num_filters: int = 8
    filter_size1: int = 3
    filter_size2: int = 2
    num_hidden: int = 256
    factor: float = 1.0
    use_bf16: bool = False
    bounded_q: bool = False  # tanh on the transformation head (stability)
    use_lrn: bool = False    # ConvNet2D parity: local response normalization
    # image channels per input (2 link directions; 4 when the position is
    # fed as periodic cos/sin features)
    v_channels: int = 2
    x_channels: int = 2

    @property
    def x_dim(self) -> int:
        return self.time_size * self.space_size * 2


def make_conv_net(spec: ConvNetSpec):
    """Build (init, apply) for the periodic-CNN S/T/Q network."""

    compute_dtype = jnp.bfloat16 if spec.use_bf16 else None
    lt, lx = spec.time_size, spec.space_size
    f1, f2 = spec.num_filters, 2 * spec.num_filters
    lt2, lx2 = (lt + 1) // 2, (lx + 1) // 2
    conv_out_dim = lt2 * lx2 * f2
    d = spec.x_dim
    h = spec.num_hidden

    def init(key: jax.Array) -> Params:
        ks = jax.random.split(key, 11)
        return {
            "conv_x1": _conv_init(ks[0], spec.filter_size1, spec.filter_size1, spec.x_channels, f1),
            "conv_x2": _conv_init(ks[1], spec.filter_size2, spec.filter_size2, f1, f2),
            "conv_v1": _conv_init(ks[2], spec.filter_size1, spec.filter_size1, spec.v_channels, f1),
            "conv_v2": _conv_init(ks[3], spec.filter_size2, spec.filter_size2, f1, f2),
            "x_layer": _dense_init(ks[4], conv_out_dim, h, spec.factor / 3.0),
            "v_layer": _dense_init(ks[5], conv_out_dim, h, 1.0 / 3.0),
            "t_layer": _dense_init(ks[6], 2, h, 1.0 / 3.0),
            "h_layer": _dense_init(ks[7], h, h, 1.0),
            # fused heads: one (h, 3d) matmul split into S | T | Q
            "head_w": jnp.concatenate(
                [
                    _variance_scaling(ks[8], (h, d), 0.001),
                    _variance_scaling(ks[9], (h, d), 0.001),
                    _variance_scaling(ks[10], (h, d), 0.001),
                ],
                axis=1,
            ),
            "head_b": jnp.zeros((3 * d,), jnp.float32),
            "coeff_scale": jnp.zeros((1, d), jnp.float32),
            "coeff_transformation": jnp.zeros((1, d), jnp.float32),
        }

    def to_image(flat: jax.Array) -> jax.Array:
        """(B, d) link layout -> (B, lt, lx, 2); periodic features (B, 2d)
        [cos | sin] -> (B, lt, lx, 4) channel-stacked."""
        b = flat.shape[0]
        if flat.shape[-1] == d:
            return flat.reshape(b, lt, lx, 2)
        cos_part, sin_part = jnp.split(flat, 2, axis=-1)
        return jnp.concatenate(
            [cos_part.reshape(b, lt, lx, 2), sin_part.reshape(b, lt, lx, 2)],
            axis=-1,
        )

    def conv_stack(p1: Params, p2: Params, flat: jax.Array) -> jax.Array:
        img = to_image(flat)
        y = jax.nn.relu(_conv2d_periodic(p1, img, compute_dtype))
        if spec.use_lrn:
            y = local_response_norm(y)
        y = jax.nn.relu(_conv2d_periodic(p2, y, compute_dtype, stride=2))
        if spec.use_lrn:
            y = local_response_norm(y)
        return y.reshape(flat.shape[0], -1)

    def apply(params: Params, v: jax.Array, x: jax.Array, t: jax.Array, aux=None):
        xc = conv_stack(params["conv_x1"], params["conv_x2"], x)
        vc = conv_stack(params["conv_v1"], params["conv_v2"], v)
        hh = (
            _dense(params["v_layer"], vc, compute_dtype)
            + _dense(params["x_layer"], xc, compute_dtype)
            + _dense(params["t_layer"], t, compute_dtype)
        )
        hh = jax.nn.relu(hh)
        hh = jax.nn.relu(_dense(params["h_layer"], hh, compute_dtype))
        heads = _matmul(hh, params["head_w"], compute_dtype) + params["head_b"]
        s_raw, translation, q_raw = jnp.split(heads, 3, axis=-1)
        scale = jnp.tanh(s_raw) * jnp.exp(params["coeff_scale"])
        if spec.bounded_q:
            q_raw = jnp.tanh(q_raw)
        transformation = q_raw * jnp.exp(params["coeff_transformation"])
        return scale, translation, transformation

    return init, apply


@dataclasses.dataclass(frozen=True)
class LocalNetSpec:
    """Static spec for the weight-shared LOCAL conditioner.

    No dense trunk, no pooling, no flatten-to-global anywhere: inputs are
    stacked as channels of one ``(B, Lt, Lx, C)`` field, pushed through
    ``num_layers`` small periodic convs, and a 1x1 conv head emits
    per-link S/T/Q directly.  Cost is O(V * k^2 * c^2) with a tiny
    constant — it scales WITH the lattice, unlike the dense-trunk MLP/CNN
    whose O(V * h) embeddings/heads grow with the lattice.  The receptive
    field after two 3x3 convs is 5x5 — the
    physical scale of the plaquette interaction, which is strictly local;
    the global analysis channel the dense trunk provided never bought
    more than a few percent per-step quality (MLP-vs-CNN study).

    This is the reference's own geometric-prior idea
    (``network/conv_net.py:57-310``) done volume-scalably: translation
    equivariant (periodic padding, per-channel head coefficients), zero
    pooling, zero dense layers.
    """

    time_size: int
    space_size: int
    channels: int = 8
    kernel_size: int = 3
    num_layers: int = 2
    factor: float = 1.0          # x-slot input-channel init scaling (parity)
    use_bf16: bool = False
    bounded_q: bool = False
    v_channels: int = 2          # 2 link dirs; 4 when cos/sin features
    x_channels: int = 2

    @property
    def x_dim(self) -> int:
        return self.time_size * self.space_size * 2


def make_local_net(spec: LocalNetSpec):
    """Build (init, apply) for the local per-link S/T/Q conditioner."""

    compute_dtype = jnp.bfloat16 if spec.use_bf16 else None
    lt, lx = spec.time_size, spec.space_size
    c = spec.channels
    k = spec.kernel_size
    cin = spec.v_channels + spec.x_channels + 2  # + 2 broadcast time channels

    def init(key: jax.Array) -> Params:
        ks = jax.random.split(key, spec.num_layers + 1)
        params: Params = {}
        params["conv_0"] = _conv_init(ks[0], k, k, cin, c)
        # factor-scaled init on the x-slot input channels (GenericNet's
        # per-input factor semantics, generic_net.py:149-161): XNet sees
        # the masked position there with factor 2
        if spec.factor != 1.0:
            w = params["conv_0"]["w"]
            lo = spec.v_channels
            hi = spec.v_channels + spec.x_channels
            w = w.at[:, :, lo:hi, :].multiply(np.sqrt(spec.factor))
            params["conv_0"] = {"w": w, "b": params["conv_0"]["b"]}
        for i in range(1, spec.num_layers):
            params[f"conv_{i}"] = _conv_init(ks[i], k, k, c, c)
        # 1x1 head conv -> 6 channels ([S | T | Q] x 2 link dirs), 0.001
        # factor so the kernel starts ~identity (head convention parity)
        fan_in = c
        stddev = np.sqrt(1.3 * 2.0 * 0.001 / fan_in)
        params["head"] = {
            "w": stddev * jax.random.truncated_normal(
                ks[-1], -2.0, 2.0, (1, 1, c, 6), jnp.float32),
            "b": jnp.zeros((6,), jnp.float32),
        }
        # per-(output, link-dir) coefficients — translation equivariance
        # keeps these channel-wise (the dense nets' (1, d) coeffs would
        # break weight sharing)
        params["coeff_scale"] = jnp.zeros((2,), jnp.float32)
        params["coeff_transformation"] = jnp.zeros((2,), jnp.float32)
        return params

    def to_image(flat: jax.Array, n_ch: int) -> jax.Array:
        b = flat.shape[0]
        if n_ch == 2:
            return flat.reshape(b, lt, lx, 2)
        cos_part, sin_part = jnp.split(flat, 2, axis=-1)
        return jnp.concatenate(
            [cos_part.reshape(b, lt, lx, 2), sin_part.reshape(b, lt, lx, 2)],
            axis=-1,
        )

    def apply(params: Params, v: jax.Array, x: jax.Array, t: jax.Array, aux=None):
        b = v.shape[0]
        t_img = jnp.broadcast_to(t[:, None, None, :], (b, lt, lx, 2))
        img = jnp.concatenate(
            [to_image(v, spec.v_channels), to_image(x, spec.x_channels),
             t_img], axis=-1)
        y = img
        for i in range(spec.num_layers):
            y = jax.nn.relu(_conv2d_periodic(params[f"conv_{i}"], y,
                                             compute_dtype))
        heads = _conv2d_periodic(params["head"], y, compute_dtype)
        s_raw = heads[..., 0:2]
        t_out = heads[..., 2:4]
        q_raw = heads[..., 4:6]
        scale = jnp.tanh(s_raw) * jnp.exp(params["coeff_scale"])
        if spec.bounded_q:
            q_raw = jnp.tanh(q_raw)
        transformation = q_raw * jnp.exp(params["coeff_transformation"])
        return (scale.reshape(b, -1), t_out.reshape(b, -1),
                transformation.reshape(b, -1))

    return init, apply


def make_local_flat_net(spec: LocalNetSpec):
    """Flat-layout edition of :func:`make_local_net`.

    Same weight-shared per-link S/T/Q family, computed directly on the
    flat ``(B, 2d)`` link arrays the dynamics already holds: the stencil
    is a 5-point cross of rolls (the ``ops/leapfrog.py``
    ``_roll_t``/``_roll_s`` pattern the Wilson gradient uses), and the
    broadcast time encoding enters as a per-sample bias (exactly a
    convolution over constant channels).  There is no flat->NHWC->flat
    round trip.  Under XLA each scalar-weighted shifted operand of the
    stencil is its own pass over the ``(B, d)`` state, so the pass count,
    not the arithmetic, sets its cost.

    The 5-point support matches the plaquette interaction's
    nearest-neighbor physics; two layers give the same effective
    receptive field class as the image net's 3x3 pair.  Tested for
    equivariance, identity init and gauge training.
    """
    if spec.kernel_size != 3:
        # the stencil support is the fixed 5-point cross (the k=3 conv's
        # physics-relevant subset); a spec asking for another kernel_size
        # would silently run a different receptive field
        raise ValueError(
            f"make_local_flat_net supports kernel_size=3 only (5-point "
            f"cross stencil); got {spec.kernel_size}")
    lt, lx = spec.time_size, spec.space_size
    d = lt * lx
    c = spec.channels
    OFF = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))
    n_off = len(OFF)
    cin = spec.v_channels + spec.x_channels

    from l2hmc.ops.leapfrog import _roll_s, _roll_t

    def init(key: jax.Array) -> Params:
        ks = jax.random.split(key, spec.num_layers + 2)
        params: Params = {}
        fan0 = n_off * cin + 2
        w0 = jax.random.normal(ks[0], (n_off, cin, c)) * np.sqrt(2.0 / fan0)
        # factor-scaled init on the x-slot input channels (GenericNet
        # per-input factor semantics — same convention as make_local_net)
        lo, hi = spec.v_channels, spec.v_channels + spec.x_channels
        w0 = w0.at[:, lo:hi, :].multiply(np.sqrt(spec.factor))
        params["stencil_0"] = {
            "w": w0,
            "wt": jax.random.normal(ks[-1], (2, c)) * np.sqrt(2.0 / fan0),
            "b": jnp.zeros((c,), jnp.float32),
        }
        for i in range(1, spec.num_layers):
            params[f"stencil_{i}"] = {
                "w": jax.random.normal(ks[i], (n_off, c, c))
                * np.sqrt(2.0 / (n_off * c)),
                "b": jnp.zeros((c,), jnp.float32),
            }
        stddev = np.sqrt(1.3 * 2.0 * 0.001 / c)
        params["head"] = {
            "w": stddev * jax.random.truncated_normal(
                ks[-2], -2.0, 2.0, (c, 6), jnp.float32),
            "b": jnp.zeros((6,), jnp.float32),
        }
        params["coeff_scale"] = jnp.zeros((2,), jnp.float32)
        params["coeff_transformation"] = jnp.zeros((2,), jnp.float32)
        return params

    def apply(params: Params, v: jax.Array, x: jax.Array, t: jax.Array,
              aux=None):
        b = v.shape[0]
        s_col = jax.lax.broadcasted_iota(jnp.int32, (b, d), 1) % lx
        roll = functools.partial(jnp.roll, axis=1)

        def split_dir(flat, n_ch):
            # dir-last layout (t, x, dir): per-direction (b, d) halves in
            # the row-major flat order _roll_t/_roll_s expect
            if n_ch == 2:
                pair = flat.reshape(b, d, 2)
                return [pair[:, :, 0], pair[:, :, 1]]
            cos_p, sin_p = jnp.split(flat, 2, axis=-1)
            return split_dir(cos_p, 2) + split_dir(sin_p, 2)

        def shift(a, off):
            dt, ds = off
            if dt:
                a = _roll_t(a, dt, lx, roll)
            if ds:
                a = _roll_s(a, ds, lx, s_col, roll)
            return a

        def layer(chs, p, t_vec=None):
            shifted = [[shift(a, off) for off in OFF] for a in chs]
            w, bias = p["w"], p["b"]
            outs = []
            for j in range(w.shape[2]):
                acc = jnp.full((b, d), 0.0) + bias[j]
                if t_vec is not None:
                    acc = acc + (t_vec @ p["wt"][:, j])[:, None]
                for oi in range(n_off):
                    for ci in range(len(chs)):
                        acc = acc + w[oi, ci, j] * shifted[ci][oi]
                outs.append(acc)
            return outs

        chans = (split_dir(v, spec.v_channels)
                 + split_dir(x, spec.x_channels))
        y = [jax.nn.relu(o) for o in layer(chans, params["stencil_0"], t)]
        for i in range(1, spec.num_layers):
            y = [jax.nn.relu(o) for o in layer(y, params[f"stencil_{i}"])]
        hw, hb = params["head"]["w"], params["head"]["b"]
        head = [hb[k] + sum(hw[ci, k] * y[ci] for ci in range(c))
                for k in range(6)]

        e_s = jnp.exp(params["coeff_scale"])
        e_q = jnp.exp(params["coeff_transformation"])

        def join(c0, c1):
            return jnp.stack([c0, c1], axis=-1).reshape(b, 2 * d)

        scale = join(jnp.tanh(head[0]) * e_s[0], jnp.tanh(head[1]) * e_s[1])
        t_out = join(head[2], head[3])
        q0, q1 = head[4], head[5]
        if spec.bounded_q:
            q0, q1 = jnp.tanh(q0), jnp.tanh(q1)
        transformation = join(q0 * e_q[0], q1 * e_q[1])
        return scale, t_out, transformation

    return init, apply


def make_zero_net(x_dim: int):
    """HMC-degenerate network: S = T = Q = 0.

    Reference: ``dynamics/gauge_dynamics.py:102-108`` and
    ``utils/dynamics.py:75-78`` — with zero nets the augmented leapfrog
    reduces exactly to plain leapfrog.
    """

    def init(key: jax.Array) -> Params:
        return {}

    def apply(params: Params, v: jax.Array, x: jax.Array, t: jax.Array, aux=None):
        z = jnp.zeros_like(v)
        return z, z, z

    return init, apply
