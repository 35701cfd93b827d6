"""Actor-critic networks in plain JAX: init/apply pairs over nested dicts.

Parameters are ``{"params": {layer_name: {"kernel": ..., "bias": ...}}}``
with the layer names the trainers and ``ppo.param_shardings`` key on
(``Conv_0``/``Conv_1`` or ``patch``, ``trunk``/``trunk2`` or ``embed`` and
``gru``, ``policy``, ``value``).  Params are created float32; ``dtype`` sets
the compute precision (bfloat16 is the standard mixed-precision recipe), and
logits/values/hidden states come back float32 either way.

Initializers: LeCun-normal kernels with zero biases, orthogonal recurrent
kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp

Params = Dict[str, Any]

_lecun = jax.nn.initializers.lecun_normal()
_orthogonal = jax.nn.initializers.orthogonal()


def dense_init(key, fan_in: int, features: int, bias: bool = True) -> Params:
    p = {"kernel": _lecun(key, (fan_in, features), jnp.float32)}
    if bias:
        p["bias"] = jnp.zeros((features,), jnp.float32)
    return p


def dense(p: Params, x: jax.Array, dtype) -> jax.Array:
    y = jnp.dot(x.astype(dtype), p["kernel"].astype(dtype))
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def conv_init(key, kh: int, kw: int, cin: int, cout: int) -> Params:
    return {
        "kernel": _lecun(key, (kh, kw, cin, cout), jnp.float32),
        "bias": jnp.zeros((cout,), jnp.float32),
    }


def conv(p: Params, x: jax.Array, stride: int, padding: str, dtype):
    """NHWC convolution with an HWIO kernel."""
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), p["kernel"].astype(dtype),
        window_strides=(stride, stride), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return y + p["bias"].astype(dtype)


def pixel_init(key, trunk: str, x: jax.Array) -> Params:
    """Spatial layers of the image trunk (none for vector inputs or the
    ``mlp`` trunk)."""
    if x.ndim < 4 or trunk == "mlp":
        return {}
    c = x.shape[-1]
    if trunk == "patch":
        return {"patch": conv_init(key, 8, 8, c, 64)}
    k0, k1 = jax.random.split(key)
    return {
        "Conv_0": conv_init(k0, 4, 4, c, 16),
        "Conv_1": conv_init(k1, 4, 4, 16, 32),
    }


def pixel_features(p: Params, trunk: str, x: jax.Array, dtype) -> jax.Array:
    """Image [B, H, W, C] -> flat features [B, F]; vectors pass through."""
    x = x.astype(dtype)
    if x.ndim < 4:
        return x
    if trunk == "patch":
        x = jax.nn.relu(conv(p["patch"], x, 8, "VALID", dtype))
    elif trunk != "mlp":
        x = jax.nn.relu(conv(p["Conv_0"], x, 2, "SAME", dtype))
        x = jax.nn.relu(conv(p["Conv_1"], x, 2, "SAME", dtype))
    return x.reshape(x.shape[0], -1)


def _feature_dim(p: Params, trunk: str, x: jax.Array, dtype) -> int:
    out = jax.eval_shape(lambda v: pixel_features(p, trunk, v, dtype), x)
    return out.shape[-1]


def gru_init(key, fan_in: int, hidden: int) -> Params:
    ks = jax.random.split(key, 6)
    return {
        "ir": dense_init(ks[0], fan_in, hidden),
        "iz": dense_init(ks[1], fan_in, hidden),
        "in": dense_init(ks[2], fan_in, hidden),
        "hr": {"kernel": _orthogonal(ks[3], (hidden, hidden), jnp.float32)},
        "hz": {"kernel": _orthogonal(ks[4], (hidden, hidden), jnp.float32)},
        "hn": {
            "kernel": _orthogonal(ks[5], (hidden, hidden), jnp.float32),
            "bias": jnp.zeros((hidden,), jnp.float32),
        },
    }


def gru(p: Params, h: jax.Array, x: jax.Array, dtype) -> jax.Array:
    """One GRU step; returns the new hidden state (also the output)."""
    h = h.astype(dtype)
    r = jax.nn.sigmoid(dense(p["ir"], x, dtype) + dense(p["hr"], h, dtype))
    z = jax.nn.sigmoid(dense(p["iz"], x, dtype) + dense(p["hz"], h, dtype))
    n = jnp.tanh(dense(p["in"], x, dtype) + r * dense(p["hn"], h, dtype))
    return (1.0 - z) * n + z * h


@dataclasses.dataclass(frozen=True)
class ActorCritic:
    """Pixel trunk -> dense trunk -> policy & value heads.

    The trunk Dense is the tensor-parallel candidate (hidden axis sharded
    over ``mp``).  ``trunk`` picks the image feature extractor:

    * ``"conv"`` — two overlapping 4x4/stride-2 convolutions.
    * ``"patch"`` — one non-overlapping 8x8 patch embedding (contraction
      8*8*C_in, ~3x fewer FLOPs than ``conv`` at 64x64) + the dense trunk.
    * ``"mlp"`` — no spatial layer: flatten the pixels straight into the
      dense trunk, plus a second hidden layer (``trunk2``) that restores the
      depth the spatial stage provided.  Its only large intermediate is
      [B, hidden] — the max-throughput trunk.
    """

    num_actions: int = 4
    hidden: int = 256
    dtype: Any = jnp.float32
    trunk: str = "conv"

    def init(self, key: jax.Array, x: jax.Array) -> Params:
        k_pix, k1, k2, k3, k4 = jax.random.split(key, 5)
        p = pixel_init(k_pix, self.trunk, x)
        f = _feature_dim(p, self.trunk, x, self.dtype)
        p["trunk"] = dense_init(k1, f, self.hidden)
        if self.trunk == "mlp":
            p["trunk2"] = dense_init(k2, self.hidden, self.hidden)
        p["policy"] = dense_init(k3, self.hidden, self.num_actions)
        p["value"] = dense_init(k4, self.hidden, 1)
        return {"params": p}

    def apply(self, variables: Params, x: jax.Array):
        p, dt = variables["params"], self.dtype
        x = pixel_features(p, self.trunk, x, dt)
        x = jax.nn.relu(dense(p["trunk"], x, dt))
        if self.trunk == "mlp":
            x = jax.nn.relu(dense(p["trunk2"], x, dt))
        logits = dense(p["policy"], x, dt)
        value = dense(p["value"], x, dt)
        return logits.astype(jnp.float32), value.astype(jnp.float32)[..., 0]


@dataclasses.dataclass(frozen=True)
class RecurrentActorCritic:
    """Pixel trunk -> ``embed`` Dense -> GRU cell -> policy & value heads.

    The GRU carry stays float32 across steps (stability); compute runs in
    ``dtype`` like the feedforward net.
    """

    num_actions: int = 4
    hidden: int = 256
    dtype: Any = jnp.float32
    trunk: str = "conv"

    def init(self, key: jax.Array, x: jax.Array, h: jax.Array) -> Params:
        del h  # the carry's width is ``hidden``
        k_pix, k1, k2, k3, k4 = jax.random.split(key, 5)
        p = pixel_init(k_pix, self.trunk, x)
        f = _feature_dim(p, self.trunk, x, self.dtype)
        p["embed"] = dense_init(k1, f, self.hidden)
        p["gru"] = gru_init(k2, self.hidden, self.hidden)
        p["policy"] = dense_init(k3, self.hidden, self.num_actions)
        p["value"] = dense_init(k4, self.hidden, 1)
        return {"params": p}

    def apply(self, variables: Params, x: jax.Array, h: jax.Array):
        p, dt = variables["params"], self.dtype
        x = pixel_features(p, self.trunk, x, dt)
        e = jax.nn.relu(dense(p["embed"], x, dt))
        new_h = gru(p["gru"], h, e, dt)
        logits = dense(p["policy"], new_h, dt)
        value = dense(p["value"], new_h, dt)
        return (
            logits.astype(jnp.float32),
            value.astype(jnp.float32)[..., 0],
            new_h.astype(jnp.float32),
        )
