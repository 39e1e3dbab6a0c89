"""Dense layer and dropout over plain parameter dicts.

Parameters stay float32 and are cast to the compute dtype at use (mixed
precision); a dense layer is ``{"kernel": (in, out)[, "bias": (out,)]}``
with LeCun-normal kernels and zero biases.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_lecun_normal = jax.nn.initializers.lecun_normal()


def dense_init(key: jax.Array, in_dim: int, out_dim: int,
               use_bias: bool) -> dict:
    p = {"kernel": _lecun_normal(key, (in_dim, out_dim), jnp.float32)}
    if use_bias:
        p["bias"] = jnp.zeros((out_dim,), jnp.float32)
    return p


def dense(p: dict, x: jnp.ndarray, dtype) -> jnp.ndarray:
    y = jnp.dot(x.astype(dtype), p["kernel"].astype(dtype))
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def dropout(x: jnp.ndarray, rate: float, key: jax.Array | None,
            deterministic: bool) -> jnp.ndarray:
    """Inverted dropout; the identity when deterministic or rate == 0."""
    if deterministic or rate == 0.0:
        return x
    if key is None:
        raise ValueError("dropout needs rngs={'dropout': key} when "
                         "deterministic=False")
    keep = jax.random.bernoulli(key, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))
