from legion.models.gcn import GCN  # noqa: F401
from legion.models.sage import SAGE  # noqa: F401

def build_model(arch: str, hidden_dim: int, num_classes: int,
                num_layers: int, dropout: float, dtype=None):
    """Model factory keyed by the config's arch string.

    lp_sage shares the SAGE encoder (reference ``lp_sage.py`` uses the
    same SAGE stack; only the loss differs — see train.loop).

    dtype: compute dtype ("float32" | "bfloat16" or a jnp dtype);
    params stay float32 (mixed precision), losses reduce in f32.
    """
    import jax.numpy as jnp
    if isinstance(dtype, str):
        dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    dtype = dtype or jnp.float32
    if arch in ("sage", "lp_sage"):
        out = hidden_dim if arch == "lp_sage" else num_classes
        return SAGE(hidden_dim=hidden_dim, out_dim=out,
                    num_layers=num_layers, dropout=dropout, dtype=dtype)
    if arch == "gcn":
        return GCN(hidden_dim=hidden_dim, out_dim=num_classes,
                   num_layers=num_layers, dropout=dropout, dtype=dtype)
    raise ValueError(f"unknown arch {arch!r}")
