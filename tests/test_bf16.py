"""bfloat16 compute path: params stay f32, outputs finite, training
converges comparably to f32 on the planted-label graph."""

import numpy as np

from legion.config import Config, DatasetConfig, ModelConfig, SamplerConfig, TrainConfig
from legion.train.loop import Trainer


def _cfg(num_classes, dtype):
    return Config(
        dataset=DatasetConfig(num_classes=num_classes),
        sampler=SamplerConfig(fanouts=(5, 5), batch_size=128,
                              eval_batch_size=128),
        model=ModelConfig(arch="sage", hidden_dim=32, num_layers=2,
                          dropout=0.2, dtype=dtype),
        train=TrainConfig(learning_rate=0.01, epochs=2, seed=0),
    )


def test_bf16_trains_and_params_stay_f32(small_graph):
    import jax
    import jax.numpy as jnp
    tr = Trainer(_cfg(small_graph.num_classes, "bfloat16"), small_graph)
    for leaf in jax.tree_util.tree_leaves(tr.state.params):
        assert leaf.dtype == jnp.float32
    first = tr.train_one_epoch(0)
    rec = tr.train_one_epoch(1)
    assert np.isfinite(rec["mean_loss"])
    assert rec["mean_loss"] < first["mean_loss"]

    acc = tr.evaluate("valid")
    # f32 comparison run
    tr32 = Trainer(_cfg(small_graph.num_classes, "float32"), small_graph)
    tr32.train_one_epoch(0)
    tr32.train_one_epoch(1)
    acc32 = tr32.evaluate("valid")
    assert acc > acc32 - 0.1, (acc, acc32)
