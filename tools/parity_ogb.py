#!/usr/bin/env python
"""One-command OGB accuracy-parity harness.

The reference's only correctness test is OGB valid/test accuracy printed
by its training client (``pytorch_extension/legion_graphsage.py:159-181``
via torchmetrics). This environment is zero-egress, so real OGB data
cannot be fetched here — this tool makes parity ONE COMMAND the day a
downloaded dataset is mountable:

    python tools/parity_ogb.py --name ogbn-products --ogb-root /data/ogb

does: convert (``legion.data.ogb``, skipped if the packed dir
already exists) -> train with the reference hyperparameters (hidden 256,
fanout [25,10], batch 8000, lr 0.003, dropout 0.5, Adam, 10 epochs —
``legion_server.py:77-83``, ``legion_graphsage.py:195-203``) -> compare
valid/test accuracy against the pinned targets of docs/PARITY.md ->
print ONE JSON verdict line -> exit nonzero on a gap > --tolerance
(default 1 point; a larger gap at matched hyperparameters is a
correctness bug, not noise — sampling parity is bit-tested).

The whole flow (mocked ogb package -> convert -> train -> verdict) is
CI-tested end-to-end in tests/test_parity_ogb.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Pinned parity targets (docs/PARITY.md "Accuracy-parity plan"): the
# standard DGL neighbor-sampling baselines the reference client
# reproduces, at its default hyperparameters.
TARGETS = {
    ("ogbn-products", "sage"): 0.78,
    ("ogbn-products", "gcn"): 0.75,
    ("ogbn-papers100M", "sage"): 0.64,
    ("ogbn-arxiv", "sage"): 0.70,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("OGB accuracy-parity harness")
    ap.add_argument("--name", default="ogbn-products",
                    help="OGB dataset name (ogbn-products / "
                         "ogbn-papers100M / ogbn-arxiv)")
    ap.add_argument("--ogb-root", required=True,
                    help="directory containing the downloaded OGB "
                         "dataset (NodePropPredDataset root)")
    ap.add_argument("--out", default=None,
                    help="packed-dataset output dir (default "
                         "<ogb-root>/<name>_packed); conversion is "
                         "skipped when meta.json already exists there")
    ap.add_argument("--arch", default="sage", choices=["sage", "gcn"])
    # reference hyperparameters (legion_server.py:77-83,
    # legion_graphsage.py:195-203)
    ap.add_argument("--batch-size", type=int, default=8000)
    ap.add_argument("--fanouts", default="25,10")
    ap.add_argument("--hidden-dim", type=int, default=256)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=0.003)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--cache-budget-gb", type=float, default=0.0,
                    help=">0: host-resident features behind the hotness "
                         "cache (papers100M-class; 0 = HBM features)")
    ap.add_argument("--target", type=float, default=None,
                    help="override the pinned test-accuracy target")
    ap.add_argument("--tolerance", type=float, default=0.01,
                    help="max allowed (target - test_acc) before "
                         "exiting nonzero")
    args = ap.parse_args(argv)

    out = args.out or os.path.join(args.ogb_root,
                                   args.name.replace("-", "_") + "_packed")
    target = args.target
    if target is None:
        target = TARGETS.get((args.name, args.arch))
        if target is None:
            ap.error(f"no pinned target for ({args.name}, {args.arch}); "
                     "pass --target explicitly")

    from legion.data.format import load_dataset

    if os.path.exists(os.path.join(out, "meta.json")):
        print(f"packed dataset found at {out}; skipping conversion",
              file=sys.stderr, flush=True)
        data = load_dataset(out)
    else:
        from legion.data.ogb import convert_ogb_node_dataset
        print(f"converting {args.name} from {args.ogb_root} -> {out}",
              file=sys.stderr, flush=True)
        convert_ogb_node_dataset(args.name, args.ogb_root, out)
        data = load_dataset(out)

    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    from legion.config import (CacheConfig, Config, DatasetConfig,
                               ModelConfig, SamplerConfig,
                               TrainConfig)
    cfg = Config(
        dataset=DatasetConfig(
            name=args.name, path=out, num_nodes=data.num_nodes,
            num_edges=data.num_edges, feature_dim=data.feature_dim,
            num_classes=data.num_classes,
            feature_placement=("host" if args.cache_budget_gb > 0
                               else "hbm")),
        sampler=SamplerConfig(fanouts=fanouts,
                              batch_size=args.batch_size),
        model=ModelConfig(arch=args.arch, hidden_dim=args.hidden_dim,
                          num_layers=len(fanouts),
                          dropout=args.dropout, dtype=args.dtype),
        train=TrainConfig(learning_rate=args.lr, epochs=args.epochs,
                          seed=args.seed),
        cache=CacheConfig(enabled=args.cache_budget_gb > 0,
                          budget_bytes=int(args.cache_budget_gb * 2**30)))

    if cfg.cache.enabled:
        from legion.train.cached_driver import run_cached_training
        res = run_cached_training(cfg, data)
        test_acc = float(res["test_acc"])
        valid_acc = float(res["history"][-1].get("valid", float("nan")))
    else:
        from legion.train.loop import Trainer
        tr = Trainer(cfg, data)
        res = tr.fit()
        test_acc = float(res["test_acc"])
        valid_acc = float(tr.evaluate("valid"))

    gap = target - test_acc
    ok = gap <= args.tolerance
    print(json.dumps({
        "dataset": args.name, "arch": args.arch,
        "valid_acc": round(valid_acc, 4),
        "test_acc": round(test_acc, 4),
        "target": target, "gap": round(gap, 4),
        "tolerance": args.tolerance,
        "parity": "PASS" if ok else "FAIL",
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
