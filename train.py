#!/usr/bin/env python
"""CLI training driver.

Replaces the reference's three-stage launch (``legion_server.py`` writes
``meta_config`` + execs the C++ ``./src/legion`` server, then the user
separately spawns the torch client, ``pytorch_extension/legion_graphsage
.py:186-190``) with one command and one config:

    python train.py --dataset PR --data-dir /data/products --arch sage
    python train.py --synthetic 100000 --arch gcn --epochs 5
    python train.py --config run.json          # full Config JSON
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# LEGION_FORCE_CPU_DEVICES=N: run on N virtual CPU devices (dry runs of
# the multi-device paths without hardware).
_cpu = int(os.environ.get("LEGION_FORCE_CPU_DEVICES", "0"))
if _cpu:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", _cpu)


def main(argv=None):
    """Parse ``argv`` (default: sys.argv), train, and return the chosen
    driver's result dict (for the single-chip HBM path: the Trainer under
    "trainer" plus its fit() result)."""
    from legion.utils.compile_cache import configure_compile_cache
    configure_compile_cache()
    ap = argparse.ArgumentParser("legion trainer")
    ap.add_argument("--config", help="Config JSON file (overrides flags)")
    ap.add_argument("--dataset", default=None,
                    help="registry code (PR/PA/CO/UKS/UKL/CL/AX)")
    ap.add_argument("--data-dir", default=None, help="packed dataset dir")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate a synthetic graph with N nodes")
    ap.add_argument("--arch", default="sage",
                    choices=["sage", "gcn", "lp_sage"])
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--fanouts", default="25,10")
    ap.add_argument("--hidden-dim", type=int, default=256)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=0.003)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--profile-dir", default=None,
                    help="capture epoch 0 with the JAX profiler into DIR")
    ap.add_argument("--cache-budget-gb", type=float, default=0.0,
                    help=">0 enables the hotness cache (host features)")
    ap.add_argument("--topology", default="hbm", choices=["hbm", "host"],
                    help="'host' = host CSR + HBM hot sub-CSR (hybrid "
                         "sampling; uk-scale graphs beyond device HBM)")
    ap.add_argument("--devices", type=int, default=1,
                    help="chips in the device mesh (0 = all local; "
                         "1 = single-chip drivers)")
    ap.add_argument("--cache-group", type=int, default=None,
                    help="cache group size Kg: chips jointly holding one "
                         "striped hot-cache copy (NVLink-clique analog). "
                         "Default: auto — the largest divisor of the mesh "
                         "size that fits inside this process's local "
                         "device count, so striping stays on NVLink (the "
                         "reference derives Kg from detected NVLink "
                         "topology, legion_server.py:61-68)")
    ap.add_argument("--features", default="hbm",
                    choices=["hbm", "hbm_sharded"],
                    help="multi-chip HBM feature placement: replicated "
                         "per chip or row-striped over the cache axis")
    ap.add_argument("--partitioned", action="store_true",
                    help="edge-partitioned multi-host training: each "
                         "host owns one graph partition, remote hops + "
                         "halo features ride collectives (launch with "
                         "LEGION_COORDINATOR/NUM_PROCESSES/PROCESS_ID "
                         "for a real multi-host run)")
    ap.add_argument("--halo-exchange", default="exact",
                    choices=["exact", "psum"],
                    help="partitioned-path halo strategy: 'exact' = "
                         "per-distance ppermutes at probed caps (each "
                         "requested row crosses the network once; "
                         "over-cap requests fail loudly), 'psum' = the "
                         "cap-free K-x oracle")
    ap.add_argument("--halo-cap-slack", type=float, default=1.3,
                    help="slack over observed per-distance request "
                         "maxima when probing the exact halo caps")
    args = ap.parse_args(argv)

    # Snapshot which tuning flags were explicitly set BEFORE any
    # auto-derivation mutates args (cache_group below) — used by the
    # --config branch's ignored-flags warning.
    non_default_flags = [n for n in (
        "arch", "hidden_dim", "dropout", "dtype", "fanouts",
        "batch_size", "lr", "epochs", "seed", "cache_budget_gb",
        "cache_group", "features", "topology", "halo_exchange",
        "halo_cap_slack", "checkpoint_dir", "profile_dir",
        "devices", "dataset", "data_dir", "synthetic")
        if getattr(args, n, None) != ap.get_default(n)]

    # Auto cache-group (reference: cache_agg_mode derived from detected
    # NVLink topology + GPU count, legion_server.py:61-68). Default Kg =
    # the largest divisor of the mesh size that fits inside this
    # process's local device count, so stripe collectives stay on the
    # host's NVLink; an
    # explicit Kg beyond the local count warns (exchange crosses hosts).
    if args.cache_group is None:
        args.cache_group = 1
        if args.cache_budget_gb > 0 and args.devices != 1:
            import jax
            total = (args.devices if args.devices > 0
                     else len(jax.devices()))
            local = jax.local_device_count()
            args.cache_group = max(
                d for d in range(1, min(local, total) + 1)
                if total % d == 0)
            print(f"auto --cache-group {args.cache_group} "
                  f"({total}-device mesh, {local} local devices)",
                  file=sys.stderr, flush=True)
    elif args.cache_group > 1 and args.cache_budget_gb > 0:
        import jax
        if args.cache_group > jax.local_device_count():
            print(f"WARNING: --cache-group {args.cache_group} exceeds "
                  f"the {jax.local_device_count()} local devices: "
                  "stripe exchange will cross process boundaries "
                  "(the network, not NVLink)", file=sys.stderr, flush=True)

    from legion.config import (DATASET_REGISTRY, CacheConfig, Config,
                               DatasetConfig, ModelConfig,
                               ParallelConfig, SamplerConfig,
                               TrainConfig)
    from legion.data.format import load_dataset
    from legion.data.synthetic import random_power_law_graph

    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
        # same precomputed-partition rule as the flags path below: a
        # partition_<k>_bn in the dataset dir is honored, not silently
        # re-partitioned (src/GPUGraphStore.cu:324-339)
        data = load_dataset(
            cfg.dataset.path,
            partition_count=(cfg.parallel.num_devices
                             if getattr(args, "partitioned", False)
                             and cfg.parallel.num_devices > 1 else None))
        # --config is the whole Config: any tuning flag also passed on
        # the command line is NOT merged (the no-silently-ignored-flags
        # contract below applies here too — say so by name)
        ignored = non_default_flags
        if ignored:
            print("WARNING: --config supplies the whole Config; these "
                  "command-line flags are ignored: "
                  + ", ".join("--" + n.replace("_", "-")
                              for n in ignored),
                  file=sys.stderr, flush=True)
    else:
        fanouts = tuple(int(x) for x in args.fanouts.split(","))
        if args.synthetic:
            data = random_power_law_graph(num_nodes=args.synthetic,
                                          avg_degree=15, feature_dim=100,
                                          num_classes=47, seed=args.seed)
            dcfg = DatasetConfig(name="synthetic", num_classes=47,
                                 feature_placement=(
                                     "host" if args.cache_budget_gb > 0
                                     else args.features))
        else:
            dcfg = (DATASET_REGISTRY[args.dataset] if args.dataset
                    else DatasetConfig())
            if not args.data_dir:
                ap.error("--data-dir (or --synthetic) required")
            # --partitioned honors a precomputed k-way partition file in
            # the dataset dir (the reference's XtraPulp partition_<k>_bn,
            # src/GPUGraphStore.cu:324-339)
            data = load_dataset(
                args.data_dir,
                partition_count=(args.devices if args.partitioned
                                 and args.devices > 1 else None))
            # Registry metadata vs meta.json must agree — a mismatch
            # means the wrong directory (or a bad conversion) and must
            # fail loudly, not train on the wrong graph (the reference
            # trusts meta_config blindly, ReadMetaFIle
            # src/GPUGraphStore.cu:190-252).
            for field, got in (("num_nodes", data.num_nodes),
                               ("num_edges", data.num_edges),
                               ("feature_dim", data.feature_dim)):
                want = getattr(dcfg, field)
                if want and want != got:
                    ap.error(
                        f"--dataset {args.dataset} registry expects "
                        f"{field}={want} but {args.data_dir}/meta.json "
                        f"has {got}: wrong directory or bad conversion")
            dcfg = DatasetConfig(
                name=dcfg.name, path=args.data_dir,
                num_nodes=data.num_nodes, num_edges=data.num_edges,
                feature_dim=data.feature_dim,
                num_classes=dcfg.num_classes or data.num_classes,
                feature_placement=("host" if args.cache_budget_gb > 0
                                   else args.features),
                # registry placement is authoritative for uk-scale codes
                # (UKS/UKL/CL declare host topology); --topology host can
                # force it for any dataset
                topology_placement=("host" if args.topology == "host"
                                    else dcfg.topology_placement))
        cfg = Config(
            dataset=dcfg,
            sampler=SamplerConfig(fanouts=fanouts,
                                  batch_size=args.batch_size),
            model=ModelConfig(arch=args.arch, hidden_dim=args.hidden_dim,
                              num_layers=len(fanouts),
                              dropout=args.dropout, dtype=args.dtype),
            train=TrainConfig(learning_rate=args.lr, epochs=args.epochs,
                              seed=args.seed,
                              checkpoint_dir=args.checkpoint_dir,
                              profile_dir=args.profile_dir),
            cache=CacheConfig(enabled=args.cache_budget_gb > 0,
                              budget_bytes=int(args.cache_budget_gb * 2**30),
                              group_size=args.cache_group),
            parallel=ParallelConfig(num_devices=args.devices,
                                    halo_exchange=args.halo_exchange,
                                    halo_cap_slack=args.halo_cap_slack),
        )

    # --config supplies the whole Config (the warning above lists every
    # ignored CLI flag, --topology included) — only the config's own
    # topology placement drives dispatch on that path
    topo_host = ((not args.config
                  and getattr(args, "topology", "hbm") == "host")
                 or cfg.dataset.topology_placement == "host")
    multi = cfg.parallel.num_devices != 1
    print(cfg.to_json())

    # No silently-ignored flags (the reference's config-that-lies defect,
    # --nbrs_num ignored at src/Server.cu:68-69, deliberately NOT
    # reproduced): every flag a chosen driver cannot honor warns loudly.
    def warn(msg):
        print(f"WARNING: {msg}", file=sys.stderr, flush=True)

    if not getattr(args, "partitioned", False) and not args.config and (
            args.halo_exchange != ap.get_default("halo_exchange")
            or args.halo_cap_slack != ap.get_default("halo_cap_slack")):
        warn("--halo-exchange/--halo-cap-slack apply only to "
             "--partitioned (ignored by this driver)")
    if getattr(args, "partitioned", False):
        if cfg.cache.enabled:
            warn("--partitioned ignores --cache-budget-gb/--cache-group "
                 "(the partitioned driver shards features per host; no "
                 "hotness cache)")
        if topo_host:
            warn("--partitioned ignores --topology host (each host holds "
                 "its own partition's CSR in HBM)")
        from legion.train.partitioned_driver import run_partitioned_training
        return run_partitioned_training(cfg, data)
    elif topo_host and multi:
        if not cfg.cache.enabled:
            warn("--topology host without --cache-budget-gb: zero hot "
                 "cache, every hop/feature is host-served")
        from legion.train.striped_hybrid_driver import (
            run_striped_hybrid_training)
        return run_striped_hybrid_training(cfg, data)
    elif topo_host:
        if cfg.cache.group_size > 1:
            warn("--cache-group > 1 needs --devices > 1; running "
                 "single-chip with an unstriped cache")
        if not cfg.cache.enabled:
            warn("--topology host without --cache-budget-gb: zero hot "
                 "cache, every hop/feature is host-served")
        from legion.train.hybrid_driver import run_hybrid_training
        return run_hybrid_training(cfg, data)
    elif cfg.cache.enabled and multi:
        from legion.train.striped_driver import run_striped_training
        return run_striped_training(cfg, data)
    elif cfg.cache.enabled:
        if cfg.cache.group_size > 1:
            warn("--cache-group > 1 needs --devices > 1; running "
                 "single-chip with an unstriped cache")
        from legion.train.cached_driver import run_cached_training
        return run_cached_training(cfg, data)
    elif multi:
        if cfg.cache.group_size > 1:
            warn("--cache-group is meaningless without --cache-budget-gb "
                 "(no cache to stripe)")
        from legion.parallel.trainer import MeshTrainer
        tr = MeshTrainer(cfg, data)
        return {"trainer": tr, **tr.fit()}
    else:
        if cfg.cache.group_size > 1:
            warn("--cache-group is meaningless without --cache-budget-gb "
                 "(no cache to stripe)")
        from legion.train.loop import Trainer
        tr = Trainer(cfg, data)
        return {"trainer": tr, **tr.fit()}


if __name__ == "__main__":
    main()
