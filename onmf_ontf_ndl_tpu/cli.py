"""Command-line interface: one subcommand per workload.

The reference has no CLI — experiments are ``main()`` blocks with
hand-edited constants (SURVEY.md §5 config). Each subcommand maps 1:1
onto the knobs of the corresponding reference driver and runs
train -> (optional) reconstruct -> save artifacts.

Examples:
  python -m onmf_ontf_ndl_tpu.cli image --path img.jpg --n-components 25 \\
      --iterations 100 --patch-size 10 --out-dir out/
  python -m onmf_ontf_ndl_tpu.cli network --source edges.txt --k2 20 \\
      --mcmc-iterations 50 --recons-iter 5000
  python -m onmf_ontf_ndl_tpu.cli ising --lattice-size 200 --temperature 5
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


_UNSET = object()  # distinguishes "flag not given" from an explicit value


def _parse_bool(v: str) -> bool:
    """Strict bool flag parser: a typo must error, not silently read as
    False."""
    low = v.lower()
    if low in ("1", "true", "yes"):
        return True
    if low in ("0", "false", "no"):
        return False
    raise argparse.ArgumentTypeError(
        f"expected one of 1/0/true/false/yes/no, got {v!r}")


def _add_fields(p: argparse.ArgumentParser, cfg_cls, skip=()):
    for f in dataclasses.fields(cfg_cls):
        if f.name in skip:
            continue
        # dest must be the exact dataclass field name (e.g. the flag
        # --mcmc-iterations maps onto field MCMC_iterations); the argparse
        # default is a sentinel so an explicit "none" is honored
        flag = "--" + f.name.replace("_", "-").lower()
        kw = {"dest": f.name, "default": _UNSET}
        required = (f.default is dataclasses.MISSING)
        if required:
            kw["required"] = True
        if f.type in ("bool", bool):
            p.add_argument(flag, type=_parse_bool, **kw)
        elif f.type in ("int", int):
            p.add_argument(flag, type=int, **kw)
        elif f.type in ("float", float):
            p.add_argument(flag, type=float, **kw)
        elif f.type in ("float | None", "int | None"):
            caster = float if "float" in str(f.type) else int
            p.add_argument(flag,
                           type=lambda s, c=caster: None if s == "none" else c(s),
                           **kw)
        else:
            p.add_argument(flag, type=str, **kw)


def _build_cfg(cfg_cls, args):
    kw = {}
    for f in dataclasses.fields(cfg_cls):
        v = getattr(args, f.name, _UNSET)
        if v is not _UNSET:
            kw[f.name] = v
    return cfg_cls(**kw)


def main(argv=None):
    # persistent compilation cache: repeat CLI invocations at the same
    # shapes skip the compile
    from onmf_ontf_ndl_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    from onmf_ontf_ndl_tpu.utils import config as cfgs
    from onmf_ontf_ndl_tpu.utils.checkpoint import save_state
    from onmf_ontf_ndl_tpu.utils import viz

    parser = argparse.ArgumentParser(
        prog="onmf-ontf-ndl-tpu",
        description="Online NMF/NTF & network dictionary learning in JAX")
    parser.add_argument("--out-dir", default="out")
    # multi-host launch (same command on every host; see
    # parallel/multihost.py). --distributed alone autodetects where a
    # cluster environment tells JAX its coordinator.
    parser.add_argument("--distributed", action="store_true",
                        help="join the multi-process JAX runtime before "
                             "touching the backend")
    parser.add_argument("--coordinator-address", default=None,
                        help="host:port of process 0's coordinator service")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    sub = parser.add_subparsers(dest="cmd", required=True)

    specs = {
        "image": cfgs.ImageConfig,
        "tensor": cfgs.TensorConfig,
        "ising": cfgs.IsingConfig,
        "network": cfgs.NetworkConfig,
        "video": cfgs.VideoConfig,
    }
    for name, cls in specs.items():
        p = sub.add_parser(name)
        # SUPPRESS so a top-level --out-dir isn't clobbered by the
        # subparser default
        p.add_argument("--out-dir", default=argparse.SUPPRESS)
        p.add_argument("--no-recons", action="store_true")
        _add_fields(p, cls)

    args = parser.parse_args(argv)
    if args.distributed or args.coordinator_address is not None:
        from onmf_ontf_ndl_tpu.parallel import multihost

        multihost.initialize(
            coordinator_address=args.coordinator_address,
            num_processes=args.num_processes, process_id=args.process_id)
        # the CLI subcommands are single-host pipelines (the flag
        # initializes the jax.distributed runtime for the parallel APIs);
        # every process runs the workload, so give non-zero processes
        # their own artifact directory instead of racing on shared files
        if multihost.process_index() != 0:
            args.out_dir = os.path.join(
                args.out_dir, f"proc{multihost.process_index()}")
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = _build_cfg(specs[args.cmd], args)
    app = cfg.build()
    t0 = time.time()
    meta = {"cmd": args.cmd, "config": dataclasses.asdict(cfg)}

    if args.cmd == "image":
        W = app.train_dict()
        viz.display_dictionary(W, cfg.patch_size, is_color=cfg.is_color,
                               save_path=f"{args.out_dir}/dict.png")
        if not args.no_recons:
            if cfg.is_color:
                rec = app.reconstruct_image_color(
                    recons_resolution=cfg.recons_resolution)
            else:
                rec = app.reconstruct_image()
            np.save(f"{args.out_dir}/recons.npy", np.asarray(rec))
        save_state(f"{args.out_dir}/state.npz", app.state)
    elif args.cmd == "tensor":
        W = app.train_dict(mode=cfg.mode, learn_joint_dict=cfg.learn_joint_dict)
        if cfg.learn_joint_dict and cfg.mode == 2:
            viz.display_dictionary(W, cfg.patch_size, is_color=True,
                                   save_path=f"{args.out_dir}/dict.png")
        save_state(f"{args.out_dir}/state.npz", app.state)
    elif args.cmd == "ising":
        _, dict_stack, errors = app.ising_mcmc_learning()
        np.save(f"{args.out_dir}/dict_stack.npy", np.asarray(dict_stack))
        np.save(f"{args.out_dir}/errors.npy", np.asarray(errors))
        viz.display_dictionary(app.W, cfg.patch_size, is_color=False,
                               save_path=f"{args.out_dir}/dict.png")
        save_state(f"{args.out_dir}/state.npz", app.state)
        meta["final_surrogate_error"] = float(np.asarray(errors)[-1])
    elif args.cmd == "network":
        app.train_dict()
        k = cfg.k1 + cfg.k2 + 1
        viz.display_network_dictionary(app.W, k,
                                       save_path=f"{args.out_dir}/dict.png")
        save_state(f"{args.out_dir}/state.npz", app.state)
        if not args.no_recons:
            recon = app.reconstruct_network(recons_iter=cfg.recons_iter,
                                            num_chains=cfg.recons_chains)
            acc = app.compute_recons_accuracy()
            if app.G_recons_edges is not None:
                # sparse (edge-array) form: export an edge list instead
                # of a dense adjacency
                app.write_edgelist(f"{args.out_dir}/recons_edges.txt")
            else:
                np.save(f"{args.out_dir}/recons_adj.npy", np.asarray(recon))
            meta["recons_accuracy"] = acc
    elif args.cmd == "video":
        W = app.train_dict(epochs=cfg.epochs)
        viz.display_dictionary(W, cfg.patch_size, is_color=cfg.is_color,
                               save_path=f"{args.out_dir}/dict.png")
        save_state(f"{args.out_dir}/state.npz", app.state)

    meta["wall_seconds"] = round(time.time() - t0, 2)
    with open(f"{args.out_dir}/run.json", "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    sys.exit(main())
