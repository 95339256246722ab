"""Command-line interface: cluster / unlimited / markers / embed.

Counterpart of `sharp_tpu/cli.py`, with the same subcommands, knobs and npz
layouts (a result file written by one CLI reads in the other), and a
`--device` option on each subcommand in place of the JAX package's
SHARP_TPU_PLATFORM switch. The device defaults to "cuda" and a CUDA request
without a card raises, as the API does; `--device cpu` runs the plain
versions on the CPU.

Usage:
    python -m sharp_tpu_torch cluster X.npz --out res.npz [--rN-seed 2103] ...
    python -m sharp_tpu_torch unlimited blocks_dir/ --out res.npz
    python -m sharp_tpu_torch markers X.npz res.npz --out markers.npz
    python -m sharp_tpu_torch embed res.npz --out emb.npz [--plot emb.png]

`X.npz` holds a cells-by-genes array under key "X" (optionally
"gene_names"/"cell_names"); results are written as npz archives. `--plot`
needs matplotlib.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load_matrix(path):
    if path.endswith(".npy"):
        return np.load(path), None, None
    with np.load(path, allow_pickle=True) as z:
        X = z["X"] if "X" in z.files else z[z.files[0]]
        gn = z["gene_names"] if "gene_names" in z.files else None
        cn = z["cell_names"] if "cell_names" in z.files else None
    return X, gn, cn


def _add_device(p):
    p.add_argument(
        "--device", default="cuda",
        help="cuda (default; raises without a card) or cpu",
    )


def _add_knobs(p):
    p.add_argument("--rN-seed", type=int, default=None)
    p.add_argument("--ensize-K", type=int, default=None)
    p.add_argument("--reduced-ndim", type=int, default=None)
    p.add_argument("--N-cluster", type=int, default=None)
    p.add_argument("--base-ncells", type=int, default=None)
    p.add_argument("--partition-ncells", type=int, default=None)
    p.add_argument("--exp-type", type=str, default=None)
    p.add_argument("--n-devices", type=int, default=None,
                   help="run the large tier's folds over this many shards, "
                   "shard d on card d %% device_count() (shards may share a "
                   "card; with --device cpu, all on the CPU); labels as on one device")
    p.add_argument("--dtype-compute", type=str, default=None, dest="dtype_compute",
                   choices=["float32", "bfloat16"],
                   help="input type of the RP product (default float32)")
    p.add_argument(
        "--linkage-backend", type=str, default=None, dest="linkage_backend",
        choices=["auto", "xla", "pallas", "pallas_bf16", "rnn", "rnn_bf16"],
        help="Ward linkage (default: auto, resolved per problem size; see "
        "ops/linkage.py:resolve_linkage_backend)",
    )
    _add_device(p)


def _knobs(args):
    kw = {}
    for k in (
        "rN_seed", "ensize_K", "reduced_ndim", "N_cluster",
        "base_ncells", "partition_ncells", "exp_type", "n_devices",
        "linkage_backend", "dtype_compute",
    ):
        v = getattr(args, k, None)
        if v is not None:
            kw[k] = v
    return kw


def _save_result(path, res, save=np.savez):
    save(
        path,
        pred_clusters=res.pred_clusters,
        x0=res.x0 if res.x0 is not None else np.zeros(0),
        viE=res.viE if res.viE is not None else np.zeros(0),
        paras=json.dumps(res.paras),
        timing=json.dumps(res.timing),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sharp_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("cluster", help="cluster a cells-by-genes matrix")
    pc.add_argument("input")
    pc.add_argument("--out", required=True)
    _add_knobs(pc)

    pu = sub.add_parser("unlimited", help="cluster a directory of blocks")
    pu.add_argument("input")
    pu.add_argument("--out", required=True)
    pu.add_argument(
        "--multihost", action="store_true",
        help="one of several processes over disjoint slices of the blocks "
        "(torch.distributed over gloo, joined from torchrun's MASTER_ADDR, "
        "MASTER_PORT, WORLD_SIZE and RANK; one process without them); "
        "the result holds this process's cells",
    )
    pu.add_argument("--no-resume", action="store_true",
                    help="ignore any existing per-block manifest")
    pu.add_argument(
        "--forview", action="store_true",
        help="keep per-cell viE/x0 view features through the streaming "
        "path so `embed` works on the result",
    )
    _add_knobs(pu)

    pm = sub.add_parser("markers", help="marker genes for a clustering")
    pm.add_argument("input")
    pm.add_argument("result")
    pm.add_argument("--out", required=True)
    pm.add_argument("--plot", default=None)
    _add_device(pm)

    pe = sub.add_parser("embed", help="2-D embedding of a clustering result")
    pe.add_argument("result")
    pe.add_argument("--out", required=True)
    pe.add_argument("--plot", default=None)
    _add_device(pe)

    args = ap.parse_args(argv)

    if args.cmd == "cluster":
        from sharp_tpu_torch.api import sharp

        X, gn, cn = _load_matrix(args.input)
        res = sharp(X, gene_names=gn, cell_names=cn, device=args.device, **_knobs(args))
        _save_result(args.out, res)
        print(res.summary())
    elif args.cmd == "unlimited":
        from sharp_tpu_torch.api import sharp_unlimited

        res = sharp_unlimited(
            args.input, multihost=args.multihost,
            resume=not args.no_resume, forview=args.forview,
            device=args.device, **_knobs(args),
        )
        # compressed: the forview x0 plane is (n_cells, n_glob) and mostly zeros
        _save_result(args.out, res, save=np.savez_compressed)
        print(res.summary())
    elif args.cmd == "markers":
        from sharp_tpu_torch.analysis.markers import get_marker_genes

        X, gn, _ = _load_matrix(args.input)
        with np.load(args.result, allow_pickle=True) as z:
            labels = z["pred_clusters"]
        res = get_marker_genes(X, labels, gene_names=gn, device=args.device)
        np.savez(args.out, **{f"mg_{k}": v for k, v in res.mginfo.items()})
        print(f"{res.n_markers} markers (adaptive AUC >= {res.adauc:.3f})")
        if args.plot:
            from sharp_tpu_torch.analysis.plotting import plot_markers

            plot_markers(res, out=args.plot)
    elif args.cmd == "embed":
        from sharp_tpu_torch.analysis.embed import visualization_embedding
        from sharp_tpu_torch.types import SharpResult

        with np.load(args.result, allow_pickle=True) as z:
            labels = z["pred_clusters"]
            x0 = z["x0"] if "x0" in z.files and z["x0"].size else None
            viE = z["viE"] if "viE" in z.files and z["viE"].size else None
        res = SharpResult(
            pred_clusters=labels, N_pred_cluster=len(np.unique(labels)),
            unique_pred_clusters=[], distr_pred_clusters={},
            x0=x0, viE=viE,
        )
        emb, idx = visualization_embedding(res, device=args.device)
        np.savez(args.out, embedding=emb, cell_indices=idx)
        print(f"embedded {len(idx)} cells")
        if args.plot:
            from sharp_tpu_torch.analysis.plotting import plot_embedding

            plot_embedding(emb, labels[idx], out=args.plot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
