#!/usr/bin/env python3
"""Where the bench's planted structure loses a cluster, fold by fold, on the
card: the port's counterpart of `scripts/debug_bench_quality.py`.

The bench's synthetic configuration at 65,536 cells x 27,998 genes, 12
planted types, K=5, p=256, folds of 2,000 (bf16 RP product, forview off;
`core.large.fold_sizes` gives 31 folds of 2,000 and two of 1,768, at n_pad
2048). The expression is the bench's recipe (`bench_torch.card_generator`,
torch generators; the JAX script draws it with jax.random), fold t from
seed 999 + t, and the RP matrix is drawn with rN_seed 7 in bf16. The first
NFOLD (default 6) folds go one at a time through `core.fold.fold_program`;
for each, its members' chosen k, their silhouettes, wMetaC's n_meta and
the fold's ARI against the planted types. Then `fuse_folds` over those
folds: its cluster count, its ARI, and the fused labels that cover more
than one planted type (over 50 cells each).

With DUMP=1 the script runs `dump_cents` instead: the same folds, and the
fuse's inputs saved to an .npz (the JAX dump's keys: cent_sum, counts,
finalC, truth, sizes) at --out (default chiprun_out/fuse_debug.npz).

Usage:
    python scripts/debug_bench_quality_torch.py                # on the card
    NFOLD=33 python scripts/debug_bench_quality_torch.py       # every fold
    DUMP=1 python scripts/debug_bench_quality_torch.py --out dump.npz
    python scripts/debug_bench_quality_torch.py --device cpu   # the plain versions (slow at this size)

Prints the JAX script's lines, the card's name and power limit, and the
record as one JSON line (also chiprun_out/debug_bench_quality_torch.json).
Imports nothing of JAX or of the JAX package.
"""

import collections
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import script_common_torch as common  # noqa: E402
import bench_torch  # noqa: E402

# the JAX script's configuration (scripts/debug_bench_quality.py:27-33)
N_CELLS, N_GENES, N_TYPES, K, P_DIM, FOLD = 65536, 27998, 12, 5, 256, 2000


def config(n_cells=N_CELLS, n_genes=N_GENES, K=K, p=P_DIM, fold=FOLD):
    from sharp_tpu_torch.config import resolve_config

    return resolve_config(n_cells, n_genes, ensize_K=K, reduced_ndim=p, partition_ncells=fold, rN_seed=7,
                          dtype_compute="bfloat16", forview=False)


def fold_pass(make_fold, cfg, R_all, nfold, dev):
    """The first nfold folds, one fold_program call each; make_fold(t, B) ->
    (X (B, genes) on dev, planted types (B,) numpy). Returns the folds' host
    summaries, their planted types, their sizes and one record a fold."""
    import torch

    from sharp_tpu_torch.analysis.ari import ari
    from sharp_tpu_torch.config import pad_dim
    from sharp_tpu_torch.core.fold import fold_program, fold_static_args
    from sharp_tpu_torch.core.large import fold_sizes, summary_to_host

    sizes = fold_sizes(cfg.n_cells, cfg.partition_ncells)
    if not 1 <= nfold <= len(sizes):
        raise ValueError(f"NFOLD={nfold}: the configuration has {len(sizes)} folds")
    B = pad_dim(max(sizes))
    static = fold_static_args(cfg)
    frs, truths, folds = [], [], []
    for t in range(nfold):
        X, y = make_fold(t, B)
        mask = torch.arange(B, device=dev) < sizes[t]
        s = fold_program(X, mask, sizes[t], R_all, True, None, has_indN=False, **static)
        fr = summary_to_host(s, sizes[t], forview=False)
        yt = np.asarray(y)[: sizes[t]]
        frs.append(fr)
        truths.append(yt)
        folds.append(dict(fold=t, k_per=fr["k_per"].tolist(), maxsil=np.round(fr["maxsil"], 3).tolist(),
                          n_meta=fr["n_meta"], fold_ARI=ari(yt, fr["finalC"])))
    return frs, truths, sizes, folds


def fuse(frs, truths, sizes, cfg, dev):
    """fuse_folds over the folds: its record (n_final, ARI, the fused labels
    that cover several planted types) and its labels."""
    from sharp_tpu_torch.analysis.ari import ari
    from sharp_tpu_torch.core.large import fuse_folds

    fres = fuse_folds(frs, cfg, n_total=sum(sizes[: len(frs)]), device=dev)
    truth = np.concatenate(truths)
    tab = collections.Counter(zip(truth.tolist(), fres.labels.tolist()))
    types_by_label = collections.defaultdict(set)
    for (ty, lb), c in tab.items():
        if c > 50:
            types_by_label[lb].add(ty)
    mixed = {int(lb): sorted(int(t) for t in tys) for lb, tys in sorted(types_by_label.items()) if len(tys) > 1}
    return dict(n_final=int(fres.n_final), ARI=ari(truth, fres.labels), mixed=mixed), fres.labels


def card_folds(dev, n_genes=N_GENES, n_types=N_TYPES):
    """make_fold on the card: the bench's generator, fold t from seed 999 + t."""
    gens = {}

    def make_fold(t, B):
        if B not in gens:
            gens[B] = bench_torch.card_generator(n_genes, n_types, B, dev)
        Xg, ys = gens[B](t, [B])
        return Xg[0], ys[0].cpu().numpy()

    return make_fold


def rp(dev, cfg):
    import torch

    from sharp_tpu_torch.ops.rp import ensemble_rp_matrix

    return ensemble_rp_matrix(7, cfg.ensize_K, cfg.n_genes, cfg.reduced_ndim, dtype=torch.bfloat16, device=dev)


def _inputs(dev, nfold, cfg, make_fold, R_all):
    """The defaults of run and dump_cents: the JAX script's configuration,
    NFOLD, the bench's generator on dev and the RP matrix of rN_seed 7."""
    cfg = config() if cfg is None else cfg
    nfold = int(os.environ.get("NFOLD", 6)) if nfold is None else nfold
    make_fold = card_folds(dev) if make_fold is None else make_fold
    R_all = rp(dev, cfg) if R_all is None else R_all
    return make_fold, cfg, R_all, nfold


def run(dev, nfold=None, cfg=None, make_fold=None, R_all=None):
    """The fold pass and the fuse. Returns the record and the fused labels."""
    make_fold, cfg, R_all, nfold = _inputs(dev, nfold, cfg, make_fold, R_all)
    frs, truths, sizes, folds = fold_pass(make_fold, cfg, R_all, nfold, dev)
    fused, labels = fuse(frs, truths, sizes, cfg, dev)
    return dict(n_cells=cfg.n_cells, nfold=nfold, sizes=sizes[:nfold], folds=folds, fuse=fused), labels


def dump_cents(outfile, dev, nfold=None, cfg=None, make_fold=None, R_all=None):
    """The fold pass, with the fuse's inputs saved to outfile (.npz): the
    folds' cent_sum and counts stacked, their finalC and planted types
    concatenated, and their sizes."""
    make_fold, cfg, R_all, nfold = _inputs(dev, nfold, cfg, make_fold, R_all)
    frs, truths, sizes, _ = fold_pass(make_fold, cfg, R_all, nfold, dev)
    np.savez(
        outfile,
        cent_sum=np.stack([fr["cent_sum"] for fr in frs]), counts=np.stack([fr["counts"] for fr in frs]),
        finalC=np.concatenate([fr["finalC"] for fr in frs]), truth=np.concatenate(truths),
        sizes=np.asarray(sizes[:nfold]),
    )
    print("saved", outfile, flush=True)


def fold_line(f):
    return (f"fold {f['fold']}: k_per={f['k_per']} maxsil={f['maxsil']} n_meta={f['n_meta']} "
            f"fold_ARI={f['fold_ARI']:.4f}")


def lines(rec):
    out = [fold_line(f) for f in rec["folds"]]
    fz = rec["fuse"]
    out.append(f"fuse over {rec['nfold']} folds: n_final={fz['n_final']} ARI={fz['ARI']:.4f}")
    out += [f"  fused label {lb} covers planted types {tys}" for lb, tys in fz["mixed"].items()]
    return out


def main(argv=None):
    ap = common.parser(__doc__)
    ap.add_argument("--out", default=os.path.join(common.REPO, "chiprun_out", "fuse_debug.npz"),
                    help="the .npz dump_cents writes with DUMP=1")
    args = ap.parse_args(argv)
    dev = common.device(args.device)
    if os.environ.get("DUMP") == "1":
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        dump_cents(args.out, dev)
        common.check_modules()
        return 0
    rec, _ = run(dev)
    for line in lines(rec):
        print(line, flush=True)
    common.finish("debug_bench_quality_torch", rec, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
