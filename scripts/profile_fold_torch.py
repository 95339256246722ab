#!/usr/bin/env python3
"""The fold program per linkage backend on the card: the port's counterpart
of `scripts/profile_fold.py`.

One fold group of SHARP_PROFILE_GROUP (default 4) folds of 2,048 cells x
27,998 genes through `core.fold.fold_program` (K=5, p=256, the bench's
configuration: bf16 RP product, forview off, n_cells 1,306,127), for the
backends "rnn" and "rnn_bf16". The expression is the bench's: 38 planted
types, made on the card by `bench_torch.card_generator` (torch generators
seeded as bench.py's keys; the JAX script draws the same recipe with
jax.random), fold t of group g from seed 999 + t. As in the JAX script,
every lane's mask is all true and its real count 2,000, and the RP matrix
is drawn with rN_seed 7 (`ops.rp.ensemble_rp_matrix`, bf16). Each group
is made and synchronised before its window opens; the window closes on a
readback of the program's last output. Reports the first call (group 0)
and four timed groups (1-4), and each backend's launches a group.

Usage:
    python scripts/profile_fold_torch.py                # on the card
    SHARP_PROFILE_GROUP=16 python scripts/profile_fold_torch.py
    python scripts/profile_fold_torch.py --device cpu   # the plain versions (slow at this size)

Prints the JAX script's lines, the card's name and power limit, and the
record as one JSON line (also chiprun_out/profile_fold_torch.json).
Imports nothing of JAX or of the JAX package.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import script_common_torch as common  # noqa: E402
import bench_torch  # noqa: E402

# the JAX script's sizes (scripts/profile_fold.py:26-36)
N_CELLS, N_GENES, K, P_DIM = 1306127, 27998, 5, 256
B, N_TYPES, N_REAL = 2048, 38, 2000
BACKENDS = ("rnn", "rnn_bf16")
TIMED_GROUPS = 4


def config(n_cells=N_CELLS, n_genes=N_GENES, K=K, p=P_DIM):
    from sharp_tpu_torch.config import resolve_config

    return resolve_config(n_cells, n_genes, ensize_K=K, reduced_ndim=p, partition_ncells=2000, rN_seed=7,
                          dtype_compute="bfloat16", forview=False)


def profile(make_group, R_all, cfg, group, dev, backends=BACKENDS, timed_groups=TIMED_GROUPS, n_real=N_REAL):
    """For each backend: the first call on group 0 and `timed_groups` timed
    groups (1..), each group made by make_group(t0, sizes) -> (X (G, B,
    genes), types) on dev. Returns the record and, per backend, the host
    summaries (finalC, k_per, n_meta) of group 0's folds."""
    import torch

    from sharp_tpu_torch.core.fold import fold_program, fold_static_args

    rec, outs = {}, {}
    for backend in backends:
        static = dict(fold_static_args(cfg), linkage_backend=backend)

        def make(g):
            Xg, _ = make_group(g * group, [n_real] * group)
            common.sync(dev)
            return Xg

        Xw = make(0)
        masks = torch.ones(Xw.shape[:2], dtype=torch.bool, device=dev)

        def run(Xg):
            out = fold_program(Xg, masks, [n_real] * group, R_all, True, None, has_indN=False, **static)
            out.n_meta.cpu()   # the window closes on the program's last output
            return out

        t0 = time.perf_counter()
        out = run(Xw)
        first = time.perf_counter() - t0
        outs[backend] = dict(finalC=out.finalC.cpu().numpy(), k_per=out.k_per.cpu().numpy(),
                             n_meta=out.n_meta.cpu().numpy())
        del Xw, out
        ts, before = [], bench_torch.counts()
        for g in range(1, timed_groups + 1):
            Xg = make(g)
            t0 = time.perf_counter()
            run(Xg)
            ts.append(time.perf_counter() - t0)
            del Xg
        ms = 1e3 * float(np.mean(ts))
        rec[backend] = dict(first_s=first, group_ms=[1e3 * t for t in ts], ms_group=ms, ms_fold=ms / group,
                            launches_per_group={k: v / timed_groups
                                                for k, v in common.launches_since(before).items()})
    return rec, outs


def run(dev, group=None):
    """The whole script on dev, at the JAX script's sizes, with a group of
    `group` folds (default SHARP_PROFILE_GROUP, else 4). Returns the
    record."""
    import torch

    from sharp_tpu_torch.ops.rp import ensemble_rp_matrix

    group = int(os.environ.get("SHARP_PROFILE_GROUP", 4)) if group is None else group
    R_all = ensemble_rp_matrix(7, K, N_GENES, P_DIM, dtype=torch.bfloat16, device=dev)
    make_group = bench_torch.card_generator(N_GENES, N_TYPES, B, dev)
    rec, _ = profile(make_group, R_all, config(), group, dev)
    return dict(group=group, shape=[group, B, N_GENES], K=K, p=P_DIM, backends=rec)


def lines(rec):
    out = []
    for backend, r in rec["backends"].items():
        out.append(f"{backend}: first call {r['first_s']:.1f}s")
        out.append(f"{backend}: {r['ms_group']:.0f} ms/group = {r['ms_fold']:.1f} ms/fold (readback-synced, "
                   f"{len(r['group_ms'])} reps: {[round(t) for t in r['group_ms']]}); launches a group "
                   f"{r['launches_per_group']}")
    return out


def main(argv=None):
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    rec = run(dev)
    for line in lines(rec):
        print(line, flush=True)
    common.finish("profile_fold_torch", rec, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
