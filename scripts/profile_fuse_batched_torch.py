#!/usr/bin/env python3
"""sMetaC over G blocks at the bench's fuse shapes on the card: the port's
counterpart of `scripts/profile_fuse_batched.py`.

At NC_pad 1024 and 1536, each with G 1 and G 8 blocks of NC_pad - 64
centroids (p 256, numpy seed 0, drawn in the JAX script's order), times
`core.smetac.smetac` with the cluster range that `smetac_range` widens
for the flagship's 1,306,127 cells (minN 26, maxN 262). G 8 is one
batched call, the port's counterpart of the JAX script's `jax.vmap`.
`linkage_backend="auto"` takes serial Ward at NC_pad 1024 and the
reciprocal-NN ladder at 1536 (`resolve_linkage_backend`). The first call
of each shape is reported as such (the JAX script's "compile"); steady is
the median of 3 calls after it, each closed by a synchronise (the JAX
script's the mean of 3 closed by one).

Gate: the G 8 call's labels and cluster count equal, block by block, those
of `smetac` on that block alone.

Usage:
    python scripts/profile_fuse_batched_torch.py                # on the card
    python scripts/profile_fuse_batched_torch.py --device cpu   # the plain versions (slow at this size)

Prints the JAX script's lines, the card's name and power limit, and the
record as one JSON line (also chiprun_out/profile_fuse_batched_torch.json).
Imports nothing of JAX or of the JAX package.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import script_common_torch as common  # noqa: E402
import bench_torch  # noqa: E402

# the JAX script's shapes (scripts/profile_fuse_batched.py:18-33)
N_CELLS, P_DIM, SEED = 1306127, 256, 0
NC_PADS = (1024, 1536)
GS = (1, 8)


def cluster_range(n_cells):
    """(minN, eff_maxN) of the fuse for n_cells (the JAX script's call)."""
    from sharp_tpu_torch.core.smetac import smetac_range

    return smetac_range(n_cells, 2, max(40, -(-n_cells // 5000)), 1 << 30)


def make_blocks(rng, NC_pad, G, minN, eff_maxN, p=P_DIM):
    """G blocks of NC_pad - 64 centroids drawn from rng: (cents (G, NC_pad,
    p), valid (G, NC_pad), NC, maxN, the static knobs)."""
    NC = NC_pad - 64
    cents = np.zeros((G, NC_pad, p), np.float32)
    cents[:, :NC] = rng.normal(size=(G, NC, p)) * 2.0
    valid = np.zeros((G, NC_pad), bool)
    valid[:, :NC] = True
    maxN = min(eff_maxN, NC - 1)
    kw = dict(minN=minN, ncand=max(eff_maxN - minN + 1, 1),
              meta_nc_pad=((min(eff_maxN, NC_pad) + 9) // 8) * 8)
    return cents, valid, NC, maxN, kw


def fuse(cents, valid, NC, maxN, kw, dev):
    """One smetac call: one block when cents is (NC_pad, p), else the
    batch's blocks in one call."""
    import torch

    from sharp_tpu_torch.core.smetac import smetac

    c, v = torch.from_numpy(cents).to(dev), torch.from_numpy(valid).to(dev)
    G = cents.shape[0] if cents.ndim == 3 else None
    return smetac(c, v, NC if G is None else [NC] * G, maxN if G is None else [maxN] * G,
                  sil_thre=0.35, linkage_backend="auto", **kw)


def one_shape(cents, valid, NC, maxN, kw, dev, reps=3):
    """The first call, the steady mean of `reps` and the launches of one
    call of the shape; for G > 1, the gate (each block alone gives the
    batch's labels and count). Returns the row and the output on the host."""
    from sharp_tpu_torch.ops.linkage import resolve_linkage_backend

    G, NC_pad = cents.shape[:2]
    args = (cents[0], valid[0]) if G == 1 else (cents, valid)
    before = bench_torch.counts()
    t0 = time.perf_counter()
    out = fuse(*args, NC, maxN, kw, dev)
    tf, n_final = out.tf.cpu().numpy(), out.n_final.cpu().numpy()
    first = time.perf_counter() - t0
    launches = common.launches_since(before)
    steady = common.timed(lambda: fuse(*args, NC, maxN, kw, dev), dev, reps, warm=0)[0]
    row = dict(NC_pad=NC_pad, G=G, NC=NC, maxN=maxN, **kw, linkage=resolve_linkage_backend("auto", NC_pad),
               first_s=first, steady_s=steady, per_block_s=steady / G, launches=launches,
               n_final=np.atleast_1d(n_final).tolist())
    if G > 1:
        for b in range(G):
            one = fuse(cents[b], valid[b], NC, maxN, kw, dev)
            if not (np.array_equal(one.tf.cpu().numpy(), tf[b]) and int(one.n_final) == int(n_final[b])):
                raise AssertionError(f"NC_pad={NC_pad}: block {b} of the batch of {G} differs from its fuse alone")
        row["blocks_equal_alone"] = True
    return row, dict(tf=tf, n_final=n_final)


def run(dev, nc_pads=NC_PADS, gs=GS, p=P_DIM, reps=3):
    """Every (NC_pad, G) in the JAX script's order, the draws from one
    numpy Generator (seed 0). Returns the record and the outputs."""
    rng = np.random.default_rng(SEED)
    minN, eff_maxN = cluster_range(N_CELLS)
    rows, outs = [], []
    for NC_pad in nc_pads:
        for G in gs:
            data = make_blocks(rng, NC_pad, G, minN, eff_maxN, p)
            row, out = one_shape(*data, dev, reps)
            rows.append(row)
            outs.append(dict(data=data, **out))
    speedup = {}
    for NC_pad in nc_pads:
        per = {r["G"]: r["per_block_s"] for r in rows if r["NC_pad"] == NC_pad}
        if 1 in per and len(per) > 1:
            speedup[str(NC_pad)] = per[1] / per[max(per)]
    rec = dict(backend=dev.type, n_cells=N_CELLS, minN=minN, eff_maxN=eff_maxN, rows=rows,
               batched_speedup=speedup)
    return rec, outs


def lines(rec):
    out = [f"backend={rec['backend']}", f"minN={rec['minN']} eff_maxN={rec['eff_maxN']}"]
    for r in rec["rows"]:
        out.append(f"NC_pad={r['NC_pad']} G={r['G']}: first={r['first_s']:.3f}s steady={r['steady_s']:.3f}s "
                   f"({r['per_block_s']:.3f}s/block) linkage={r['linkage']} launches={r['launches']}")
    out.append(f"per-block speedup of the batched call over one block: {rec['batched_speedup']}")
    return out


def main(argv=None):
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    rec, _ = run(dev)
    for line in lines(rec):
        print(line, flush=True)
    common.finish("profile_fuse_batched_torch", rec, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
