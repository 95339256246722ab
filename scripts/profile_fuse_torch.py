#!/usr/bin/env python3
"""`fuse_folds` at the bench's block shape on the card, the host's share
beside the card's: the port's counterpart of `scripts/profile_fuse.py`.

Fabricates per-fold summaries (`fake_fold_results`, copied from the JAX
script: 25 folds x ~40 clusters, p 256, numpy seed 0, the shape of one
50,000-cell block of the 1.3M bench) for 6 blocks and times
`core.large.fuse_folds` on each, cold (block 0, the first call of the
process's fuse) and warm (all 6); each call ends in the host's labels, so
the host clock closes on a readback. Then the host's share: the same 6
fuses with `core.large.smetac` replaced by a replay of the results it gave
in the warm pass, in call order, so that the fuse's host work (prepare,
finish) is all that runs. The JAX script's mock caches `smetac` by its
static arguments and hands every block of one shape block 0's result; the
replay gives each block its own, so the mocked fuses give the warm fuses'
labels (a gate).

Gates: the cold fuse equals the warm fuse of block 0 (labels and cluster
count); the mocked fuses give the warm fuses' labels.

Usage:
    python scripts/profile_fuse_torch.py                # on the card
    python scripts/profile_fuse_torch.py --device cpu

Prints the JAX script's lines, the card's name and power limit, and the
record as one JSON line (also chiprun_out/profile_fuse_torch.json).
Imports nothing of JAX or of the JAX package.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import script_common_torch as common  # noqa: E402
import bench_torch  # noqa: E402

N_BLOCKS, N_TOTAL = 6, 50000


def fake_fold_results(rng, T=25, nclust=40, nc_pad=48, p=256, n_fold=2000):
    frs = []
    for t in range(T):
        k = int(rng.integers(nclust - 3, nclust + 2))
        counts = np.zeros(nc_pad, np.float32)
        counts[:k] = rng.multinomial(n_fold, np.ones(k) / k)
        cents = np.zeros((nc_pad, p), np.float32)
        cents[:k] = rng.normal(size=(k, p)) * 2.0
        cent_sum = cents * counts[:, None]
        finalC = rng.integers(0, k, n_fold).astype(np.int32)
        frs.append({
            "finalC": finalC,
            "n_meta": k,
            "cent_sum": cent_sum,
            "counts": counts,
            "k_per": np.full(5, k, np.int32),
            "maxsil": np.full(5, 0.5, np.float32),
            "overflow": False,
        })
    return frs


def config():
    """The JAX script's configuration (the bench's, n_cells 1,306,127)."""
    from sharp_tpu_torch.config import resolve_config

    return resolve_config(1306127, 27998, ensize_K=5, reduced_ndim=256, partition_ncells=2000, rN_seed=7,
                          forview=False)


def run(dev, n_blocks=N_BLOCKS, T=25):
    """Cold, warm and mocked fuses of n_blocks fake blocks of T folds.
    Returns the record and the warm fuses' results."""
    from sharp_tpu_torch.core import large

    cfg = config()
    rng = np.random.default_rng(0)
    blocks = [fake_fold_results(rng, T) for _ in range(n_blocks)]

    def fuse(frs):
        t0 = time.perf_counter()
        res = large.fuse_folds(frs, cfg, n_total=N_TOTAL, device=dev)
        return time.perf_counter() - t0, res

    before = bench_torch.counts()
    cold_s, cold = fuse(blocks[0])
    cold_launches = common.launches_since(before)

    real, given = large.smetac, []

    def recording(*a, **k):
        given.append(real(*a, **k))
        return given[-1]

    large.smetac = recording
    try:
        warm = [fuse(frs) for frs in blocks]
    finally:
        large.smetac = real
    if not (np.array_equal(cold.labels, warm[0][1].labels) and cold.n_final == warm[0][1].n_final):
        raise AssertionError("the cold fuse of block 0 differs from its warm fuse")

    replay = iter(given)
    large.smetac = lambda *a, **k: next(replay)
    try:
        mocked = [fuse(frs) for frs in blocks]
    finally:
        large.smetac = real
    for i, ((_, w), (_, m)) in enumerate(zip(warm, mocked)):
        if not np.array_equal(w.labels, m.labels):
            raise AssertionError(f"block {i}: the fuse with smetac replayed gives other labels")
    warm_s = [s for s, _ in warm]
    host_s = float(np.mean([s for s, _ in mocked]))
    warm_mean = float(np.mean(warm_s))
    rec = dict(backend=dev.type, n_blocks=n_blocks, T=T, cold_s=cold_s, warm_s=warm_s, warm_mean_s=warm_mean,
               host_s=host_s, host_share=host_s / warm_mean, cold_launches=cold_launches,
               n_final=[int(r.n_final) for _, r in warm], cold_equals_warm=True, mocked_equals_warm=True)
    return rec, [r for _, r in warm]


def lines(rec):
    out = [f"backend={rec['backend']}", f"block 0 (cold): {rec['cold_s']:.3f}s"]
    out += [f"block {i} (warm path): {s:.3f}s" for i, s in enumerate(rec["warm_s"])]
    out.append(f"host-side prepare+finish per block (smetac replayed): {rec['host_s']:.3f}s "
               f"({100 * rec['host_share']:.1f}% of a warm fuse)")
    return out


def main(argv=None):
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    rec, _ = run(dev)
    for line in lines(rec):
        print(line, flush=True)
    common.finish("profile_fuse_torch", rec, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
