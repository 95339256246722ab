#!/usr/bin/env python3
"""The linkage backends on the card at the fold shapes: the port's
counterpart of `scripts/bench_linkage_backends.py`, which decided
`resolve_linkage_backend`'s defaults on the TPU.

At (K=5, n_pad 2048, 2,000 real) and (5, 1024, 1,000 real), on the JAX
script's data (numpy seed 0, 12 planted types in p 256, Pearson
distances), times the reciprocal-NN ladder (`ward_linkage_rnn`) with f32
and bf16 storage, and serial Ward (`ward_linkage_fast`, f32; and
`ops.linkage_cuda.ward_linkage_serial` with bf16 storage), the port's
counterparts of the rows the JAX script ran on the TPU as "pallas f32"
and "pallas bf16". The TPU ran serial Ward only up to n 1024 (its VMEM
cap, which `SERIAL_MAX_N` still mirrors); the card's kernel has no cap, so
both rows run at both sizes. Each time is the median of 5 calls after a
warm-up, each closed by a synchronise (the JAX script's `t` takes the mean
of 5 closed by one).

Gates: every merge sequence valid; serial f32's real merges (the first
n_real - 1) identical to the f32 ladder's, except that merges at exactly
tied heights may come in another order (`tied_swaps`: the serial loop
takes a tie's first index first, the ladder the merge its earlier round
recorded): on the card's data at n_pad 2048, lane 0 holds two independent
merges at one float32 height, which the plain versions on the CPU order
the same way.
The crossover: at each size, the faster of serial f32 and the f32 ladder.
`SERIAL_MAX_N` is not changed by this script.

Usage:
    python scripts/bench_linkage_backends_torch.py                # on the card
    python scripts/bench_linkage_backends_torch.py --device cpu   # the plain versions (slow at this size)

Prints the JAX script's lines, the card's name and power limit, and the
record as one JSON line (also chiprun_out/bench_linkage_backends_torch.json).
Imports nothing of JAX or of the JAX package.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import script_common_torch as common  # noqa: E402
import bench_torch  # noqa: E402

# the JAX script's shapes and data (scripts/bench_linkage_backends.py:34-46)
K, P_DIM, N_TYPES, SEED = 5, 256, 12, 0
SIZES = ((2048, 2000), (1024, 1000))
BACKENDS = ("rnn f32", "rnn bf16", "serial f32", "serial bf16")


def make_points(rng, n_pad, n_real, K=K, p=P_DIM, n_types=N_TYPES):
    """One size's points, drawn from rng in the JAX script's order: X (K,
    n_pad, p) float32 (rows past n_real zero) and the real mask."""
    types = rng.integers(0, n_types, n_real)
    cents = rng.normal(size=(n_types, p)) * 3.0
    X = np.zeros((K, n_pad, p), np.float32)
    for k in range(K):
        X[k, :n_real] = cents[types] + rng.normal(size=(n_real, p))
    return X, np.arange(n_pad) < n_real


def linkage_fns(D):
    """The four backends over D (K, n, n), by name."""
    import torch

    from sharp_tpu_torch.ops.linkage import ward_linkage_fast, ward_linkage_rnn
    from sharp_tpu_torch.ops.linkage_cuda import ward_linkage_serial

    return {
        "rnn f32": lambda: ward_linkage_rnn(D),
        "rnn bf16": lambda: ward_linkage_rnn(D, store_dtype=torch.bfloat16),
        "serial f32": lambda: ward_linkage_fast(D),
        "serial bf16": lambda: ward_linkage_serial(D, store_dtype=torch.bfloat16),
    }


def tied_swaps(ma, ha, mb, hb):
    """How far merge sequences a and b (numpy merges (k, 2), heights (k,),
    each sorted by height) differ: the positions whose merges differ, when
    every such position lies in a run of exactly tied heights that spans
    the same positions in both and holds the same merges in both (the
    serial loop orders a tie by first index, the ladder by the round that
    recorded it); None when they differ otherwise."""
    diff = np.nonzero((ma != mb).any(axis=1))[0]
    for i in diff:
        lo, hi = np.searchsorted(ha, ha[i], "left"), np.searchsorted(ha, ha[i], "right")
        if (lo, hi) != (np.searchsorted(hb, hb[i], "left"), np.searchsorted(hb, hb[i], "right")) or (
            sorted(map(tuple, ma[lo:hi].tolist())) != sorted(map(tuple, mb[lo:hi].tolist()))
        ):
            return None
    return len(diff)


def one_size(X, mask, dev, backends=BACKENDS, r=5):
    """The backends over one size's points: the gates (every lane valid;
    serial f32's real merges identical to the f32 ladder's), then each
    backend's ms and launches of one call. Returns the row and the links."""
    import torch

    from sharp_tpu_torch.ops.distance import pearson_distance
    from sharp_tpu_torch.ops.linkage import validate_merge_sequence

    D = pearson_distance(torch.from_numpy(X).to(dev), torch.from_numpy(mask).to(dev)).contiguous()
    n_pad, n_real = D.shape[-1], int(mask.sum())
    fns = linkage_fns(D)
    row = dict(K=D.shape[0], n_pad=n_pad, n_real=n_real, ms={}, launches={})
    links = {}
    for name in backends:
        before = bench_torch.counts()
        links[name] = fns[name]()
        common.sync(dev)
        row["launches"][name] = common.launches_since(before)
        for lane in range(D.shape[0]):
            errs = validate_merge_sequence(links[name].merges[lane], links[name].heights[lane], n_real, n_pad)
            if errs:
                raise AssertionError(f"{name} n={n_pad} lane {lane}: {errs}")
    if "serial f32" in links and "rnn f32" in links:
        k = n_real - 1
        swaps = []
        for lane in range(D.shape[0]):
            a, b = links["serial f32"], links["rnn f32"]
            n = tied_swaps(a.merges[lane, :k].cpu().numpy(), a.heights[lane, :k].cpu().numpy(),
                           b.merges[lane, :k].cpu().numpy(), b.heights[lane, :k].cpu().numpy())
            if n is None:
                raise AssertionError(f"n={n_pad} lane {lane}: serial f32 and the f32 ladder merge differently")
            swaps.append(n)
        row["serial_f32_equals_rnn_f32"] = not any(swaps)
        row["tied_swaps_by_lane"] = swaps
    for name in backends:
        row["ms"][name] = 1e3 * common.timed(fns[name], dev, r)[0]
    if "serial f32" in row["ms"] and "rnn f32" in row["ms"]:
        row["faster_f32"] = "serial" if row["ms"]["serial f32"] < row["ms"]["rnn f32"] else "rnn"
        row["serial_over_rnn_f32"] = row["ms"]["serial f32"] / row["ms"]["rnn f32"]
    return row, links


def run(dev, sizes=SIZES, backends=BACKENDS, r=5, members=K, p=P_DIM):
    """Every size in the JAX script's order, its draws from one numpy
    Generator (seed 0). Returns the record."""
    rng = np.random.default_rng(SEED)
    rows = []
    for n_pad, n_real in sizes:
        X, mask = make_points(rng, n_pad, n_real, members, p)
        rows.append(one_size(X, mask, dev, backends, r)[0])
    return dict(backend=dev.type, rows=rows, crossover={str(row["n_pad"]): row.get("faster_f32") for row in rows})


def lines(rec):
    out = [f"backend: {rec['backend']}"]
    for row in rec["rows"]:
        ms = row["ms"]
        out.append(f"n={row['n_pad']} K={row['K']}: rnn f32 {ms['rnn f32']:7.1f} ms   "
                   f"rnn bf16 {ms['rnn bf16']:7.1f} ms")
        out.append(f"             serial f32 {ms['serial f32']:7.1f} ms   serial bf16 {ms['serial bf16']:7.1f} ms"
                   f"   (faster in f32: {row['faster_f32']}, serial/rnn {row['serial_over_rnn_f32']:.3f})")
    return out


def main(argv=None):
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    rec = run(dev)
    for line in lines(rec):
        print(line, flush=True)
    common.finish("bench_linkage_backends_torch", rec, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
