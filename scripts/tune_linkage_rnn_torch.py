#!/usr/bin/env python3
"""The ladder's knobs on the card: the port's counterpart of
`scripts/tune_linkage_rnn.py`.

Times `ops.linkage.ward_linkage_rnn` over one fold group's GROUP x K lanes
at n_pad 2048 (the JAX script's data: 2,000 real points of 12 planted
types in p 256, numpy seed 5, Pearson distances) with bf16 storage, for
the JAX script's grid of (pair_cap, compact_n, compact_cap), the time of a
batch being the median of 10 calls after a warm-up, each closed by a
synchronise (the JAX script takes the least of 3; the median of 3 moved
the order of the points between runs on the card). Every lane's merge
sequence must be valid.

`compact_cap` sizes the JAX package's round-based tail, which the port's
serial tail (`rnn_tail_kernel`) replaces: the port takes it for signature
parity only, so both values must give identical merges and heights, and
each (pair_cap, compact_n) is timed once, as one point. compact_n 512
drains through the tail kernel's global tier (Cn > 256); pair_cap 512
in f32 storage takes the round's 32-row strip.

Beside the grid, `host_round_counts` (the JAX script's host replica of the
ladder's round structure, float64, copied as it is) on the first lane, and
the port's real rounds per level on that lane, read from the ladder's own
count (`RnnLadder.level_rounds`); the port's last entry is the tail, which
drains its Cn survivors serially in n_alive - 1 merges where the replica
counts rounds of at most compact_cap pairs.

Usage:
    python scripts/tune_linkage_rnn_torch.py                # on the card
    python scripts/tune_linkage_rnn_torch.py --device cpu   # the plain versions (slow at this size)

Prints the JAX script's lines, the card's name and power limit, and the
record as one JSON line (also chiprun_out/tune_linkage_rnn_torch.json).
Imports nothing of JAX or of the JAX package.
"""

import itertools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import script_common_torch as common  # noqa: E402
import bench_torch  # noqa: E402

# the JAX script's shape and grid (scripts/tune_linkage_rnn.py:87-114)
GROUP, K, B, P_DIM = 4, 5, 2048, 256
N_REAL, N_TYPES, SEED = 2000, 12, 5
PAIR_CAPS = (128, 256, 512)
COMPACT_NS = (256, 512)
COMPACT_CAPS = (32, 64)
DEFAULT_POINT = (128, 256)   # the ladder's defaults (pair_cap, compact_n)


def host_round_counts(D, pair_cap, compact_n, compact_cap):
    """Replay the ladder's round structure host-side, counting rounds."""
    n = D.shape[0]
    D = D.copy()
    np.fill_diagonal(D, np.inf)
    alive = np.ones(n, bool)
    sizes = np.ones(n)
    rounds = []
    lvl = n
    C = compact_n

    def one_round(P):
        nn = np.argmin(D, axis=1)
        ar = np.arange(len(nn))
        mutual = (nn[nn] == ar) & alive[: len(nn)]
        lead = mutual & (ar < nn)
        pairs = np.nonzero(lead)[0][:P]
        for a in pairs:
            b = nn[a]
            na, nb = sizes[a], sizes[b]
            h = D[a, b]
            nk = sizes
            new = ((na + nk) * D[a] + (nb + nk) * D[b] - nk * h) / (
                na + nb + nk
            )
            D[a, :] = new
            D[:, a] = new
            D[a, a] = np.inf
            D[b, :] = np.inf
            D[:, b] = np.inf
            alive[b] = False
            sizes[a] = na + nb
        return len(pairs)

    while lvl > C:
        nxt = max(lvl // 2, C)
        r = 0
        while alive.sum() > nxt:
            m = one_round(min(pair_cap, lvl // 2))
            r += 1
            if m == 0:
                break
        rounds.append((lvl, r))
        # compact
        surv = np.nonzero(alive)[0][:nxt]
        D = D[np.ix_(surv, surv)].copy()
        sizes = sizes[surv].copy()
        alive = np.ones(len(surv), bool)
        lvl = nxt
    r = 0
    while alive.sum() > 1:
        m = one_round(compact_cap)
        r += 1
        if m == 0:
            break
    rounds.append((lvl, r))
    return rounds


def make_points(lanes=GROUP * K, n_pad=B, p=P_DIM, n_real=N_REAL, n_types=N_TYPES, seed=SEED):
    """The JAX script's points, drawn with numpy in its order: X (lanes,
    n_pad, p) float32 (rows past n_real zero) and the real mask (n_pad,)."""
    rng = np.random.default_rng(seed)
    types = rng.integers(0, n_types, (lanes, n_real))
    cents = rng.normal(size=(n_types, p)) * 3.0
    X = np.zeros((lanes, n_pad, p), np.float32)
    for i in range(lanes):
        X[i, :n_real] = cents[types[i]] + rng.normal(size=(n_real, p))
    return X, np.arange(n_pad) < n_real


def distances(X, mask, dev):
    """Pearson distances with the pad tiers, (lanes, n_pad, n_pad) on dev."""
    import torch

    from sharp_tpu_torch.ops.distance import pearson_distance

    D = pearson_distance(torch.from_numpy(X).to(dev), torch.from_numpy(mask).to(dev)).contiguous()
    common.sync(dev)
    return D


def port_rounds(D1, pair_cap, compact_n, store):
    """The port's real rounds per level of the ladder over D1 (1, n, n), as
    [(level, rounds), ..., (Cn, tail merges)]: the rounds of each level that
    had a lane active (`RnnLadder.level_rounds`), then the serial tail's
    n_alive - 1 merges."""
    from sharp_tpu_torch.ops.linkage import rnn_ladder

    ladder = rnn_ladder(D1, pair_cap, store, compact_n)
    levels, lvl = [], D1.shape[-1]
    for r in ladder.level_rounds:
        levels.append((lvl, int(r)))
        lvl = max(lvl // 2, compact_n)
    levels.append((ladder.D.shape[-1], int(ladder.alive.sum()) - 1))
    return levels


def replica(D, pair_caps=PAIR_CAPS, compact_n=256, compact_cap=32):
    """host_round_counts on the first lane (float64) beside the port's real
    rounds there (f32 storage), per pair_cap."""
    import torch

    D0 = D[0].double().cpu().numpy()
    return [dict(pair_cap=pc, compact_n=compact_n, compact_cap=compact_cap,
                 replica=host_round_counts(D0.copy(), pc, compact_n, compact_cap),
                 port=port_rounds(D[:1], pc, compact_n, torch.float32))
            for pc in pair_caps]


def grid(D, n_real, dev, pair_caps=PAIR_CAPS, compact_ns=COMPACT_NS, compact_caps=COMPACT_CAPS,
         store=None, reps=10, folds=GROUP):
    """The grid over D (lanes, n, n) with `store` storage (default bf16):
    for each (pair_cap, compact_n), every compact_cap's merges and heights
    identical and every lane's merge sequence valid (else AssertionError),
    then the time of a batch (median of `reps` after a warm-up) and the
    launches of one call. Returns one dict a point, and the links."""
    import torch

    from sharp_tpu_torch.ops.linkage import validate_merge_sequence, ward_linkage_rnn

    store = torch.bfloat16 if store is None else store
    L, n = D.shape[0], D.shape[-1]
    points, links = [], {}
    for pc, cn in itertools.product(pair_caps, compact_ns):
        def run(cc=compact_caps[0]):
            return ward_linkage_rnn(D, pair_cap=pc, store_dtype=store, compact_n=cn, compact_cap=cc)

        before = bench_torch.counts()
        link = run()
        common.sync(dev)
        launches = common.launches_since(before)
        for cc in compact_caps[1:]:
            other = run(cc)
            if not (torch.equal(other.merges, link.merges) and torch.equal(other.heights, link.heights)):
                raise AssertionError(f"pair_cap={pc} compact_n={cn}: compact_cap {cc} and {compact_caps[0]} "
                                     "give different merges")
        errs = {lane: e for lane in range(L)
                if (e := validate_merge_sequence(link.merges[lane], link.heights[lane], n_real, n))}
        if errs:
            raise AssertionError(f"pair_cap={pc} compact_n={cn}: invalid merge sequences {errs}")
        sec, ts, _ = common.timed(run, dev, reps)
        links[pc, cn] = link
        points.append(dict(pair_cap=pc, compact_n=cn, compact_caps=list(compact_caps), ms_batch=1e3 * sec,
                           ms_fold=1e3 * sec / folds, reps_ms=[1e3 * t for t in ts], valid=True,
                           compact_caps_identical=True, launches=launches))
    return points, links


def run(dev, group=GROUP, n_pad=B, p=P_DIM, n_real=N_REAL, pair_caps=PAIR_CAPS, compact_ns=COMPACT_NS,
        reps=10, replica_caps=PAIR_CAPS):
    """The whole script on dev: the replica beside the port's rounds, then
    the grid. Returns the record (and the distances, for chip_smoke)."""
    X, mask = make_points(group * K, n_pad, p, n_real)
    D = distances(X, mask, dev)
    rec = dict(shape=[group * K, n_pad], n_real=n_real, p=p, store="bf16", group=group, K=K,
               rounds=replica(D, replica_caps, min(256, n_pad), 32))
    points, _ = grid(D, n_real, dev, pair_caps, compact_ns, reps=reps, folds=group)
    best = min(points, key=lambda q: q["ms_batch"])
    default = next((q for q in points if (q["pair_cap"], q["compact_n"]) == DEFAULT_POINT), None)
    rec.update(points=points, best=dict(pair_cap=best["pair_cap"], compact_n=best["compact_n"],
                                        ms_batch=best["ms_batch"]))
    if default is not None:
        rec["best"]["vs_default"] = default["ms_batch"] / best["ms_batch"]
    return rec, D


def lines(rec):
    """The JAX script's lines, with the port's rounds beside the replica."""
    out = [f"pair_cap={r['pair_cap']}: rounds per level {r['replica']} (port, real rounds; the tail's "
           f"serial merges last: {r['port']})" for r in rec["rounds"]]
    for q in rec["points"]:
        out.append(f"pair_cap={q['pair_cap']} compact_n={q['compact_n']} compact_cap={q['compact_caps']} "
                   f"(identical merges): {q['ms_batch']:.1f} ms/batch = {q['ms_fold']:.1f} ms/fold valid=yes "
                   f"launches={q['launches']}")
    b = rec["best"]
    out.append(f"best: pair_cap={b['pair_cap']} compact_n={b['compact_n']} {b['ms_batch']:.1f} ms/batch"
               + (f", {b['vs_default']:.3f}x the default 128/256" if "vs_default" in b else ""))
    return out


def main(argv=None):
    args = common.parser(__doc__).parse_args(argv)
    dev = common.device(args.device)
    rec, _ = run(dev)
    for line in lines(rec):
        print(line, flush=True)
    common.finish("tune_linkage_rnn_torch", rec, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
