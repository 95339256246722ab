"""A numpy model of the cut-replay kernel's two routes, and merge sequences
to test it on.

`snapshots_model` follows csrc/cutree.cu phase by phase: deaths (a), the
viability check (b), the labels before the first snapshot step by pointer
jumping (c) and the short replay (d); a sequence that fails (b) takes the
serial replay from step 0 (e). Numpy only: the card tests import it too.
"""

import numpy as np

NEVER = np.iinfo(np.int32).max


def snapshot_steps(n_real: int, n: int, minN: int, ncand: int):
    """(t0, t1): the first and last steps whose labels are snapshot rows."""
    return max(0, n_real - minN - ncand), min(n_real - 1 - minN, n - 2)


def viable(merges: np.ndarray, t1: int) -> bool:
    """Whether steps 0..t1 of one problem's merges (n-1, 2) merge a live
    pair each, and each j once: indices in range, i != j, neither i nor j
    merged away before."""
    n = merges.shape[0] + 1
    death = np.full(n, NEVER, np.int64)
    for s in range(t1 + 1):
        i, j = (int(v) for v in merges[s])
        if not (0 <= i < n and 0 <= j < n) or i == j or death[i] < s or death[j] != NEVER:
            return False
        death[j] = s
    return True


def snapshots_model(merges: np.ndarray, n_real, *, minN: int, ncand: int):
    """merges (G, n-1, 2) -> (snaps (G, ncand, n) int32, routes (G,) int32),
    0 for the parallel route, 1 for the serial one."""
    G, m, _ = merges.shape
    n = m + 1
    nr = np.broadcast_to(np.asarray(n_real, np.int64).reshape(-1), (G,))
    snaps = np.zeros((G, ncand, n), np.int32)
    routes = np.zeros(G, np.int32)
    for g in range(G):
        mg = merges[g].astype(np.int64)
        t0, t1 = snapshot_steps(int(nr[g]), n, minN, ncand)
        if t0 > t1:
            continue
        if viable(mg, t1):
            # (a) and (c): each index merged away before step t0 points at
            # its survivor, every other index at itself; then jump to roots
            parent = np.arange(n)
            parent[mg[:t0, 1]] = mg[:t0, 0]
            while not np.array_equal(parent[parent], parent):
                parent = parent[parent]
            labels, start = parent, t0
        else:
            routes[g] = 1
            labels, start = np.arange(n), 0
        # (d) the replay of steps start..t1, a row per step from t0 on
        for s in range(start, t1 + 1):
            i, j = mg[s]
            labels = np.where(labels == j, i, labels)
            if s >= t0:
                snaps[g, int(nr[g]) - 1 - minN - s] = labels
    return snaps, routes


def random_viable_merges(rng, n: int, first: int = None) -> np.ndarray:
    """A random viable merge sequence (n-1, 2) of n points: random live
    pairs merged as (min, max). With `first`, the points below it merge
    among themselves before any other, as a padded problem's real points
    do."""
    out = []

    def drain(live):
        while len(live) > 1:
            p = int(rng.integers(len(live)))
            q = int(rng.integers(len(live) - 1))
            q += q >= p
            a, b = live[p], live[q]
            out.append((min(a, b), max(a, b)))
            gone = p if a > b else q
            live[gone] = live[-1]
            live.pop()
        return live

    first = n if first is None else first
    rest = drain([int(x) for x in rng.permutation(first)])
    drain(rest + [int(x) for x in rng.permutation(np.arange(first, n))])
    return np.asarray(out, np.int32)


def chain_merges(n: int) -> np.ndarray:
    """(n-2, n-1), (n-3, n-2), ..., (0, 1): one cluster absorbed step after
    step into clusters of ever smaller index, a chain of length n - 1."""
    i = np.arange(n - 2, -1, -1, dtype=np.int32)
    return np.stack([i, i + 1], axis=1)
