"""The contract the cut-replay kernel's parallel route relies on, on the CPU.

csrc/cutree.cu replays only the last ncand merge steps, from labels it
finds by pointer jumping over each index's death, wherever the merges up
to the last snapshot step are viable (each merges a live pair, each j
once); any other sequence takes its serial replay. These tests pin that:
the port's linkages emit viable sequences; a numpy model of the kernel's
phases (tests/cutree_model.py) equals the plain replay `cutree_snapshots`
on them, on random viable sequences, on an O(n) chain and on non-viable
sequences; and the port's `cutree_multi` equals the JAX package's at
n_pad 4608, a size the small tier pads to. Cut labels are integers and
must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutree_model import chain_merges, random_viable_merges, snapshot_steps, snapshots_model, viable
from sharp_tpu.ops import linkage as jlink
from sharp_tpu_torch.ops import linkage as tlink
from sharp_tpu_torch.ops.select import prep_distance
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(minN=2, ncand=39)


def _distances(K, n, nreal, seed):
    rng = np.random.default_rng(seed)
    X = np.zeros((K, n, 24), np.float32)
    X[:, :nreal] = rng.normal(size=(K, nreal, 24))
    X[:, 1:4] = X[:, :1]   # exact ties
    mask = torch.arange(n) < nreal
    return prep_distance(torch.from_numpy(X), mask, symmetric=False)[0]


@pytest.fixture(scope="module")
def linkage_merges():
    """Merges of the port's linkages on padded problems: serial Ward in
    f32 and bf16 storage at (3, 256) and the ladder at (2, 512)."""
    D = _distances(3, 256, 230, seed=0)
    D2 = _distances(2, 512, 470, seed=1)
    return {
        "ward_f32": (tlink.ward_linkage(D).merges, [230, 200, 150]),
        "ward_bf16": (tlink.ward_linkage(D, store_dtype=torch.bfloat16).merges, [230, 230, 40]),
        "rnn": (tlink.ward_linkage_rnn(D2, compact_n=64).merges, [470, 300]),
    }


@pytest.mark.parametrize("which", ["ward_f32", "ward_bf16", "rnn"])
def test_linkage_merges_are_viable(linkage_merges, which):
    merges, nr = linkage_merges[which]
    n = merges.shape[1] + 1
    for g, n_real in enumerate(nr):
        assert viable(merges[g].numpy(), snapshot_steps(n_real, n, **KW)[1])


def _hold_model(merges, nr, routes_expected):
    snaps, routes = snapshots_model(np.asarray(merges), nr, **KW)
    ref = tlink.cutree_snapshots(torch.as_tensor(np.asarray(merges)), nr, **KW)
    np.testing.assert_array_equal(snaps, ref.numpy())
    np.testing.assert_array_equal(routes, routes_expected)


@pytest.mark.parametrize("which", ["ward_f32", "ward_bf16", "rnn"])
def test_model_matches_plain_replay_on_linkage_merges(linkage_merges, which):
    merges, nr = linkage_merges[which]
    _hold_model(merges.numpy(), nr, [0] * len(nr))


def test_model_matches_plain_replay_on_random_and_chain_sequences():
    rng = np.random.default_rng(7)
    n = 384
    merges = np.stack([random_viable_merges(rng, n), random_viable_merges(rng, n, first=300),
                       chain_merges(n), random_viable_merges(rng, n)])
    # the chain's labels before t0 are one root at the end of an O(n) chain;
    # n_real = 3 leaves a single snapshot step, n_real <= minN none
    _hold_model(merges, [n, 300, 330, 3], [0, 0, 0, 0])
    _hold_model(merges[:1], [2], [0])
    snaps, _ = snapshots_model(merges, [n, 300, 330, 3], **KW)
    assert snaps[3, 0].any() and not snaps[3, 1:].any()
    assert not snapshots_model(merges[:1], [2], **KW)[0].any()


def test_model_takes_the_serial_route_on_non_viable_sequences():
    rng = np.random.default_rng(8)
    n = 256
    reused = random_viable_merges(rng, n)
    reused[200, 1] = reused[100, 1]              # a j merged away twice
    dead_i = random_viable_merges(rng, n)
    dead_i[220, 0] = dead_i[50, 1]               # a merge into a dead i
    flipped = random_viable_merges(rng, n)[:, ::-1]   # (max, min): survivors die again
    late = random_viable_merges(rng, n)
    late[-1, 1] = late[0, 1]                     # past the last snapshot step: still viable
    merges = np.ascontiguousarray(np.stack([reused, dead_i, flipped, late]))
    _hold_model(merges, [n, n, n, 240], [1, 1, 1, 0])


def test_cutree_multi_matches_jax_at_4608():
    """The shape the kernel's old size cap refused: one problem padded to
    4608, 4,500 real cells merged first, as the small tier makes it."""
    n, nreal = 4608, 4500
    merges = random_viable_merges(np.random.default_rng(9), n, first=nreal)
    mask = np.arange(n) < nreal
    kw = dict(minN=2, ncand=39, nc_pad=48)
    got = tlink.cutree_multi(torch.from_numpy(merges), nreal, torch.from_numpy(mask), 40, **kw)
    ref = jlink.cutree_multi(jnp.asarray(merges), jnp.asarray(nreal), jnp.asarray(mask), jnp.asarray(40), **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.valid.any() and (got.k[got.valid] >= 2).all()
