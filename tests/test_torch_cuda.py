"""The hand-written CUDA kernels of sharp_tpu_torch against their plain versions.

Needs a CUDA card and nvcc; without a card every test skips. This file
imports no JAX, so it also runs where JAX is not installed (the test
package's conftest imports JAX, hence --noconftest there):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Merges, heights and cut snapshots must be identical: the kernels perform
the plain loops' float32 operations in the same order, without fused
multiply-adds.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device (these tests run on the card)")
    return torch.device("cuda")


def _distances(K, n, nreal, p, seed, dev):
    from sharp_tpu_torch.ops.select import prep_distance

    g = torch.Generator(device="cpu").manual_seed(seed)
    Z = torch.zeros((K, n, p))
    Z[:, :nreal] = torch.randn((K, nreal, p), generator=g)
    mask = torch.arange(n) < nreal
    D, _, _ = prep_distance(Z.to(dev), mask.to(dev), symmetric=False)
    return D.contiguous()


def _tied(kind, n, nreal, dev, seed=0):
    """Tie-heavy problems (1, n, n). "wmetac": 1 - the share of 5 member
    labellings that put two points together (six distinct values), as
    wMetaC's similarities are; "smetac": 40 centroids with 25 near-duplicate
    replicas each, half of them exact copies (exact zero distances), as
    sMetaC's fold centroids are."""
    from sharp_tpu_torch.ops.select import prep_distance

    rng = np.random.default_rng(seed)
    mask = torch.arange(n) < nreal
    if kind == "wmetac":
        lab = rng.integers(0, 6, (nreal, 5))
        S = np.zeros((n, n), np.float32)
        S[:nreal, :nreal] = (lab[:, None, :] == lab[None, :, :]).mean(-1)
        D, _, _ = prep_distance(torch.from_numpy(S).to(dev), mask.to(dev), symmetric=True)
    else:
        C = rng.normal(size=(40, 24))
        y = np.arange(nreal) % 40
        noise = 1e-3 * rng.normal(size=(nreal, 24)) * (rng.random((nreal, 1)) < 0.5)
        X = np.zeros((n, 24), np.float32)
        X[:nreal] = C[y] + noise
        D, _, _ = prep_distance(torch.from_numpy(X).to(dev), mask.to(dev), symmetric=False)
    return D[None].contiguous()


def _hold_serial(D, store):
    from sharp_tpu_torch.ops.linkage import ward_linkage
    from sharp_tpu_torch.ops.linkage_cuda import LAUNCHES, ward_linkage_serial

    before = LAUNCHES["ward_serial"]
    got = ward_linkage_serial(D, store_dtype=store)
    torch.cuda.synchronize()
    assert LAUNCHES["ward_serial"] == before + 1
    ref = ward_linkage(D, store_dtype=store)
    assert torch.equal(got.merges, ref.merges)
    assert torch.equal(got.heights, ref.heights)
    return ref


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,n,nreal", [
    (3, 128, 110), (15, 512, 479), (1, 1000, 990), (1, 1024, 1000),
    (2, 200, 200), (1, 256, 240), (2, 257, 257),   # both sides of the shared-memory tier
])
def test_ward_serial_matches_plain(dev, store, K, n, nreal):
    from sharp_tpu_torch.ops.linkage_cuda import ward_linkage_serial

    D = _distances(K, n, nreal, 32, seed=n, dev=dev)
    ref = _hold_serial(D, store)
    one = ward_linkage_serial(D[0], store_dtype=store)
    assert torch.equal(one.merges, ref.merges[0])


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,n,nreal", [("wmetac", 256, 230), ("smetac", 1024, 1000)])
def test_ward_serial_tied_matches_plain(dev, store, kind, n, nreal):
    """Merges and heights identical on tie-heavy problems: the exact row
    cache gives the plain loop's first-index order on every tie."""
    _hold_serial(_tied(kind, n, nreal, dev), store)


def test_ward_serial_bf16_at_2048(dev):
    """bf16 storage at the large tier's padded size, where the JAX package
    runs this kernel for "pallas_bf16"."""
    _hold_serial(_distances(1, 2048, 2000, 32, seed=7, dev=dev), torch.bfloat16)


@pytest.mark.parametrize("n", [5120, 8192])
def test_ward_serial_bf16_up_to_its_largest_n(dev, n):
    """The small tier's largest padded size under the default base_ncells
    (5120) and the largest n whose row state sits in shared memory (8192,
    225 KB)."""
    from sharp_tpu_torch.ops.linkage_cuda import WARD_STATE_SMEM_MAX_N

    assert n <= WARD_STATE_SMEM_MAX_N
    _hold_serial(_distances(1, n, n - 40, 16, seed=n, dev=dev), torch.bfloat16)


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_ward_serial_above_the_shared_state_limit(dev, store):
    """n 8320: the row state in the global scratch (no size cap any more);
    merges and heights identical to the plain loop."""
    from sharp_tpu_torch.ops.linkage_cuda import WARD_STATE_SMEM_MAX_N

    n = 8320
    assert n > WARD_STATE_SMEM_MAX_N
    _hold_serial(_distances(1, n, n - 40, 16, seed=n, dev=dev), store)


def test_gethclust_on_card_above_8192(dev, monkeypatch):
    """gethclust at 8,300 points (n_pad 8704) answers on the card, as in the
    JAX package: its linkage, serial Ward with the row state in the global
    scratch, identical to the plain loop on the same padded matrix, and the
    returned heights its first n - 1."""
    import sharp_tpu_torch
    from sharp_tpu_torch.ops import select
    from sharp_tpu_torch.ops.linkage import ward_linkage

    seen = {}
    real = select.linkage

    def spy(D, backend, method):
        out = real(D, backend, method)
        seen.update(D=D, out=out)
        return out

    monkeypatch.setattr(select, "linkage", spy)
    n = 8300
    rng = np.random.default_rng(n)
    y = rng.integers(0, 6, n)
    X = (3.0 * np.eye(6)[y] @ rng.normal(size=(6, 20)) + 0.5 * rng.normal(size=(n, 20))).astype(np.float32)
    d = (1.0 - np.corrcoef(X)).astype(np.float32)
    got = sharp_tpu_torch.gethclust(d, X, device=dev)
    assert seen["D"].shape == (8704, 8704) and seen["D"].is_cuda
    ref = ward_linkage(seen["D"])
    assert torch.equal(seen["out"].merges, ref.merges)
    assert torch.equal(seen["out"].heights, ref.heights)
    np.testing.assert_array_equal(got["height"], ref.heights.cpu().numpy()[: n - 1])
    assert got["f"].shape == (n,) and 2 <= got["f"].max() <= 40


@pytest.mark.parametrize("ncand", [1, 13, 39])
def test_cutree_kernel_matches_plain(dev, ncand):
    from sharp_tpu_torch.ops.linkage import cutree_multi, cutree_snapshots, ward_linkage
    from sharp_tpu_torch.ops.linkage_cuda import LAUNCHES, cutree_multi_kernel, cutree_snapshots_kernel

    D = _distances(3, 256, 230, 16, seed=1, dev=dev)
    merges = ward_linkage(D).merges
    nr = [230, 200, 150]
    before = LAUNCHES["cutree"]
    got = cutree_snapshots_kernel(merges, nr, minN=2, ncand=ncand)
    assert LAUNCHES["cutree"] == before + 1
    assert torch.equal(got, cutree_snapshots(merges, nr, minN=2, ncand=ncand))
    mask = torch.arange(256, device=dev) < 230
    a = cutree_multi_kernel(merges[0], 230, mask, 40, minN=2, ncand=ncand, nc_pad=48)
    b = cutree_multi(merges[0], 230, mask, 40, minN=2, ncand=ncand, nc_pad=48)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _hold_cutree(merges, nr, routes, ncand=39):
    """The cut replay on the card against the plain replay: identical
    snapshots, one launch, the route of each problem as expected."""
    from sharp_tpu_torch.ops.linkage import cutree_snapshots
    from sharp_tpu_torch.ops.linkage_cuda import LAUNCHES, ROUTES, cutree_snapshots_kernel

    before = LAUNCHES["cutree"]
    got = cutree_snapshots_kernel(merges, nr, minN=2, ncand=ncand)
    torch.cuda.synchronize()
    assert LAUNCHES["cutree"] == before + 1
    assert ROUTES["cutree"].tolist() == routes
    assert torch.equal(got, cutree_snapshots(merges, nr, minN=2, ncand=ncand))
    return got


@pytest.mark.parametrize("n", [4608, 5120, 8192, 20480, 32768])
def test_cutree_kernel_without_size_cap(dev, n):
    """Sizes the old kernel refused (above 4096): the small tier's padded
    4608 and 5120, 8192, 20480, and 32768, where the replay's state leaves
    shared memory for the global scratch. Random viable sequences, one
    with its real points merged first as a padded problem's are."""
    from cutree_model import random_viable_merges

    rng = np.random.default_rng(n)
    nr = [n - 108, n // 2 + 1, 40]
    merges = np.stack([random_viable_merges(rng, n, first=nr[0]), random_viable_merges(rng, n),
                       random_viable_merges(rng, n)])
    _hold_cutree(torch.from_numpy(merges).to(dev), nr, [0, 0, 0])


def test_cutree_kernel_serial_route_and_edges(dev):
    """Non-viable sequences (a j merged away twice, a merge into a dead i)
    take the serial route with identical output; a violation after the
    last snapshot step does not; n_real <= minN leaves every row 0."""
    from cutree_model import chain_merges, random_viable_merges

    rng = np.random.default_rng(3)
    n = 4608
    reused = random_viable_merges(rng, n)
    reused[3000, 1] = reused[1000, 1]
    dead_i = random_viable_merges(rng, n)
    dead_i[4000, 0] = dead_i[20, 1]
    late = random_viable_merges(rng, n)
    late[-1, 1] = late[0, 1]
    merges = torch.from_numpy(np.stack([reused, dead_i, late, chain_merges(n), late])).to(dev)
    nr = torch.tensor([n, n, 4000, n, 2], dtype=torch.int32, device=dev)   # counts on the card
    got = _hold_cutree(merges, nr, [1, 1, 0, 0, 0])
    assert not got[4].any()
    # one host count for all problems: dead_i's fault now lies after the
    # last snapshot step
    _hold_cutree(merges[:3].contiguous(), [4000] * 3, [1, 0, 0])
    odd = torch.from_numpy(random_viable_merges(rng, 1027)[None]).to(dev)   # no 16-byte rows
    _hold_cutree(odd, [1000], [0])


# --- the selection sweep: csrc/sweep.cu ---------------------------------------

def _sweep_problem(dev, n, nreals, maxNs, *, minN=2, ncand=39, nc_pad=48, kind="blobs", seed=0, p=16):
    """A selection of L lanes at n_pad n on the card: D_real, feats_unit, the
    serial-Ward merges and the cut replay's labels, each lane's n_real and
    maxN (tensors). kind "blobs": 12 Gaussian clusters a lane; "tied": a
    wMetaC-like similarity of 5 labellings (six distinct values, so widths
    tie); "dup": blobs whose every point has an exact duplicate."""
    from sharp_tpu_torch.ops.linkage_cuda import cutree_multi_kernel, ward_linkage_serial
    from sharp_tpu_torch.ops.select import prep_distance

    rng = np.random.default_rng(seed)
    L = len(nreals)
    mask = torch.from_numpy(np.arange(n)[None, :] < np.asarray(nreals)[:, None])
    if kind == "tied":
        mat = np.zeros((L, n, n), np.float32)
        for lane, r in enumerate(nreals):
            lab = rng.integers(0, 6, (r, 5))
            mat[lane, :r, :r] = (lab[:, None, :] == lab[None, :, :]).mean(-1)
    else:
        mat = np.zeros((L, n, p), np.float32)
        for lane, r in enumerate(nreals):
            cen = 3.0 * rng.normal(size=(12, p))
            pts = cen[rng.integers(0, 12, r)] + rng.normal(size=(r, p))
            if kind == "dup":
                pts[1::2] = pts[0::2][: r // 2]
            mat[lane, :r] = pts
    mask = mask.to(dev)
    D, D_real, feats = prep_distance(torch.from_numpy(mat).to(dev), mask, symmetric=kind == "tied")
    link = ward_linkage_serial(D.contiguous())
    nr = torch.tensor(nreals, dtype=torch.int32, device=dev)
    mx = torch.tensor(maxNs, dtype=torch.int32, device=dev)
    kw = dict(minN=minN, ncand=ncand, nc_pad=nc_pad)
    cuts = cutree_multi_kernel(link.merges, nr, mask, mx, **kw)
    return (D_real, feats, link.merges, cuts.labels, mask, nr, mx), kw, link, cuts


def _hold_sweep(args, kw):
    """The sweep through its kernels against its plain version on the same
    card: one launch of each kernel, msil bit-equal, CH to 1e-5 relative
    (its two sums run in another order). Returns the kernels' (msil, ch)."""
    from sharp_tpu_torch.ops import silhouette

    before = dict(silhouette.LAUNCHES)
    msil, ch = silhouette.sweep_scores_nested(*args, **kw)
    torch.cuda.synchronize()
    assert {k: silhouette.LAUNCHES[k] - before[k] for k in before} == dict.fromkeys(before, 1)
    pm, pc = silhouette.sweep_scores_nested_plain(*args, **kw)
    assert torch.equal(msil, pm), float((msil - pm).abs().max())
    torch.testing.assert_close(ch, pc, rtol=1e-5, atol=0)
    return msil, ch


# (n, n_real per lane, maxN per lane, the sweep's minN/ncand/nc_pad, kind):
# the shapes the cells reach and the edges
SWEEP_SHAPES = {
    # a fold group of 16 folds x 5 members; the bench's short folds
    "fold_80x2048": (2048, [2000] * 70 + [1063] * 5 + [1064] * 5, [40] * 80, {}, "blobs"),
    # a fold group's wMetaC meta problems; Wang's members, its testlog lane
    # and its wMetaC problem
    "wmetac_16x256": (256, [250 - 3 * g for g in range(16)], [40] * 16, {}, "tied"),
    "wang_15x512": (512, [479] * 15, [40] * 15, {}, "blobs"),
    "wang_1x512": (512, [479], [40], {}, "blobs"),
    "wang_wmetac_1x640": (640, [600], [40], {}, "tied"),
    # the atlas's sMetaC fuses: NC_pad 1536, minN 26, maxN 261
    "smetac_4x1536": (1536, [1500, 1480, 1300, 700], [261] * 4, dict(minN=26, ncand=236, nc_pad=270), "dup"),
    # gethclust's largest padded size
    "gethclust_1x8192": (8192, [8000], [40], {}, "blobs"),
    # n_real well below n_pad, maxN below 40, k == 1 (one real cell), an
    # all-singleton cut (two), exact duplicates
    "edges_8x256": (256, [256, 200, 41, 12, 3, 2, 1, 100], [40, 25, 40, 40, 40, 40, 40, 5], {}, "dup"),
    # every lane's finest cut capped at nc_pad - 1
    "capped_4x512": (512, [500, 480, 300, 60], [40] * 4, dict(nc_pad=16), "blobs"),
}


@pytest.mark.parametrize("shape", list(SWEEP_SHAPES))
def test_sweep_kernels_match_plain(dev, shape):
    n, nreals, maxNs, over, kind = SWEEP_SHAPES[shape]
    args, kw, _, _ = _sweep_problem(dev, n, nreals, maxNs, kind=kind, **over)
    msil, _ = _hold_sweep(args, kw)
    assert msil.shape == (len(nreals), kw.get("ncand", 39))


def test_sweep_kernels_match_the_cpu_copy(dev):
    """The kernels on the card against the plain sweep on a CPU copy of the
    same inputs. The distances are multiples of 1/64, so the sums of the
    one-hot product are exact in any order and msil is bit-equal across
    devices; the cosine products of CH round differently on each device."""
    from sharp_tpu_torch.ops import silhouette

    args, kw, _, _ = _sweep_problem(dev, 512, [479, 300, 60], [40, 40, 12])
    D_real = torch.round(args[0] * 64.0) / 64.0
    args = (D_real, *args[1:])
    msil, ch = _hold_sweep(args, kw)
    cm, cc = silhouette.sweep_scores_nested_plain(*(a.cpu() for a in args), **kw)
    assert torch.equal(msil.cpu(), cm)
    torch.testing.assert_close(ch.cpu(), cc, rtol=1e-4, atol=0)


@pytest.mark.parametrize("sil_thre", [0.35, 1.5], ids=["silhouette", "ch_fallback"])
def test_select_cut_through_the_kernels_matches_plain(dev, monkeypatch, sil_thre):
    """select_cut on the kernels' scores and on the plain sweep's, on the
    card: the chosen candidate, k, labels and maxsil identical, by the
    silhouette rule and by the CH fallback."""
    from sharp_tpu_torch.ops import select, silhouette

    args, kw, link, cuts = _sweep_problem(dev, 512, [479, 400, 200, 41, 3], [40, 40, 40, 20, 40], kind="dup")
    rule = dict(sil_thre=sil_thre, height_Ntimes=2.0, height_tail=10)
    D_real, feats, _, _, mask, nr, mx = args
    got = select.select_cut(D_real, feats, link, cuts, mask, nr, mx, **kw, **rule)
    monkeypatch.setattr(select, "sweep_scores_nested", silhouette.sweep_scores_nested_plain)
    ref = select.select_cut(D_real, feats, link, cuts, mask, nr, mx, **kw, **rule)
    for name in ("oind", "k", "labels", "maxsil", "msil"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def _tail_lanes(L, Cn, dev, seed=0):
    """Compacted-tail-like lanes: the first n_alive slots live, dead slots
    and the diagonal BIG, sizes > 1, running heights, increasing global
    indices, duplicated points (exact ties)."""
    from sharp_tpu_torch.ops.distance import BIG

    g = torch.Generator(device="cpu").manual_seed(seed)
    n_alive = [Cn - (7 * lane) % (Cn // 2) for lane in range(L)]
    D = torch.stack([_distances(1, Cn, na, 16, seed=seed + lane, dev="cpu")[0] for lane, na in enumerate(n_alive)])
    D[:, 1:4] = D[:, 0:1]
    D[:, :, 1:4] = D[:, :, 0:1]
    alive = torch.zeros((L, Cn))
    for lane, na in enumerate(n_alive):
        alive[lane, :na] = 1.0
        D[lane, na:, :] = BIG
        D[lane, :, na:] = BIG
    D[:, torch.arange(Cn), torch.arange(Cn)] = BIG
    sizes = torch.randint(1, 6, (L, Cn), generator=g).float()
    lasth = torch.rand((L, Cn), generator=g) * 0.05
    gidx = torch.sort(torch.randint(0, 4 * Cn, (L, Cn), generator=g), dim=1).values.int()
    return [x.to(dev) for x in (D, alive, sizes, gidx, lasth)], n_alive


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_rnn_tail_kernel_matches_plain(dev, store):
    from sharp_tpu_torch.ops.linkage import rnn_tail
    from sharp_tpu_torch.ops.linkage_cuda import LAUNCHES, rnn_tail_kernel

    (D, *state), n_alive = _tail_lanes(12, 256, dev)
    D = D.to(store)
    before = LAUNCHES["rnn_tail"]
    got = rnn_tail_kernel(D, *state)
    torch.cuda.synchronize()
    assert LAUNCHES["rnn_tail"] == before + 1
    ref = rnn_tail(D, *state)
    for lane, na in enumerate(n_alive):
        for a, b in zip(got, ref):
            assert torch.equal(a[lane, : na - 1], b[lane, : na - 1])
        assert not got[0][lane, na - 1 :].any()


def _hold_tail(D, state, n_alive, routes):
    from sharp_tpu_torch.ops.linkage import rnn_tail
    from sharp_tpu_torch.ops.linkage_cuda import ROUTES, rnn_tail_kernel

    got = rnn_tail_kernel(D, *state)
    torch.cuda.synchronize()
    assert ROUTES["rnn_tail"].tolist() == routes
    ref = rnn_tail(D, *state)
    for lane, na in enumerate(n_alive):
        steps = max(na - 1, 0)
        for a, b in zip(got, ref):
            assert torch.equal(a[lane, :steps], b[lane, :steps])
            assert not a[lane, steps:].any()


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_rnn_tail_kernel_routes(dev, store):
    """Cn 256: lanes of n_alive 2 and 1 and the tied lanes drain from the
    triangle in shared memory; a lane made asymmetric by one ulp takes the
    row route in the same launch. Cn 512: every lane takes the row route."""
    from sharp_tpu_torch.ops.distance import BIG

    (D, *state), n_alive = _tail_lanes(6, 256, dev, seed=4)
    upper = torch.triu(D, 1)
    D = upper + upper.transpose(1, 2)            # exactly symmetric
    for lane, na in ((1, 2), (2, 1)):
        n_alive[lane] = na
        state[0][lane, na:] = 0.0
        D[lane, na:, :] = BIG
        D[lane, :, na:] = BIG
    D[:, torch.arange(256), torch.arange(256)] = BIG
    D = D.to(store)
    bits = D.view(torch.int32 if store == torch.float32 else torch.int16)
    bits[3, 5, 9] += 1                         # D[3, 5, 9] one ulp above D[3, 9, 5]
    _hold_tail(D, state, n_alive, [0, 0, 0, 1, 0, 0])
    (D, *state), n_alive = _tail_lanes(3, 512, dev, seed=5)
    _hold_tail(D.to(store), state, n_alive, [1, 1, 1])


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_ladder_with_kernel_tail_matches_plain_tail(dev, store):
    """The ladder on the card (rounds in the round kernel, tail in the tail
    kernel) against the same rounds finished by the plain tail, against
    plain rounds (round_impl="xla") on the card, and against the whole
    ladder on the CPU."""
    from sharp_tpu_torch.ops.linkage import rnn_ladder, rnn_tail, ward_linkage_rnn
    from sharp_tpu_torch.ops.linkage_cuda import LAUNCHES

    D = _distances(6, 1024, 1000, 24, seed=5, dev=dev)
    before, rounds_before = LAUNCHES["rnn_tail"], LAUNCHES["rnn_round"]
    got = ward_linkage_rnn(D, store_dtype=store)
    torch.cuda.synchronize()
    assert LAUNCHES["rnn_tail"] == before + 1
    assert LAUNCHES["rnn_round"] >= rounds_before + 2   # levels 1024 and 512
    ladder = rnn_ladder(D, store_dtype=store)
    plain = ladder.finish(*rnn_tail(*ladder.tail_inputs()))
    xla = ward_linkage_rnn(D, store_dtype=store, round_impl="xla")
    cpu = ward_linkage_rnn(D.cpu(), store_dtype=store)
    for ref in (plain, xla, cpu):
        assert torch.equal(got.merges.cpu(), ref.merges.cpu())
        assert torch.equal(got.heights.cpu(), ref.heights.cpu())


def _round_ladder(m, dev, store, seed=0):
    """A ladder of four lanes at n_pad m with exact ties: lane 0 coarse
    symmetric distances (many pairs, more than P), lane 1 frozen (all but 8
    clusters merged away, so at most nxt alive), lane 2 all-tied pads (one
    pair a round), lane 3 lane 0 made asymmetric by one step below the
    diagonal (rows a and b must be read as rows)."""
    from sharp_tpu_torch.ops.distance import BIG
    from sharp_tpu_torch.ops.linkage import RnnLadder

    g = torch.Generator(device="cpu").manual_seed(seed)
    up = torch.triu(torch.randint(1, 40, (m, m), generator=g) * 0.03125, 1)
    sym = up + up.T
    D = torch.stack([sym, sym, torch.full((m, m), 0.5), sym + 0.03125 * torch.tril(torch.ones(m, m), -1)])
    ladder = RnnLadder(D.to(dev), store)
    ladder.alive[1, 8:] = False
    ladder.D[1, 8:, :] = BIG
    ladder.D[1, :, 8:] = BIG
    return ladder


def _ladder_copy(ladder):
    import copy

    out = copy.copy(ladder)
    for name in ("D", "alive", "sizes", "gidx", "lasth", "merges", "heights", "cnt", "rounds"):
        setattr(out, name, getattr(ladder, name).clone())
    out.rowcache = None if ladder.rowcache is None else tuple(x.clone() for x in ladder.rowcache)
    out.scratch = None
    out.level_rounds = list(ladder.level_rounds)
    return out


@pytest.mark.parametrize("m", [256, 512, 270])
@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_rnn_round_kernel_matches_plain(dev, store, m):
    """Six rounds of the round kernel against the plain round on a copy of
    the ladder: every field, the row cache and the merge records identical
    after each; the frozen lane untouched; 270 takes the scalar path (not a
    multiple of the vector width)."""
    from sharp_tpu_torch.ops.linkage import rnn_round
    from sharp_tpu_torch.ops.linkage_cuda import LAUNCHES, rnn_round_kernel

    ladder = _round_ladder(m, dev, store)
    frozen = ladder.D[1].clone()
    nxt, P = m // 2, 8
    cnt = []
    for t in range(6):
        ladder.row_cache()
        plain = _ladder_copy(ladder)
        before = dict(LAUNCHES)
        rnn_round_kernel(ladder, nxt, P)
        torch.cuda.synchronize()
        assert LAUNCHES["rnn_round"] == before["rnn_round"] + 1
        assert LAUNCHES["rnn_pairs"] == before["rnn_pairs"] + 1
        rnn_round(plain, nxt, P)
        for name in ("D", "alive", "sizes", "gidx", "lasth", "merges", "heights", "cnt", "rounds"):
            assert torch.equal(getattr(ladder, name), getattr(plain, name)), (t, name)
        assert all(torch.equal(a, b) for a, b in zip(ladder.rowcache, plain.rowcache)), t
        cnt.append(ladder.cnt.tolist())
    assert torch.equal(ladder.D[1], frozen) and int(ladder.rounds[1]) == 0
    assert cnt[0][0] == P                             # more leads than P
    assert [c[2] for c in cnt] == [1, 2, 3, 4, 5, 6]  # one pair a round
    # a round with no lane active changes nothing but the discard slot
    state = _ladder_copy(ladder)
    rnn_round_kernel(ladder, m, P)
    for name in ("D", "alive", "sizes", "lasth", "cnt", "rounds"):
        assert torch.equal(getattr(ladder, name), getattr(state, name)), name
    for name in ("merges", "heights"):
        assert torch.equal(getattr(ladder, name)[:, : m - 1], getattr(state, name)[:, : m - 1]), name


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_rnn_round_kernel_more_pairs_than_threads(dev, store):
    """More pairs a lane than the selection's 1024 threads: at m 2304 every
    point 2i has 2i + 1 as its mutual nearest neighbour (1,152 pairs, P =
    m // 2), so every slot past the block's threads must record its merge,
    kill its dying row and code its columns. Two rounds against the plain
    round on a copy of the ladder: every field and the row cache
    identical."""
    from sharp_tpu_torch.ops.linkage import RnnLadder, rnn_round
    from sharp_tpu_torch.ops.linkage_cuda import rnn_round_kernel

    m = 2304
    g = torch.Generator(device="cpu").manual_seed(7)
    lanes = []
    for _ in range(2):
        up = torch.triu(torch.randint(20, 60, (m, m), generator=g) * 0.03125, 1)
        D = up + up.T
        i = torch.arange(0, m, 2)
        D[i, i + 1] = D[i + 1, i] = 1e-4 * (1 + torch.randperm(m // 2, generator=g).float())
        lanes.append(D)
    ladder = RnnLadder(torch.stack(lanes).to(dev), store)
    nxt, P = 256, m // 2
    for t in range(2):
        ladder.row_cache()
        plain = _ladder_copy(ladder)
        rnn_round_kernel(ladder, nxt, P)
        rnn_round(plain, nxt, P)
        torch.cuda.synchronize()
        for name in ("D", "alive", "sizes", "gidx", "lasth", "merges", "heights", "cnt", "rounds"):
            assert torch.equal(getattr(ladder, name), getattr(plain, name)), (t, name)
        assert all(torch.equal(a, b) for a, b in zip(ladder.rowcache, plain.rowcache)), t
        if t == 0:
            assert ladder.cnt.tolist() == [m // 2, m // 2]
            assert int(ladder.alive.sum()) == m


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_pad_heavy_ladder_reads_every_k_rounds(dev, store, monkeypatch):
    """Lanes of 1000, 500 and 60 real points at n_pad 1024 (the last one's
    pads merge one pair a round): the ladder with kernel rounds reading the
    host every 8 rounds, and every round, against plain rounds on the card:
    merges and heights identical; one launch of each of the round's kernels
    a round; at most 7 rounds a level with no lane active; plain rounds
    read every round."""
    from sharp_tpu_torch.ops import linkage
    from sharp_tpu_torch.ops.linkage import rnn_ladder, rnn_tail
    from sharp_tpu_torch.ops.linkage_cuda import LAUNCHES

    D = torch.cat([_distances(1, 1024, nr, 24, seed=nr, dev=dev) for nr in (1000, 500, 60)])
    links = {}
    assert linkage._read_every(D, True) == 8 and linkage._read_every(D, False) == 1
    real_read_every = linkage._read_every
    for name, k, impl in (("k8", None, "auto"), ("k1", 1, "auto"), ("xla", None, "xla")):
        monkeypatch.setattr(linkage, "_read_every", real_read_every if k is None else lambda D, fused, k=k: k)
        before = dict(LAUNCHES)
        s = rnn_ladder(D, store_dtype=store, round_impl=impl)
        torch.cuda.synchronize()
        launched = LAUNCHES["rnn_round"] - before["rnn_round"]
        assert LAUNCHES["rnn_pairs"] - before["rnn_pairs"] == launched
        real, levels = sum(int(r) for r in s.level_rounds), len(s.level_rounds)
        if name == "k1":
            assert launched == real and s.host_reads == real + levels
        elif name == "k8":
            assert real <= launched <= real + 7 * levels and s.host_reads < real
        else:
            assert launched == 0 and s.host_reads == real + levels
        links[name] = s.finish(*rnn_tail(*s.tail_inputs()))
    for name in ("k1", "xla"):
        assert torch.equal(links["k8"].merges, links[name].merges)
        assert torch.equal(links["k8"].heights, links[name].heights)


def test_unlimited_on_card_matches_cpu(dev, tmp_path):
    """sharp_unlimited over SBLK files on the card (sparse feed and host
    densify) and on the CPU, with the same injected RP matrix: identical
    labels; every kernel of the path launched."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from synth import make_tpm_like

    from sharp_tpu_torch import sharp_unlimited
    from sharp_tpu_torch.io.blocks import save_blocks
    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.parallel import streaming

    X, y = make_tpm_like(n_cells=1500, n_genes=400, n_types=4, seed=5)
    d = str(tmp_path / "blocks")
    save_blocks(d, [X[:800], X[800:]], fmt="sblk")
    rng = np.random.default_rng(2)
    R = {}

    def rp(seed, K, m, p, dtype=torch.float32, device="cpu"):
        if (K, m, p) not in R:
            R[(K, m, p)] = ((rng.random((m, K * p)) < 0.05) * rng.choice([-1.0, 1.0], (m, K * p))).astype(np.float32)
        return torch.from_numpy(R[(K, m, p)]).to(device, dtype)

    real = streaming.ensemble_rp_matrix
    streaming.ensemble_rp_matrix = rp
    kw = dict(rN_seed=3, ensize_K=4, partition_ncells=300, resume=False, linkage_backend="rnn")
    try:
        linkage_cuda.LAUNCHES.update(dict.fromkeys(linkage_cuda.LAUNCHES, 0))
        card = sharp_unlimited(d, device=dev, **kw)
        assert linkage_cuda.LAUNCHES["rnn_round"] > 0 and linkage_cuda.LAUNCHES["rnn_tail"] > 0
        assert linkage_cuda.LAUNCHES["cutree"] > 0
        dense = sharp_unlimited(d, device=dev, sparse_feed=False, **kw)
        cpu = sharp_unlimited(d, device="cpu", **kw)
        serial = sharp_unlimited(d, device=dev, **dict(kw, linkage_backend="auto"))
        assert linkage_cuda.LAUNCHES["ward_serial"] > 0
    finally:
        streaming.ensemble_rp_matrix = real
    np.testing.assert_array_equal(card.pred_clusters, cpu.pred_clusters)
    np.testing.assert_array_equal(card.pred_clusters, dense.pred_clusters)
    assert len(serial.pred_clusters) == 1500


def test_wrappers_refuse_bad_input(dev):
    from sharp_tpu_torch.ops.linkage_cuda import cutree_snapshots_kernel, ward_linkage_serial

    with pytest.raises(TypeError):
        ward_linkage_serial(torch.zeros((4, 4), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        ward_linkage_serial(torch.zeros((8, 8), device=dev).T)  # not contiguous
    with pytest.raises(TypeError):
        ward_linkage_serial(torch.zeros((8, 8), device=dev), store_dtype=torch.float16)
    with pytest.raises(ValueError):
        ward_linkage_serial(torch.zeros((1, 1, 1), device=dev))   # n < 2
    with pytest.raises(TypeError):
        cutree_snapshots_kernel(torch.zeros((1, 3, 2), dtype=torch.int64, device=dev), 4, minN=2, ncand=2)

    from sharp_tpu_torch.ops.linkage_cuda import rnn_tail_kernel

    (D, *state), _ = _tail_lanes(2, 64, dev)
    with pytest.raises(TypeError):
        rnn_tail_kernel(D.double(), *state)
    with pytest.raises(ValueError):
        rnn_tail_kernel(D, state[0], state[1], state[2].long(), state[3])
    big = torch.zeros((1, 1100, 1100), device=dev)
    with pytest.raises(ValueError):
        rnn_tail_kernel(big, *(torch.zeros((1, 1100), device=dev) for _ in range(4)))

    from sharp_tpu_torch.ops.linkage_cuda import rnn_round_kernel

    ladder = _round_ladder(64, dev, torch.float32)
    ladder.row_cache()
    bad = _ladder_copy(ladder)
    bad.D = ladder.D.double()
    with pytest.raises(TypeError):
        rnn_round_kernel(bad, 32, 8)
    bad.D = ladder.D.transpose(1, 2)                # not contiguous
    with pytest.raises(ValueError):
        rnn_round_kernel(bad, 32, 8)
    bad = _ladder_copy(ladder)
    bad.cnt = ladder.cnt.int()
    with pytest.raises(ValueError):
        rnn_round_kernel(bad, 32, 8)
    with pytest.raises(ValueError):
        rnn_round_kernel(ladder, 32, 33)              # P > m // 2

    from sharp_tpu_torch.ops.silhouette import sweep_score_kernel, sweep_scores_nested

    args, kw, _, _ = _sweep_problem(dev, 64, [60, 50], [40, 40])
    with pytest.raises(TypeError):
        sweep_scores_nested(args[0].double(), *args[1:], **kw)
    with pytest.raises(TypeError):
        sweep_scores_nested(*args[:2], args[2].long(), *args[3:], **kw)
    sums = torch.zeros((2, 64, 87), device=dev)
    own = torch.zeros((2, 39, 64), dtype=torch.uint8, device=dev)
    live = torch.zeros((2, 39, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                 # a table not contiguous
        sweep_score_kernel(sums, sums[:, 0], sums.transpose(1, 2).contiguous().transpose(1, 2), own, live, args[4])


def test_sharp_on_card_matches_cpu(dev):
    """The small path on the card and on the CPU, with the same injected
    draws, gives identical labels."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from synth import make_tpm_like

    import sharp_tpu_torch
    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch import carry

    n, genes = 300, 400
    X, y = make_tpm_like(n_cells=n, n_genes=genes, n_types=4, seed=8)
    kw = dict(rN_seed=11, ensize_K=5, prep=False)
    cfg = resolve_config(n, genes, **kw)
    rng = np.random.default_rng(0)
    p = cfg.reduced_ndim
    R = (rng.random((genes, 5 * p)) < 0.05).astype(np.float32) * rng.choice([-1.0, 1.0], (genes, 5 * p))
    probe = carry.testlog_probe_from_jax(
        rng.permutation(n), rng.choice([-1.0, 0.0, 1.0], (genes, p)), n, genes, p, device="cpu"
    )
    a = sharp_tpu_torch.sharp(X, rM=R, testlog_probe=probe, device=dev, **kw)
    b = sharp_tpu_torch.sharp(X, rM=R, testlog_probe=probe, device="cpu", **kw)
    np.testing.assert_array_equal(a.pred_clusters, b.pred_clusters)
    np.testing.assert_array_equal(a.per_member_k, b.per_member_k)


def test_large_tier_on_card_matches_cpu(dev):
    """The large tier (forced by a low base_ncells; folds padded to 512, the
    ladder on every block linkage) on the card and on the CPU, with the
    same injected draws, gives identical labels, member counts and folds."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from synth import make_tpm_like

    import sharp_tpu_torch
    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch import carry
    from sharp_tpu_torch.ops.linkage_cuda import LAUNCHES

    n, genes = 700, 400
    X, y = make_tpm_like(n_cells=n, n_genes=genes, n_types=4, seed=3)
    kw = dict(rN_seed=4, ensize_K=4, prep=False, base_ncells=400, partition_ncells=300,
              linkage_backend="rnn")
    cfg = resolve_config(n, genes, **kw)
    rng = np.random.default_rng(1)
    p = cfg.reduced_ndim
    R = (rng.random((genes, 4 * p)) < 0.05).astype(np.float32) * rng.choice([-1.0, 1.0], (genes, 4 * p))
    draws = dict(
        rM=R,
        testlog_probe=carry.testlog_probe_from_jax(
            rng.permutation(n), rng.choice([-1.0, 0.0, 1.0], (genes, p)), n, genes, p, device="cpu"
        ),
        shuffle_perm=carry.shuffle_perm_from_jax(rng.permutation(n), n),
    )
    before = LAUNCHES["rnn_tail"]
    a = sharp_tpu_torch.sharp(X, device=dev, **draws, **kw)
    assert LAUNCHES["rnn_tail"] > before
    b = sharp_tpu_torch.sharp(X, device="cpu", **draws, **kw)
    np.testing.assert_array_equal(a.pred_clusters, b.pred_clusters)
    np.testing.assert_array_equal(a.per_member_k, b.per_member_k)
    np.testing.assert_array_equal(a.folds, b.folds)


def test_fold_groups_do_not_change_results_on_card(dev):
    """One fold per call and three folds in one call give the same labels
    and member counts on the card (float summaries to float32 rounding: the
    one RP product of a group has another row count)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from synth import make_tpm_like

    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch.parallel.sharded import process_folds_grouped

    X, _ = make_tpm_like(n_cells=600, n_genes=300, n_types=4, seed=6)
    cfg = resolve_config(600, 300, ensize_K=3, partition_ncells=200, rN_seed=2)
    g = torch.Generator(device="cpu").manual_seed(0)
    R = torch.sign(torch.randn((300, 3 * cfg.reduced_ndim), generator=g)).to(dev)
    runs = [process_folds_grouped(X, [200, 200, 200], 256, R, cfg, True, group=k, device=dev) for k in (1, 3)]
    for a, b in zip(*runs):
        for k in ("finalC", "n_meta", "counts", "k_per", "overflow"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        np.testing.assert_allclose(a["cent_sum"], b["cent_sum"], rtol=1e-5, atol=1e-4)


def test_marker_chunk_stats_on_card_equal_cpu(dev):
    """The marker statistics of a chunk on the card and on the CPU: dp, best
    cluster and AUROC identical (exact integer rank and tie sums, the same
    float32 operations), z and the fold change to rtol 1e-5 (the fold
    change's per-cluster means are a float32 matrix product, summed in
    another order by cuBLAS); the same call twice on the card identical."""
    from sharp_tpu_torch.analysis.markers import _gene_chunk_stats

    rng = np.random.default_rng(4)
    n, G, C = 6000, 512, 9
    y = rng.integers(0, C, n)
    X = rng.lognormal(0.5, 1.0, size=(n, G)).astype(np.float32)
    X[rng.random((n, G)) < 0.6] = 0.0
    X[:, :40] = np.round(X[:, :40])          # heavy ties
    X[np.ix_(y == 2, np.arange(50, 60))] *= 20.0
    oh = torch.from_numpy(np.eye(C, dtype=np.float32)[y])
    counts = torch.from_numpy(np.bincount(y, minlength=C).astype(np.float32))
    Xt = torch.from_numpy(X)
    for ng in (1, 4):
        cpu = _gene_chunk_stats(Xt, oh, counts, C=C, ng=ng)
        card = _gene_chunk_stats(Xt.to(dev), oh.to(dev), counts.to(dev), C=C, ng=ng)
        again = _gene_chunk_stats(Xt.to(dev), oh.to(dev), counts.to(dev), C=C, ng=ng)
        for a, b in zip(card, again):
            assert torch.equal(a, b)
        for i in range(3):
            assert torch.equal(card[i].cpu(), cpu[i]), ("dp", "best", "auc")[i]
        for i in (3, 4):
            np.testing.assert_allclose(card[i].cpu().numpy(), cpu[i].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [479, 2000])
def test_gethclust_on_card_equals_cpu(dev, n):
    """gethclust through serial Ward and the cut replay (n_pad 512 and 2048)
    on the card and on the CPU: labels, the chosen cut and the heights
    identical; msil and CH to the tolerance of the sweep's float32 matrix
    products (tests/test_torch_analysis.py)."""
    import sharp_tpu_torch
    from sharp_tpu_torch.ops.linkage_cuda import LAUNCHES

    rng = np.random.default_rng(n)
    y = rng.integers(0, 6, n)
    X = (3.0 * np.eye(6)[y] @ rng.normal(size=(6, 20)) + 0.5 * rng.normal(size=(n, 20))).astype(np.float32)
    d = (1.0 - np.corrcoef(X)).astype(np.float32)
    before = dict(LAUNCHES)
    got = sharp_tpu_torch.gethclust(d, X, device=dev)
    assert LAUNCHES["ward_serial"] == before["ward_serial"] + 1
    assert LAUNCHES["cutree"] == before["cutree"] + 1
    ref = sharp_tpu_torch.gethclust(d, X, device="cpu")
    np.testing.assert_array_equal(got["f"], ref["f"])
    np.testing.assert_array_equal(got["height"], ref["height"])
    assert got["oind"] == ref["oind"]
    np.testing.assert_allclose(got["msil"], ref["msil"], atol=1e-6)
    np.testing.assert_allclose(got["CHind"], ref["CHind"], rtol=1e-4)


@pytest.mark.parametrize("clusters", [30, 40])
def test_global_block_fuse_runs_on_the_card_by_default(dev, monkeypatch, clusters):
    """The global fuse of 26 block summaries at the bench's declared size
    (1,306,127 cells: minN 26, maxN 262), without a device argument: its
    sMetaC inputs and outputs sit on the card, its linkage and cut replay
    launch their kernels (serial Ward at NC_pad 1024 for 26 x 30 clusters,
    the ladder at 1536 for 26 x 40), and the result is the CPU's. The RP
    matrix also defaults to the card."""
    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.ops.rp import ensemble_rp_matrix
    from sharp_tpu_torch.parallel import streaming

    assert ensemble_rp_matrix(7, 2, 100, 8).device.type == "cuda"
    seen = []
    real = streaming.smetac

    def spy(cents, valid, *a, **k):
        out = real(cents, valid, *a, **k)
        seen.append({cents.device.type, valid.device.type, out.tf.device.type, out.n_final.device.type})
        return out

    monkeypatch.setattr(streaming, "smetac", spy)
    cfg = resolve_config(1306127, 27998, ensize_K=5, reduced_ndim=256, partition_ncells=2000, rN_seed=7,
                         dtype_compute="bfloat16", forview=False)
    rng = np.random.default_rng(clusters)
    types = rng.normal(size=(38, 64)) * 3.0
    summaries = []
    for _ in range(26):
        t = rng.integers(0, 38, clusters)
        cents = (types[t] + 0.2 * rng.normal(size=(clusters, 64))).astype(np.float32)
        summaries.append((cents, rng.integers(100, 5000, clusters).astype(np.float64)))
    before = dict(linkage_cuda.LAUNCHES)
    card = streaming.global_block_fuse(summaries, cfg)
    launched = {k: linkage_cuda.LAUNCHES[k] - before[k] for k in before}
    cpu = streaming.global_block_fuse(summaries, cfg, device="cpu")
    assert seen == [{"cuda"}, {"cpu"}]
    linkage = "ward_serial" if clusters == 30 else "rnn_tail"
    assert launched[linkage] == 1 and launched["cutree"] == 1, launched
    if clusters == 40:
        assert launched["rnn_round"] >= 2, launched
    tf, remap = card[0][: 26 * clusters], card[1]
    np.testing.assert_array_equal(remap[tf], cpu[1][cpu[0][: 26 * clusters]])


def _fold_results(rng, T, nclust, nc_pad, p, n_fold):
    """Well-separated synthetic fold summaries, as tests/test_large.py
    makes them (this file imports nothing of the JAX package)."""
    frs = []
    for _ in range(T):
        k = int(rng.integers(max(nclust - 2, 2), nclust + 1))
        counts = np.zeros(nc_pad, np.float32)
        counts[:k] = rng.multinomial(n_fold, np.ones(k) / k)
        cents = np.zeros((nc_pad, p), np.float32)
        cents[:k] = rng.normal(size=(k, p)) * 4.0
        frs.append({
            "finalC": rng.integers(0, k, n_fold).astype(np.int32), "n_meta": k,
            "cent_sum": cents * counts[:, None], "counts": counts,
            "k_per": np.full(3, k, np.int32), "maxsil": np.full(3, 0.5, np.float32), "overflow": False,
        })
    return frs


def test_fuse_folds_positional_n_total_on_card(dev):
    """`fuse_folds(frs, cfg, N)` on the card: N is the block's cell count,
    unused; the labels and cluster count of `fuse_folds(frs, cfg)`, on the
    card and on the CPU."""
    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch.core.large import fuse_folds

    cfg = resolve_config(40000, 1000, ensize_K=3, reduced_ndim=32, partition_ncells=500)
    frs = _fold_results(np.random.default_rng(9), T=4, nclust=6, nc_pad=cfg.nc_pad, p=32, n_fold=500)
    ref = fuse_folds(frs, cfg, device="cpu")
    for got in (fuse_folds(frs, cfg, 2000, device=dev), fuse_folds(frs, cfg, device=dev)):
        np.testing.assert_array_equal(got.labels, ref.labels)
        assert got.n_final == ref.n_final > 1


def test_process_fold_on_card_matches_cpu(dev):
    """The one-fold program on the card and on the CPU with one RP matrix:
    labels, cluster and member counts identical, with indN_cluster kept."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from synth import make_tpm_like

    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch.core.large import process_fold

    X, _ = make_tpm_like(n_cells=200, n_genes=300, n_types=4, seed=6)
    g = torch.Generator(device="cpu").manual_seed(0)
    for indN in (None, 3):
        cfg = resolve_config(200, 300, ensize_K=3, partition_ncells=200, rN_seed=2, indN_cluster=indN)
        R = torch.sign(torch.randn((300, 3 * cfg.reduced_ndim), generator=g))
        a = process_fold(X, 200, 256, R.to(dev), cfg, True, device=dev)
        b = process_fold(X, 200, 256, R, cfg, True, device="cpu")
        for k in ("finalC", "n_meta", "counts", "k_per", "overflow"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        if indN is not None:
            assert (a["k_per"] == indN).all()


@pytest.mark.parametrize("feed", ["dense", "sparse"])
def test_fold_timing_line_on_card(dev, monkeypatch, capsys, feed):
    """SHARP_TPU_FOLD_TIMING=1 on the card: one `[fold-timing]` line with
    the four parts, the fold program's seconds above 0, and the summaries
    of the pass without it."""
    import os
    import re
    import sys

    import scipy.sparse as sp

    sys.path.insert(0, os.path.dirname(__file__))
    from synth import make_tpm_like

    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch.io.sparse import SparseBlock
    from sharp_tpu_torch.parallel.sharded import process_folds_grouped

    X, _ = make_tpm_like(n_cells=600, n_genes=300, n_types=4, seed=6)
    X[X < np.quantile(X, 0.6)] = 0.0
    data = X if feed == "dense" else SparseBlock.from_scipy(sp.csr_matrix(X))
    cfg = resolve_config(600, 300, ensize_K=3, partition_ncells=200, rN_seed=2)
    g = torch.Generator(device="cpu").manual_seed(0)
    R = torch.sign(torch.randn((300, 3 * cfg.reduced_ndim), generator=g)).to(dev)
    plain = process_folds_grouped(data, [200, 200, 200], 256, R, cfg, True, 2, device=dev)
    monkeypatch.setenv("SHARP_TPU_FOLD_TIMING", "1")
    timed = process_folds_grouped(data, [200, 200, 200], 256, R, cfg, True, 2, device=dev)
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("[fold-timing]")]
    assert len(lines) == 1
    parts = dict(re.findall(r"(\w+_s)=(\d+\.\d\d)", lines[0]))
    assert list(parts) == ["slice_s", "transfer_s", "device_s", "readback_s"], lines[0]
    assert float(parts["device_s"]) > 0.0
    for a, b in zip(timed, plain):
        for k in ("finalC", "n_meta", "counts", "k_per", "overflow"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_tracer_counts_on_card(dev):
    """The tracer on the card: the host reads it counts in one sharp() call
    are the device-to-host copies of a CUDA profile of that call, all
    under its API span; the round kernel's launches carry bytes and
    CUDA-event time, which holds each launch's kernels: never less than
    their device time in the trace; the cut replay carries its bytes."""
    import os
    import sys

    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.dirname(__file__))
    from synth import make_tpm_like

    import sharp_tpu_torch
    from sharp_tpu_torch.ops import linkage_cuda
    from sharp_tpu_torch.ops.linkage import ward_linkage_rnn
    from sharp_tpu_torch.utils import timers

    X, _ = make_tpm_like(n_cells=300, n_genes=400, n_types=4, seed=8)
    kw = dict(rN_seed=11, ensize_K=5, exp_type="TPM", device=dev)
    sharp_tpu_torch.sharp(X, **kw)
    torch.cuda.synchronize()
    timers.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sharp_tpu_torch.sharp(X, **kw)
        torch.cuda.synchronize()
    snap = timers.snapshot()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if not str(e.device_type()).endswith("CPU") and not e.is_user_annotation()]
    copies = sum(1 for n in names if "DtoH" in n or "Device -> Host" in n)
    assert snap["host_reads_under"]["api"] == sum(snap["host_reads"].values()) == copies == 7

    def kernel_ms(prof, names):
        return sum(e.end_ns() - e.start_ns() for e in prof.profiler.kineto_results.events()
                   if not str(e.device_type()).endswith("CPU") and any(n in e.name() for n in names)) / 1e6

    timers.reset()
    before = linkage_cuda.LAUNCHES["rnn_round"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ward_linkage_rnn(_distances(3, 512, 500, 16, 3, dev), compact_n=64)
        torch.cuda.synchronize()
    snap = timers.snapshot()
    k = snap["kernels"]["rnn_round"]
    launches = linkage_cuda.LAUNCHES["rnn_round"] - before
    assert launches > 0 and k["bytes"] > 0
    # event stamps resolve to about half a microsecond; 1 us a launch of room
    assert k["ms"] >= kernel_ms(prof, ("rnn_pairs_select", "rnn_pairs_rows", "rnn_round_scatter")) - 1e-3 * launches > 0
    assert 0 < snap["sums"]["ladder.live_lane_rounds"] < snap["sums"]["ladder.launched_lane_rounds"]
    timers.reset()
    merges = torch.stack([torch.zeros(2047, dtype=torch.int32), torch.arange(1, 2048, dtype=torch.int32)], 1)
    with profile(activities=[ProfilerActivity.CUDA]):
        linkage_cuda.cutree_snapshots_kernel(merges.expand(80, 2047, 2).contiguous().to(dev), 2048, minN=2, ncand=39)
    assert timers.snapshot()["kernels"]["cutree"] == {"bytes": linkage_cuda.cutree_bytes(80, 2047, 39), "ms": 0}


# --- the RP product: operand kernel and tensor-core product ------------------

def _cells(n, genes, dev, seed=0, big=False):
    """Expression-like float32 cells: log-normal with a fifth zeros (and,
    with `big`, some values past float16's range)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.empty((n, genes), device=dev).log_normal_(1.0, 2.0, generator=g)
    X[torch.rand((n, genes), generator=g, device=dev) < 0.2] = 0.0
    if big:
        X[torch.rand((n, genes), generator=g, device=dev) < 0.01] = 1e5
    return X


@pytest.mark.parametrize("n,genes", [(256, 27998), (33, 1000), (37, 61)])
@pytest.mark.parametrize("log_transform", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rp_operand_kernel_matches_plain(dev, dtype, log_transform, n, genes):
    """The operand kernel is `log2p1(X).to(dtype)` bit for bit (27,998 genes
    take float2 loads and a ragged octet, 1,000 float2 loads alone, 61
    single loads), and its pad columns are exact zeros."""
    from sharp_tpu_torch.ops import rp

    X = _cells(n, genes, dev, seed=genes, big=not log_transform)
    before = rp.LAUNCHES["rp_operand"]
    got = rp.rp_operand(X, dtype, log_transform)
    torch.cuda.synchronize()
    assert rp.LAUNCHES["rp_operand"] == before + 1
    cols = -(-genes // 8) * 8
    plain = rp.rp_operand_plain(X, dtype, log_transform, cols)
    assert got.shape == plain.shape == (n, cols) and got.dtype == dtype
    assert torch.equal(got.view(torch.int16), plain.view(torch.int16))
    assert torch.equal(got[:, genes:].view(torch.int16), torch.zeros((n, cols - genes), dtype=torch.int16, device=dev))
    with pytest.raises(TypeError):
        rp.rp_operand(X.double(), dtype, log_transform)
    with pytest.raises(TypeError):
        rp.rp_operand(X, torch.float32, log_transform)
    with pytest.raises(ValueError):
        rp.rp_operand(X.T, dtype, log_transform)


def test_rp_tensor_core_product_error(dev):
    """The tensor-core product at a fold's shape, (2,048 x 27,998) x
    (27,998 x 1,280) in bfloat16, is within 1e-6 norm-wise relative error
    of the float64 product of the same rounded operands."""
    from sharp_tpu_torch.ops import rp

    K, p = 5, 256
    X = _cells(2048, 27998, dev)
    R = rp.ensemble_rp_matrix(7, K, 27998, p, dtype=torch.bfloat16, device=dev)
    got = rp.rp_project_ensemble(X, R, K=K, log_transform=True)
    Xb = rp.log2p1(X).to(torch.bfloat16)
    ref = (Xb.double() @ R.double()) / np.sqrt(p)
    ref = ref.reshape(2048, K, p).permute(1, 0, 2)
    err = ((got.double() - ref).norm() / ref.norm()).item()
    assert got.dtype == torch.float32 and got.shape == (K, 2048, p) and got.is_contiguous()
    assert err < 1e-6, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.float8_e4m3fn])
def test_rp_float32_and_float8_routes_unchanged(dev, dtype):
    """A float32 R (TF32 off) and the benchmark control's float8 R keep the
    float32 route: the cells rounded to R's dtype, a float32 torch.matmul,
    the scale; bit for bit, with no operand kernel."""
    from sharp_tpu_torch.ops import rp

    K, p, genes = 3, 40, 1003
    X = _cells(300, genes, dev)
    R = rp.ensemble_rp_matrix(2, K, genes, p, device=dev).to(dtype)
    before = rp.LAUNCHES["rp_operand"]
    for log_transform in (True, False):
        Xc = rp.log2p1(X) if log_transform else X
        ref = torch.matmul(Xc.to(dtype).float(), R.float())
        ref = (ref * torch.tensor(float(p), device=dev).rsqrt()).reshape(300, K, p).permute(1, 0, 2)
        got = rp.rp_project_ensemble(X, R, K=K, log_transform=log_transform)
        # raw cells past float8's range round to NaN on both routes
        torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
        one = (torch.matmul(Xc.to(dtype).float(), R[:, :p].float()) * torch.tensor(float(p), device=dev).rsqrt())
        got = rp.rp_project(X, R[:, :p], log_transform=log_transform)
        torch.testing.assert_close(got, one, rtol=0, atol=0, equal_nan=True)
    assert rp.LAUNCHES["rp_operand"] == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rp_product_unmoved_by_reduction_flags(dev, dtype):
    """cuBLAS's reduced-precision reduction flags concern sums kept in a
    16-bit output; the RP product's output is float32, so at a fold's shape
    (2,048 x 27,998) x (27,998 x 1,280) it is bit for bit the same with
    them on (torch's default) and off, and the call leaves them as they
    were."""
    from sharp_tpu_torch.ops import rp

    mm = torch.backends.cuda.matmul
    saved = [(mm.allow_bf16_reduced_precision_reduction, mm.allow_bf16_reduced_precision_reduction_split_k),
             (mm.allow_fp16_reduced_precision_reduction, mm.allow_fp16_reduced_precision_reduction_split_k)]
    X = _cells(2048, 27998, dev)
    R = rp.ensemble_rp_matrix(7, 5, 27998, 256, dtype=dtype, device=dev)
    try:
        mm.allow_bf16_reduced_precision_reduction = mm.allow_fp16_reduced_precision_reduction = True
        on = rp.rp_project_ensemble(X, R, K=5, log_transform=True)
        assert mm.allow_bf16_reduced_precision_reduction and mm.allow_fp16_reduced_precision_reduction
        mm.allow_bf16_reduced_precision_reduction = mm.allow_fp16_reduced_precision_reduction = False
        off = rp.rp_project_ensemble(X, R, K=5, log_transform=True)
        assert not (mm.allow_bf16_reduced_precision_reduction or mm.allow_fp16_reduced_precision_reduction)
    finally:
        mm.allow_bf16_reduced_precision_reduction = saved[0]
        mm.allow_fp16_reduced_precision_reduction = saved[1]
    assert torch.equal(on, off)


def test_rp_operand_kernel_under_its_operator(dev):
    """The operand kernel's launch is the operator `sharp::rp_operand`:
    the profiler ties the kernel to that host operation, so a span around
    the projection holds the kernel's device time as it holds aten's; and
    R's padded copy is made once for an R, again after R is written."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from sharp_tpu_torch.ops import rp

    X = _cells(512, 27998, dev)
    R = rp.ensemble_rp_matrix(7, 2, 27998, 64, dtype=torch.bfloat16, device=dev)
    first = rp.rp_project_ensemble(X, R, K=2, log_transform=True)
    padded = rp._padded_rows(R, 28000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("rp.span"):
            again = rp.rp_project_ensemble(X, R, K=2, log_transform=True)
        torch.cuda.synchronize()
    assert torch.equal(first, again) and rp._padded_rows(R, 28000) is padded
    events = prof.profiler.kineto_results.events()
    kernels = [e for e in events if "rp_operand_kernel" in e.name()]
    assert len(kernels) == 1 and kernels[0].linked_correlation_id()
    # the profiler's own events may share the id; the operator is among them
    linked = {e.name() for e in events if str(e.device_type()).endswith("CPU")
              and e.correlation_id() == kernels[0].linked_correlation_id()}
    assert "sharp::rp_operand" in linked, linked
    R.mul_(2)
    assert rp._padded_rows(R, 28000) is not padded
    # doubling every entry doubles every product and sum exactly
    assert torch.equal(rp.rp_project_ensemble(X, R, K=2, log_transform=True), 2 * first)


def test_rp_operand_first_call_imports_no_compiler(dev):
    """The operator's first call, in a fresh process, imports none of
    torch's compiler stack (`torch.library.custom_op` would, on its first
    call: seconds of every run's set-up)."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, torch\n"
            "from sharp_tpu_torch.ops import rp\n"
            "rp.rp_operand(torch.ones((4, 9), device='cuda'), torch.bfloat16, True)\n"
            "torch.cuda.synchronize()\n"
            "print(sorted(m for m in ('torch._dynamo', 'torch._inductor') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_rp_tracer_counts_rows_by_route(dev):
    """One atlas-shaped fold group (16 x 2,048 rows x 27,998 genes, K=5,
    p=256, bfloat16) through the fold program: the tracer counts its 32,768
    rows on the tensor-core route and none on the float32 route, and the
    host does not synchronise under `sharp.fold.rp` (the scale was an
    upload that did); a float32
    call counts its rows on the float32 route and none on the other."""
    from torch.profiler import ProfilerActivity, profile

    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch.core.fold import fold_program, fold_static_args
    from sharp_tpu_torch.ops import rp
    from sharp_tpu_torch.utils import timers

    G, B, genes, K, p = 16, 2048, 27998, 5, 256
    cfg = resolve_config(1306127, genes, ensize_K=K, reduced_ndim=p, partition_ncells=2000,
                         dtype_compute="bfloat16", forview=False, rN_seed=7)
    R = rp.ensemble_rp_matrix(7, K, genes, p, dtype=torch.bfloat16, device=dev)
    X = torch.empty((G, B, genes), device=dev)
    for g in range(G):
        X[g] = _cells(B, genes, dev, seed=g)
    masks = torch.arange(B, device=dev)[None, :] < 2000
    masks = masks.expand(G, B).contiguous()
    rp.rp_project_ensemble(X[0, :8], R, K=K, log_transform=True)     # the scale, the kernels
    torch.cuda.synchronize()
    timers.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fold_program(X, masks, [2000] * G, R, True, None, **fold_static_args(cfg))
        out.n_meta.cpu()
    sums = timers.snapshot()["sums"]
    assert sums["rp.tensor_core_rows"] == G * B and "rp.float32_rows" not in sums
    events = [e for e in prof.events() if str(e.device_type).endswith("CPU")]
    spans = [e.time_range for e in events if e.name == "sharp.fold.rp"]
    assert len(spans) == 1
    inside = [e.name for e in events
              if spans[0].start <= e.time_range.start and e.time_range.end <= spans[0].end]
    assert any("Launch" in n for n in inside), inside
    assert not [n for n in inside if "Synchronize" in n], inside

    timers.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        rp.rp_project_ensemble(X[0, :100], R.float(), K=K, log_transform=True)
    sums = timers.snapshot()["sums"]
    assert sums["rp.float32_rows"] == 100 and "rp.tensor_core_rows" not in sums


# --- the dense feed: last, since a profiled large-tier call followed by an
# unprofiled fold pass hides kernels from a later profile in the process ---

def _plain_dense_feed(X, sizes, offsets, group, block_pad, rows, logf, dev, timing, feed=None):
    """The dense feed as a plain gather: each group gathered with numpy into
    a zeroed array and copied to dev from pageable memory."""
    for g0 in range(0, len(sizes), group):
        gsizes = [int(s) for s in sizes[g0 : g0 + group]]
        Xg = np.zeros((len(gsizes), block_pad, X.shape[1]), np.float32)
        for j, sz in enumerate(gsizes):
            Xg[j, :sz] = X[rows[offsets[g0 + j] : offsets[g0 + j] + sz]]
        yield gsizes, torch.from_numpy(Xg).to(dev), logf


def test_dense_feed_on_card_equals_plain_gather(dev, monkeypatch):
    """Fifty groups of four unequal folds through two page-locked slots,
    each group's copies held back on the copy stream by a sleep: every group
    on the card is the plain gather's byte for byte, pad rows included, so
    no slot is refilled before the copy out of it has finished."""
    from sharp_tpu_torch.parallel import sharded

    monkeypatch.setattr(sharded, "_MAX_SLOTS", 2)
    monkeypatch.setattr(sharded, "_FREE_SLOTS", {})
    inner = sharded._group_buffer

    def held_back(*a, **k):
        data = inner(*a, **k)
        torch.cuda._sleep(2_000_000)     # on the copy stream, ahead of the group's copies
        return data

    monkeypatch.setattr(sharded, "_group_buffer", held_back)
    rng = np.random.default_rng(0)
    sizes = rng.integers(100, 257, 200).tolist()
    n = sum(sizes)
    X = rng.standard_normal((n, 1000)).astype(np.float32)
    X[::7, 3] = np.nan
    rows = rng.permutation(n)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    fed = sharded._dense_feed(X, sizes, offsets, 4, 256, rows, True, dev, None)
    plain = _plain_dense_feed(X, sizes, offsets, 4, 256, rows, True, torch.device("cpu"), None)
    groups = 0
    for (gsizes, data, _), (want_sizes, want, _) in zip(fed, plain):
        assert gsizes == want_sizes and data.is_cuda
        assert torch.equal(data.cpu().view(torch.int32), want.view(torch.int32))
        groups += 1
    assert groups == 50
    [sets] = sharded._FREE_SLOTS.values()
    assert [len(s.bufs) for s in sets] == [2] and all(b.is_pinned() for b in sets[0].bufs)


def test_dense_feed_on_card_pins_and_keeps_the_answer(dev, monkeypatch):
    """A large-tier sharp() call on the card in three fold groups: the feed
    copies from page-locked slots only (the tracer's pinned bytes are all
    the bytes copied), and the labels, folds, viE and per-member k and max
    silhouettes are those of the same call fed by a plain gather."""
    import os
    import sys

    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.dirname(__file__))
    from synth import make_tpm_like

    import sharp_tpu_torch
    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch.parallel import sharded
    from sharp_tpu_torch.utils import timers

    n, genes, K, p = 2000, 400, 4, 32
    X, _ = make_tpm_like(n_cells=n, n_genes=genes, n_types=5, seed=12)
    kw = dict(rN_seed=4, ensize_K=K, reduced_ndim=p, prep=False, log_transform=True, base_ncells=400,
              partition_ncells=200, forview=True)
    cfg = resolve_config(n, genes, **kw)
    fold = sharded._fold_bytes(cfg.block_pad, genes, False, K, **sharded._sweep_shape(cfg))
    monkeypatch.setenv("SHARP_TPU_HBM_BUDGET", str(sharded.SWEEP_CHUNK_BYTES + 4 * fold + fold // 2))
    rng = np.random.default_rng(2)
    R = (rng.random((genes, K * p)) < 0.05).astype(np.float32) * rng.choice([-1.0, 1.0], (genes, K * p))
    draws = dict(rM=R, shuffle_perm=torch.from_numpy(rng.permutation(n)))
    lanes, inner = [], sharded.fold_program

    def counted(Xg, *a, **k):
        lanes.append(Xg.shape[0])
        return inner(Xg, *a, **k)

    monkeypatch.setattr(sharded, "fold_program", counted)
    timers.reset()
    with profile(activities=[ProfilerActivity.CUDA]):
        a = sharp_tpu_torch.sharp(X, device=dev, **draws, **kw)
        torch.cuda.synchronize()
    sums = timers.snapshot()["sums"]
    timers.reset()
    assert lanes == [4, 4, 2]
    assert sums["feed.pageable_bytes"] == 0
    assert sums["feed.pinned_bytes"] == sums["feed.copied_bytes"] == 10 * cfg.block_pad * genes * 4
    monkeypatch.setattr(sharded, "_dense_feed", _plain_dense_feed)
    b = sharp_tpu_torch.sharp(X, device=dev, **draws, **kw)
    for key in ("pred_clusters", "folds", "viE", "per_member_k", "per_member_maxsil"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)


def test_sparse_feed_on_card_stages_across_blocks(dev, monkeypatch):
    """sharp_unlimited over four scipy CSR blocks of two folds each, a fold
    a group, on the card: the wire is copied from page-locked sets only
    (the tracer's pinned wire bytes are all its wire bytes) and on the
    feed's own stream; every block's first group but the first is staged
    during the previous block's last; the labels and fold summaries are
    the CPU call's."""
    import os
    import sys

    import scipy.sparse as sp
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.dirname(__file__))
    from synth import make_tpm_like

    import sharp_tpu_torch
    from sharp_tpu_torch.parallel import sharded
    from sharp_tpu_torch.utils import timers

    n, genes, K, p = 2000, 400, 4, 32
    X, _ = make_tpm_like(n_cells=n, n_genes=genes, n_types=5, seed=21)
    X[X < np.quantile(X, 0.7)] = 0.0
    blocks = [sp.csr_matrix(X[b : b + 500]) for b in range(0, n, 500)]
    rng = np.random.default_rng(3)
    R = (rng.random((genes, K * p)) < 0.05).astype(np.float32) * rng.choice([-1.0, 1.0], (genes, K * p))
    kw = dict(rM=R, group=1, rN_seed=4, ensize_K=K, reduced_ndim=p, partition_ncells=250)
    streams, inner = [], sharded._on

    def watched(d, stream):
        streams.append(stream)
        return inner(d, stream)

    monkeypatch.setattr(sharded, "_on", watched)
    timers.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        card = sharp_tpu_torch.sharp_unlimited(blocks, device=dev, **kw)
        torch.cuda.synchronize()
    sums = timers.snapshot()["sums"]
    timers.reset()
    copy_streams = list(streams)
    cpu = sharp_tpu_torch.sharp_unlimited(blocks, device="cpu", **kw)
    assert sums["feed.wire_pinned_bytes"] == sums["feed.wire_bytes"] > 0
    assert sums["feed.block_first_ahead"] == len(blocks) - 1
    assert len(copy_streams) == 2 * len(blocks)
    assert all(s is not None and s != torch.cuda.default_stream(s.device) for s in copy_streams)
    for key in ("pred_clusters", "block_labels", "folds", "fold_labels", "fold_counts", "per_member_k"):
        np.testing.assert_array_equal(getattr(card, key), getattr(cpu, key), err_msg=key)


_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def _launches_under(prof, name):
    """The CUDA launch calls inside each host span `name` of a profile."""
    events = prof.events()
    starts = [e.time_range.start for e in events if e.name in _LAUNCH_CALLS]
    spans = [e for e in events if e.name == name and str(e.device_type).endswith("CPU")]
    return [sum(sp.time_range.start <= t <= sp.time_range.end for t in starts) for sp in spans]


# Last in the file: its profiles around unprofiled fold passes leave the
# process's later profiles without device kernels (PERF.md section 7).
def test_fold_selection_launches(dev, monkeypatch):
    """A fold program on the card: each selection (the members' and
    wMetaC's) launches each sweep kernel once and counts its lanes as
    `select.kernel_lanes`. Under each `sharp.fold.select` and
    `sharp.fold.wmetac.meta.select` span the sweep, everything but the rule
    chain, makes at most 45 CUDA launches (the kernels and the torch
    preamble); the plain sweep made ~1,800. The rule chain's own launches
    are counted on the same lanes with the sweep's scores given."""
    import os
    import sys

    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.dirname(__file__))
    from synth import make_tpm_like

    from sharp_tpu_torch.config import resolve_config
    from sharp_tpu_torch.core.fold import fold_program, fold_static_args
    from sharp_tpu_torch.ops import select, silhouette
    from sharp_tpu_torch.utils import timers

    G, B, genes = 4, 512, 300
    X, _ = make_tpm_like(n_cells=G * 480, n_genes=genes, n_types=5, seed=4)
    cfg = resolve_config(G * 480, genes, rN_seed=1, ensize_K=5)
    Xg = torch.zeros(G, B, genes)
    Xg[:, :480] = torch.from_numpy(X.reshape(G, 480, genes))
    masks = (torch.arange(B) < 480).expand(G, B).contiguous()
    R = torch.sign(torch.randn((genes, 5 * cfg.reduced_ndim), generator=torch.Generator().manual_seed(0)))

    def profiled():
        fold_program(Xg.to(dev), masks.to(dev), [480] * G, R.to(dev), True, **fold_static_args(cfg))
        torch.cuda.synchronize()
        timers.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fold_program(Xg.to(dev), masks.to(dev), [480] * G, R.to(dev), True, **fold_static_args(cfg))
            torch.cuda.synchronize()
        return prof, timers.snapshot()["sums"]

    spans = ("sharp.fold.select", "sharp.fold.wmetac.meta.select")
    before = dict(silhouette.LAUNCHES)
    prof, sums = profiled()
    assert {k: silhouette.LAUNCHES[k] - before[k] for k in before} == dict.fromkeys(before, 2 * 2)
    assert sums["select.kernel_lanes"] == G * 5 + G and not sums.get("select.plain_lanes")
    kernels = {name: _launches_under(prof, name) for name in spans}
    # the rule chain alone: the sweep's scores handed in
    scores = {}
    real_sweep = silhouette.sweep_scores_nested

    def given(D_real, *a, **k):
        key = tuple(D_real.shape)
        if key not in scores:
            scores[key] = real_sweep(D_real, *a, **k)
        return scores[key]

    monkeypatch.setattr(select, "sweep_scores_nested", given)
    chain = {name: _launches_under(profiled()[0], name) for name in spans}
    monkeypatch.setattr(select, "sweep_scores_nested", silhouette.sweep_scores_nested_plain)
    plain = {name: _launches_under(profiled()[0], name) for name in spans}
    print(f"CUDA launches a selection: kernels {kernels}, the rule chain alone {chain}, plain sweep {plain}")
    for name in spans:
        assert len(kernels[name]) == len(chain[name]) == len(plain[name]) == 1, name
        sweep = kernels[name][0] - chain[name][0]
        assert 3 <= sweep <= 45, (name, kernels[name], chain[name])
        assert plain[name][0] - chain[name][0] > 20 * sweep, (name, plain[name], chain[name])
