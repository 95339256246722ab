"""Median silhouette and Calinski-Harabasz over candidate cuts.

Counterpart of `sharp_tpu/ops/silhouette.py` (`masked_median`,
`silhouette_median`, `ch_index`, `sweep_scores`, `sweep_scores_nested`).
The reference loops k = 2..40 calling `cluster::silhouette` and
`clues::get_CH` per cut (R/get_opt_hclust.R:129-154). Conventions kept: the
silhouette summary is the *median* of per-cell widths (R-style, mean of the
two middles), singletons get width 0, and CH uses the "1-corr" dispersion
of clues::get_CH.

`sweep_scores` scores each cut of one problem on its own, as the
reference does; it is the reference of `sweep_scores_nested`, which scores
the nested cuts of L problems (lanes) at once and is what the selection
runs. Own-cluster quantities are gathers, not one-hot contractions.

`sweep_scores_nested` launches the sweep's hand-written kernels
(`csrc/sweep.cu`: `sweep_nodes`, `sweep_score`, `sweep_median`) for a CUDA
tensor and takes its plain version, `sweep_scores_nested_plain`, for a CPU
tensor; any other device raises. The kernels launch on the current stream
and do not synchronise; each adds one to its entry of `LAUNCHES` under a
lock (the shards of `parallel/sharded.py` select from several threads).
While a profiler records, the lanes each route took are counted
(`select.kernel_lanes`, `select.plain_lanes` in `timers.snapshot()["sums"]`).
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from sharp_tpu_torch.ops.linkage import counts_per_problem
from sharp_tpu_torch.utils.timers import add

_INF = float("inf")
# the candidate scoring's (lanes, ncand, n, V) temporaries are built this
# many bytes of lanes at a time
SWEEP_CHUNK_BYTES = 512 << 20
# launches of the sweep's kernels, keyed by the kernel's name; on the card only
LAUNCHES = dict.fromkeys(("sweep_nodes", "sweep_score", "sweep_median"), 0)
_LAUNCHES_LOCK = threading.Lock()


def masked_median(x: torch.Tensor, mask: torch.Tensor, n_valid) -> torch.Tensor:
    """Median of x (..., n) over entries where mask, R-style (mean of two
    middles); n_valid an int or a tensor of x's leading shape (a count per
    row, read on the device)."""
    xs = torch.sort(torch.where(mask, x, _INF), dim=-1).values
    if not isinstance(n_valid, torch.Tensor):
        n_valid = torch.full((), n_valid, device=x.device)
    nv = n_valid.expand(x.shape[:-1]).unsqueeze(-1)
    lo = torch.gather(xs, -1, torch.clamp_min((nv - 1) // 2, 0))
    hi = torch.gather(xs, -1, torch.clamp_min(nv // 2, 0))
    return (0.5 * (lo + hi)).squeeze(-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    mu = v.mean(dim=-1, keepdim=True)
    vc = v - mu
    return vc * torch.rsqrt((vc * vc).sum(dim=-1, keepdim=True) + 1e-12)


def _onehot(labels: torch.Tensor, real_mask: torch.Tensor, nc_pad: int) -> torch.Tensor:
    return F.one_hot(labels.long(), nc_pad).to(torch.float32) * real_mask[:, None].to(torch.float32)


def silhouette_median(D_real, labels, real_mask, n_real, nc_pad: int) -> torch.Tensor:
    """Median silhouette width of one labelling of one problem. D_real (n,
    n) with pad rows/cols zeroed and a zero diagonal; labels (n,) dense ids
    in [0, k), padded cells at nc_pad-1."""
    rm = real_mask.to(torch.float32)
    oh = _onehot(labels, real_mask, nc_pad)
    counts = oh.sum(dim=0)
    sums = D_real @ oh                                         # (n, nc_pad)
    own = labels.long()
    own_count = counts[own] * rm
    own_sum = sums.gather(1, own[:, None])[:, 0] * rm
    a = own_sum / torch.clamp_min(own_count - 1.0, 1.0)
    mean_other = sums / torch.clamp_min(counts[None, :], 1.0)
    # exclude own cluster, empty clusters, and the garbage pad slot
    slot = torch.arange(nc_pad, device=D_real.device)[None, :]
    excl = (slot == own[:, None]) | (counts[None, :] < 0.5) | (slot == nc_pad - 1)
    b = torch.where(excl, _INF, mean_other).amin(dim=1)
    s = (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-12)
    s = torch.where(own_count <= 1.5, 0.0, s)                  # singleton convention
    s = torch.where(torch.isfinite(b), s, 0.0)                 # k == 1 edge
    return masked_median(s, real_mask, n_real)


def ch_index(feats_unit, labels, real_mask, n_real, k, nc_pad: int) -> torch.Tensor:
    """Calinski-Harabasz with the 1-corr dispersion (clues::get_CH) of one
    labelling of one problem; feats_unit (n, p) centred unit rows."""
    rm = real_mask.to(torch.float32)
    oh = _onehot(labels, real_mask, nc_pad)
    counts = oh.sum(dim=0)
    cent_u = _unit((oh.T @ feats_unit) / torch.clamp_min(counts[:, None], 1.0))
    # within: sum over cells of (1 - corr(x_i, centroid_own))
    corr_own = (feats_unit @ cent_u.T).gather(1, labels.long()[:, None])[:, 0]
    W = torch.where(real_mask, 1.0 - corr_own, 0.0).sum()
    # between: sum over clusters of n_c * (1 - corr(centroid_c, global mean))
    n_real = torch.as_tensor(n_real, device=feats_unit.device)
    g = (feats_unit * rm[:, None]).sum(dim=0) / torch.clamp_min(n_real, 1)
    corr_cg = (cent_u * _unit(g[None, :])[0][None, :]).sum(dim=-1)
    slot_valid = (counts > 0.5) & (torch.arange(nc_pad, device=counts.device) != nc_pad - 1)
    B = torch.where(slot_valid, counts * (1.0 - corr_cg), 0.0).sum()
    k = torch.as_tensor(k, device=feats_unit.device)
    ch = (B / torch.clamp_min(k - 1.0, 1.0)) / torch.clamp_min(
        W / torch.clamp_min(n_real - k.to(torch.float32), 1.0), 1e-12
    )
    return torch.where((k > 1) & (n_real > k), ch, 0.0)


def sweep_scores(D_real, feats_unit, labels_all, ks, real_mask, n_real, *, nc_pad: int):
    """Median silhouette + CH of every candidate cut of one problem, each
    cut scored on its own. labels_all (ncand, n), ks (ncand,). Returns
    (msil (ncand,), ch (ncand,))."""
    msil = [silhouette_median(D_real, lab, real_mask, n_real, nc_pad) for lab in labels_all]
    ch = [ch_index(feats_unit, lab, real_mask, n_real, k, nc_pad) for lab, k in zip(labels_all, ks)]
    return torch.stack(msil), torch.stack(ch)


def sweep_bytes(lanes: int, n: int, ncand: int, nc_pad: int) -> int:
    """Device bytes the plain sweep holds for `lanes` lanes at n_pad n
    besides its inputs and the SWEEP_CHUNK_BYTES of its scoring: four (n,
    V) float32 node tables and three (ncand, n) per-cut rows a lane, V =
    nc_pad + ncand. The kernels' route holds less (three tables, no
    scoring temporaries), so this bounds both."""
    V = nc_pad + ncand
    return lanes * (4 * n * V * 4 + 3 * ncand * n * 8)


def sweep_scores_nested_plain(
    D_real: torch.Tensor,       # ([L,] n, n) pad rows/cols zeroed, zero diagonal
    feats_unit: torch.Tensor,   # ([L,] n, p) centered unit rows
    merges: torch.Tensor,       # ([L,] n_pad - 1, 2) linkage merge sequences
    labels_all: torch.Tensor,   # ([L,] ncand, n) dense per-cut labels (cutree)
    real_mask: torch.Tensor,    # ([L,] n) bool, or (n,) for every lane
    n_real,                     # int or (L,) tensor
    maxN,                       # int or (L,) tensor
    *,
    minN: int,
    ncand: int,
    nc_pad: int,
):
    """The plain version of `sweep_scores_nested` (on any device): median
    silhouette + CH for every candidate cut of L lanes, using cut nesting.
    Returns (msil ([L,] ncand), ch ([L,] ncand)).

    Cuts k = minN..minN+ncand-1 are nested, so the distinct clusters of a
    lane's sweep are the <= nc_pad clusters of its finest cut plus one new
    node per coarser cut: the per-cluster distance sums are one (n, n) x
    (n, V) product plus ncand column additions, V = nc_pad + ncand. The JAX
    package's `lax.scan` over candidates (vmapped over lanes) is a Python
    loop over the static c = ncand-1..0 here; each step gathers every
    lane's merge, own columns and node rows on the device, so the sweep
    reads nothing back to the host. `n_real` and `maxN` are per lane.
    """
    squeeze = D_real.dim() == 2
    if squeeze:
        D_real, feats_unit, merges, labels_all = (x[None] for x in (D_real, feats_unit, merges, labels_all))
    L, n = D_real.shape[0], D_real.shape[-1]
    V = nc_pad + ncand
    dev = D_real.device
    real_mask = real_mask.expand(L, n)
    rm = real_mask.to(torch.float32)
    nr = counts_per_problem(n_real, L, dev).long()
    mx = counts_per_problem(maxN, L, dev).long()
    lanes = torch.arange(L, device=dev)

    # nc_pad - 1 caps representable cuts: k clusters need dense ids
    # 0..k-1 clear of the reserved garbage slot nc_pad - 1
    kmax_eff = torch.clamp_max(torch.minimum(mx, nr - 1), min(minN + ncand - 1, nc_pad - 1))
    c_fine = torch.clamp(kmax_eff - minN, 0, ncand - 1)
    own = labels_all[lanes, c_fine].long()                     # (L, n)
    oh_fine = F.one_hot(own, V).to(torch.float32) * rm[..., None]
    counts = oh_fine.sum(dim=1)                                # (L, V)
    sums = D_real @ oh_fine                                    # (L, n, V)
    centsum = oh_fine.transpose(1, 2) @ feats_unit             # (L, V, p)
    del oh_fine
    alive = counts > 0.5

    colv = torch.arange(V, device=dev)
    m = merges.shape[1]
    own_all = [None] * ncand
    alive_all = [None] * ncand
    for c in range(ncand - 1, -1, -1):
        apply = c < c_fine                                     # (L,)
        t = torch.clamp(nr - (minN + c) - 1, 0, m - 1)
        ij = merges[lanes, t].long()                           # (L, 2)
        coli = own[lanes, ij[:, 0]]
        colj = own[lanes, ij[:, 1]]
        newslot = nc_pad + c
        sums[:, :, newslot] = torch.where(
            apply[:, None], sums[lanes, :, coli] + sums[lanes, :, colj], sums[:, :, newslot]
        )
        counts[:, newslot] = torch.where(apply, counts[lanes, coli] + counts[lanes, colj], counts[:, newslot])
        centsum[:, newslot] = torch.where(
            apply[:, None], centsum[lanes, coli] + centsum[lanes, colj], centsum[:, newslot]
        )
        merged = (own == coli[:, None]) | (own == colj[:, None])
        own = torch.where(apply[:, None] & merged, newslot, own)
        gone = (colv[None, :] == coli[:, None]) | (colv[None, :] == colj[:, None])
        alive = torch.where(apply[:, None], (alive & ~gone) | (colv == newslot)[None, :], alive)
        own_all[c] = own
        alive_all[c] = alive
    own_all = torch.stack(own_all, dim=1)                      # (L, ncand, n)
    alive_all = torch.stack(alive_all, dim=1)                  # (L, ncand, V)

    # cut-independent node quantities
    cent_u = _unit(centsum / torch.clamp_min(counts[..., None], 1.0))  # (L, V, p)
    FC = feats_unit @ cent_u.transpose(1, 2)                   # (L, n, V)
    g = (feats_unit * rm[..., None]).sum(dim=1) / torch.clamp_min(nr, 1)[:, None]
    g_u = _unit(g)
    corr_cg = (cent_u * g_u[:, None, :]).sum(dim=-1)           # (L, V)
    mean_node = sums / torch.clamp_min(counts, 1.0)[:, None, :]  # (L, n, V)
    nodes_ok = counts > 0.5
    ks = (minN + torch.arange(ncand, device=dev)).to(torch.float32)

    msil, ch = [], []
    chunk = max(1, SWEEP_CHUNK_BYTES // (8 * ncand * n * V))
    for l0 in range(0, L, chunk):
        sl = slice(l0, l0 + chunk)
        own_c = own_all[sl]
        lc = own_c.shape[0]
        rmc = rm[sl, None, :]

        def at_own(node_table):                                # (lc, n, V) -> (lc, ncand, n)
            return node_table[:, None].expand(lc, ncand, n, V).gather(3, own_c[..., None])[..., 0]

        own_sum = at_own(sums[sl]) * rmc
        own_count = counts[sl, None, :].expand(lc, ncand, V).gather(2, own_c) * rmc
        a = own_sum / torch.clamp_min(own_count - 1.0, 1.0)
        excl = (~(alive_all[sl] & nodes_ok[sl, None, :]))[:, :, None, :] | (colv == own_c[..., None])
        b = torch.where(excl, _INF, mean_node[sl, None]).amin(dim=-1)
        del excl
        s = (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-12)
        s = torch.where(own_count <= 1.5, 0.0, s)
        s = torch.where(torch.isfinite(b), s, 0.0)

        corr_own = at_own(FC[sl])
        W = torch.where(real_mask[sl, None, :], 1.0 - corr_own, 0.0).sum(dim=-1)
        Bv = torch.where(
            alive_all[sl] & nodes_ok[sl, None, :],
            counts[sl, None, :] * (1.0 - corr_cg[sl, None, :]), 0.0,
        ).sum(dim=-1)
        nrc = nr[sl, None]
        chc = (Bv / torch.clamp_min(ks - 1.0, 1.0)) / torch.clamp_min(
            W / torch.clamp_min(nrc - ks, 1.0), 1e-12
        )
        ch.append(torch.where((ks > 1) & (nrc > ks), chc, 0.0))
        msil.append(masked_median(s, real_mask[sl, None, :], nrc))
    msil, ch = torch.cat(msil), torch.cat(ch)
    return (msil[0], ch[0]) if squeeze else (msil, ch)


def sweep_scores_nested(
    D_real: torch.Tensor,       # ([L,] n, n) pad rows/cols zeroed, zero diagonal
    feats_unit: torch.Tensor,   # ([L,] n, p) centered unit rows
    merges: torch.Tensor,       # ([L,] n_pad - 1, 2) int32 linkage merge sequences
    labels_all: torch.Tensor,   # ([L,] ncand, n) int32 dense per-cut labels (cutree)
    real_mask: torch.Tensor,    # ([L,] n) bool, or (n,) for every lane
    n_real,                     # int or (L,) tensor
    maxN,                       # int or (L,) tensor
    *,
    minN: int,
    ncand: int,
    nc_pad: int,
):
    """Median silhouette + CH for every candidate cut of L lanes, using cut
    nesting. Returns (msil ([L,] ncand), ch ([L,] ncand)).

    On a CUDA tensor: the finest cut's one-hot and its three products in
    torch, as in the plain version, then the three kernels of
    `csrc/sweep.cu` in place of its candidate loop and chunked scoring:
    `msil` is bit-equal to `sweep_scores_nested_plain` on the same device,
    `ch` equal up to the order of its two sums. On a CPU tensor: the plain
    version. Nothing is read back to the host.
    """
    squeeze = D_real.dim() == 2
    L = 1 if squeeze else D_real.shape[0]
    if D_real.device.type == "cpu":
        add("select.plain_lanes", L)
        return sweep_scores_nested_plain(
            D_real, feats_unit, merges, labels_all, real_mask, n_real, maxN,
            minN=minN, ncand=ncand, nc_pad=nc_pad,
        )
    if D_real.device.type != "cuda":
        raise ValueError(f"unsupported device {D_real.device} (cpu or cuda)")
    if D_real.dtype != torch.float32 or feats_unit.dtype != torch.float32:
        raise TypeError(f"sweep_scores_nested takes float32 D_real and feats_unit, got "
                        f"{D_real.dtype} and {feats_unit.dtype}")
    if squeeze:
        D_real, feats_unit, merges, labels_all = (x[None] for x in (D_real, feats_unit, merges, labels_all))
    add("select.kernel_lanes", L)
    msil, ch = _sweep_on_card(D_real, feats_unit, merges, labels_all, real_mask, n_real, maxN,
                              minN=minN, ncand=ncand, nc_pad=nc_pad)
    return (msil[0], ch[0]) if squeeze else (msil, ch)


def _sweep_on_card(D_real, feats_unit, merges, labels_all, real_mask, n_real, maxN, *,
                   minN: int, ncand: int, nc_pad: int):
    """`sweep_scores_nested` of L lanes (L, n, .) on the card: the torch
    preamble and node quantities around the three kernels."""
    L, n = D_real.shape[0], D_real.shape[-1]
    V = nc_pad + ncand
    dev = D_real.device
    real_mask = real_mask.expand(L, n).contiguous()
    rm = real_mask.to(torch.float32)
    nr = counts_per_problem(n_real, L, dev)
    mx = counts_per_problem(maxN, L, dev)

    # the finest cut each lane scores, and its one-hot: the plain version's
    # values, so the products below are its products
    kmax_eff = torch.clamp_max(torch.minimum(mx, nr - 1), min(minN + ncand - 1, nc_pad - 1))
    c_fine = torch.clamp(kmax_eff - minN, 0, ncand - 1)
    fine = torch.gather(labels_all, 1, c_fine.long()[:, None, None].expand(L, 1, n))
    oh = torch.zeros((L, n, V), dtype=torch.float32, device=dev).scatter_(2, fine.view(L, n, 1).long(), rm[..., None])
    counts = oh.sum(dim=1)                                     # (L, V)
    sums = D_real @ oh                                         # (L, n, V)
    centsum = oh.transpose(1, 2) @ feats_unit                  # (L, V, p)
    del oh
    own, live = sweep_nodes_kernel(
        merges.contiguous(), labels_all.contiguous(), nr, c_fine, sums, counts, centsum,
        minN=minN, nc_pad=nc_pad,
    )
    # cut-independent node quantities, as in the plain version
    cent_u = _unit(centsum / torch.clamp_min(counts[..., None], 1.0))
    FC = feats_unit @ cent_u.transpose(1, 2)                   # (L, n, V)
    g = (feats_unit * rm[..., None]).sum(dim=1) / torch.clamp_min(nr, 1)[:, None]
    corr_cg = (cent_u * _unit(g)[:, None, :]).sum(dim=-1)      # (L, V)
    width, wterm = sweep_score_kernel(sums, counts, FC, own, live, real_mask)
    return sweep_median_kernel(width, wterm, real_mask, nr, live, counts, corr_cg, minN=minN)


# the own table's integer type by the largest node count it holds
_OWN_TYPES = ((256, torch.uint8, 1), (32768, torch.int16, 2), (2 ** 31 - 1, torch.int32, 4))
# gridDim.y of sweep_score and sweep_median holds the lanes
SWEEP_MAX_LANES = 65535


def _own_type(V: int):
    return next((dt, nb) for cap, dt, nb in _OWN_TYPES if V <= cap)


def _check(*tables) -> None:
    """Raise unless each (name, x, dtype, shape) is a contiguous tensor of
    `dtype` and `shape`, then unless each lies on a CUDA device."""
    for name, x, dtype, shape in tables:
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {tuple(shape)}, got {tuple(x.shape)}"
                             f"{'' if x.is_contiguous() else ' (not contiguous)'}")
    for name, x, _, _ in tables:
        if x.device.type != "cuda":
            raise ValueError(f"{name} must lie on a CUDA device, got {x.device}")


def _launch(stage: int, name: str, L: int, n: int, p: int, V: int, nc_pad: int, minN: int, ncand: int,
            own_bytes: int, **ptr) -> None:
    from sharp_tpu_torch.ops._build import load_kernels

    if not 1 <= L <= SWEEP_MAX_LANES:
        raise ValueError(f"{name} takes 1 <= L <= {SWEEP_MAX_LANES} lanes, got {L}")
    args = [ptr.get(k) for k in ("merges", "labels", "n_real", "c_fine", "sums", "counts", "centsum", "fc",
                                 "real", "corr_cg", "own", "live", "width", "wterm", "msil", "ch")]
    rc = load_kernels()["sweep.cu"].sharp_sweep_launch(
        *(None if a is None else a.data_ptr() for a in args),
        L, n, p, V, nc_pad, minN, ncand, own_bytes, stage, torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError_t {rc}")
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def sweep_nodes_kernel(merges, labels, n_real, c_fine, sums, counts, centsum, *, minN: int, nc_pad: int):
    """Replay each lane's nested merges from its finest scored cut c_fine
    (L,) int32 down to candidate 0 (`csrc/sweep.cu`, sweep_nodes): merges
    (L, n-1, 2) and labels (L, ncand, n) int32, n_real (L,) int32; the new
    nodes' columns of sums (L, n, V), counts (L, V) and centsum (L, V, p)
    float32 are written in place. Returns own (L, ncand, n), each cell's
    node at each candidate, in the narrowest integer type that holds V,
    and live (L, ncand, ceil(V / 32)) int32, the bits of the live nodes."""
    L, ncand, n = labels.shape
    V, p = centsum.shape[1], centsum.shape[2]
    if V != nc_pad + ncand:
        raise ValueError(f"sweep_nodes takes V = nc_pad + ncand = {nc_pad + ncand} nodes, got {V}")
    _check(
        ("merges", merges, torch.int32, (L, n - 1, 2)),
        ("labels", labels, torch.int32, (L, ncand, n)),
        ("n_real", n_real, torch.int32, (L,)),
        ("c_fine", c_fine, torch.int32, (L,)),
        ("sums", sums, torch.float32, (L, n, V)),
        ("counts", counts, torch.float32, (L, V)),
        ("centsum", centsum, torch.float32, (L, V, p)),
    )
    own_dtype, own_bytes = _own_type(V)
    own = torch.empty((L, ncand, n), dtype=own_dtype, device=sums.device)
    live = torch.empty((L, ncand, -(-V // 32)), dtype=torch.int32, device=sums.device)
    _launch(0, "sweep_nodes", L, n, p, V, nc_pad, minN, ncand, own_bytes, merges=merges, labels=labels,
            n_real=n_real, c_fine=c_fine, sums=sums, counts=counts, centsum=centsum, own=own, live=live)
    return own, live


def sweep_score_kernel(sums, counts, fc, own, live, real_mask):
    """Each cell's silhouette width and 1 - corr(own centroid) term at
    every candidate (`csrc/sweep.cu`, sweep_score): sums and fc (L, n, V)
    float32, counts (L, V), own and live from `sweep_nodes_kernel`,
    real_mask (L, n) bool. Returns (width, wterm), (L, ncand, n) float32
    each; wterm is 0 at pad cells."""
    L, ncand, n = own.shape
    V = counts.shape[1]
    _check(
        ("sums", sums, torch.float32, (L, n, V)),
        ("counts", counts, torch.float32, (L, V)),
        ("fc", fc, torch.float32, (L, n, V)),
        ("own", own, _own_type(V)[0], (L, ncand, n)),
        ("live", live, torch.int32, (L, ncand, -(-V // 32))),
        ("real_mask", real_mask, torch.bool, (L, n)),
    )
    width = torch.empty((L, ncand, n), dtype=torch.float32, device=sums.device)
    wterm = torch.empty_like(width)
    _launch(1, "sweep_score", L, n, 0, V, V - ncand, 0, ncand, _own_type(V)[1], sums=sums, counts=counts,
            fc=fc, own=own, live=live, real=real_mask, width=width, wterm=wterm)
    return width, wterm


def sweep_median_kernel(width, wterm, real_mask, n_real, live, counts, corr_cg, *, minN: int):
    """Each candidate's median width over the real cells (R's median, as
    `masked_median`) and CH index (`csrc/sweep.cu`, sweep_median): width and
    wterm from `sweep_score_kernel`, real_mask (L, n) bool, n_real (L,)
    int32, live from `sweep_nodes_kernel`, counts and corr_cg (L, V)
    float32. Returns (msil, ch), (L, ncand) float32 each."""
    L, ncand, n = width.shape
    V = counts.shape[1]
    _check(
        ("width", width, torch.float32, (L, ncand, n)),
        ("wterm", wterm, torch.float32, (L, ncand, n)),
        ("real_mask", real_mask, torch.bool, (L, n)),
        ("n_real", n_real, torch.int32, (L,)),
        ("live", live, torch.int32, (L, ncand, -(-V // 32))),
        ("counts", counts, torch.float32, (L, V)),
        ("corr_cg", corr_cg, torch.float32, (L, V)),
    )
    msil = torch.empty((L, ncand), dtype=torch.float32, device=width.device)
    ch = torch.empty_like(msil)
    _launch(2, "sweep_median", L, n, 0, V, V - ncand, minN, ncand, _own_type(V)[1], width=width, wterm=wterm,
            real=real_mask, n_real=n_real, live=live, counts=counts, corr_cg=corr_cg, msil=msil, ch=ch)
    return msil, ch
