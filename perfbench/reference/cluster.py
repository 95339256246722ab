"""Plain reference of one clustering problem: projection, distances, Ward,
cuts and the choice of the cut.

Written from the reference algorithm (SHARP's R/get_opt_hclust.R and
R/RPmat.R, with the conventions its Python ports document): imports torch
and numpy only, and nothing of the program under test. Every function runs
on the device of its inputs. Problems are unpadded: a lane holds its n real
points only.

Conventions:
  * projection: log2(1 + x) when asked, operands rounded to the stated
    precision, products and sums in float32, scaled by 1/sqrt(p);
  * distance: 1 - Pearson correlation of rows, clamped at 0, zero diagonal;
  * Ward (ward.D) by the Lance-Williams update, greedy: each step merges the
    pair of smallest distance (first row, then first column on ties); the
    survivor is the smaller index;
  * a cut at k clusters numbers its clusters by their smallest member;
  * the cut is chosen by the median silhouette (near ties within 1e-4
    ranked by the height gap), else by the Calinski-Harabasz index with the
    1 - corr dispersion, else by the dendrogram's height-gap rule; where a
    comparison of that chain lies within rounding of its threshold, the
    other choice is admissible too (`choose`), since another float32 order
    of the same sums may fall on either side. `READINGS` keeps how close
    the comparisons came and which choices needed that room.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

SIL_TIE_EPS = np.float32(1e-4)
HEIGHT_TAIL = 10
# rounding room of the rule chain's comparisons: a candidate within it of a
# threshold or of the best may fall either side in another float32 order.
# Absolute on silhouettes; relative on the height ratio, the CH index and
# the height-gap rule. Set from readings of sound runs (PERF.md section 2).
SIL_ROOM = 2e-6
REL_ROOM = 2e-6
# the rooms tried, smallest first, to read what a choice needed
LADDER = (1e-8, 2e-8, 5e-8, 1e-7, 2e-7, 5e-7, 1e-6, 2e-6)
# problems chosen, the closest approach of each comparison to its threshold,
# and the room ("sil" or "rel", size) each choice other than the first needed
READINGS = {"problems": 0, "closest": {}, "taken": []}


def reset_readings() -> None:
    READINGS.update(problems=0, closest={}, taken=[])


def readings() -> dict:
    """The rule chain's readings since the last reset, for a run's record."""
    taken = READINGS["taken"]
    return {"problems": READINGS["problems"], "closest": dict(READINGS["closest"]),
            "non_primary": len(taken), "rooms_taken": [list(t) for t in taken]}


def note_taken(room) -> None:
    """Record that a choice other than the reference's first was taken."""
    if room is not None:
        READINGS["taken"].append(room)


def _closest_to(kind: str, value) -> None:
    c = READINGS["closest"]
    c[kind] = min(c.get(kind, math.inf), float(value))


def _top_gap(v) -> float:
    """Relative gap between the largest two finite values of v."""
    v = np.sort(np.asarray(v, np.float64)[np.isfinite(v)])
    return float((v[-1] - v[-2]) / max(abs(v[-1]), 1e-30)) if len(v) > 1 else math.inf


def round_operand(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x (float32) rounded to the precision `kind` and back to float32:
    "float32" as it is, "tf32" to TF32's 10 mantissa bits (round to
    nearest even), or a torch dtype name ("bfloat16", "float8_e4m3fn")."""
    x = x.float()
    if kind == "float32":
        return x
    if kind == "tf32":
        i = x.contiguous().view(torch.int32)
        i = (i + (0x0FFF + ((i >> 13) & 1))) & -8192
        return i.view(torch.float32)
    return x.to(getattr(torch, kind)).float()


@contextlib.contextmanager
def full_float32():
    """Matrix products in full float32 (TF32 off) inside the block."""
    mm, cu = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cu


def mm(a: torch.Tensor, b: torch.Tensor, kind: str = "float32") -> torch.Tensor:
    """a @ b with both operands in the precision `kind`, float32 sums."""
    return round_operand(a, kind) @ round_operand(b, kind)


def project(X: torch.Tensor, R: torch.Tensor, K: int, log: bool, kind: str) -> torch.Tensor:
    """Ensemble projection of cells X (n, genes) by the stacked (genes, K*p)
    RP matrices -> (K, n, p)."""
    n = X.shape[0]
    p = R.shape[1] // K
    Xt = torch.log2(1.0 + X.float()) if log else X.float()
    out = mm(Xt, R, kind) / math.sqrt(p)
    return out.reshape(n, K, p).permute(1, 0, 2)


def unit_rows(F: torch.Tensor) -> torch.Tensor:
    """Rows centred and scaled to unit length."""
    C = F - F.mean(dim=-1, keepdim=True)
    return C / torch.clamp_min(C.norm(dim=-1, keepdim=True), 1e-30)


def pearson_distance(F: torch.Tensor, kind: str = "float32") -> torch.Tensor:
    """1 - corr between the rows of F (..., n, p), clamped at 0, zero diagonal."""
    U = unit_rows(F)
    D = torch.clamp_min(1.0 - mm(U, U.transpose(-1, -2), kind), 0.0)
    n = D.shape[-1]
    return D * (1.0 - torch.eye(n, device=D.device))


def ward(D: torch.Tensor):
    """Greedy ward.D over L problems D (L, n, n) -> merges (L, n-1, 2)
    (survivor, merged away) and heights (L, n-1)."""
    L, n, _ = D.shape
    dev = D.device
    W = D.float().clone()
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    W[:, eye] = math.inf
    lanes = torch.arange(L, device=dev)
    size = torch.ones((L, n), device=dev)
    merges = torch.zeros((L, n - 1, 2), dtype=torch.long, device=dev)
    heights = torch.zeros((L, n - 1), device=dev)
    flat = W.view(L, n * n)
    for t in range(n - 1):
        a = torch.argmin(flat, dim=1)
        h = flat[lanes, a]
        i = torch.minimum(a // n, a % n)
        j = torch.maximum(a // n, a % n)
        ni, nj = size[lanes, i][:, None], size[lanes, j][:, None]
        new = ((ni + size) * W[lanes, i] + (nj + size) * W[lanes, j] - size * h[:, None]) / (ni + nj + size)
        new[lanes, i] = math.inf
        new[lanes, j] = math.inf
        W[lanes, i] = new
        W[lanes, :, i] = new
        W[lanes, j] = math.inf
        W[lanes, :, j] = math.inf
        size[lanes, i] = (ni + nj)[:, 0]
        merges[:, t, 0] = i
        merges[:, t, 1] = j
        heights[:, t] = h
    return merges, heights


def cuts(merges: torch.Tensor, ks) -> torch.Tensor:
    """Labels of the cuts at k clusters, for each k of `ks`, of L merge
    sequences (L, n-1, 2) -> (L, len(ks), n), clusters numbered 0..k-1 by
    their smallest member."""
    L, m, _ = merges.shape
    n = m + 1
    dev = merges.device
    want = {n - k: c for c, k in enumerate(ks) if 1 <= k <= n}
    lab = torch.arange(n, device=dev).repeat(L, 1)
    out = torch.zeros((L, len(ks), n), dtype=torch.long, device=dev)
    if n in [int(k) for k in ks]:
        out[:, [int(k) for k in ks].index(n)] = lab
    for t in range(m):
        i, j = merges[:, t, 0:1], merges[:, t, 1:2]
        lab = torch.where(lab == j, i, lab)
        c = want.get(t + 1)
        if c is not None:
            out[:, c] = lab
    # representatives are the smallest members: number them in order
    rep = torch.zeros((L, len(ks), n), dtype=torch.long, device=dev)
    rep.scatter_(2, out, 1)
    newid = torch.cumsum(rep, dim=2) - 1
    return torch.gather(newid, 2, out)


def _median(s: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, the mean of the two middles."""
    n = s.shape[-1]
    v = torch.sort(s, dim=-1).values
    return 0.5 * (v[..., (n - 1) // 2] + v[..., n // 2])


def scores(D: torch.Tensor, Fu: torch.Tensor, labels: torch.Tensor, ks, chunk: int = 48):
    """Median silhouette and Calinski-Harabasz index (1 - corr dispersion)
    of the cuts `labels` (C, n) of one problem: D (n, n), Fu (n, P) unit
    rows, ks the cuts' cluster counts. -> (msil (C,), ch (C,))."""
    n = D.shape[-1]
    msil, chs = [], []
    g = unit_rows(Fu.mean(dim=0, keepdim=True))[0]
    for c0 in range(0, labels.shape[0], chunk):
        lab = labels[c0 : c0 + chunk]
        kk = torch.as_tensor([float(k) for k in ks[c0 : c0 + chunk]], device=D.device)
        W = int(lab.max()) + 1
        oh = torch.nn.functional.one_hot(lab, W).float()            # (C, n, W)
        cnt = oh.sum(dim=1)                                         # (C, W)
        sums = torch.matmul(D, oh)                                  # (C, n, W)
        own_cnt = torch.gather(cnt, 1, lab)
        own_sum = torch.gather(sums, 2, lab[..., None])[..., 0]
        a = own_sum / torch.clamp_min(own_cnt - 1.0, 1.0)
        other = (oh > 0) | (cnt[:, None, :] < 0.5)
        b = torch.where(other, math.inf, sums / torch.clamp_min(cnt[:, None, :], 1.0)).amin(dim=-1)
        s = (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-12)
        s = torch.where((own_cnt <= 1.5) | ~torch.isfinite(b), 0.0, s)
        msil.append(_median(s))
        cent = unit_rows(torch.matmul(oh.transpose(1, 2), Fu) / torch.clamp_min(cnt[..., None], 1.0))
        corr_own = torch.gather(torch.matmul(Fu, cent.transpose(1, 2)), 2, lab[..., None])[..., 0]
        Wd = (1.0 - corr_own).sum(dim=1)
        Bd = torch.where(cnt > 0.5, cnt * (1.0 - cent @ g), 0.0).sum(dim=1)
        ch = (Bd / torch.clamp_min(kk - 1.0, 1.0)) / torch.clamp_min(Wd / torch.clamp_min(n - kk, 1.0), 1e-12)
        chs.append(torch.where((kk > 1) & (n > kk), ch, 0.0))
    return torch.cat(msil), torch.cat(chs)


def _rule_chain(msil, ch, valid, heights, n, minN, ncand, sil_thre, height_Ntimes, tail, sil_m, rel_m,
                read=False):
    """The rule chain with each comparison made stricter, exact and looser
    by its room (`sil_m` absolute on silhouettes, `rel_m` relative) -> the
    chosen candidates under each; `read` notes how close each comparison
    came (exact pass)."""
    f32 = np.float32
    mv = np.where(valid, msil, f32(-np.inf))
    maxsil = mv.max()
    ks = minN + np.arange(ncand)
    m = len(heights)
    out = set()
    for s in ((-1, 0, 1) if sil_m or rel_m else (0,)):
        near = valid & (mv >= f32(maxsil - SIL_TIE_EPS) + f32(s * sil_m))
        if read and valid.any():
            _closest_to("sil_tie", np.abs(mv[valid] - f32(maxsil - SIL_TIE_EPS)).min())
            _closest_to("sil_thre", abs(maxsil - f32(sil_thre)))
        if near.sum() > 1:
            h_next = heights[np.clip(n - ks, 0, m - 1)]
            h_last = np.where(ks >= n, f32(0), heights[np.clip(n - ks - 1, 0, m - 1)])
            eps = f32(max(f32(1e-6) * heights[: n - 1].max(), f32(1e-12)))
            ratio = np.where(near, (h_next + eps) / (np.maximum(h_last, f32(0)) + eps), f32(-np.inf))
            sil = np.flatnonzero(ratio >= ratio.max() - abs(ratio.max()) * rel_m) if rel_m else [int(np.argmax(ratio))]
            if read:
                _closest_to("ratio", _top_gap(ratio))
        else:
            sil = [int(np.argmax(mv))]
        use_sil = not maxsil <= f32(sil_thre) + f32(s * sil_m)
        if use_sil:
            out.update(int(o) for o in sil)
            continue
        chv = np.where(valid, np.asarray(ch, f32), f32(-np.inf))
        ch_os = np.flatnonzero(chv >= chv.max() - abs(chv.max()) * rel_m) if rel_m else [int(np.argmax(chv))]
        hp = np.concatenate([heights, np.zeros(max(tail - m, 0), f32)])
        start = int(np.clip(n - 1 - tail, 0, max(len(hp) - tail, 0)))
        idx = start + np.arange(tail)
        w = hp[idx]
        wv = idx < n - 1
        w = np.where(wv, w, w[max(int(wv.sum()) - 1, 0)])
        pred, succ = w[:-1], w[1:]
        bar = f32(height_Ntimes - 1.0) * pred
        flag = ((succ - pred) > bar * f32(1 + s * rel_m)) & wv[1:]
        if read:
            _closest_to("ch", _top_gap(chv))
            gaps = np.abs((succ - pred) / np.maximum(bar, f32(1e-30)) - 1.0)[wv[1:]]
            if len(gaps):
                _closest_to("height_gap", gaps.min())
        for ch_o in ch_os:
            if ch_o == 0 and flag.any():
                pind = int(np.argmax(flag))
                opth = f32(0.5) * (pred[pind] + succ[pind])
                below = int((heights[: n - 1] <= opth).sum())
                out.add(int(np.clip(n - below - minN, 0, ncand - 1)))
            else:
                out.add(int(ch_o))
    return out


def _room(args, o: int):
    """The smallest room of the ladder, on one kind of comparison, under
    which candidate `o` is chosen -> (kind, room)."""
    for r in LADDER:
        if o in _rule_chain(*args, r, 0.0):
            return ("sil", r)
        if o in _rule_chain(*args, 0.0, r):
            return ("rel", r)
    return ("both", max(SIL_ROOM, REL_ROOM))


def choose(msil, ch, valid, heights, n: int, minN: int, ncand: int, sil_thre: float,
           height_Ntimes: float, tail: int = HEIGHT_TAIL):
    """The rule chain on one problem's candidates (host arrays of ncand;
    heights the n - 1 merge heights, ascending) -> (choices, rooms): the
    chosen candidate first, then every other candidate that a comparison
    within its room (`SIL_ROOM`, `REL_ROOM`) of its threshold, or of the
    best, would choose; rooms[i] is what choice i needed (None for the
    first)."""
    msil = np.asarray(msil, np.float32)
    heights = np.asarray(heights, np.float32)
    args = (msil, ch, valid, heights, n, minN, ncand, sil_thre, height_Ntimes, tail)
    READINGS["problems"] += 1
    primary = _rule_chain(*args, 0.0, 0.0, read=True).pop()
    others = sorted(_rule_chain(*args, SIL_ROOM, REL_ROOM) - {primary})
    return [primary] + others, [None] + [_room(args, o) for o in others]


def opt_hclust(D: torch.Tensor, F: torch.Tensor, *, minN: int, ncand: int, maxN, nc_cap: int,
               sil_thre: float, height_Ntimes: float, tail: int = HEIGHT_TAIL, prefer_k=None) -> dict:
    """Cluster L problems of n points: D (L, n, n) distances, F (L, n, P)
    features for the CH index; maxN an int or one per lane; candidates k =
    minN..minN+ncand-1 that are <= n - 1, <= maxN and <= nc_cap are scored.
    Returns labels (L, n), k (L,), maxsil (L,), msil (L, ncand), the cuts
    (L, C, n), `alts`, each lane's admissible candidates, and `rooms`, what
    each needed (`choose`).
    `prefer_k` (a cluster count a lane, the program's) takes the admissible
    candidate with that many clusters where there is one."""
    L, n = D.shape[0], D.shape[-1]
    maxN = [int(maxN)] * L if np.isscalar(maxN) else [int(x) for x in maxN]
    ks = [minN + c for c in range(ncand) if minN + c <= n]
    merges, heights = ward(D)
    cut = cuts(merges, ks)                                            # (L, C, n)
    Fu = unit_rows(F.float())
    labels, kout, maxsil, msils, alts, rooms = [], [], [], [], [], []
    h_host = heights.cpu().numpy()
    for l in range(L):
        valid = np.array([k <= n - 1 and k <= maxN[l] and k <= nc_cap for k in
                          (minN + np.arange(ncand))])
        vk = [c for c in range(ncand) if valid[c]]
        msil = np.full(ncand, np.nan, np.float32)
        ch = np.full(ncand, np.nan, np.float32)
        if vk:
            ms, cs = scores(D[l], Fu[l], cut[l, vk], [minN + c for c in vk])
            msil[vk] = ms.cpu().numpy()
            ch[vk] = cs.cpu().numpy()
        alt, room = choose(msil, ch, valid, h_host[l], n, minN, ncand, sil_thre, height_Ntimes, tail)
        alt, room = [a for a in alt if a < len(ks)], [r for a, r in zip(alt, room) if a < len(ks)]
        o = alt[0]
        if prefer_k is not None:
            i = next((i for i, a in enumerate(alt) if int(cut[l, a].max()) + 1 == int(prefer_k[l])), 0)
            o = alt[i]
            note_taken(room[i])
        lab = cut[l, o]
        labels.append(lab)
        kout.append(int(lab.max()) + 1)
        maxsil.append(float(np.where(valid, msil, -np.inf).max()))
        msils.append(msil)
        alts.append(alt)
        rooms.append(room)
    return dict(labels=torch.stack(labels), k=kout, maxsil=np.asarray(maxsil, np.float32),
                alts=alts, rooms=rooms, msil=np.stack(msils), cuts=cut)
