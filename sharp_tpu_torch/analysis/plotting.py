"""Plots: marker-gene heatmap and cluster embedding scatter.

Counterpart of `sharp_tpu/analysis/plotting.py`, with the same palette.
matplotlib is imported inside the functions only: nothing else of the
package needs it.

Equivalents of plot_markers (R/plot_markers.R:38-238: top-N markers per
cluster, cells ordered by cluster, ~1e4-cell proportional subsample,
row-standardized blue-white-red heatmap with cluster color annotations)
and the scatter part of visualization_SHARP (R/visualization_SHARP.R:110-167,
40-color palette recycled). Matplotlib replaces pheatmap/ggplot2.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from sharp_tpu_torch.analysis.markers import MarkerResult

# the reference's 40-color palette (R/getrowColor.R:52-58)
PALETTE = [
    "red", "purple", "blue", "yellow", "green", "orange", "brown", "gray",
    "black", "coral", "beige", "cyan", "turquoise", "pink", "khaki",
    "magenta", "violet", "salmon", "goldenrod", "orchid", "seagreen",
    "slategray", "darkred", "darkblue", "darkcyan", "darkgreen", "darkgray",
    "darkkhaki", "darkorange", "darkmagenta", "darkviolet", "darkturquoise",
    "darksalmon", "darkgoldenrod", "darkorchid", "darkseagreen",
    "darkslategray", "deeppink", "lightcoral", "lightcyan",
]


def _color_of(label_index: int) -> str:
    return PALETTE[label_index % len(PALETTE)]


def plot_markers(
    res: MarkerResult,
    *,
    n_marker: int = 10,
    max_cells: int = 10000,
    log_transform: bool = True,
    out: Optional[str] = None,
    seed: int = 0,
):
    """Marker heatmap: top `n_marker` genes per cluster x cluster-ordered
    cells, row-standardized. Returns (fig, sorted marker table)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = np.asarray(res.label)
    clusters = np.unique(labels)
    # top-N per cluster by the mginfo sort order (already cluster, -fc, -auc)
    sel_rows = []
    for c in clusters:
        rows = np.flatnonzero(res.mginfo["cluster"] == c)[:n_marker]
        sel_rows.extend(rows.tolist())
    sel_rows = np.asarray(sel_rows, int)
    if len(sel_rows) == 0:
        raise ValueError("no markers to plot")
    genes = res.mginfo["gene"][sel_rows]
    gidx = res.mginfo["gene_index"][sel_rows]

    # proportional cell subsample, ordered by cluster (R/plot_markers.R:136-143)
    rng = np.random.default_rng(seed)
    n = len(labels)
    order = []
    for c in clusters:
        ci = np.flatnonzero(labels == c)
        if n > max_cells:
            take = max(int(round(len(ci) / n * max_cells)), 1)
            ci = np.sort(rng.choice(ci, min(take, len(ci)), replace=False))
        order.append(ci)
    cell_order = np.concatenate(order)

    # rows of res.mat are aligned with mginfo rows
    M = res.mat[sel_rows][:, cell_order].astype(np.float64)
    if log_transform:
        M = np.log2(1 + M)
    sd = M.std(axis=1, keepdims=True)
    keep = sd[:, 0] > 0
    M = (M[keep] - M[keep].mean(axis=1, keepdims=True)) / sd[keep]
    genes = genes[keep]
    M = np.clip(M, -3, 3)

    fig, ax = plt.subplots(
        figsize=(10, max(4, 0.18 * M.shape[0])), constrained_layout=True
    )
    im = ax.imshow(M, aspect="auto", cmap="bwr", vmin=-3, vmax=3)
    ax.set_yticks(range(len(genes)))
    ax.set_yticklabels(genes, fontsize=6)
    ax.set_xticks([])
    # cluster color strip
    bounds = np.cumsum([len(o) for o in order])
    start = 0
    for i, c in enumerate(clusters):
        ax.axvspan(
            start - 0.5, bounds[i] - 0.5, ymin=1.0, ymax=1.02,
            color=_color_of(i), clip_on=False,
        )
        start = bounds[i]
    fig.colorbar(im, ax=ax, shrink=0.5, label="row z-score")
    ax.set_title("SHARP-TPU marker genes (top %d per cluster)" % n_marker)
    if out:
        fig.savefig(out, dpi=150)
    return fig, {k: v[sel_rows][keep] for k, v in res.mginfo.items()}


def plot_embedding(
    emb: np.ndarray,
    labels: Union[np.ndarray, list],
    *,
    out: Optional[str] = None,
    title: str = "SHARP-TPU clusters",
):
    """2-D scatter of the t-SNE embedding, reference palette recycled."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = np.asarray(labels)
    fig, ax = plt.subplots(figsize=(7, 6), constrained_layout=True)
    for i, c in enumerate(np.unique(labels)):
        m = labels == c
        ax.scatter(
            emb[m, 0], emb[m, 1], s=6, color=_color_of(i),
            label=str(c), linewidths=0,
        )
    ax.legend(markerscale=2, fontsize=7, title="cluster", ncols=2)
    ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    if out:
        fig.savefig(out, dpi=150)
    return fig
