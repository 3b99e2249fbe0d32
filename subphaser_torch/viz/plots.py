"""Matplotlib figures replacing the reference's R/matplotlib plot scripts.

- k-mer frequency histogram (reference Jellyfish.plot_histogram, 650-666)
- PCA scatter by subgenome (reference Cluster.pca, Cluster.py:48-75)
- chromosome x k-mer heatmap with SG side colors (replaces the R
  gplots::heatmap.2 template, reference Jellyfish.py:524-609)

Host code. matplotlib (Agg backend) is imported inside each plotting
function, so the module imports where matplotlib is not installed.
"""

from __future__ import annotations

import numpy as np

FONTSIZE = 15
LABELSIZE = 13


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


def plot_histogram(data, outfig, step=25, xlim_pct=99, xlabel="Kmer occurrence",
                   ylabel="Count", vline=None):
    data = np.asarray(data)
    if data.size == 0:
        return
    plt = _pyplot()
    _max = float(data.max())
    nbins = max(int(_max / step), 1)
    plt.figure(figsize=(7, 5), dpi=300, tight_layout=True)
    plt.hist(data, bins=nbins)
    plt.xlim(0, np.percentile(data, xlim_pct))
    plt.xlabel(xlabel, fontsize=FONTSIZE)
    plt.ylabel(ylabel, fontsize=FONTSIZE)
    plt.tick_params(labelsize=LABELSIZE)
    plt.ticklabel_format(style="plain")
    if vline is not None:
        plt.axvline(vline, ls="--", c="grey")
    plt.savefig(outfig, bbox_inches="tight", dpi=300)
    plt.close()


def plot_pca(scores, ratio, chrs, d_sg, d_colors, outfig):
    plt = _pyplot()
    plt.figure(figsize=(7, 7), dpi=300, tight_layout=True)
    by_sg: dict[str, list] = {}
    for (x, y), chrom in zip(scores[:, :2], chrs):
        by_sg.setdefault(d_sg[chrom], []).append((x, y))
    for sg, pts in sorted(by_sg.items()):
        xs, ys = zip(*pts)
        plt.scatter(xs, ys, c=d_colors[sg], marker="o", label=sg)
    plt.axhline(0, ls="--", c="grey")
    plt.axvline(0, ls="--", c="grey")
    plt.xlabel(f"PC1 ({ratio[0] * 100:.1f}%)", fontsize=FONTSIZE)
    plt.ylabel(f"PC2 ({ratio[1] * 100:.1f}%)", fontsize=FONTSIZE)
    plt.legend(fontsize=FONTSIZE)
    plt.tick_params(labelsize=LABELSIZE)
    plt.savefig(outfig, bbox_inches="tight", dpi=300)
    plt.close()


def plot_heatmap(
    freqs,            # (B, C) normalized k-mer frequencies
    chrs,             # chromosome names (C)
    d_sg,             # chrom -> SG
    kmer_sg,          # (B,) SG index per k-mer or -1 (unassigned)
    sg_names,
    d_colors,
    outfig,
    subsample: int = 10000,
    seed: int = 0,
    scale: str = "row",
    title: str | None = None,
    xlab: str | None = None,
    lab_col: bool = True,
    key: bool = False,
):
    """Chromosomes x k-mers heatmap, Z-scored per k-mer, SG side colors.

    ``scale``/``title``/``xlab``/``lab_col``/``key`` are the native
    analogues of the reference's -heatmap_options heatmap.2 sub-flags
    (scale=, main=, xlab=, labCol=, key=; reference Jellyfish.py:525-603):
    scale picks the Z-score axis ("row" = per k-mer, the heatmap.2
    default; "column" = per chromosome; "none" = raw frequencies), key
    adds the color scale bar."""
    plt = _pyplot()
    rng = np.random.default_rng(seed)
    b = freqs.shape[0]
    if b > subsample:
        sel = np.sort(rng.choice(b, subsample, replace=False))
        freqs = freqs[sel]
        kmer_sg = kmer_sg[sel]
    data = freqs.T.astype(np.float64)  # (C, B)
    if scale == "row":
        mean = data.mean(axis=0, keepdims=True)
        std = data.std(axis=0, ddof=1, keepdims=True)
    elif scale == "column":
        mean = data.mean(axis=1, keepdims=True)
        std = data.std(axis=1, ddof=1, keepdims=True)
    else:
        mean = np.zeros((1, 1))
        std = np.ones((1, 1))
    z = (data - mean) / np.where(std > 0, std, 1.0)

    # cluster BOTH axes with complete-linkage euclidean (the defaults of the
    # reference's heatmap.2 call, Jellyfish.py:524-609: Rowv/Colv dendrograms
    # with RowSideColors/ColSideColors)
    from scipy.cluster.hierarchy import dendrogram, leaves_list, linkage

    row_link = linkage(z, method="complete") if z.shape[0] > 2 else None
    row_order = leaves_list(row_link) if row_link is not None else np.arange(z.shape[0])
    col_link = None
    if 2 < z.shape[1] <= 20000:
        col_link = linkage(z.T.astype(np.float32), method="complete")
        col_order = leaves_list(col_link)
    else:  # too many columns to cluster: group by assigned SG
        col_order = np.argsort(kmer_sg, kind="stable")
    z = z[np.ix_(row_order, col_order)]
    ksg = kmer_sg[col_order]
    chrs_o = [chrs[i] for i in row_order]

    fig = plt.figure(figsize=(10, 6.6), dpi=200)
    gs = fig.add_gridspec(
        3, 3, width_ratios=[0.12, 0.02, 1], height_ratios=[0.12, 0.04, 1],
        wspace=0.01, hspace=0.01,
    )
    # dendrogram panels (leaves match the heatmap ordering)
    if row_link is not None:
        axrd = fig.add_subplot(gs[2, 0])
        dendrogram(row_link, ax=axrd, orientation="left", no_labels=True,
                   color_threshold=0, above_threshold_color="#444444")
        axrd.invert_yaxis()  # match imshow's top-to-bottom row order
        axrd.axis("off")
    if col_link is not None:
        axcd = fig.add_subplot(gs[0, 2])
        dendrogram(col_link, ax=axcd, orientation="top", no_labels=True,
                   color_threshold=0, above_threshold_color="#444444")
        axcd.axis("off")
    ax = fig.add_subplot(gs[2, 2])
    vmax = np.nanpercentile(np.abs(z), 99) or 1.0
    im = ax.imshow(z, aspect="auto", cmap="RdYlGn_r", vmin=-vmax, vmax=vmax,
                   interpolation="nearest")
    if lab_col:
        ax.set_yticks(range(len(chrs_o)))
        ax.set_yticklabels(
            chrs_o, fontsize=max(4, min(10, 200 // max(len(chrs_o), 1))))
        ax.yaxis.tick_right()
    else:
        ax.set_yticks([])
    ax.set_xticks([])
    ax.set_xlabel("Differential kmers" if xlab is None else xlab,
                  fontsize=FONTSIZE)
    if title:
        ax.set_title(title, fontsize=FONTSIZE + 1)
    if key:
        fig.colorbar(im, ax=ax, fraction=0.03, pad=0.08,
                     label={"row": "row Z-score", "column": "column Z-score",
                            "none": "frequency"}.get(scale, ""))

    from matplotlib.colors import ListedColormap

    # row side colors: chromosome SG
    axr = fig.add_subplot(gs[2, 1], sharey=ax)
    row_colors = [d_colors[d_sg[c]] for c in chrs_o]
    axr.imshow(
        np.arange(len(row_colors)).reshape(-1, 1),
        aspect="auto", cmap=ListedColormap(row_colors), interpolation="nearest",
    )
    axr.set_xticks([])
    axr.set_yticks([])

    # column side colors: k-mer SG (grey when unassigned)
    axc = fig.add_subplot(gs[1, 2], sharex=ax)
    col_palette = ["#dddddd"] + [d_colors[s] for s in sg_names]
    axc.imshow(
        (ksg + 1).reshape(1, -1),
        aspect="auto", cmap=ListedColormap(col_palette),
        vmin=-0.5, vmax=len(col_palette) - 0.5, interpolation="nearest",
    )
    axc.set_xticks([])
    axc.set_yticks([])

    fig.savefig(outfig, bbox_inches="tight")
    plt.close(fig)
