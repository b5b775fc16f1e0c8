"""The figures' drawing layer, on the port.

Port of ``figures/plotting.py``: the CSV readers, loss and bar axes, and
the mesh panels that :mod:`largesteps_torch.figures.draw` lays out.  Curves
are drawn by matplotlib; mesh panels by the port's renderer
(:mod:`largesteps_torch.vis`) on ``device``.  Files are read from and
written to ``OUTPUT_DIR``, the experiments' own
(:data:`largesteps_torch.figures.common.OUTPUT_DIR`: ``LS_OUTPUT_DIR`` or
``largesteps_torch/figures/output``).

Style: single y-axis per plot, fixed categorical color order (validated
for color-vision-deficiency separation), recessive grid, legend whenever
more than one series is shown.
"""
import csv
import os

import numpy as np
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from ..io.ply import read_ply  # noqa: E402
from ..vis import render_mesh_image, save_mesh_png  # noqa: E402
from .common import OUTPUT_DIR  # noqa: E402,F401

# Fixed categorical order (CVD-validated palette; assign by slot, never cycle)
SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4",
          "#008300", "#4a3aa7", "#e34948"]
TEXT = "#3d3d3a"
GRID = "#d9d8d3"

plt.rcParams.update({
    "figure.dpi": 110,
    "savefig.dpi": 150,
    "font.size": 10,
    "axes.edgecolor": GRID,
    "axes.labelcolor": TEXT,
    "axes.titlecolor": TEXT,
    "axes.grid": True,
    "grid.color": GRID,
    "grid.linewidth": 0.6,
    "axes.axisbelow": True,
    "xtick.color": TEXT,
    "ytick.color": TEXT,
    "text.color": TEXT,
    "legend.frameon": False,
    "lines.linewidth": 2.0,
})


def read_loss_csv(path):
    """-> (iterations, im_loss, reg_loss) arrays from a *_loss.csv."""
    its, im, reg = [], [], []
    with open(path, newline="") as fh:
        for row in csv.DictReader(fh):
            its.append(int(row["iteration"]))
            im.append(float(row["im_loss"]))
            reg.append(float(row["reg_loss"]))
    return np.asarray(its), np.asarray(im), np.asarray(reg)


def read_metrics_csv(path):
    """-> dict of the single row in a *_metrics.csv."""
    with open(path, newline="") as fh:
        row = next(iter(csv.DictReader(fh)))
    return {k: float(v) for k, v in row.items()}


def smooth(y, k: int = 25):
    """Running mean (the noisy per-step loss reads poorly raw)."""
    if len(y) <= k:
        return y
    kernel = np.ones(k) / k
    pad = np.concatenate([np.full(k - 1, y[0]), y])
    return np.convolve(pad, kernel, mode="valid")


def loss_axes(ax, runs, ylabel="image loss", logy=True, smooth_k=25):
    """Plot one loss curve per (label, iterations, values) run triple."""
    for i, (label, its, vals) in enumerate(runs):
        ax.plot(its, smooth(vals, smooth_k), color=SERIES[i % len(SERIES)],
                label=label)
    ax.set_xlabel("iteration")
    ax.set_ylabel(ylabel)
    if logy:
        ax.set_yscale("log")
    if len(runs) > 1:
        ax.legend()


def bar_axes(ax, labels, values, ylabel, color=SERIES[0]):
    x = np.arange(len(labels))
    ax.bar(x, values, color=color, width=0.62, zorder=2)
    ax.set_xticks(x, labels)
    ax.set_ylabel(ylabel)
    ax.grid(axis="x", visible=False)
    for xi, v in zip(x, values):
        ax.annotate(f"{v:.3g}", (xi, v), textcoords="offset points",
                    xytext=(0, 3), ha="center", fontsize=8)


def mesh_panel(path_ply, out_png, res=384, title=None, device=None):
    """Render one mesh PLY to a PNG panel through the port's renderer on
    ``device``."""
    mesh = read_ply(path_ply)
    save_mesh_png(out_png, mesh["vertices"], mesh["faces"], res=res,
                  device=device)
    return out_png


def mesh_grid_figure(out_png, panels, ncols=None, panel_res=320,
                     device=None):
    """Grid of mesh renders on ``device``: panels = [(title, ply_path),
    ...]."""
    n = len(panels)
    ncols = ncols or min(n, 4)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(2.6 * ncols, 2.8 * nrows))
    axes = np.atleast_1d(axes).ravel()
    for ax in axes[n:]:
        ax.axis("off")
    for ax, (title, ply) in zip(axes, panels):
        mesh = read_ply(ply)
        img = render_mesh_image(mesh["vertices"], mesh["faces"],
                                res=panel_res, device=device)
        img = img / max(np.percentile(img, 99.5), 1e-6)
        ax.imshow(np.clip(img, 0, 1))
        ax.set_title(title, fontsize=9)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return out_png


def require(paths, hint):
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise SystemExit(
            f"missing experiment output: {missing[0]}\n"
            f"run `python -m {hint}` first (add --quick for a fast pass)")


def save(fig, out_png):
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    print(f"wrote {out_png}")
    return out_png
