"""The seven figures, drawn from the port's experiment files.

    python -m largesteps_torch.figures.draw [EXP ...] [--device cuda]

One function for each ``figures/<exp>/figure.py`` (comparison, influence,
multiscale, reg_fail, remeshing, teaser, viewpoints), with its inputs,
series, labels and output names (``figure.png``; ``meshes.png`` or
``final_mesh.png`` where the experiment left final meshes).  Each reads
``<out_dir>/<exp>/`` (default ``OUTPUT_DIR``, where
``python -m largesteps_torch.figures.<exp>`` writes) and renders its mesh
panels on ``device`` (the card unless the caller asks for the CPU).  With
no EXP, every figure whose experiment has output is drawn.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from . import common
from . import plotting as pl

__all__ = ["FIGURES", "draw", "main"]


def _dir(exp, out_dir):
    return os.path.join(out_dir or common.OUTPUT_DIR, exp)


def _wrote(path):
    print(f"wrote {path}")
    return path


def comparison(out_dir=None, device=None):
    """Per-scene image-loss curves for ours against the Laplacian and
    bilaplacian regularizations, final Hausdorff distances, final-mesh
    panels."""
    methods = [("ours", "ours"), ("lapreg", "laplacian reg"),
               ("bilapreg", "bilaplacian reg")]
    d = _dir("comparison", out_dir)
    scenes = sorted({f.split("_")[0] for f in os.listdir(d)
                     if f.endswith("_loss.csv")}) if os.path.isdir(d) else []
    if not scenes:
        pl.require([os.path.join(d, "suzanne_ours_loss.csv")],
                   "largesteps_torch.figures.comparison")
    fig, axes = pl.plt.subplots(2, len(scenes),
                                figsize=(3.4 * len(scenes), 6.0),
                                squeeze=False)
    for col, scene in enumerate(scenes):
        runs, labels, hausdorffs = [], [], []
        for key, label in methods:
            lc = os.path.join(d, f"{scene}_{key}_loss.csv")
            mc = os.path.join(d, f"{scene}_{key}_metrics.csv")
            if not os.path.exists(lc):
                continue
            its, im, _ = pl.read_loss_csv(lc)
            runs.append((label, its, im))
            labels.append(label.split()[0])
            hausdorffs.append(pl.read_metrics_csv(mc)["hausdorff"])
        pl.loss_axes(axes[0][col], runs)
        axes[0][col].set_title(scene)
        pl.bar_axes(axes[1][col], labels, hausdorffs, "sym. Hausdorff")
    out = [pl.save(fig, os.path.join(d, "figure.png"))]
    panels = [(f"{scene} / {label}", ply)
              for scene in scenes for key, label in methods
              if os.path.exists(ply := os.path.join(
                  d, f"{scene}_{key}_final.ply"))]
    if panels:
        out.append(_wrote(pl.mesh_grid_figure(
            os.path.join(d, "meshes.png"), panels, ncols=len(methods),
            device=device)))
    return out


def influence(out_dir=None, device=None):
    """The halved symmetric Hausdorff distance against α (the reference
    halves the symmetric distance here, its figure notebook's cell 4)."""
    d = _dir("influence", out_dir)
    alphas, dists = [], []
    if os.path.isdir(d):
        for f in sorted(os.listdir(d)):
            if f.startswith("alpha_") and f.endswith("_metrics.csv"):
                alphas.append(float(f[len("alpha_"):-len("_metrics.csv")]))
                dists.append(pl.read_metrics_csv(
                    os.path.join(d, f))["hausdorff"] / 2)
    if not alphas:
        pl.require([os.path.join(d, "alpha_0_metrics.csv")],
                   "largesteps_torch.figures.influence")
    order = np.argsort(alphas)
    alphas = np.asarray(alphas)[order]
    dists = np.asarray(dists)[order]
    fig, ax = pl.plt.subplots(figsize=(4.6, 3.4))
    ax.plot(np.arange(len(alphas)), dists, color=pl.SERIES[0],
            marker="o", markersize=5)
    ax.set_xticks(np.arange(len(alphas)), [f"{a:g}" for a in alphas])
    ax.set_xlabel(r"$\alpha$")
    ax.set_ylabel("Hausdorff / 2")
    return [pl.save(fig, os.path.join(d, "figure.png"))]


# the multiscale leg's remesh steps (figures/multiscale/figure.py:9)
MULTISCALE_REMESH = [500, 1500, 3000, 4500, 7000, 10000, 12000, 14000]


def multiscale(out_dir=None, device=None):
    """The loss across the remesh schedule, the remeshes marked, and the
    final mesh."""
    d = _dir("multiscale", out_dir)
    lc = os.path.join(d, "multiscale_loss.csv")
    pl.require([lc], "largesteps_torch.figures.multiscale")
    its, im, _ = pl.read_loss_csv(lc)
    fig, ax = pl.plt.subplots(figsize=(6.4, 3.6))
    pl.loss_axes(ax, [("ours + remeshing", its, im)])
    for r in MULTISCALE_REMESH:
        if r < its[-1]:
            ax.axvline(r, color=pl.GRID, linewidth=1.0, zorder=1)
    ax.set_title("remesh events marked")
    out = [pl.save(fig, os.path.join(d, "figure.png"))]
    ply = os.path.join(d, "multiscale_final.ply")
    if os.path.exists(ply):
        out.append(_wrote(pl.mesh_panel(
            ply, os.path.join(d, "final_mesh.png"), device=device)))
    return out


def reg_fail(out_dir=None, device=None):
    """Silhouette-loss curves for ours against Adam with the bilaplacian at
    three weights, and the final meshes."""
    runs_ = [("ours", "ours (λ=99)"), ("reg_1", "reg w=1"),
             ("reg_400", "reg w=400"), ("reg_10000", "reg w=10000")]
    d = _dir("reg_fail", out_dir)
    pl.require([os.path.join(d, "ours_loss.csv")],
               "largesteps_torch.figures.reg_fail")
    runs = []
    for key, label in runs_:
        lc = os.path.join(d, f"{key}_loss.csv")
        if os.path.exists(lc):
            its, im, _ = pl.read_loss_csv(lc)
            runs.append((label, its, im))
    fig, ax = pl.plt.subplots(figsize=(5.2, 3.6))
    pl.loss_axes(ax, runs, ylabel="silhouette loss")
    out = [pl.save(fig, os.path.join(d, "figure.png"))]
    panels = [(label, ply) for key, label in runs_
              if os.path.exists(ply := os.path.join(d, f"{key}_final.ply"))]
    if panels:
        out.append(_wrote(pl.mesh_grid_figure(
            os.path.join(d, "meshes.png"), panels, device=device)))
    return out


def remeshing(out_dir=None, device=None):
    """Loss curves of the four methods (the regularized baseline, ours,
    remeshed at 750 and at 0) and each one's final Hausdorff distance."""
    methods = ["reg", "base", "remesh_middle", "remesh_start"]
    d = _dir("remeshing", out_dir)
    names = [m for m in methods
             if os.path.isfile(os.path.join(d, f"{m}_loss.csv"))]
    if not names:
        pl.require([os.path.join(d, "base_loss.csv")],
                   "largesteps_torch.figures.remeshing")
    runs, dists = [], []
    for m in names:
        its, im, _ = pl.read_loss_csv(os.path.join(d, f"{m}_loss.csv"))
        runs.append((m, its, im))
        dists.append(pl.read_metrics_csv(
            os.path.join(d, f"{m}_metrics.csv"))["hausdorff"])
    fig, (ax0, ax1) = pl.plt.subplots(1, 2, figsize=(9.2, 3.6))
    pl.loss_axes(ax0, runs)
    pl.bar_axes(ax1, names, dists, "sym. Hausdorff")
    return [pl.save(fig, os.path.join(d, "figure.png"))]


def teaser(out_dir=None, device=None):
    """The four methods' loss curves, Hausdorff distances and final
    meshes side by side."""
    methods = [("ours", "ours"), ("ours_remesh", "ours + remesh"),
               ("reg", "regularized"), ("naive", "naive")]
    d = _dir("teaser", out_dir)
    pl.require([os.path.join(d, "ours_loss.csv")],
               "largesteps_torch.figures.teaser")
    runs, labels, dists = [], [], []
    for key, label in methods:
        lc = os.path.join(d, f"{key}_loss.csv")
        if not os.path.exists(lc):
            continue
        its, im, _ = pl.read_loss_csv(lc)
        runs.append((label, its, im))
        labels.append(label)
        dists.append(pl.read_metrics_csv(
            os.path.join(d, f"{key}_metrics.csv"))["hausdorff"])
    fig, (ax0, ax1) = pl.plt.subplots(1, 2, figsize=(9.2, 3.6))
    pl.loss_axes(ax0, runs)
    pl.bar_axes(ax1, [l.split()[0] for l in labels], dists, "sym. Hausdorff")
    out = [pl.save(fig, os.path.join(d, "figure.png"))]
    panels = [(label, ply) for key, label in methods
              if os.path.exists(ply := os.path.join(d, f"{key}_final.ply"))]
    if panels:
        out.append(_wrote(pl.mesh_grid_figure(
            os.path.join(d, "meshes.png"), panels, device=device)))
    return out


def viewpoints(out_dir=None, device=None):
    """The final symmetric Hausdorff distance against the camera count,
    ours and the regularized baseline."""
    d = _dir("viewpoints", out_dir)
    series = {"ours": {}, "reg": {}}
    if os.path.isdir(d):
        for f in sorted(os.listdir(d)):
            if f.startswith("views_") and f.endswith("_metrics.csv"):
                parts = f[:-len("_metrics.csv")].split("_")
                n = int(parts[1])
                method = parts[2] if len(parts) > 2 else "ours"
                series.setdefault(method, {})[n] = pl.read_metrics_csv(
                    os.path.join(d, f))["hausdorff"]
    if not series["ours"]:
        pl.require([os.path.join(d, "views_1_ours_metrics.csv")],
                   "largesteps_torch.figures.viewpoints")
    fig, ax = pl.plt.subplots(figsize=(4.6, 3.4))
    for k, (method, pts) in enumerate(sorted(series.items())):
        if not pts:
            continue
        cams = sorted(pts)
        ax.plot(cams, [pts[c] for c in cams],
                color=pl.SERIES[k % len(pl.SERIES)], marker="o",
                markersize=5, label=method)
    ax.legend(frameon=False)
    cams = sorted(series["ours"]) or [1]
    ax.set_xlabel("viewpoints")
    ax.set_ylabel("sym. Hausdorff")
    ax.set_xscale("log")
    ax.set_xticks(list(cams), [str(c) for c in cams])
    return [pl.save(fig, os.path.join(d, "figure.png"))]


FIGURES = {f.__name__: f for f in (comparison, influence, multiscale,
                                   reg_fail, remeshing, teaser, viewpoints)}


def draw(exp, out_dir=None, device=None):
    """Draw figure ``exp``; returns the paths written."""
    return FIGURES[exp](out_dir, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("exp", nargs="*",
                    help=f"figures to draw, of {', '.join(FIGURES)} "
                         f"(default: every figure whose experiment has "
                         f"output)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = [e for e in args.exp if e not in FIGURES]
    if unknown:
        ap.error(f"unknown figure {unknown[0]!r}; choose from "
                 f"{', '.join(FIGURES)}")
    exps = args.exp or [e for e in FIGURES
                        if os.path.isdir(_dir(e, None))]
    if not exps:
        raise SystemExit(f"no experiment output under {common.OUTPUT_DIR}")
    return {e: draw(e, device=args.device) for e in exps}


if __name__ == "__main__":
    main()
