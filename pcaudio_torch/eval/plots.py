"""The paper's figures from the experiment files (the port's copy of the
paper-figure part of ``pcaudio/eval/plots.py``).

Re-implements ``Code/paper_plots/plots.py`` (expt 1 and expt 2 figures) and
``Code/paper_plots/plots_rebut.py`` (the importance-sampling overlay) over
the reference schemas that ``cli eval`` writes: the framewise and temporal
(Fs, N) robustness pairs, the framewise and temporal subsampling curves,
and the rebuttal overlay; and the MoG clustering figures of
``set_transformer-master/plots.py`` for ``tasks.clustering``.  matplotlib
is imported inside the functions only: the module imports where
matplotlib is missing, and only drawing needs it.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, Optional, Sequence

import numpy as np


def _load(path_or_dict) -> Dict:
    if isinstance(path_or_dict, (str,)):
        with open(path_or_dict) as f:
            return json.load(f)
    return path_or_dict


def plot_expt1_pair(
    baseline, set_model, *,
    baseline_title: str, set_title: str,
    train_window: int, xlim, out_path: Optional[str] = None,
    drop_last: int = 2,
):
    """Two-panel accuracy-vs-window-size figure (``plots.py:12-98``): grid
    baseline on the left with the shaded cannot-process region beyond its
    training window, set model on the right, one curve per sampling rate."""
    import matplotlib.pyplot as plt

    db, ds = _load(baseline), _load(set_model)
    fig, axes = plt.subplots(1, 2, figsize=(8, 3.2), constrained_layout=True)
    for ax, d, title in ((axes[0], db, baseline_title),
                         (axes[1], ds, set_title)):
        xs = d["list_N"][: len(d["list_N"]) - drop_last or None]
        for F, accs in d["data"].items():
            ys = accs[: len(xs)]
            ax.plot(xs, ys, ".-", label=str(int(float(F))))
        ax.grid(True)
        ax.set_ylim(0.1, 0.7)
        ax.set_xlim(*xlim)
        ax.set_title(title)
        ax.set_xlabel("Window Size (Samples)")
    axes[0].axvspan(train_window, xlim[1], facecolor="gray", alpha=0.5)
    axes[0].text(train_window * 1.1, 0.42,
                 "Baseline cannot process inputs\nlarger than training window",
                 fontsize=7.5, va="top")
    axes[0].set_ylabel("Accuracy")
    axes[1].legend(fontsize=7, title="Fs")
    if out_path:
        fig.savefig(out_path, transparent=True, bbox_inches="tight")
    return fig


def _expt2_curves(d: Dict, ntot: int):
    ks = np.asarray(d["list_K"], dtype=float) / ntot
    mean = np.array([d["data"][str(k) if str(k) in d["data"] else k][0]
                     for k in d["list_K"]])
    var = np.array([d["data"][str(k) if str(k) in d["data"] else k][1]
                    for k in d["list_K"]])
    return ks, mean, var


def plot_expt2_pair(
    set_randk, set_maxk, base_randk, base_maxk, *,
    ntot: int, set_title: str, baseline_title: str,
    out_path: Optional[str] = None,
):
    """Accuracy vs fraction-of-points-kept (``plots.py:104-224``): rand-K with
    ±std band (mean of 10 runs) and top-K, set model vs baseline.  ``ntot`` is
    1024 framewise / 5120 temporal (``plots.py:104,166``)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 3.4), constrained_layout=True)
    for (rk, mk, title, ls) in (
        (_load(set_randk), _load(set_maxk), set_title, "-"),
        (_load(base_randk), _load(base_maxk), baseline_title, "--"),
    ):
        ks, mean, var = _expt2_curves(rk, ntot)
        std = np.sqrt(var)
        ax.plot(ks, mean, ls, label=f"{title} rand-K")
        ax.fill_between(ks, mean - std, mean + std, alpha=0.25)
        ks, mean, _ = _expt2_curves(mk, ntot)
        ax.plot(ks, mean, ls, label=f"{title} top-K")
    ax.grid(True)
    ax.set_xlabel("Fraction of input points kept")
    ax.set_ylabel("Accuracy")
    ax.legend(fontsize=8)
    if out_path:
        fig.savefig(out_path, transparent=True, bbox_inches="tight")
    return fig


def plot_rebut_overlay(
    naive_randk, naive_maxk, imp_randk, imp_maxk, *,
    ntot: int = 5120, win_f: int = 64, out_path: Optional[str] = None,
):
    """Naive vs importance-sampled subsampling curves
    (``plots_rebut.py:13-87``)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 3.4), constrained_layout=True)
    for d, label, ls in ((_load(naive_randk), "rand-K", "-"),
                         (_load(naive_maxk), "top-K", "-")):
        ks, mean, _ = _expt2_curves(d, ntot)
        ax.plot(ks, mean, ls, label=f"naive {label}")
    for d, label in ((_load(imp_randk), "rand-K"),
                     (_load(imp_maxk), "top-K")):
        inner = d["data"][str(win_f) if str(win_f) in d["data"] else win_f]
        ks = np.asarray(d["list_K"], dtype=float) / ntot
        mean = np.array([inner[str(k) if str(k) in inner else k][0]
                         for k in d["list_K"]])
        ax.plot(ks, mean, "--", label=f"importance {label} (winF={win_f})")
    ax.grid(True)
    ax.set_xlabel("Fraction of input points kept")
    ax.set_ylabel("Accuracy")
    ax.legend(fontsize=8)
    if out_path:
        fig.savefig(out_path, transparent=True, bbox_inches="tight")
    return fig


def generate_all(plots_dir: str, out_dir: str,
                 log: Callable[[str], None] = print) -> Sequence[str]:
    """Draw the five paper figures from a directory of result files with
    the reference names (``FST_expt1.json`` …) into ``out_dir``; returns
    the paths written.  A figure whose files are not all there is skipped
    and named through ``log`` (the rebuttal overlay needs the files of
    ``cli eval --experiments rebut`` beside 3ST's expt-2 files); no figure
    at all is an error."""
    import os

    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    figures = [
        ("framewise_N_Fs_varying.pdf", plot_expt1_pair,
         ("FB_expt1.json", "FST_expt1.json"),
         dict(baseline_title="FB", set_title="FST", train_window=2048,
              xlim=(1000, 4200))),
        ("temporal_N_Fs_varying.pdf", plot_expt1_pair,
         ("CNNTemp_expt1.json", "3ST_expt1.json"),
         dict(baseline_title="CNN", set_title="3ST", train_window=1024,
              xlim=(500, 2200))),
        ("framewise_subsampling.pdf", plot_expt2_pair,
         ("FST_randK_expt2.json", "FST_maxK_expt2.json",
          "FB_randK_expt2.json", "FB_maxK_expt2.json"),
         dict(ntot=1024, set_title="FST", baseline_title="FB")),
        ("temporal_subsampling.pdf", plot_expt2_pair,
         ("3ST_randK_expt2.json", "3ST_maxK_expt2.json",
          "CNNTemp_randK_expt2.json", "CNNTemp_maxK_expt2.json"),
         dict(ntot=5120, set_title="3ST", baseline_title="CNN")),
        ("rebut_importance.pdf", plot_rebut_overlay,
         ("3ST_randK_expt2.json", "3ST_maxK_expt2.json",
          "3ST_rebut_expt_randK.json", "3ST_rebut_expt_maxK.json"), {}),
    ]
    outs = []
    for name, plot, files, kw in figures:
        paths = [os.path.join(plots_dir, f) for f in files]
        missing = [f for f, q in zip(files, paths) if not os.path.exists(q)]
        if missing:
            log(f"skipped {name}: no {', '.join(missing)} in {plots_dir}")
            continue
        out = os.path.join(out_dir, name)
        plt.close(plot(*paths, out_path=out, **kw))
        outs.append(out)
    if not outs:
        raise FileNotFoundError(f"no figure's result files in {plots_dir}")
    return outs


# ---------------------------------------------------------------------------
# MoG clustering visualization (``set_transformer-master/plots.py:7-41``)
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def draw_ellipse(pos, cov, ax, **kwargs):
    """2-sigma covariance ellipse for one Gaussian component."""
    import matplotlib.patches as mpatches
    import numpy.linalg as la

    vals, vecs = la.eigh(cov)
    order = vals.argsort()[::-1]
    vals, vecs = vals[order], vecs[:, order]
    theta = np.degrees(np.arctan2(*vecs[:, 0][::-1]))
    w, h = 4 * np.sqrt(np.maximum(vals, 0))
    ax.add_patch(mpatches.Ellipse(pos, w, h, angle=theta, alpha=0.25,
                                  **kwargs))


def scatter_mog(X, labels, mu, cov, ax=None):
    """Scatter a clustered point set with per-component covariance ellipses."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    K = mu.shape[0]
    cmap = plt.get_cmap("tab10")
    for k in range(K):
        pts = X[labels == k]
        ax.scatter(pts[:, 0], pts[:, 1], s=4, color=cmap(k % 10))
        draw_ellipse(mu[k], cov[k], ax, color=cmap(k % 10))
    return ax


def plot_clustering_batch(X, labels, mu, sigma, out_path=None, ncols=2):
    """Grid of clustered sets (``mixture_of_mvns.py:48-58``): diagonal sigmas
    become diag covariance ellipses.  ``X [B, N, 2]``, ``labels [B, N]``,
    ``mu``/``sigma [B, K, 2]``, as tensors or arrays."""
    import matplotlib.pyplot as plt

    X, labels, mu, sigma = map(_host, (X, labels, mu, sigma))
    B = X.shape[0]
    nrows = -(-B // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 3 * nrows))
    for i, ax in enumerate(np.atleast_1d(axes).flatten()):
        if i >= B:
            ax.axis("off")
            continue
        cov = np.stack([np.diag(s ** 2) for s in sigma[i]])
        scatter_mog(X[i], labels[i], mu[i], cov, ax=ax)
        ax.set_xticks([])
        ax.set_yticks([])
    if out_path:
        fig.savefig(out_path, bbox_inches="tight")
    return fig
