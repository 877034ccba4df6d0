"""``python -m pcaudio_torch.cli plots`` and ``pcaudio_torch.eval.plots``:
the paper's five figures from the committed result files
(``artifacts/cli_cycle/paper_plots/``), each curve the JAX package's
(``pcaudio.eval.plots``) point for point; a figure whose files are missing
is skipped and named; and the module imports without matplotlib, which the
card's machine lacks."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import pcaudio.eval.plots as jax_plots
import pcaudio_torch.eval.plots as plots
from pcaudio_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "artifacts", "cli_cycle", "paper_plots")
FIGURES = ["framewise_N_Fs_varying.pdf", "temporal_N_Fs_varying.pdf",
           "framewise_subsampling.pdf", "temporal_subsampling.pdf",
           "rebut_importance.pdf"]


def test_cli_plots_draws_the_five_figures(tmp_path):
    out = str(tmp_path / "figures")
    paths = cli.main(["plots", "--results-dir", RESULTS, "--out-dir", out])
    assert [os.path.basename(p) for p in paths] == FIGURES
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(5) == b"%PDF-"
        assert os.path.getsize(p) > 5000


def _curves(fig):
    return [[(np.asarray(line.get_xdata(), float), np.asarray(line.get_ydata(), float))
             for line in ax.get_lines()] for ax in fig.axes]


@pytest.mark.parametrize("which", ["expt1", "expt2", "rebut"])
def test_curves_match_jax(which):
    """The same curves (every line of every panel) as the JAX package's
    figure functions on the same files."""
    import matplotlib.pyplot as plt

    p = lambda n: os.path.join(RESULTS, n)  # noqa: E731
    if which == "expt1":
        args = (p("FB_expt1.json"), p("FST_expt1.json"))
        kw = dict(baseline_title="FB", set_title="FST", train_window=2048,
                  xlim=(1000, 4200))
        fn = "plot_expt1_pair"
    elif which == "expt2":
        args = (p("3ST_randK_expt2.json"), p("3ST_maxK_expt2.json"),
                p("CNNTemp_randK_expt2.json"), p("CNNTemp_maxK_expt2.json"))
        kw = dict(ntot=5120, set_title="3ST", baseline_title="CNN")
        fn = "plot_expt2_pair"
    else:
        args = (p("3ST_randK_expt2.json"), p("3ST_maxK_expt2.json"),
                p("3ST_rebut_expt_randK.json"), p("3ST_rebut_expt_maxK.json"))
        kw = {}
        fn = "plot_rebut_overlay"
    got = getattr(plots, fn)(*args, **kw)
    ref = getattr(jax_plots, fn)(*args, **kw)
    cg, cr = _curves(got), _curves(ref)
    assert [len(a) for a in cg] == [len(a) for a in cr] and sum(map(len, cg)) > 1
    for panel_g, panel_r in zip(cg, cr):
        for (xg, yg), (xr, yr) in zip(panel_g, panel_r):
            np.testing.assert_array_equal(xg, xr)
            np.testing.assert_array_equal(yg, yr)
    plt.close(got)
    plt.close(ref)


def test_missing_files_skip_their_figure(tmp_path):
    """Without the rebuttal sweep's files (``cli eval --experiments rebut``
    writes them; tests/test_torch_cli_eval.py draws the overlay from the
    port's own) the other four figures are drawn and the fifth is named as
    skipped; a directory with no result file is an error."""
    results = tmp_path / "results"
    shutil.copytree(RESULTS, results,
                    ignore=shutil.ignore_patterns("3ST_rebut_*"))
    said = []
    paths = plots.generate_all(str(results), str(tmp_path / "out"), log=said.append)
    assert [os.path.basename(p) for p in paths] == FIGURES[:4]
    assert len(said) == 1 and "rebut_importance.pdf" in said[0]
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        plots.generate_all(str(empty), str(tmp_path / "out2"), log=said.append)


def test_module_imports_without_matplotlib():
    code = ("import sys; import pcaudio_torch.eval.plots, pcaudio_torch.cli; "
            "assert 'matplotlib' not in sys.modules; print('ok')")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
