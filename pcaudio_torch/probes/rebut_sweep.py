"""The paper's importance-sampling rebuttal sweep at full length on the card:
``cli eval --experiments rebut`` with a 3ST at the recipe's width (64
hidden, 64 inducing points, 8 heads; weights from a seed), on the
synthetic ESC-10 corpus at 40 clips a class (80 test clips), one window
width (64) and every K of ``default_list_K(5120)`` (103), one randK run:
the shape of ``artifacts/cli_cycle/paper_plots/3ST_rebut_expt_*.json``.

    python -m pcaudio_torch.probes.rebut_sweep [--clips-per-class 40] [--dir DIR]

Prints the corpus' set-up time, the sweep's wall time (and the CLI's own
``wall_s``), its engine and parity gate, K4's forward launches, the test
chunks and forwards, and the maxK accuracy range, each line with the
card's name and power limit; the last line is the same as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import torch

from pcaudio_torch import cli
from pcaudio_torch.checkpoint import export_reference_pth
from pcaudio_torch.data import generate_esc_corpus
from pcaudio_torch.eval.experiments import _MB_CHUNKS, default_list_K
from pcaudio_torch.ops.kernels.mha import fused_mha_fwd
from pcaudio_torch.probes.timing import card
from pcaudio_torch.train import RECIPES


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clips-per-class", type=int, default=40)
    ap.add_argument("--dir", help="work directory (default: a temporary one, "
                    "removed at the end)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the sweep is timed on the card")
    name_limit = card()
    work = args.dir or tempfile.mkdtemp(prefix="pcaudio_rebut_")
    try:
        t0 = time.perf_counter()
        csv, audio = generate_esc_corpus(os.path.join(work, "corpus"),
                                         clips_per_class=args.clips_per_class)
        corpus_s = time.perf_counter() - t0
        cfg = RECIPES["3ST"]()
        torch.manual_seed(args.seed)
        pth = os.path.join(work, "3ST_net.pth")
        export_reference_pth(cfg.build_model(), pth, cfg)
        config = os.path.join(work, "3ST_config.json")
        with open(config, "w") as f:
            json.dump(cfg.to_reference_json(), f)
        out = os.path.join(work, "out")
        os.environ.pop("PCAUDIO_FUSED_ATTN", None)
        fused_mha_fwd.launches = 0
        t0 = time.perf_counter()
        results, prov = cli.main(["eval", "--config", config, "--pth", pth,
                                  "--esc-csv", csv, "--esc-audio", audio,
                                  "--experiments", "rebut", "--out-dir", out,
                                  "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(out, "3ST_rebut_expt_maxK.provenance.json")) as f:
            cli_wall = json.load(f)["wall_s"]
        maxk = results["3ST_rebut_expt_maxK.json"]["data"][64]
        accs = [v[0] for v in maxk.values()]
        list_K = default_list_K(cfg.window_size * cfg.Ntemp // 2)
        # the gate's forwards are K4 launches too (5 attends a forward)
        rec = {"clips_per_class": args.clips_per_class, "corpus_s": corpus_s,
               "sweep_wall_s": wall, "cli_wall_s": cli_wall,
               "engine": prov["engine"],
               "gate": (prov.get("fused_gate") or {}).get("agreement"),
               "k4_fwd_launches": fused_mha_fwd.launches,
               "list_K": len(list_K), "microbatch": _MB_CHUNKS,
               "maxK_accuracy": [min(accs), max(accs)], "device": name_limit}
        print(f"[rebut] corpus ({args.clips_per_class} clips a class) {corpus_s:.1f} s "
              f"({name_limit})")
        print(f"[rebut] cli eval --experiments rebut: {wall:.1f} s of wall time "
              f"(the CLI's wall_s {cli_wall:.1f}), engine {prov['engine']}, gate "
              f"{rec['gate']}, {rec['k4_fwd_launches']} K4 forward launches, "
              f"{len(list_K)} K x (maxK + 1 randK run) a microbatch of "
              f"{_MB_CHUNKS} chunks; maxK accuracy {min(accs):.4f}-{max(accs):.4f} "
              f"({name_limit})")
        print(json.dumps(rec))
        return rec
    finally:
        if not args.dir:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
