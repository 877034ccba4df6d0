"""pcaudio_torch command-line interface (counterpart of ``pcaudio/cli.py``).

    python -m pcaudio_torch.cli train FST|FB|3ST|CNNTemp \\
        --esc-csv esc50.csv --esc-audio audio/ --out-dir runs/fst \\
        [--epochs N] [--checkpoint-every N] [--max-steps N] \\
        [--device cuda|cpu]
    python -m pcaudio_torch.cli eval --config FST_config.json \\
        (--pth FST_net.pth | --checkpoint runs/fst) --esc-csv esc50.csv \\
        --esc-audio audio/ [--experiments expt1 expt2 rebut] [--out-dir DIR] \\
        [--device cuda|cpu]
    python -m pcaudio_torch.cli plots --results-dir DIR --out-dir figures/
    python -m pcaudio_torch.cli modelnet40 --data ModelNet40_cloud.h5 \\
        [--num_pts 1000] [--train_epochs 2000] [--log-dir result] \\
        [--device cuda|cpu]
    python -m pcaudio_torch.cli clustering [--model set_transformer|deepset] \\
        [--mode train|bench] [--num_steps 50000] [--device cuda|cpu]
    python -m pcaudio_torch.cli max-regression [--steps 500] [--device cuda|cpu]

``train`` featurizes the seeded ESC-10 train/test split on the device, trains
the recipe (``pcaudio_torch.train.recipes``) and writes, under ``--out-dir``,
the training checkpoints ``step_<epoch>.pt``, the reference config sidecar
``reference_config.json`` and the weights as a reference-convention
``<recipe>_net.pth`` (with the ``module.`` prefix for FST and 3ST, without
for FB and CNNTemp, as the reference saves them), which ``pcaudio_torch.
serve.AudioClassifier.from_reference_checkpoint`` loads for a 3ST.

``eval`` runs the paper's robustness sweeps (``pcaudio_torch.eval.
experiments``) for the config's model (FST, FB, 3ST or CNN_Temp) on its
seeded test split and writes ``<tag>_expt1.json``,
``<tag>_randK_expt2.json`` and ``<tag>_maxK_expt2.json`` in the
reference's schema, each with a ``.provenance.json`` side-file; ``rebut``
(3ST only; another model prints so and writes nothing) writes
``3ST_rebut_expt_randK.json`` and ``3ST_rebut_expt_maxK.json``.

``plots`` draws the paper's five figures from a directory of those files
(``pcaudio_torch.eval.plots``; needs matplotlib).

``modelnet40``, ``clustering`` and ``max-regression`` are the Set
Transformer's own tasks (``pcaudio_torch.tasks``), with the JAX commands'
flags and defaults: ``modelnet40`` trains on the ModelNet40 h5 dump and
writes each epoch's record to ``<log-dir>/<exp_name>.jsonl``
(``utils.MetricsWriter``; ``--log-dir ''`` writes none); ``clustering``
trains the amortized MoG clusterer and then, in either mode, prints its
benchmark as one JSON line (``model_ll``, ``oracle_ll``);
``max-regression`` trains the small ST and the max- and mean-pool
DeepSets and prints their final MAEs as one JSON line.

Every command but ``plots`` runs on ``cuda`` unless ``--device cpu`` is
given; without a CUDA device that is an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _add_esc_args(p):
    p.add_argument("--esc-csv", required=True, help="path to esc50.csv")
    p.add_argument("--esc-audio", required=True,
                   type=lambda s: os.path.join(s, ""),
                   help="path to the ESC-50 audio directory")


def _device(args):
    """``--device`` as a ``torch.device``; exits naming ``--device cpu``
    where it asks for a card that is not there."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(args.device)


def cmd_train(args):
    """Train a recipe; returns ``(state, history)``."""
    from pcaudio_torch.checkpoint import export_reference_pth, save_checkpoint
    from pcaudio_torch.data import load_esc_split_waves
    from pcaudio_torch.train import (
        RECIPES, build_trainer, fit, make_eval_step, make_train_step,
        prepare_data)

    device = _device(args)
    cfg = RECIPES[args.recipe]()
    if args.epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    splits = {}
    for split in ("train", "test"):
        waves, lengths, labels = load_esc_split_waves(
            args.esc_csv, args.esc_audio, cfg.numpy_seed, split=split)
        splits[split] = prepare_data(waves, lengths, labels, cfg, device=device)
    key, what = ("points", "clouds") if cfg.is_set_model else ("x", "inputs")
    print(f"{args.recipe}: {len(splits['train']['labels'])} train / "
          f"{len(splits['test']['labels'])} test {what} of shape "
          f"{tuple(splits['train'][key].shape[1:])} on {device}")

    state, apply_fn = build_trainer(cfg, device=device)
    state, history = fit(
        state, make_train_step(apply_fn, state.optimizer), splits["train"],
        batch_size=cfg.batch_size, epochs=cfg.epochs, seed=cfg.numpy_seed,
        eval_data=splits["test"], eval_step=make_eval_step(apply_fn),
        eval_every=10, checkpoint_dir=args.out_dir,
        checkpoint_every=args.checkpoint_every, config=cfg,
        max_steps=args.max_steps)
    last = history[-1]["epoch"] + 1 if history else cfg.epochs
    save_checkpoint(args.out_dir, state, cfg, step=last)
    pth = os.path.join(args.out_dir, f"{args.recipe}_net.pth")
    export_reference_pth(state.model, pth, cfg)
    print(f"saved checkpoint step_{last}.pt and {os.path.basename(pth)} "
          f"to {args.out_dir}")
    return state, history


def _fused_attn_choice(device) -> bool:
    """Whether the sweeps run kernel K4: ``PCAUDIO_FUSED_ATTN`` unset means
    K4 on a CUDA device and the plain attention on the CPU, ``"0"`` the
    plain attention, ``"1"`` K4 (an error on the CPU: K4 has no CPU
    mode)."""
    env = os.environ.get("PCAUDIO_FUSED_ATTN")
    if env is None:
        return device.type == "cuda"
    if env == "0":
        return False
    if env == "1":
        if device.type != "cuda":
            raise RuntimeError("PCAUDIO_FUSED_ATTN=1 asks for kernel K4, which "
                               "needs a CUDA device; unset it or set 0 on the "
                               "CPU")
        return True
    raise ValueError(f"PCAUDIO_FUSED_ATTN={env!r}: expected 0 or 1")


def _fused_parity_gate(cfg, model, fmodel, waves, lengths):
    """Argmax agreement of the fused-attention model ``fmodel`` with the
    plain one ``model`` on the first real microbatch: at most 256 valid
    frames or chunks of the first 8 test clips at the training config,
    unmasked and with the expt-2 engine's rank mask (K = n/2).

    Tie-aware: a disagreement is accepted only as a top-2 near-tie, its
    plain logits' top-2 gap within twice the largest logit deviation the
    two models show on this probe, and at most 2 % of rows may disagree.
    Returns ``(passed, record)``."""
    import torch

    from pcaudio_torch.core.config import ARCH_FST
    from pcaudio_torch.dsp.featurize import FeaturizeConfig, featurize_batch
    from pcaudio_torch.eval.experiments import (
        _ranks_desc, _temporal_rows, _valid_frames)
    from pcaudio_torch.ops.cloud import (
        frame_cloud, freq_coords, grid_cloud, time_coords)

    rows, nb, dev = 256, min(len(waves), 8), waves.device
    fcfg = FeaturizeConfig(fs=cfg.sampling_rate, n_fft=cfg.window_size,
                           top_db=cfg.trim_dB, trim=True)
    lm, fm = featurize_batch(waves[:nb], lengths[:nb], fcfg)
    zeros = torch.zeros(nb, dtype=torch.int64, device=dev)
    if cfg.architecture == ARCH_FST:
        frames, valid, _ = _valid_frames(lm, fm, zeros)
        clouds = frame_cloud(frames, freq_coords(frames.shape[-1],
                                                 cfg.sampling_rate, device=dev))
    else:
        flat, valid, _ = _temporal_rows(lm, fm, zeros, cfg.Ntemp)
        clouds = grid_cloud(
            flat, freq_coords(flat.shape[-1], cfg.sampling_rate, device=dev),
            time_coords(cfg.Ntemp, cfg.window_size, cfg.sampling_rate,
                        cfg.hop_factor, device=dev))
    clouds = clouds[valid][:rows]
    kmask = _ranks_desc(clouds[..., -1]) < clouds.shape[1] // 2
    agree = total = 0
    max_dev = bad_gap = 0.0
    with torch.no_grad():
        for m in (None, kmask):
            lf, lx = fmodel(clouds, m), model(clouds, m)
            max_dev = max(max_dev, float((lf - lx).abs().max()))
            eq = lf.argmax(-1) == lx.argmax(-1)
            agree += int(eq.sum())
            total += clouds.shape[0]
            if not bool(eq.all()):
                top2 = lx.sort(dim=-1).values[:, -2:]
                gaps = top2[:, 1] - top2[:, 0]
                bad_gap = max(bad_gap, float(gaps[~eq].max()))
    tie_tol = 2.0 * max_dev
    passed = agree == total or (total - agree <= max(1, total // 50)
                                and bad_gap <= tie_tol)
    return passed, {
        "agreement": [agree, total],
        "rows": int(clouds.shape[0]),
        "max_logit_dev": max_dev,
        "worst_disagree_top2_gap": bad_gap,
        "tie_tolerance": tie_tol,
        "probe": "first real featurized microbatch at the training config, "
                 "unmasked + expt2-style rank-mask (K = n_points/2); "
                 "disagreements accepted only as top-2 near-ties within "
                 "2x the measured fused-vs-plain logit deviation",
    }


def _model(cfg, state_dict, fused_attn: bool, device):
    model = cfg.build_model(fused_attn=fused_attn)
    model.load_state_dict(state_dict)
    return model.to(device).eval()


def cmd_eval(args):
    """Run the sweeps of ``args.experiments`` and write their files; returns
    ``{file name: result dict}`` and the provenance.

    On a CUDA device an FST's or a 3ST's attention runs through kernel K4
    unless ``PCAUDIO_FUSED_ATTN=0``, after :func:`_fused_parity_gate`
    holds the K4 model against the plain one; the baselines have no
    attention and run plain (provenance ``engine: "plain"``).  Unlike the
    JAX ``cmd_eval``, which falls back to its XLA path when the gate fails,
    a failed gate prints the gate's record and exits non-zero: no fallback
    hides the kernel."""
    import torch

    from pcaudio_torch.checkpoint import load_checkpoint, load_reference_pth
    from pcaudio_torch.core.config import (
        ARCH_3ST, ARCH_CNN, ARCH_FB, ARCH_FST, ExperimentConfig)
    from pcaudio_torch.core.device import resolve_device
    from pcaudio_torch.data import load_esc_split_waves
    from pcaudio_torch.eval import (
        framewise_expt1, framewise_expt2, make_3st_chunk_classifier,
        make_cloud_classifier, make_cnn_chunk_classifier,
        make_fb_frame_classifier, make_fst_frame_classifier,
        rebut_importance_expt, temporal_expt1, temporal_expt2)
    from pcaudio_torch.utils.metrics import dump_with_provenance

    cfg = ExperimentConfig.from_reference_json(args.config)
    arch = cfg.architecture
    tags = {ARCH_FST: "FST", ARCH_FB: "FB", ARCH_3ST: "3ST", ARCH_CNN: "CNNTemp"}
    if arch not in tags:
        raise ValueError(f"unknown architecture {arch!r}")
    device = resolve_device(args.device)
    # the baselines have no attention: no K4, no gate
    fused = _fused_attn_choice(device) and cfg.is_set_model
    state_dict = (load_reference_pth(args.pth) if args.pth
                  else load_checkpoint(args.checkpoint)[0]["model"])
    model = _model(cfg, state_dict, False, device)
    waves, lengths, labels = load_esc_split_waves(
        args.esc_csv, args.esc_audio, cfg.numpy_seed, split="test")
    waves = torch.from_numpy(waves).to(device)
    lengths = torch.from_numpy(lengths).to(device)
    prov = {"engine": "plain", "backend": device.type,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "esc_csv": args.esc_csv, "checkpoint": args.pth or args.checkpoint}
    if fused:
        fmodel = _model(cfg, state_dict, True, device)
        ok, gate = _fused_parity_gate(cfg, model, fmodel, waves, lengths)
        gate["passed"] = ok
        prov["fused_gate"] = gate
        if not ok:
            print(json.dumps(gate), flush=True)
            raise SystemExit(f"eval: the fused attention parity gate failed "
                             f"({gate['agreement'][0]}/{gate['agreement'][1]} "
                             f"agree); set PCAUDIO_FUSED_ATTN=0 for the plain "
                             f"attention")
        model, prov["engine"] = fmodel, "fused"
        print(f"eval: fused masked attention (argmax parity gate passed on "
              f"real data, {gate['agreement'][0]}/{gate['agreement'][1]})",
              flush=True)

    tag = tags[arch]
    os.makedirs(args.out_dir, exist_ok=True)
    results = {}

    def dump(obj, fname, t0):
        dump_with_provenance(obj, os.path.join(args.out_dir, fname),
                             dict(prov, wall_s=time.perf_counter() - t0))
        results[fname] = obj
        print(f"wrote {fname}", flush=True)

    common = dict(fsog=cfg.sampling_rate, Nfft=cfg.window_size,
                  hf=cfg.hop_factor, tDb=cfg.trim_dB, device=device)
    if "expt1" in args.experiments:
        t0 = time.perf_counter()
        if arch == ARCH_FST:
            out = framewise_expt1(make_fst_frame_classifier(model), waves,
                                  lengths, labels, **common)
        elif arch == ARCH_FB:
            out = framewise_expt1(make_fb_frame_classifier(model), waves,
                                  lengths, labels, fixed_nfft=True, **common)
        elif arch == ARCH_3ST:
            out = temporal_expt1(make_3st_chunk_classifier(model), waves,
                                 lengths, labels, Ntemp=cfg.Ntemp, **common)
        else:
            out = temporal_expt1(make_cnn_chunk_classifier(model), waves,
                                 lengths, labels, Ntemp=cfg.Ntemp,
                                 fixed_nfft=True, **common)
        dump(out, f"{tag}_expt1.json", t0)
    if "expt2" in args.experiments:
        t0 = time.perf_counter()
        if arch == ARCH_FST:
            rnd, mx = framewise_expt2(None, make_cloud_classifier(model),
                                      waves, lengths, labels, mode="cloud",
                                      **common)
        elif arch == ARCH_FB:
            rnd, mx = framewise_expt2(make_fb_frame_classifier(model), None,
                                      waves, lengths, labels, mode="replace",
                                      **common)
        elif arch == ARCH_3ST:
            rnd, mx = temporal_expt2(make_cloud_classifier(model), None,
                                     waves, lengths, labels, mode="cloud",
                                     Ntemp=cfg.Ntemp, **common)
        else:
            rnd, mx = temporal_expt2(None, make_cnn_chunk_classifier(model),
                                     waves, lengths, labels, mode="replace",
                                     Ntemp=cfg.Ntemp, **common)
        dump(rnd, f"{tag}_randK_expt2.json", t0)
        dump(mx, f"{tag}_maxK_expt2.json", t0)
    if "rebut" in args.experiments:
        if arch != ARCH_3ST:
            print(f"eval: the rebuttal sweep is 3ST-only; nothing written for "
                  f"{tag}", flush=True)
        else:
            t0 = time.perf_counter()
            rnd, mx = rebut_importance_expt(make_cloud_classifier(model), waves,
                                            lengths, labels, Ntemp=cfg.Ntemp,
                                            **common)
            dump(rnd, "3ST_rebut_expt_randK.json", t0)
            dump(mx, "3ST_rebut_expt_maxK.json", t0)
    return results, prov


def cmd_plots(args):
    """Draw the paper's figures; returns their paths."""
    from pcaudio_torch.eval.plots import generate_all

    outs = generate_all(args.results_dir, args.out_dir)
    for o in outs:
        print(o)
    return outs


def cmd_modelnet40(args):
    """Train on ModelNet40; returns ``(state, history)``."""
    from pcaudio_torch.tasks.modelnet40 import ModelNet40Config, train
    from pcaudio_torch.utils.metrics import MetricsWriter

    device = _device(args)
    cfg = ModelNet40Config(num_pts=args.num_pts,
                           learning_rate=args.learning_rate,
                           batch_size=args.batch_size, dim=args.dim,
                           n_heads=args.n_heads, n_anc=args.n_anc,
                           train_epochs=args.train_epochs)
    metrics = (MetricsWriter(os.path.join(args.log_dir, cfg.exp_name + ".jsonl"))
               if args.log_dir else None)
    try:
        return train(cfg, args.data, metrics=metrics, device=device)
    finally:
        if metrics is not None:
            metrics.close()


def cmd_clustering(args):
    """Train the MoG clusterer, then print and return its benchmark
    ``{"model_ll", "oracle_ll"}``."""
    from pcaudio_torch.tasks.clustering import ClusteringConfig, benchmark, train

    device = _device(args)
    cfg = ClusteringConfig(model=args.model, K=args.K,
                           num_steps=args.num_steps, B=args.B)
    model, _, _ = train(cfg, device=device)
    mll, oll = benchmark(model, cfg)
    out = {"model_ll": mll, "oracle_ll": oll}
    print(json.dumps(out))
    return out


def cmd_max_regression(args):
    """Train the three max-regression models (weights from torch seed 0),
    then print and return their final MAEs."""
    import torch

    from pcaudio_torch.tasks.max_regression import (
        SmallDeepSet, SmallSetTransformer, train)

    device = _device(args)
    out = {}
    for name, make in (("set_transformer", SmallSetTransformer),
                       ("deepset_max", lambda: SmallDeepSet(pool="max")),
                       ("deepset_mean", lambda: SmallDeepSet(pool="mean"))):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = make()
        _, out[name] = train(model, steps=args.steps, log=print, device=device)
    print(json.dumps(out))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pcaudio_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("train", help="train a reference recipe")
    p.add_argument("recipe", choices=["FST", "FB", "3ST", "CNNTemp"])
    _add_esc_args(p)
    p.add_argument("--epochs", type=int, default=None,
                   help="override the recipe's 500 epochs")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="save a checkpoint every N epochs")
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after N optimizer steps in all")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="run the paper's robustness sweeps")
    e.add_argument("--config", required=True, help="reference *_config.json")
    w = e.add_mutually_exclusive_group(required=True)
    w.add_argument("--pth", help="reference-convention *_net.pth")
    w.add_argument("--checkpoint",
                   help="directory of this package's step_*.pt checkpoints")
    _add_esc_args(e)
    e.add_argument("--experiments", nargs="+", default=["expt1", "expt2"],
                   choices=["expt1", "expt2", "rebut"])
    e.add_argument("--out-dir", default="paper_plots")
    e.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    e.set_defaults(fn=cmd_eval)

    pl = sub.add_parser("plots", help="draw the paper's figures")
    pl.add_argument("--results-dir", required=True,
                    help="directory of the eval result files")
    pl.add_argument("--out-dir", required=True)
    pl.set_defaults(fn=cmd_plots)

    m = sub.add_parser("modelnet40", help="ModelNet40 classification")
    m.add_argument("--data", required=True, help="the ModelNet40 h5 dump")
    m.add_argument("--num_pts", type=int, default=1000)
    m.add_argument("--learning_rate", type=float, default=1e-3)
    m.add_argument("--batch_size", type=int, default=64)
    m.add_argument("--dim", type=int, default=256)
    m.add_argument("--n_heads", type=int, default=4)
    m.add_argument("--n_anc", type=int, default=16)
    m.add_argument("--train_epochs", type=int, default=2000)
    m.add_argument("--log-dir", default="result")
    m.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    m.set_defaults(fn=cmd_modelnet40)

    c = sub.add_parser("clustering", help="amortized MoG clustering demo")
    c.add_argument("--model", default="set_transformer",
                   choices=["set_transformer", "deepset"])
    c.add_argument("--mode", default="train", choices=["train", "bench"])
    c.add_argument("--K", type=int, default=4)
    c.add_argument("--B", type=int, default=10)
    c.add_argument("--num_steps", type=int, default=50000)
    c.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    c.set_defaults(fn=cmd_clustering)

    x = sub.add_parser("max-regression", help="max-of-set regression demo")
    x.add_argument("--steps", type=int, default=500)
    x.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    x.set_defaults(fn=cmd_max_regression)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
