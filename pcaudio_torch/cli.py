"""pcaudio_torch command-line interface (counterpart of ``pcaudio/cli.py``).

    python -m pcaudio_torch.cli train FST --esc-csv esc50.csv \\
        --esc-audio audio/ --out-dir runs/fst [--epochs N] \\
        [--checkpoint-every N] [--max-steps N] [--device cuda|cpu]

``train`` featurizes the seeded ESC-10 train/test split on the device, trains
the recipe (``pcaudio_torch.train.recipes``) and writes, under ``--out-dir``,
the training checkpoints ``step_<epoch>.pt``, the reference config sidecar
``reference_config.json`` and the weights as a reference-convention
``<recipe>_net.pth``, which ``pcaudio_torch.serve.AudioClassifier.
from_reference_checkpoint`` loads for a 3ST.  The device is ``cuda`` unless
``--device cpu`` is given; without a CUDA device that is an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def _add_esc_args(p):
    p.add_argument("--esc-csv", required=True, help="path to esc50.csv")
    p.add_argument("--esc-audio", required=True,
                   type=lambda s: os.path.join(s, ""),
                   help="path to the ESC-50 audio directory")


def cmd_train(args):
    """Train a recipe; returns ``(state, history)``."""
    import torch

    from pcaudio_torch.checkpoint import export_reference_pth, save_checkpoint
    from pcaudio_torch.core.config import ARCH_FST
    from pcaudio_torch.data import load_esc_split_waves
    from pcaudio_torch.train import (
        RECIPES, TrainState, build_trainer, fit, make_eval_step,
        make_train_step, prepare_framewise_data, prepare_temporal_data)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the CPU")
    device = torch.device(args.device)
    cfg = RECIPES[args.recipe]()
    if args.epochs is not None:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    prep = (prepare_framewise_data if cfg.architecture == ARCH_FST
            else prepare_temporal_data)
    splits = {}
    for split in ("train", "test"):
        waves, lengths, labels = load_esc_split_waves(
            args.esc_csv, args.esc_audio, cfg.numpy_seed, split=split)
        splits[split] = prep(waves, lengths, labels, cfg, device=device)
    print(f"{args.recipe}: {len(splits['train']['labels'])} train / "
          f"{len(splits['test']['labels'])} test clouds of "
          f"{splits['train']['points'].shape[1]} points on {device}")

    model, apply_fn, optimizer = build_trainer(cfg, device=device)
    state = TrainState(model, optimizer)
    state, history = fit(
        state, make_train_step(apply_fn, optimizer), splits["train"],
        batch_size=cfg.batch_size, epochs=cfg.epochs, seed=cfg.numpy_seed,
        eval_data=splits["test"], eval_step=make_eval_step(apply_fn),
        eval_every=10, checkpoint_dir=args.out_dir,
        checkpoint_every=args.checkpoint_every, config=cfg,
        max_steps=args.max_steps)
    last = history[-1]["epoch"] + 1 if history else cfg.epochs
    save_checkpoint(args.out_dir, state, cfg, step=last)
    pth = os.path.join(args.out_dir, f"{args.recipe}_net.pth")
    export_reference_pth(model, pth)
    print(f"saved checkpoint step_{last}.pt and {os.path.basename(pth)} "
          f"to {args.out_dir}")
    return state, history


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pcaudio_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("train", help="train a reference recipe")
    p.add_argument("recipe", choices=["FST", "3ST"])
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
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
