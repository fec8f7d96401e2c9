"""Training launcher: sandwich-rule supernet training with atomic
checkpointing and restart (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --units 2 --steps 100 --ckpt-dir ck

It takes every flag of the reference and the port's launcher convention
(as ``launch/serve.py``): ``--device`` (default ``cuda``), ``--size
{full,reduced}`` (the published widths and depth, the default on
``cuda``; the small fp32 twin, the default on ``cpu`` and refused on the
card) and ``--units N`` (the first N repeat units). The reference's
``--reduced`` is on by default and cannot be turned off; here it means
``--size reduced``. A run that would not fit the device (parameters, bf16
gradients and two fp32 moments) is refused before it allocates.
Re-invoking the same command resumes from the latest valid checkpoint.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import torch

from repro_torch import compat
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.serving.executor import (check_fits, free_bytes,
                                          serving_config)
from repro_torch.training import data, optimizer as opt
from repro_torch.training.trainer import Trainer, TrainerConfig, TrainerState


def training_bytes(cfg: ArchConfig) -> int:
    """Bytes a training run holds before activations: the parameters,
    gradients of the same types, and AdamW's two fp32 moments of every
    leaf."""
    return 2 * lm.param_bytes(cfg) + 2 * lm.param_bytes(cfg, torch.float32)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="the same as --size reduced")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--n-random", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--size", default=None, choices=("full", "reduced"),
                    help="full: published widths and depth (default on "
                         "cuda); reduced: the small fp32 twin (default on "
                         "cpu)")
    ap.add_argument("--units", type=int, default=None,
                    help="train the first N repeat units of each stage")
    args = ap.parse_args(argv)
    if args.reduced:
        if args.size == "full":
            ap.error("--reduced is --size reduced; not with --size full")
        args.size = "reduced"
    return args


def main(argv: Optional[List[str]] = None) -> TrainerState:
    args = parse_args(argv)
    cfg = serving_config(args.arch, args.device, args.size, args.units)
    device = compat.resolve_device(args.device)
    check_fits(cfg, free_bytes(device), training_bytes(cfg),
               f"{cfg.dtype} weights, gradients and fp32 moments")
    task = data.SyntheticTask(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                              global_batch=args.batch, seed=0, order=1,
                              noise=0.01)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir)
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps)
    tr = Trainer(cfg, ocfg, tcfg, task, n_random=args.n_random,
                 device=device)
    st = tr.resume_or_init(0)
    if st.step:
        print(f"resumed from checkpoint at step {st.step}")
    st = tr.run(st)
    if not st.losses:
        print(f"done: step {st.step}, no step left to run")
        return st
    print(f"done: step {st.step}, loss {st.losses[0]:.3f} -> "
          f"{st.losses[-1]:.3f}, stragglers {len(st.straggler_steps)}")
    return st


if __name__ == "__main__":
    main()
