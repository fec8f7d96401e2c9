"""The training loop (port of ``repro/training/trainer.py``): periodic atomic
checkpoints, crash/preemption restart from the latest valid step, and
straggler detection from per-step time outliers.

The loop is restartable at any instant:
  * data is stateless-by-step (training/data.py),
  * checkpoints are atomic (training/checkpoint.py),
  * the subnets a step samples come from a generator seeded with the step.

With a ``plan`` (``distributed.sharding.ShardingPlan``) a resume places
the parameters with ``plan.params`` and the AdamW moments with the ZeRO-1
``optimizer.state_shardings`` over the plan's mesh, as the reference's
elastic restore does: a checkpoint saved on one mesh resumes on another.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Union

import numpy as np
import torch

from repro_torch import compat
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import data as data_mod
from repro_torch.training import optimizer as opt
from repro_torch.training import supernet


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    keep: int = 3
    straggler_factor: float = 3.0      # step > factor * median -> flagged
    log_every: int = 10


@dataclass
class TrainerState:
    params: Any
    opt_state: Any
    step: int = 0
    straggler_steps: List[int] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)


def _requires_grad(params):
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    return params


class Trainer:
    def __init__(self, cfg, opt_cfg: opt.AdamWConfig, tcfg: TrainerConfig,
                 task: data_mod.SyntheticTask, *, n_random: int = 1,
                 step_fn: Optional[Callable] = None, device=None,
                 plan=None):
        self.cfg = cfg
        self.plan = plan
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.task = task
        self.device = compat.resolve_device(device)
        self.step_fn = step_fn or supernet.make_train_step(
            cfg, opt_cfg, n_random=n_random)

    # -- lifecycle -----------------------------------------------------
    def init_state(self, seed: Union[int, torch.Generator] = 0
                   ) -> TrainerState:
        """Random parameters on the trainer's device from ``seed`` (or a
        generator on that device), every leaf requiring grad, and AdamW's
        zero state."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=self.device).manual_seed(int(seed))
        params = _requires_grad(lm.init_model(self.cfg, gen, self.device))
        return TrainerState(params=params, opt_state=opt.init(params))

    def resume_or_init(self, seed: Union[int, torch.Generator] = 0
                       ) -> TrainerState:
        """Restart-from-failure entry point: the latest complete
        checkpoint, else a fresh state."""
        st = self.init_state(seed)
        last = ckpt.latest_step(self.tcfg.ckpt_dir)
        if last is not None:
            shardings = mesh = None
            if self.plan is not None:
                shardings = {"params": self.plan.params(st.params),
                             "opt": opt.state_shardings(self.plan,
                                                        st.params)}
                mesh = self.plan.mesh
            tree, extra = ckpt.restore(
                self.tcfg.ckpt_dir, {"params": st.params,
                                     "opt": st.opt_state},
                shardings=shardings, mesh=mesh)
            st.params = _requires_grad(tree["params"])
            st.opt_state = tree["opt"]
            st.step = int(extra.get("step", last))
        return st

    # -- loop ----------------------------------------------------------
    def run(self, st: TrainerState, *, until: Optional[int] = None,
            crash_at: Optional[int] = None) -> TrainerState:
        """Run to ``until`` (or total_steps). ``crash_at`` simulates a
        hard failure (tests/examples) AFTER that step's compute, before
        its checkpoint. A step's time ends when its loss is read back,
        which waits for the device."""
        until = until or self.tcfg.total_steps
        times: List[float] = []
        while st.step < until:
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.task.batch(st.step).items()}
            gen = torch.Generator().manual_seed(st.step)
            t0 = time.perf_counter()
            st.params, st.opt_state, metrics = self.step_fn(
                st.params, st.opt_state, batch, gen)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            st.step += 1
            st.losses.append(loss)
            # straggler detection: compare against the running median
            times.append(dt)
            if len(times) >= 8:
                med = float(np.median(times[-32:]))
                if dt > self.tcfg.straggler_factor * med:
                    st.straggler_steps.append(st.step)
            if crash_at is not None and st.step == crash_at:
                raise RuntimeError(f"simulated node failure at step {st.step}")
            if st.step % self.tcfg.ckpt_every == 0 or st.step == until:
                ckpt.save(self.tcfg.ckpt_dir, st.step,
                          {"params": st.params, "opt": st.opt_state},
                          extra={"step": st.step})
                ckpt.prune(self.tcfg.ckpt_dir, keep=self.tcfg.keep)
        return st
