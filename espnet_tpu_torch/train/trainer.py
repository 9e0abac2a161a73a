"""Epoch-loop trainer (port of espnet_tpu/train/trainer.py).

resume -> for each epoch: the train phase (stats kept on the device between
`log_interval` flushes, one device-to-host copy a flush) -> the valid phase
(`make_eval_step`) -> epoch params, the resume state, the best-epoch link,
pruning and early stopping; after the last epoch, the curves and the n-best
average. Gradient accumulation is `make_train_step(accum_steps=...)`. All
per-step randomness (dropout, SpecAug, the FFN kernels' seeds) comes from one
`torch.Generator` seeded from `seed + 1`, saved with the resume state.
`profile_steps` traces steps [2, 2 + profile_steps) of the first epoch with
`torch.profiler` into <out>/profile. TensorBoard and wandb are used when
installed (as in JAX), and so are matplotlib's curves.

The port's parameters always live in one flat float32 vector (the JAX
package's `flat_optimizer` mode), so `TrainerOptions` has no such switch.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from espnet_tpu_torch.convert import jax_params_to_state_dict, model_params
from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.models.asr import init_random_
from espnet_tpu_torch.train.checkpoint import CheckpointManager
from espnet_tpu_torch.train.reporter import (Reporter, SubReporter,
                                             TensorboardLogger, WandbLogger,
                                             matplotlib_plot)
from espnet_tpu_torch.train.steps import (BATCH_KEYS, TrainState,
                                          make_eval_step, make_train_step)

logger = logging.getLogger("espnet_tpu")


@dataclasses.dataclass
class TrainerOptions:
    max_epoch: int = 40
    patience: Optional[int] = None
    keep_nbest: int = 10
    # phase, key, mode
    best_metric: Tuple[str, str, str] = ("valid", "acc", "max")
    log_interval: int = 50
    seed: int = 0
    resume: bool = True
    # micro-batches per step (make_train_step accum_steps)
    accum_grad: int = 1
    # partial pretrained transfer specs "path:src:dst:excludes"
    init_param: tuple = ()
    # per-epoch attention heat maps of the first validation batch
    # (train/plot.py; PNGs where matplotlib is installed)
    plot_attention: bool = False
    use_wandb: bool = False
    wandb_project: str = ""
    # torch.profiler trace of steps [2, 2 + profile_steps) of the first
    # epoch into <out>/profile; 0 disables
    profile_steps: int = 0


class Trainer:
    def __init__(self, model, tx, out_dir,
                 options: TrainerOptions = TrainerOptions(), device="cuda",
                 batch_arg_names: Tuple[str, ...] = BATCH_KEYS):
        self.model = model
        # the batch fields the model takes, in order
        self.batch_arg_names = tuple(batch_arg_names)
        self.tx = tx
        self.options = options
        self.out_dir = Path(out_dir)
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(out_dir, options.keep_nbest)
        self.reporter = Reporter()
        self.tb = TensorboardLogger(out_dir)
        self.wandb = WandbLogger(options.use_wandb, options.wandb_project)
        self.train_step = None
        self.eval_step = None
        self.generator = torch.Generator().manual_seed(options.seed + 1)
        self.epoch_seconds: Dict[int, float] = {}  # wall time of each epoch
        # every train step's stats as registered: (epoch, stats) on the host
        self.step_log: List[Tuple[int, Dict[str, float]]] = []

    def init_state(self, extra_var_init: Optional[Dict] = None
                   ) -> TrainState:
        """Random parameters from `seed` (then the init_param specs), the
        global-MVN statistics `extra_var_init` ({"mvn": {"mvn": {"mean",
        "inv_std"}}}, as the JAX collection) into the model's buffers; moves
        the model to the device and flattens its parameters there."""
        model = self.model
        init_random_(model, torch.Generator().manual_seed(self.options.seed))
        if self.options.init_param:
            from espnet_tpu_torch.train.pretrained import load_pretrained

            params = model_params(model)
            for spec in self.options.init_param:
                params, _, _ = load_pretrained(params, spec)
            model.load_state_dict(jax_params_to_state_dict(params),
                                  strict=False)
        if extra_var_init:
            mvn = extra_var_init["mvn"]["mvn"]
            with torch.no_grad():
                model.mvn.mean.copy_(torch.from_numpy(
                    np.asarray(mvn["mean"], np.float32)))
                model.mvn.inv_std.copy_(torch.from_numpy(
                    np.asarray(mvn["inv_std"], np.float32)))
        self.train_step = make_train_step(model, self.tx, self.device,
                                          accum_steps=self.options.accum_grad,
                                          batch_keys=self.batch_arg_names)
        self.eval_step = make_eval_step(model, self.device,
                                        batch_keys=self.batch_arg_names)
        return TrainState.create(model, self.tx)

    def _flush(self, sub: SubReporter, pending: List, t_win: float) -> None:
        """Register the pending steps' stats with one device-to-host copy;
        step_time is the window's wall time over its steps."""
        if not pending:
            return
        keys = list(pending[0][0])
        values = torch.stack([torch.stack([st[k].float() for k in keys])
                              for st, _ in pending]).cpu().tolist()
        dt = (time.perf_counter() - t_win) / len(pending)
        for row, (_, weight) in zip(values, pending):
            stats = dict(zip(keys, row))
            stats["step_time"] = dt
            sub.register(stats, weight=weight)
            self.step_log.append((sub.epoch, stats))
        pending.clear()

    def run(self, state: TrainState, train_iter, valid_iter=None,
            hooks: Iterable[Callable] = ()) -> TrainState:
        opts = self.options
        names = self.batch_arg_names
        start_epoch = 1
        if opts.resume and self.ckpt.has_checkpoint():
            state, last_epoch, rep_state, gen_state = self.ckpt.load_state(
                state, self.model)
            self.reporter.load_state_dict(rep_state)
            if gen_state is not None:
                self.generator.set_state(gen_state)
            start_epoch = last_epoch + 1
            logger.info("resumed from epoch %d", last_epoch)

        for epoch in range(start_epoch, opts.max_epoch + 1):
            self.reporter.start_epoch(epoch)
            t0 = time.perf_counter()
            # ---- train phase ----
            sub = SubReporter("train", epoch)
            n_steps = train_iter.num_steps()
            pending: List = []
            t_win = time.perf_counter()
            profiler = None
            for i, batch in enumerate(train_iter.epoch(epoch), 1):
                if i == 1:
                    from espnet_tpu_torch.utils.typecheck import check_batch

                    check_batch(batch, names)
                if opts.profile_steps and epoch == start_epoch:
                    profiler = self._profile(i, profiler)
                state, stats = self.train_step(state, batch, self.generator)
                pending.append((stats, len(batch[names[0]])))
                if i % opts.log_interval == 0:
                    self._flush(sub, pending, t_win)
                    t_win = time.perf_counter()
                    logger.info(sub.log_message(i, n_steps))
            self._flush(sub, pending, t_win)
            if profiler is not None:  # short epoch: close the trace
                self._stop_profile(profiler)
            train_stats = self.reporter.finish_phase(sub)
            self.tb.log_epoch(epoch, "train", train_stats)
            self.wandb.log_epoch(epoch, "train", train_stats)

            # ---- valid phase ----
            if valid_iter is not None:
                sub = SubReporter("valid", epoch)
                plot_batch = None
                for batch in valid_iter.epoch(epoch):
                    if plot_batch is None:
                        plot_batch = batch
                    stats = self.eval_step(state, batch)
                    keys = list(stats)
                    row = torch.stack([stats[k] for k in keys]).cpu().tolist()
                    sub.register(dict(zip(keys, row)),
                                 weight=len(batch[names[0]]))
                valid_stats = self.reporter.finish_phase(sub)
                self.tb.log_epoch(epoch, "valid", valid_stats)
                self.wandb.log_epoch(epoch, "valid", valid_stats)
                if opts.plot_attention and plot_batch is not None:
                    from espnet_tpu_torch.train.plot import \
                        dump_attention_plots

                    dump_attention_plots(self.model, plot_batch,
                                         self.out_dir, epoch, tb=self.tb)

            for hook in hooks:
                hook(self, state, epoch)

            # ---- checkpoint + best/prune ----
            self.ckpt.save_epoch_params(self.model, epoch)
            self.ckpt.save_state(state, epoch, self.reporter.state_dict(),
                                 self.generator.get_state())
            phase, key, mode = self._best_metric(valid_iter)
            best = self.reporter.best_epoch(phase, key, mode)
            if best is not None:
                self.ckpt.link_best(best, f"{phase}.{key}.best")
            ranked = [e for e, _ in self.reporter.sort_epochs(phase, key,
                                                              mode)]
            self.ckpt.prune(ranked[: opts.keep_nbest] + [epoch])

            dt = time.perf_counter() - t0
            self.epoch_seconds[epoch] = dt
            logger.info(
                "epoch %d done in %.1fs: %s", epoch, dt,
                ", ".join(f"{k}={v:.4g}"
                          for k, v in sorted(train_stats.items())))
            if opts.patience is not None and \
                    self.reporter.check_early_stopping(opts.patience, phase,
                                                       key, mode):
                logger.info("early stopping at epoch %d", epoch)
                break
        self._plot()
        self.tb.close()
        self.wandb.close()
        # n-best average
        phase, key, mode = self._best_metric(valid_iter)
        ranked = [e for e, _ in self.reporter.sort_epochs(phase, key, mode)]
        keep = [e for e in ranked[: opts.keep_nbest]
                if self.ckpt.params_path(e).exists()]
        if keep:
            self.ckpt.average_nbest(keep, f"{phase}.{key}")
        return state

    def _best_metric(self, valid_iter):
        if valid_iter is None:
            return "train", "loss", "min"
        return self.options.best_metric

    def _profile(self, i: int, profiler):
        """Start the trace before step 2 (step 1 builds the kernels); stop
        it before step 2 + profile_steps."""
        if i == 2:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
            profiler.start()
        elif profiler is not None and i == 2 + self.options.profile_steps:
            self._stop_profile(profiler)
            profiler = None
        return profiler

    def _stop_profile(self, profiler) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        out = self.out_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(out / "trace.json"))
        logger.info("profile trace written to %s", out)

    def _plot(self) -> None:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            logger.warning("matplotlib is not installed: no curves in %s",
                           self.out_dir / "images")
            return
        matplotlib_plot(self.reporter, self.out_dir)
