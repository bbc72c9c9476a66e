"""Training loop: the fault-tolerant loop around the train step — the
port of ``repro.training.train_loop``.

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``, a function of tensors as the reference's
jitted step is: the loss and its gradient by autograd (fresh leaves each
step, so no ``.grad`` carries over), microbatches summed into float32
gradients as the reference's ``scan`` sums them, optional int8
compression, then ``adamw_update``, which returns new trees (in
``Trainer``'s step it writes them over the old ones, as the reference's
step donates them). ``Trainer`` adds checkpoint/restart (bitwise
resumable given the same data order), heartbeat and straggler monitoring
and a history. It runs on the card unless the caller passes
``device="cpu"``; a step's time brackets a synchronisation of its loss,
as the reference's ``block_until_ready``.

The step takes ``DTensor``s as well: parameters, AdamW state and batch
placed by ``parallel.sharding``'s ``param_shardings``,
``opt_state_shardings`` and ``batch_sharding``, called under
``parallel.constraints.activation_mesh(mesh)`` and DTensor's
``implicit_replication()`` (together the reference's ``with mesh:``).
Every rank of the mesh calls it with the same global batch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, fence, resolve_device
from repro_torch.ft.monitor import HeartbeatMonitor, StragglerDetector
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.compression import CompressionConfig, compress_grads


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    adamw: opt_mod.AdamWConfig = opt_mod.AdamWConfig()
    compression: Optional[CompressionConfig] = None
    microbatch: int = 0           # >0: grad accumulation inner steps


def value_and_grad(params, batch, cfg: ModelConfig):
    """(loss, gradient tree) of ``tf.loss_fn`` at ``params``: gradients
    in each parameter's dtype; a leaf the loss does not reach gets zeros,
    as ``jax.grad`` gives it."""
    flat = {k: v.detach().requires_grad_(True)
            for k, v in layers.flatten(params).items()}
    loss = tf.loss_fn(layers.unflatten(flat), batch, cfg)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    return loss.detach(), layers.unflatten({
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(flat.items(), grads)})


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    donate: bool = False) -> Callable:
    """``donate``: the step writes its new parameters and AdamW state
    over the ``params`` and ``opt_state`` it is given
    (``adamw_update(donate=True)``), as the reference's ``jax.jit(...,
    donate_argnums=(0, 1))`` reuses their buffers."""
    def train_step(params, opt_state, batch):
        if tcfg.microbatch and tcfg.microbatch > 1:
            mb = tcfg.microbatch
            b = batch["tokens"].shape[0]
            assert b % mb == 0
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = {k: torch.zeros_like(v, dtype=torch.float32)
                     for k, v in layers.flatten(params).items()}
            for i in range(mb):
                part = {k: v[i * (b // mb):(i + 1) * (b // mb)]
                        for k, v in batch.items()}
                l_i, g_i = value_and_grad(params, part, cfg)
                loss = loss + l_i
                for k, g in layers.flatten(g_i).items():
                    grads[k] += g.float()
            loss = loss / mb
            grads = layers.unflatten({k: g / mb for k, g in grads.items()})
        else:
            loss, grads = value_and_grad(params, batch, cfg)
        if tcfg.compression is not None:
            grads = compress_grads(grads, tcfg.compression)
        params, opt_state, metrics = opt_mod.adamw_update(
            params, grads, opt_state, tcfg.adamw, donate=donate)
        return params, opt_state, {"loss": loss, **metrics}
    return train_step


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 data: Iterator[Dict[str, np.ndarray]],
                 params=None, seed: int = 0, device: DeviceLike = None):
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self.data = data
        # the step updates the trees the Trainer holds in place (params
        # given by the caller included)
        self.step_fn = make_train_step(cfg, tcfg, donate=True)
        self.params = params if params is not None else tf.init_params(
            cfg, torch.Generator(device=self.device).manual_seed(seed),
            self.device)
        self.opt_state = opt_mod.init_opt_state(self.params)
        self.step = 0
        self.ckpt = CheckpointManager(
            tcfg.checkpoint_dir, keep_last=tcfg.keep_checkpoints) \
            if tcfg.checkpoint_dir else None
        self.heartbeat = HeartbeatMonitor()
        self.straggler = StragglerDetector()
        self.history: list = []
        #: called with each logged step's history entry in place of the
        #: default line (``launch/train.py`` prints rates with it)
        self.on_log: Optional[Callable[[dict], None]] = None

    # ------------------------------------------------------------------
    def try_restore(self) -> bool:
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        step, state, _ = self.ckpt.restore(device=self.device)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = step
        return True

    def save(self) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(self.step,
                       {"params": self.params, "opt": self.opt_state},
                       extra={"step": self.step})

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> Dict[str, float]:
        n = steps if steps is not None else self.tcfg.steps
        last = {}
        for _ in range(n):
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in next(self.data).items()}
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            fence(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step += 1
            self.heartbeat.beat(self.step)
            self.straggler.record(dt)
            last = {k: float(v) for k, v in metrics.items()}
            last["step_time_s"] = dt
            last["tokens"] = int(batch["tokens"].numel())
            self.history.append({"step": self.step, **last})
            if self.step % self.tcfg.log_every == 0:
                if self.on_log is not None:
                    self.on_log(self.history[-1])
                else:
                    print(f"step {self.step}: loss={last['loss']:.4f} "
                          f"gnorm={last['grad_norm']:.3f} {dt*1e3:.0f}ms",
                          flush=True)
            if self.ckpt and self.step % self.tcfg.checkpoint_every == 0:
                self.save()
        if self.ckpt:
            self.save()
            self.ckpt.wait()
        return last
