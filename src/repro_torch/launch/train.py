"""Training launcher: config-driven, checkpoint/restart — the port of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --layers 12 --steps 100 --batch 8 --seq 256 --ckpt /tmp/ckpt

Runs on the card (``--device cuda``, the default; it raises without one)
or, when asked, on the CPU (``--device cpu``). One process, one device:
the data pipeline takes host 0 of 1 and the parameters stay whole, as
the reference's launcher runs them (it builds no mesh; a sharded step
over a ``DeviceMesh`` is ``training.train_loop``'s step called on
DTensors, as ``chip_smoke.py`` phase 18 drives it). Each logged step
prints its loss, gradient norm, step time, tokens/s and, on the card,
the share of the H100's bf16 peak that ``6 N tokens / step time``
reaches (N the parameter count, ``launch.mesh.PEAK_FLOPS_BF16``).
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import PackedBatchIterator, SyntheticTokenSource
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import PEAK_FLOPS_BF16
from repro_torch.training.compression import CompressionConfig
from repro_torch.training.train_loop import TrainConfig, Trainer


def step_line(entry: dict, n_params: int, on_card: bool) -> str:
    """One logged step: loss, grad norm, ms, tokens/s and (card only) the
    bf16-peak share of 6 N tokens / step time."""
    dt = entry["step_time_s"]
    rate = entry["tokens"] / dt
    share = (f"{100 * 6 * n_params * rate / PEAK_FLOPS_BF16:.2f} % of the "
             "bf16 peak" if on_card else "bf16-peak share n/a on the cpu")
    return (f"step {entry['step']}: loss={entry['loss']:.4f} "
            f"gnorm={entry['grad_norm']:.3f} {dt * 1e3:.1f}ms "
            f"{rate:.1f} tokens/s {share}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--layers", type=int, default=0,
                    help="truncate the layer stack (0 = full)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else \
        get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    n_params = cfg.num_params()
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={device}")

    data = PackedBatchIterator(
        SyntheticTokenSource(cfg.vocab_size, seed=0),
        batch=args.batch, seq_len=args.seq)
    tcfg = TrainConfig(
        steps=args.steps, log_every=args.log_every,
        checkpoint_dir=args.ckpt, microbatch=args.microbatch,
        compression=CompressionConfig() if args.compress_grads else None)
    trainer = Trainer(cfg, tcfg, data, device=device)
    trainer.on_log = lambda entry: print(
        step_line(entry, n_params, device.type == "cuda"), flush=True)
    if args.resume and trainer.try_restore():
        print(f"resumed from step {trainer.step}")
    last = trainer.run()
    print(f"done: step={trainer.step} loss={last['loss']:.4f}")
    data.close()


if __name__ == "__main__":
    main()
