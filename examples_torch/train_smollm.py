"""End-to-end training example on the PyTorch/CUDA port (the counterpart of
``examples/train_smollm.py``): a ~110M-parameter SmolLM-family model for a
few hundred steps on the synthetic corpus, with versioned async
checkpointing, straggler monitoring, int8 gradient compression, and a
mid-run restart to prove checkpoint/restore continuity.

    python3 examples_torch/train_smollm.py [--steps 200] [--device cpu]

Runs on the card by default; ``--device cpu`` runs the plain PyTorch
path. No weights can be downloaded, so it trains from the port's own
``init_params`` (``torch.Generator`` seed 0). ``--layers``, ``--d-model``
and ``--vocab`` shrink the model for a quick run.
"""
import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import (PackedBatchIterator,  # noqa: E402
                                       SyntheticTokenSource)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.training.compression import CompressionConfig  # noqa: E402
from repro_torch.training.train_loop import TrainConfig, Trainer  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=0,
                    help="shrink the width (0 = SmolLM-360M's 960)")
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ~110M params: the SmolLM-360M architecture at 12 layers
    cfg = dataclasses.replace(get_config("smollm-360m"),
                              name="smollm-110m", num_layers=args.layers)
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model,
                                  d_ff=args.d_model * 2,
                                  head_dim=args.d_model // cfg.num_heads)
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab_size=args.vocab)
    n = cfg.num_params()
    print(f"model: {cfg.name}  params={n/1e6:.1f}M  device={device}")

    src = SyntheticTokenSource(cfg.vocab_size, seed=0)
    data = PackedBatchIterator(src, batch=args.batch, seq_len=args.seq)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = TrainConfig(steps=args.steps, log_every=10,
                           checkpoint_every=50, checkpoint_dir=ckpt_dir,
                           compression=CompressionConfig())
        trainer = Trainer(cfg, tcfg, data, device=device)
        print(f"training {args.steps // 2} steps ...")
        trainer.run(args.steps // 2)
        trainer.save()
        trainer.ckpt.wait()

        # simulate a node failure: fresh process state, restore, continue
        print("\n-- simulated failure: restoring from checkpoint --")
        trainer2 = Trainer(cfg, tcfg, data, device=device)
        assert trainer2.try_restore()
        print(f"restored at step {trainer2.step}; "
              f"continuing {args.steps - trainer2.step} steps ...")
        last = trainer2.run(args.steps - trainer2.step)
        print(f"\nfinal: step={trainer2.step} loss={last['loss']:.4f} "
              f"stragglers_flagged={len(trainer2.straggler.flagged)}")
    data.close()


if __name__ == "__main__":
    main()
