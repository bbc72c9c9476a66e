"""Phase 18's float32 replay of the 2-layer smollm-360m against its
float64 trajectory: are the sharded run's AdamW sign flips a property of
sharding, or of float32?

    python3 benchmarks_torch/elastic_f64.py [--steps-only]

Runs ``chip_smoke.py`` phase 18's ``f32_2layers`` case (smollm-360m at
full width, 2 layers, float32, B=4 x S=512, AdamW, 3 steps on a (2, 2)
mesh, a save, 2 steps on (1, 2) after a sharded restore; thread ranks
on one card) through ``chip_smoke.elastic_restart``, and beside it the
same 5 steps (the same seeded parameters and batches) unsharded on the
card, unsharded in float32 on the CPU, and unsharded in float64 on the
CPU (the model at ``dtype="float64"`` under ``chip_smoke.float64_math``,
so its statistics, products, softmax, logits and AdamW's moments stay
float64). Prints one JSON line a pair of runs and step (3 and 5): the
worst leaf (largest difference over the leaf's largest magnitude) and,
per leaf, the elements past 1e-3 of its largest magnitude (phase 18's
limit), then the card's name and power limit. Needs a GPU; exits
non-zero without one.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CASE = "f32_2layers"
FLASH = ("flash_attention", "flash_attention_bwd",
         "flash_attention_bwd_wgmma", "flash_attention_bwd_tf32x3")


def f64_steps(cs, case, seeded: dict) -> dict:
    """The case's ``sum(ELASTIC_STEPS)`` steps in float64 on the CPU from
    the ``seeded`` parameters (a numpy tree): numpy parameters after
    each world's last step."""
    from repro_torch.models.layers import flatten, unflatten
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    cfg = dataclasses.replace(case["cfg"], dtype="float64")
    params = unflatten({k: torch.from_numpy(v).double()
                        for k, v in flatten(seeded).items()})
    data, after = cs._elastic_data(case, 0), {}
    with cs.float64_math():
        opt = init_opt_state(params)
        step_fn = make_train_step(cfg, TrainConfig())
        for i in range(sum(cs.ELASTIC_STEPS)):
            batch = {k: torch.as_tensor(v) for k, v in next(data).items()}
            params, opt, _ = step_fn(params, opt, batch)
            if i + 1 in (cs.ELASTIC_STEPS[0], sum(cs.ELASTIC_STEPS)):
                after[i + 1] = {k: v.numpy().copy()
                                for k, v in flatten(params).items()}
    data.close()
    return after


def compare(got: dict, want: dict) -> dict:
    """The worst leaf and, per leaf, the elements past ELASTIC_TOL of its
    largest magnitude."""
    from chip_smoke import ELASTIC_TOL, worst_leaf
    past = {}
    for k, w in want.items():
        d = np.abs(np.asarray(got[k], np.float64) - w)
        n = int((d > ELASTIC_TOL * max(float(np.abs(w).max()), 1e-30))
                .sum())
        if n:
            past[k] = n
    return {"worst": worst_leaf(got, want), "past": past}


def main() -> int:
    if not torch.cuda.is_available():
        print("elastic_f64: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    for name in FLASH:
        _build.build(name)
    case = next(c for c in cs.elastic_cases(control=False)
                if c["name"] == CASE)
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        r = cs.elastic_restart([case], root=root)
        runs["sharded_card"] = {s: cs.saved_params(root, CASE, s)
                                for s in (cs.ELASTIC_STEPS[0],
                                          sum(cs.ELASTIC_STEPS))}
    runs["unsharded_card"] = r["want"][CASE]["params"]
    seeded = cs.unflatten({k: v.cpu().numpy() for k, v in cs.flatten(
        cs._elastic_params(case, "cuda")).items()})
    runs["unsharded_cpu"] = cs.unsharded_steps(dict(case, params=seeded),
                                               "cpu")["params"]
    runs["float64_cpu"] = f64_steps(cs, case, seeded)
    for a, b in (("sharded_card", "unsharded_card"),
                 ("sharded_card", "float64_cpu"),
                 ("unsharded_card", "float64_cpu"),
                 ("unsharded_cpu", "float64_cpu"),
                 ("unsharded_cpu", "unsharded_card")):
        for step in sorted(runs[b]):
            print(json.dumps({"case": CASE, "got": a, "want": b,
                              "step": step,
                              **compare(runs[a][step], runs[b][step])}),
                  flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
