"""Roofline analysis over the dry-run artifact (the port of
``repro.launch.roofline``, over the H100 model of ``launch.mesh``).

Three terms per (arch x shape x mesh) cell, in seconds per step:

  compute    = FLOPs / (chips x 989e12)              [bf16 dense peak, H100]
  memory     = bytes / (chips x 3.35e12)             [HBM3 bandwidth]
  collective = per-card collective bytes / 450e9     [NVLink 4, one way,
               in place of the reference's one ICI link; the DTensor
               collectives' shapes are per-card]

FLOPs / bytes come from the dispatch walk (``counting.dispatch_costs``:
global logical counts, the kernels by their formulas). Collective bytes
come from DTensor's collectives (``counting.collective_costs``).

MODEL_FLOPS = 6 * N_active * tokens (train) or 2 * N_active * tokens
(prefill/decode). The MFU-style roofline fraction is
    ideal_compute_time / max(all three terms),
i.e. what fraction of the step's critical-path resource the useful model
math could saturate. For memory-bound decode cells we additionally report
bandwidth utilisation of the minimal traffic (params+cache once per step).

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single]

(``--mesh local`` reads the one-card cells; ``--json`` another artifact.)
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

from repro_torch.configs import get_config
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

RESULTS = Path(__file__).resolve().parents[3] / "benchmarks_torch" / "results"

TOKENS = {"train_4k": 4096 * 256, "prefill_32k": 32768 * 32,
          "decode_32k": 128, "long_500k": 1}


def analyze_cell(key: str, rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return None
    arch, shape, mesh_kind = key.split("|")
    cfg = get_config(arch)
    chips = rec["devices"]
    flops = rec["jaxpr"]["flops"]
    byts = rec["jaxpr"]["bytes"]
    coll = rec["collectives"]["total_bytes"]

    byts_fused = rec["jaxpr"].get("bytes_fused", byts)
    t_comp = flops / (chips * PEAK_FLOPS_BF16)
    t_mem = byts / (chips * HBM_BW)
    t_mem_fused = byts_fused / (chips * HBM_BW)
    t_coll = coll / NVLINK_BW
    bound = max(t_comp, t_mem, t_coll)
    # kernelized bound: elementwise/reduce chains fused on chip (what the
    # hand-written kernels deliver)
    bound_fused = max(t_comp, t_mem_fused, t_coll)
    dominant = ["compute", "memory", "collective"][
        [t_comp, t_mem, t_coll].index(bound)]

    n_active = rec["model"]["active_params"]
    toks = TOKENS[shape]
    mf = (6 if shape == "train_4k" else 2) * n_active * toks
    ideal = mf / (chips * PEAK_FLOPS_BF16)
    frac = ideal / bound if bound else 0.0

    # minimal HBM traffic for serve steps: params (bf16) + KV cache once
    min_bytes = 2 * n_active
    if shape in ("decode_32k", "long_500k"):
        seq = 32768 if shape == "decode_32k" else 524288
        batch = 128 if shape == "decode_32k" else 1
        if cfg.attention == "mla" and cfg.mla:
            kv = batch * seq * (cfg.mla.kv_lora_rank
                                + cfg.mla.qk_rope_head_dim) * 2
            kv *= cfg.num_layers
        elif cfg.family == "ssm":
            s = cfg.ssm
            kv = (batch * s.n_heads(cfg.d_model) * s.head_dim * s.d_state
                  * 4) * cfg.num_layers
        else:
            kv = (2 * batch * seq * cfg.num_kv_heads * cfg.head_dim * 2) \
                * cfg.num_layers
            if cfg.window:
                kv = kv * (len(cfg.global_attn_layers) / cfg.num_layers) \
                    + (2 * batch * min(cfg.window, seq) * cfg.num_kv_heads
                       * cfg.head_dim * 2) * (
                        cfg.num_layers - len(cfg.global_attn_layers)) \
                    / cfg.num_layers * cfg.num_layers
        min_bytes += kv
    bw_util = (min_bytes / (chips * HBM_BW)) / bound if bound else 0.0

    return {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "chips": chips,
        "t_compute_s": t_comp, "t_memory_s": t_mem,
        "t_memory_fused_s": t_mem_fused,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": mf, "hlo_flops": flops,
        "useful_ratio": mf / flops if flops else 0.0,
        "roofline_fraction": frac,
        "roofline_fraction_fused": ideal / bound_fused if bound_fused
        else 0.0,
        "bw_utilisation": bw_util,
        "peak_gib_per_dev": rec["memory"]["peak_bytes_per_device"] / 2**30,
        "collective_gib": coll / 2**30,
    }


def load_table(path: Optional[str] = None, mesh: str = "single"):
    p = Path(path) if path else RESULTS / "dryrun.json"
    data = json.loads(p.read_text())
    rows = []
    for key, rec in sorted(data.items()):
        if mesh != "both" and not key.endswith(f"|{mesh}"):
            continue
        row = analyze_cell(key, rec)
        if row:
            rows.append(row)
    return rows


def fmt_row(r: Dict) -> str:
    return (f"{r['arch']:<24} {r['shape']:<12} {r['mesh']:<7}"
            f"{r['t_compute_s']*1e3:>9.2f} {r['t_memory_s']*1e3:>9.2f} "
            f"{r['t_memory_fused_s']*1e3:>9.2f} "
            f"{r['t_collective_s']*1e3:>9.2f}  {r['dominant']:<10} "
            f"{r['useful_ratio']:>6.2f} {r['roofline_fraction']:>6.1%} "
            f"{r['roofline_fraction_fused']:>6.1%} "
            f"{r['peak_gib_per_dev']:>8.1f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "local"])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    rows = load_table(args.json, args.mesh)
    hdr = (f"{'arch':<24} {'shape':<12} {'mesh':<7}"
           f"{'comp_ms':>9} {'mem_ms':>9} {'memF_ms':>9} {'coll_ms':>9}  "
           f"{'dominant':<10} "
           f"{'useful':>6} {'roofl':>6} {'roofF':>6} {'GiB/dev':>8}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(fmt_row(r))
    out = RESULTS / f"roofline_{args.mesh}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    print(f"\nwrote {out}")


if __name__ == "__main__":
    main()
