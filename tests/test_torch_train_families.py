"""Phase 15's bf16 family runs and trainer options rehearsed on the CPU,
against the JAX package.

``chip_smoke.py`` phase 15 trains llava-next-mistral-7b and
seamless-m4t-large-v2 through ``Trainer`` on ``chip_smoke.train_data``
(the token pipeline with image patches or audio frames beside it, drawn
from a seeded numpy generator as ``model_batch`` lays them out), and
holds ``make_train_step``'s microbatches and int8 compression on the card
(``chip_smoke.trainer_options``). Here the same helpers run on reduced
float32 configs with ``device="cpu"``: the batches carry the frontend
features in ``model_batch``'s layout, the losses of two steps are finite,
and one step's updated parameters equal the reference's jitted
``make_train_step`` on the same numpy batch and weights within 1e-4 of
each leaf's largest magnitude (``tests/test_torch_training.py``'s
tolerance); the options' checks pass at 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from _torch_parity import np_
from repro.configs import reduced_config as ref_reduced_config
from repro.models import init_params as ref_init_params
from repro.training import optimizer as ref_opt
from repro.training.train_loop import TrainConfig as RefTrainConfig
from repro.training.train_loop import make_train_step as ref_train_step
from repro_torch.configs import reduced_config
from repro_torch.models import layers, transformer
from repro_torch.training.train_loop import TrainConfig, Trainer

TOL = 1e-4
B, S = 2, 32


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "seamless-m4t-large-v2"])
def test_frontend_family_trains_as_the_reference(arch):
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    ref_cfg = dataclasses.replace(ref_reduced_config(arch), dtype="float32")
    data = cs.train_data(cfg, B, S, seed=1)
    batches = [next(data) for _ in range(2)]
    data.close()
    n_extra = cfg.num_patches if cfg.frontend == "patches" else S
    feat = {"patches": transformer.VISION_EMBED_DIM,
            "frames": transformer.AUDIO_FEAT_DIM}[cfg.frontend]
    layout = cs.model_batch(cfg, S, n_extra, 0, "cpu")
    for batch in batches:
        assert set(batch) == set(layout) == {"tokens", "labels",
                                             cfg.frontend}
        x = batch[cfg.frontend]
        assert x.shape == layout[cfg.frontend].shape == (B, n_extra, feat)
        assert x.dtype == layout[cfg.frontend].dtype == torch.float32
        assert batch["tokens"].shape == (B, S)

    ref_params = jax.tree.map(np.asarray, jax.jit(
        ref_init_params, static_argnums=0)(ref_cfg, jax.random.PRNGKey(0)))
    trainer = Trainer(cfg, TrainConfig(steps=2, log_every=100),
                      iter(batches), params=transformer.params_from_reference(
                          ref_params, cfg, "cpu"), device="cpu")
    trainer.run(1)
    ref_batch = {k: jnp.asarray(np_(v)) for k, v in batches[0].items()}
    params = jax.tree.map(jnp.asarray, ref_params)
    new, _, metrics = ref_train_step(ref_cfg, RefTrainConfig())(
        params, ref_opt.init_opt_state(params), ref_batch)
    assert abs(trainer.history[0]["loss"] - float(metrics["loss"])) <= \
        TOL * abs(float(metrics["loss"]))
    got = layers.flatten(trainer.params)
    for name, r in _flat(new).items():
        r = np.asarray(r, np.float64)
        err = np.abs(np_(got[name]).astype(np.float64) - r).max()
        assert err <= TOL * max(np.abs(r).max(), 1e-30), (name, err)
    trainer.run(1)
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 2 and np.isfinite(losses).all(), losses


def test_trainer_options_on_the_cpu():
    """Phase 15's in-process checks of the options at a reduced config:
    ``microbatch=2`` against the whole batch (loss, grad norm, each
    gradient leaf) within 1e-5; the compressed gradient bit-equal to the
    same call on its CPU copy (the card's check on the CPU: the same
    device twice)."""
    cfg = dataclasses.replace(reduced_config(cs.OPTIONS_ARCH),
                              dtype="float32")
    o = cs.trainer_options("cpu", cfg=cfg, batch=8, seq=64)
    assert max(o["rel"].values()) <= cs.OPTIONS_TOL
    assert o["worst"][0] <= cs.OPTIONS_TOL
    assert o["leaves"] == len(transformer.param_defs(cfg))
    assert 0 < o["quantized"] < o["leaves"]      # norms stay unquantized
