"""Phase 18's control replay: the ``embed`` lookup whose table gradient
is summed in float64 (``chip_smoke.f64_embed_grad``).

While the context is open, ``models.transformer.row_gather`` gives the
same rows as without it, and its table gradient is the float64
``index_add`` of the whole upstream gradient over the lookup's indices,
cast once to the table's dtype: on plain tensors, and on DTensors of a
(2, 2) ("data", "model") mesh of 4 thread ranks, where the indices and
the upstream gradient are sharded on the batch and the table on its
rows (the gathered gradient is the same bits). Outside the context, or
off on a thread, the lookup is the port's own.

The arbiter of the same phase, ``embed_arbiter``, recomputes step 1's
gradient in float64 under ``float64_math`` and ``check_arbiter`` holds
each run to float32 rounding of it: both pieces are checked here too.
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from repro_torch.configs import reduced_config
from repro_torch.models import transformer as models_tf
from repro_torch.models.layers import flatten, unflatten

V, D, B, S = 48, 8, 4, 16


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((V, D), dtype=np.float32))
    # zipfian ids: many repeats, so the sum's order matters in float32
    idx = torch.from_numpy(np.minimum(rng.zipf(1.3, (B, S)) - 1, V - 1)
                           .astype(np.int32))
    up = torch.from_numpy(rng.standard_normal((B, S, D), dtype=np.float32))
    return table, idx, up


def _f64_sum(idx, up):
    """The float64 index_add of the upstream gradient, cast once."""
    return torch.zeros((V, D), dtype=torch.float64).index_add_(
        0, idx.reshape(-1).long(), up.reshape(-1, D).double()).float()


def _lookup_grad(table, idx, up):
    t = table.clone().requires_grad_(True)
    out = models_tf.row_gather(t, idx)
    out.backward(up)
    return out.detach(), t.grad


def test_f64_lookup_gradient_is_the_float64_sum_cast_once():
    table, idx, up = _inputs()
    plain_out, plain_grad = _lookup_grad(table, idx, up)
    with cs.f64_embed_grad():
        out, grad = _lookup_grad(table, idx, up)
    assert torch.equal(out, table[idx.long()]) and torch.equal(out,
                                                               plain_out)
    assert grad.dtype == torch.float32
    assert torch.equal(grad, _f64_sum(idx, up))
    # the port's own float32 sum of the same terms is another order's
    torch.testing.assert_close(plain_grad, grad, rtol=0, atol=1e-5)
    with cs.f64_embed_grad(False):
        _, off = _lookup_grad(table, idx, up)
    _, after = _lookup_grad(table, idx, up)
    assert torch.equal(off, plain_grad) and torch.equal(after, plain_grad)


def _sharded(mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    table, idx, up = _inputs()
    t = distribute_tensor(table, mesh, [Replicate(), Shard(0)],
                          src_data_rank=None).requires_grad_(True)
    i = distribute_tensor(idx, mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    with cs.f64_embed_grad():
        out = models_tf.row_gather(t, i)
        out.backward(distribute_tensor(up, mesh, list(out.placements),
                                       src_data_rank=None))
    return (out.full_tensor(), t.grad.full_tensor(),
            tuple(t.grad.placements))


def test_f64_lookup_gradient_on_sharded_tables_and_batches():
    from torch.distributed.tensor import Replicate, Shard
    table, idx, up = _inputs()
    ranks = cs.thread_ranks(_sharded, 4, device="cpu",
                            mesh=cs.ELASTIC_MESH)
    for out, grad, placements in ranks:
        assert torch.equal(out, table[idx.long()])
        assert placements == (Replicate(), Shard(0))
        assert torch.equal(grad, _f64_sum(idx, up))


def test_float64_math_keeps_a_float64_model_in_float64():
    """Under ``float64_math`` a float64 model's float32 statistics,
    products and logits stay float64 (its loss is float64, and differs
    from the float32 run's by float32 rounding); outside it
    ``Tensor.float`` and the default dtype are restored."""
    cfg = dataclasses.replace(reduced_config("smollm-360m"),
                              dtype="float32")
    case = cs.elastic_cases([("f32", cfg, 2, 16)], control=False)[0]
    params = cs._elastic_params(case, "cpu")
    data = cs._elastic_data(case, 0)
    batch = {k: torch.as_tensor(v) for k, v in next(data).items()}
    data.close()
    loss32 = models_tf.loss_fn(params, batch, cfg)
    p64 = unflatten({k: v.double() for k, v in flatten(params).items()})
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    with cs.float64_math():
        loss64 = models_tf.loss_fn(p64, batch, cfg64)
        assert torch.zeros(1).dtype == torch.float64
    assert loss32.dtype == torch.float32 and loss64.dtype == torch.float64
    assert 0 < abs(float(loss64) - float(loss32)) < 1e-5 * float(loss64)
    assert torch.zeros(1).dtype == torch.float32
    assert torch.ones(2, dtype=torch.float64).float().dtype == torch.float32


def test_arbiter_check_holds_each_run_to_float32_rounding():
    """``check_arbiter`` passes the H100's readings (every run within
    3.98e-6 of the float64 recomputation, 1-2 of 1,106,880 ``embed``
    elements of another sign) and fails a run whose gradient departs,
    however close the others are."""
    good = {"nonzero": 1_106_880}
    for run, worst, sign in zip(cs.RUNS, (3.98e-6, 3.98e-6, 2e-6, 2e-6),
                                (1, 1, 2, 2)):
        good[run] = {"rel": 1.4e-6, "sign": sign,
                     "worst_leaf": (worst, "lm_head")}
    cs.check_arbiter("f32", good)
    for bad in ({"rel": 3e-4}, {"sign": 40},
                {"worst_leaf": (2e-5, "embed")}):
        a = {k: dict(v) if isinstance(v, dict) else v
             for k, v in good.items()}
        a["sharded"].update(bad)
        with pytest.raises(AssertionError, match="sharded run"):
            cs.check_arbiter("f32", a)
