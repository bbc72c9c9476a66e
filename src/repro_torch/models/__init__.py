"""Model code of the port: every architecture family of
``repro.models`` (dense, MLA + MoE, Mamba-2 SSM, the hybrid, the
encoder-decoder and the vision frontend), with the same seven
exports."""
from repro_torch.models.transformer import (abstract_params, decode_step,
                                            init_cache, init_params, loss_fn,
                                            param_defs, prefill)

__all__ = ["abstract_params", "decode_step", "init_cache", "init_params",
           "loss_fn", "param_defs", "prefill"]
