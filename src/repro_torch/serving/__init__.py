"""repro_torch.serving — the serving path of the port: the paged MVCC
KV cache (``pages``), the two-phase continuous-batching scheduler
(``scheduler``) and ``ServeEngine`` (``engine``), whose attention runs
through the ``decode_attention`` / ``flash_attention_causal`` kernels
and whose request state lives in a sharded Bohm store."""
from repro_torch.serving.engine import (STATE_ACTIVE, STATE_DONE,
                                        STATE_UNKNOWN, ServeEngine,
                                        make_state_workload)
from repro_torch.serving.pages import (PagedKV, append_kv, gather_kv,
                                       init_paged_kv)
from repro_torch.serving.scheduler import BohmScheduler, Request, StepPlan

__all__ = ["STATE_ACTIVE", "STATE_DONE", "STATE_UNKNOWN", "ServeEngine",
           "make_state_workload", "PagedKV", "append_kv", "gather_kv",
           "init_paged_kv", "BohmScheduler", "Request", "StepPlan"]
