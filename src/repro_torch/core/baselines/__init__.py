"""The four protocols the paper measures Bohm against (port of
``repro.core.baselines``): single-version 2PL, Silo-style OCC, snapshot
isolation and Hekaton-style pessimistic MVCC, each a round model over one
batch with the uniform stats contract ``{rounds, aborts, commits}`` (0-d
int32) plus a [T] bool ``commit_mask`` and the protocol's own extras.

Each reference ``lax.while_loop`` is a Python loop over rounds here; its
exit test syncs the host once a round, as the wavefront does once a wave
(``core/execute.py``).
"""
from repro_torch.core.baselines.hekaton import run_hekaton
from repro_torch.core.baselines.occ import run_occ
from repro_torch.core.baselines.snapshot_isolation import run_si
from repro_torch.core.baselines.two_phase_locking import run_2pl

__all__ = ["run_2pl", "run_hekaton", "run_occ", "run_si"]
