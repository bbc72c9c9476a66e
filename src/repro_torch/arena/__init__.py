"""Protocol arena: cross-protocol evaluation harness (port of
``repro.arena``).

One ``ProtocolEngine`` interface over Bohm (barriered and conflict-aware
scheduler variants) and the four baselines (Hekaton-pessimistic MVCC,
OCC, 2PL, Snapshot Isolation); a workload matrix runner that reproduces
the paper's headline claim (Bohm sustains throughput under contention
where trackers/validators collapse — at equal serializability
guarantees); and an executable anomaly gauntlet whose MVSG certifier
checks every protocol's OUTPUT for serial-equivalence, flagging SI on
write-skew and the read-only anomaly while certifying the rest.
"""
from repro_torch.arena.anomalies import (INIT, Scenario, Verdict,
                                         certify, default_scenarios,
                                         make_tag_workload,
                                         read_only_anomaly_scenario,
                                         rmw_control_scenario,
                                         run_si_schedule, tag_batch,
                                         write_skew_scenario)
from repro_torch.arena.matrix import (ArenaCell, arena_matrix, run_cell,
                                      run_gauntlet, run_matrix,
                                      stamp_results)
from repro_torch.arena.protocols import (PROTOCOL_NAMES, BaselineProtocol,
                                         BatchOutput, BohmProtocol,
                                         ProtocolEngine, make_protocol,
                                         make_protocols)

__all__ = [
    "INIT", "Scenario", "Verdict", "certify", "default_scenarios",
    "make_tag_workload", "read_only_anomaly_scenario",
    "rmw_control_scenario", "run_si_schedule", "tag_batch",
    "write_skew_scenario",
    "ArenaCell", "arena_matrix", "run_cell", "run_gauntlet",
    "run_matrix", "stamp_results",
    "PROTOCOL_NAMES", "BaselineProtocol", "BatchOutput", "BohmProtocol",
    "ProtocolEngine", "make_protocol", "make_protocols",
]
