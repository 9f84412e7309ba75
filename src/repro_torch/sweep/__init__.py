"""repro_torch.sweep — declarative scenario sweeps with content-addressed
caching and parallel execution, on the port's simulator.

The paper's contribution is a simulation environment that makes graph
accelerators *comparable* by sweeping performance dimensions; this package
is the sweep engine on top of the accelerator models, the counterpart of
the reference's ``repro.sweep``:

- :mod:`repro_torch.sweep.spec` — ``SweepSpec`` axes -> typed ``Scenario``
  records (invalid combinations filtered, not crashed on),
- :mod:`repro_torch.sweep.cache` — content-addressed on-disk result store
  keyed by scenario hash (graph recipe + configs + engine version +
  backend tag),
- :mod:`repro_torch.sweep.runner` — cache-aware serial/parallel executor
  on one device with per-scenario failure isolation and
  resume-after-interrupt,
- :mod:`repro_torch.sweep.results` — deterministic row aggregation,
  CSV/JSON export, rank/Spearman validation helpers.

The reference's adaptive search (``repro.sweep.search``) is not ported yet.

CLI: ``python -m repro_torch.sweep --accels accugraph,hitgraph --graphs sd
--problems bfs`` (``--device cpu`` without a card).
"""
from repro_torch.sweep.cache import ResultCache, scenario_hash, scenario_key
from repro_torch.sweep.results import (
    rank,
    result_rows,
    scenario_row,
    spearman,
    write_csv,
    write_json,
)
from repro_torch.sweep.runner import (
    ExecutionPolicy,
    ScenarioPlan,
    ScenarioResult,
    SweepResult,
    execute_chunk,
    execute_scenario,
    execute_scenario_policied,
    execute_scenarios_batch,
    plan_scenarios,
    run_sweep,
)
from repro_torch.sweep.spec import ConfigOverride, Scenario, Skipped, SweepSpec

__all__ = [
    "ConfigOverride",
    "ExecutionPolicy",
    "ResultCache",
    "Scenario",
    "ScenarioPlan",
    "ScenarioResult",
    "Skipped",
    "SweepResult",
    "SweepSpec",
    "execute_chunk",
    "execute_scenario",
    "execute_scenario_policied",
    "execute_scenarios_batch",
    "plan_scenarios",
    "rank",
    "result_rows",
    "run_sweep",
    "scenario_hash",
    "scenario_key",
    "scenario_row",
    "spearman",
    "write_csv",
    "write_json",
]
