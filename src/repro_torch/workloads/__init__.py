# Workload scenario suite + unified bench regression harness: each
# scenario is a declarative, seeded, parameterized communication-pattern
# generator driving the matching fabric (and the trace recorder /
# progress-lane model) end-to-end; the bench harness sweeps every
# scenario under every engine/progress mode, runs all detectors, and
# gates regressions against a committed baseline.
#
# Importing the package registers the built-in scenario gallery.
# A copy of ``repro.workloads``: the port imports nothing of the JAX
# package. Keep the two in step.
from .base import (DEFECT_DETECTOR, Scenario, all_scenarios, get, names,
                   progress_schedule, register, scenario)
from . import scenarios  # noqa: F401  (registers the gallery)
from .bench import (DEFECT_KINDS, ENGINE_MODES, FAULT_DETECTOR,
                    FAULT_FINDING_KINDS, FAULT_KINDS, PE_REQUESTS,
                    PROGRESS_MODES, RECOVERY_FINDING_KINDS, ScenarioRun,
                    build_fabric, cell_key, check, compare_to_baseline,
                    count_ops, defect_coverage, fault_coverage,
                    fault_detector_kinds, hist_percentile,
                    live_progress_records, make_baseline, plan_for,
                    run_scenario, sweep)
from . import hotpath  # noqa: F401  (throughput bench + perf gate)
from . import telemetry  # noqa: F401  (live-bridge overhead + liveness gate)

__all__ = [
    "DEFECT_DETECTOR", "Scenario", "all_scenarios", "get", "names",
    "progress_schedule", "register", "scenario",
    "DEFECT_KINDS", "ENGINE_MODES", "FAULT_DETECTOR",
    "FAULT_FINDING_KINDS", "FAULT_KINDS", "PE_REQUESTS",
    "PROGRESS_MODES", "RECOVERY_FINDING_KINDS", "ScenarioRun",
    "build_fabric", "cell_key", "check", "compare_to_baseline",
    "count_ops", "defect_coverage", "fault_coverage",
    "fault_detector_kinds", "hist_percentile", "hotpath",
    "live_progress_records", "make_baseline", "plan_for",
    "run_scenario", "sweep", "telemetry",
]
