"""nomadlint for the PyTorch/CUDA package: AST-based static analysis
(host-sync and kernel-build discipline, lock discipline, determinism,
exception hygiene). Run it locally with

    python -m nomad_tpu_torch.analysis [--json] [paths...]

and see analysis/RULES.md for the rule catalog and the
suppression/baseline workflow. Importing the package registers every
rule module."""
from .core import (                                    # noqa: F401
    Baseline, Finding, ProjectRule, Rule, all_rules, analyze_paths,
    analyze_source, register,
)
from .project import ProjectIndex                          # noqa: F401
from . import (                                            # noqa: F401
    rules_cvx, rules_det, rules_dur, rules_exc, rules_jit, rules_lead,
    rules_lint, rules_lock, rules_lockorder, rules_mesh, rules_obs,
    rules_perf, rules_queue, rules_read, rules_registry, rules_rpc,
    rules_shard, rules_sync,
)

__all__ = ["Baseline", "Finding", "ProjectIndex", "ProjectRule", "Rule",
           "all_rules", "analyze_paths", "analyze_source", "register"]
