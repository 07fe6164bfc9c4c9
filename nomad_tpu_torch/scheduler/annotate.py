"""Plan annotation (ref scheduler/annotate.go): decorate a job diff with
the scheduling consequences of each change so `job plan` can show not just
WHAT changed but what the change FORCES — create, destroy, in-place
update, or create/destroy update — alongside the per-group placement
counts."""
from __future__ import annotations

from typing import Optional

ANN_FORCES_CREATE = "forces create"
ANN_FORCES_DESTROY = "forces destroy"
ANN_FORCES_INPLACE = "forces in-place update"
ANN_FORCES_DESTRUCTIVE = "forces create/destroy update"


def _annotate_count_change(tg_diff: dict) -> None:
    """ref annotate.go annotateCountChange"""
    for f in tg_diff.get("Fields") or []:
        if f.get("Name") != "Count":
            continue
        try:
            old = int(f.get("Old") or 0)
            new = int(f.get("New") or 0)
        except ValueError:
            continue
        if new > old:
            f.setdefault("Annotations", []).append(ANN_FORCES_CREATE)
        elif new < old:
            f.setdefault("Annotations", []).append(ANN_FORCES_DESTROY)


def _annotate_task(task_diff: dict, destructive: bool) -> None:
    """ref annotate.go annotateTask: every non-terminal task change is
    either destructive or in-place, decided by what the reconciler
    actually planned for the group."""
    if task_diff.get("Type") in ("Added", "Deleted", "None"):
        # Added/Deleted: the group-level counts cover it; None: an
        # unchanged task carried as context by a contextual diff forces
        # nothing (ref annotate.go skips DiffTypeNone)
        return
    ann = ANN_FORCES_DESTRUCTIVE if destructive else ANN_FORCES_INPLACE
    task_diff.setdefault("Annotations", []).append(ann)


def annotate_job_diff(diff: Optional[dict],
                      annotations) -> Optional[dict]:
    """Attach scheduling annotations to a job diff in place (and return
    it). `annotations` is a PlanAnnotations with desired_tg_updates."""
    if not diff:
        return diff
    desired = getattr(annotations, "desired_tg_updates", None) or {} \
        if annotations is not None else {}
    for tg_diff in diff.get("TaskGroups") or []:
        name = tg_diff.get("Name", "")
        du = desired.get(name)
        _annotate_count_change(tg_diff)
        destructive = bool(du and du.destructive_update > 0)
        for obj in tg_diff.get("Tasks") or []:
            _annotate_task(obj, destructive)
        if du is not None:
            tg_diff["Updates"] = {
                "create": du.place, "destroy": du.stop,
                "migrate": du.migrate, "canary": du.canary,
                "in-place update": du.in_place_update,
                "create/destroy update": du.destructive_update,
                "ignore": du.ignore,
            }
    return diff
