"""REG001/REG002 — registry drift between code and its paper trail.

The codebase keeps three registries that only stay honest by hand:
fault-injection site names vs the docs/FAULT_INJECTION.md catalog, lint
rule ids vs the analysis/RULES.md table (and their
tests/test_torch_analysis.py fixtures), and SchedulerConfiguration fields
vs their docstring/validate() coverage. Every one of them has drifted
silently at least once ("the table forgot the new row"). These rules
end the class mechanically.

Both rules sit out when the corresponding paper half doesn't exist
(fixture trees without a docs/ dir) and when the code half is empty (a
single-module analyze_source fixture fires no fault sites), so only
whole-tree scans — and fixtures that deliberately build both halves —
produce findings. Doc-side findings land on the .md file; they can't be
inline-suppressed, only fixed or baselined.
"""
from __future__ import annotations

import re

from .core import Finding, ProjectRule, register
from .project import annotation_name, site_match

# raft bookkeeping stamped by the FSM, not operator knobs
_CONFIG_EXEMPT = {"create_index", "modify_index"}
# scalar annotations validate() must range-check; bools and nested
# config objects (which carry their own validate) are exempt
_SCALAR_ANNS = {"int", "float", "str"}


def _doc_finding(rule, path: str, line: int, raw: str, message: str):
    return Finding(rule=rule.id, path=path, line=line, col=0,
                   message=message, severity=rule.severity, context=raw)


@register
class FaultSiteDrift(ProjectRule):
    id = "REG001"
    severity = "error"
    short = ("faults.fire/mangle site without a docs/FAULT_INJECTION.md "
             "catalog row, or a documented site fired nowhere")

    def check_project(self, index) -> list:
        docs = index.docs
        if not docs.fault_rows or not index.fault_sites:
            return []
        out = []
        doc_patterns = [p for p, _, _ in docs.fault_rows]
        code_patterns = sorted({p for p, _, _ in index.fault_sites})
        reported = set()
        for pattern, mod, node in index.fault_sites:
            if any(site_match(pattern, dp) for dp in doc_patterns):
                continue
            if (pattern, mod.path) in reported:
                continue
            reported.add((pattern, mod.path))
            out.append(mod.finding(
                self, node,
                f"fault site `{pattern}` is fired here but has no row in "
                f"the {docs.fault_doc_path} site catalog — add the row "
                f"(site, where, what a fault simulates)"))
        for dp, lineno, raw in docs.fault_rows:
            if any(site_match(cp, dp) for cp in code_patterns):
                continue
            out.append(_doc_finding(
                self, docs.fault_doc_path, lineno, raw,
                f"documented fault site `{dp}` is fired nowhere in the "
                f"scanned tree — stale row (delete it, or restore the "
                f"faults.fire call it described)"))
        return out


@register
class RuleRegistryDrift(ProjectRule):
    id = "REG002"
    severity = "error"
    short = ("registered rule without analysis/RULES.md row or "
             "test_torch_analysis fixture; SchedulerConfiguration field "
             "without docstring/validate coverage")

    def check_project(self, index) -> list:
        out = []
        out.extend(self._check_rule_table(index))
        for mod, cls in index.config_classes:
            out.extend(self._check_config(index, mod, cls))
        return out

    def _check_rule_table(self, index) -> list:
        docs = index.docs
        if not index.rule_defs:
            return []
        out = []
        doc_ids = {r for r, _, _ in docs.rule_rows}
        code_ids = {r for r, _, _ in index.rule_defs}
        for rule_id, mod, cls in index.rule_defs:
            if docs.rule_rows and rule_id not in doc_ids:
                out.append(mod.finding(
                    self, cls,
                    f"rule {rule_id} is registered but has no row in the "
                    f"{docs.rules_doc_path} rules table"))
            if docs.test_lint_text is not None and \
                    rule_id not in docs.test_lint_text:
                out.append(mod.finding(
                    self, cls,
                    f"rule {rule_id} has no fixture coverage in "
                    f"{docs.test_lint_path} (the id never appears)"))
        for rule_id, lineno, raw in docs.rule_rows:
            if rule_id not in code_ids:
                out.append(_doc_finding(
                    self, docs.rules_doc_path, lineno, raw,
                    f"documented rule {rule_id} is not registered — stale "
                    f"row (delete it, or restore the rule)"))
        return out

    def _check_config(self, index, mod, cls) -> list:
        import ast
        out = []
        docstring = ast.get_docstring(cls) or ""
        validate_src = ""
        has_validate = False
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name == "validate":
                has_validate = True
                validate_src = "\n".join(
                    mod.lines[stmt.lineno - 1:stmt.end_lineno])
        for stmt in cls.body:
            if not (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                continue
            name = stmt.target.id
            if name in _CONFIG_EXEMPT:
                continue
            if not re.search(rf"\b{re.escape(name)}\b", docstring):
                out.append(mod.finding(
                    self, stmt,
                    f"{cls.name}.{name} is not mentioned in the class "
                    f"docstring — every operator knob gets a docstring "
                    f"entry"))
            if annotation_name(stmt) in _SCALAR_ANNS and has_validate and \
                    not re.search(rf"\b{re.escape(name)}\b", validate_src):
                out.append(mod.finding(
                    self, stmt,
                    f"{cls.name}.{name} is never referenced in validate() "
                    f"— scalar knobs get a range/enum check"))
        return out
