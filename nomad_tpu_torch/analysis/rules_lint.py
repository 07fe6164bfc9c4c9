"""LINT000 — suppression hygiene for nomadlint's own markers.

`# nomadlint: disable=TYPO001` was silently ignored before this rule: a
typo'd or stale rule id means the suppression does nothing while reading
as if it does, and a marker with no justification tail defeats the whole
point of the audit trail. Flag:

  * disables naming rule ids that aren't registered;
  * disables with no justification (accepted either side of the marker:
    `# nomadlint: disable=X — why` or `# why — nomadlint: disable=X`);
  * comments that mention nomadlint+disable but don't parse as a marker
    at all (e.g. a missing colon) — those silently suppress nothing.

LINT000 findings are themselves suppressible the usual way (add LINT000
to the disable list), which the driver handles before rules run.
"""
from __future__ import annotations

from .core import Rule, SourceModule, register
from . import core as _core


@register
class SuppressionHygiene(Rule):
    id = "LINT000"
    severity = "error"
    short = ("nomadlint disable marker names an unregistered rule, lacks "
             "a justification, or doesn't parse")

    def _finding(self, mod: SourceModule, line: int, message: str):
        from .core import Finding
        return Finding(rule=self.id, path=mod.path, line=line, col=0,
                       message=message, severity=self.severity,
                       context=mod.source_line(line))

    def check(self, mod: SourceModule) -> list:
        out = []
        for rec in mod.suppression_comments:
            if rec.malformed:
                out.append(self._finding(
                    mod, rec.line,
                    "unparseable nomadlint marker (suppresses nothing) — "
                    "expected `# nomadlint: disable=RULE1,RULE2 — why`"))
                continue
            unknown = sorted(r for r in rec.rules if r not in _core._REGISTRY)
            if unknown:
                out.append(self._finding(
                    mod, rec.line,
                    f"disable names unregistered rule(s) "
                    f"{', '.join(unknown)} — typo, or the rule was removed "
                    f"(see --list-rules)"))
            elif not rec.justified:
                out.append(self._finding(
                    mod, rec.line,
                    "suppression without a justification — say why: "
                    "`# nomadlint: disable="
                    + ",".join(rec.rules) + " — <reason>`"))
        return out
