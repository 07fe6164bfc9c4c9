"""CLI entry point:
`python -m nomad_tpu_torch.analysis [--json] [paths...]`.

Exit status 0 when every finding is baselined or suppressed, 1 when
active findings (or unparseable files) remain — the same contract
tests/test_torch_analysis.py enforces in tier-1. `--changed` is the
edit-loop fast path (git-dirty files, per-file rules only); `--graph`
dumps the whole-program ProjectIndex for debugging rule resolution.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from . import Baseline, all_rules, analyze_paths
from .core import BASELINE_FILENAME, SourceModule, iter_py_files


def _changed_files(paths) -> list:
    """.py files under `paths` that differ from HEAD (staged, unstaged,
    or untracked). Raises RuntimeError outside a git checkout."""
    names: set = set()
    for cmd in (["git", "diff", "--name-only", "HEAD"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(res.stderr.strip() or "git failed")
        names.update(ln.strip() for ln in res.stdout.splitlines()
                     if ln.strip())
    scopes = [os.path.abspath(p) for p in paths]
    out = []
    for name in sorted(names):
        if not name.endswith(".py") or not os.path.exists(name):
            continue                        # deleted files have no AST
        ap = os.path.abspath(name)
        if any(ap == s or ap.startswith(s + os.sep) for s in scopes):
            out.append(name)
    return out


def _graph_dump(paths) -> dict:
    from .project import ProjectIndex
    mods = []
    for path, match_path in iter_py_files(paths):
        try:
            with open(path, encoding="utf-8") as fh:
                mods.append(SourceModule(path, fh.read(),
                                         match_path=match_path))
        except (SyntaxError, UnicodeDecodeError, OSError):
            continue
    return ProjectIndex(mods, paths).graph_summary()


def main(argv=None, out=None) -> int:
    out = out or sys.stdout
    ap = argparse.ArgumentParser(
        prog="python -m nomad_tpu_torch.analysis",
        description="nomadlint: JIT-safety / lock-discipline / "
                    "determinism static analyzer")
    ap.add_argument("paths", nargs="*", default=["nomad_tpu_torch"],
                    help="files or directories to scan "
                         "(default: nomad_tpu_torch)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as a JSON array "
                         "(rule, path, line, message)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help=f"baseline file (default: nearest "
                         f"{BASELINE_FILENAME} above the first path)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file (report everything)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--changed", action="store_true",
                    help="scan only git-dirty .py files under the given "
                         "paths (per-file rules only — the whole-program "
                         "pass needs a full scan)")
    ap.add_argument("--graph", action="store_true",
                    help="dump the whole-program ProjectIndex as JSON "
                         "and exit (call edges, lock edges, registries)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}  [{rule.severity}]  {rule.short}", file=out)
        return 0

    if args.graph:
        print(json.dumps(_graph_dump(args.paths), indent=2, sort_keys=True),
              file=out)
        return 0

    if args.no_baseline:
        baseline = Baseline()
    elif args.baseline:
        baseline = Baseline.load(args.baseline)
    else:
        baseline = Baseline.discover(args.paths[0])

    if args.changed:
        try:
            targets = _changed_files(args.paths)
        except (RuntimeError, OSError) as e:
            print(f"--changed needs a git checkout: {e}", file=out)
            return 1
        if not targets:
            print("nomadlint: no changed .py files under "
                  + " ".join(args.paths), file=out)
            return 0
        findings, errors = analyze_paths(targets, project=False)
        if not args.as_json:
            print(f"nomadlint --changed: {len(targets)} file(s); "
                  f"per-file rules only (project rules need a full scan)",
                  file=out)
    else:
        findings, errors = analyze_paths(args.paths)
    active = [f for f in findings if not baseline.matches(f)]
    baselined = len(findings) - len(active)

    if args.as_json:
        print(json.dumps([f.as_dict() for f in active], indent=2),
              file=out)
        # stdout stays a pure findings array (the CI ingestion
        # contract); parse errors still fail the run and go to stderr
        # so a failing rc is never paired with a silent empty `[]`
        for path, msg in errors:
            print(f"{path}: PARSE ERROR: {msg}", file=sys.stderr)
    else:
        for f in active:
            print(f.render(), file=out)
        for path, msg in errors:
            print(f"{path}: PARSE ERROR: {msg}", file=out)
        summary = (f"nomadlint: {len(active)} finding(s)"
                   + (f", {baselined} baselined" if baselined else "")
                   + (f", {len(errors)} parse error(s)" if errors else ""))
        print(summary, file=out)
    return 1 if active or errors else 0


if __name__ == "__main__":
    sys.exit(main())
