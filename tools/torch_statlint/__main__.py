"""CLI: ``python -m tools.torch_statlint [paths...]``.

Scans ``deequ_tpu_torch`` when given no paths. Exit codes: 0 = zero
non-baselined findings; 1 = findings (or stale baseline entries); 2 =
usage/baseline errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Sequence

from .core import (
    DEFAULT_BASELINE,
    DEFAULT_TARGETS,
    REPO_ROOT,
    ModuleIndex,
    apply_baseline,
    load_baseline,
    run_checks,
    write_baseline,
)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tools.torch_statlint",
        description=(
            "Machine-check the port's load-bearing invariants (fold-body "
            "purity, lock discipline, env-knob convention, failure/fault "
            "registries, export-plane completeness, state algebra, tuning "
            "and span-kind registries, dead imports)."
        ),
    )
    parser.add_argument(
        "paths", nargs="*",
        help=f"files/dirs to scan (default: {' '.join(DEFAULT_TARGETS)})",
    )
    parser.add_argument(
        "--baseline", default=None,
        help=(
            "baseline JSON of grandfathered findings (default: the "
            "checked-in tools/torch_statlint/baseline.json when scanning the "
            "default tree; NONE for explicit paths)"
        ),
    )
    parser.add_argument(
        "--write-baseline", metavar="PATH",
        help="write every current finding to PATH as a baseline and exit 0",
    )
    parser.add_argument(
        "--checks", default=None,
        help="comma-separated check ids to run (default: all)",
    )
    parser.add_argument("--json", action="store_true", help="JSON output")
    args = parser.parse_args(argv)

    t0 = time.monotonic()
    if args.paths:
        paths = args.paths
        baseline_path = args.baseline
    else:
        paths = [os.path.join(REPO_ROOT, t) for t in DEFAULT_TARGETS]
        baseline_path = args.baseline or DEFAULT_BASELINE

    index = ModuleIndex(paths)
    only = args.checks.split(",") if args.checks else None
    try:
        findings = run_checks(index, only=only)
    except ValueError as exc:
        print(f"torch_statlint: {exc}", file=sys.stderr)
        return 2

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(
            f"torch_statlint: wrote {len(findings)} finding(s) to "
            f"{args.write_baseline}; fill in each entry's reason"
        )
        return 0

    try:
        baseline = load_baseline(baseline_path) if baseline_path else {}
    except (ValueError, KeyError, json.JSONDecodeError) as exc:
        print(f"torch_statlint: bad baseline {baseline_path}: {exc}", file=sys.stderr)
        return 2

    if only:
        # a SCOPED run can only vouch for the checks it ran: entries of
        # unselected checks must not be reported stale (an operator
        # obeying "delete it" would break the full run)
        baseline = {
            fp: reason for fp, reason in baseline.items()
            if fp.split(":", 1)[0] in only
        }
    new, stale = apply_baseline(findings, baseline, baseline_path or "")
    reported: List = new + stale
    elapsed = time.monotonic() - t0

    if args.json:
        print(json.dumps({
            "modules": len(index.modules),
            "findings": [f.__dict__ for f in reported],
            "baselined": len(findings) - len(new),
            "elapsed_s": round(elapsed, 3),
        }, indent=2))
    else:
        for f in reported:
            print(f.render())
        print(
            f"torch_statlint: {len(index.modules)} modules, "
            f"{len(new)} finding(s), {len(stale)} stale baseline entr"
            f"{'y' if len(stale) == 1 else 'ies'}, "
            f"{len(findings) - len(new)} baselined, {elapsed:.2f}s"
        )
    return 1 if reported else 0


if __name__ == "__main__":
    sys.exit(main())
