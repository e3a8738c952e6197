"""``python -m deepspeed_tpu_torch.analysis --concurrency`` — lint the
port's serving control plane.

    python -m deepspeed_tpu_torch.analysis --concurrency
    python -m deepspeed_tpu_torch.analysis --concurrency --mode error
    python -m deepspeed_tpu_torch.analysis --concurrency \\
        --concurrency-path some_module.py --json

Exit status, as the JAX package's CLI: 0 clean (or ``--mode warn``), 2
when error-severity findings survive suppression in ``--mode error``, 1
on usage or analysis failure.  The graph lint and the planners of a
DeepSpeed config (the JAX CLI's other modes) are ROADMAP.md Queue 1 item
14: any of them exits 1 naming it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.analysis",
        description="Lint the host-concurrency discipline of the serving "
                    "control plane (lock order, blocking under a lock, "
                    "thread-role contracts).")
    ap.add_argument("configs", nargs="*",
                    help="DeepSpeed JSON configs: the graph lint of a "
                         "config is not ported (ROADMAP.md Queue 1 "
                         "item 14)")
    ap.add_argument("--mode", choices=("warn", "error"), default="warn",
                    help="'error': exit 2 on error-severity findings; "
                         "'warn' (default): report only")
    ap.add_argument("--concurrency", action="store_true",
                    help="run the host-concurrency lint over the control "
                         "plane's sources")
    ap.add_argument("--concurrency-path", action="append", default=[],
                    dest="concurrency_paths", metavar="FILE",
                    help="analyze these Python files instead of the "
                         "shipped control plane (repeatable)")
    ap.add_argument("--suppress", action="append", default=[],
                    help="rule-code prefix to suppress (repeatable)")
    ap.add_argument("--verbose", "-v", action="store_true",
                    help="include info-severity findings in the report")
    ap.add_argument("--json", action="store_true", dest="json_out",
                    help="emit one machine-readable JSON line")
    # the JAX CLI's config modes (--plan, --dispatch, --model, ...) are
    # item 14: any argument this parser does not know refuses with it
    args, other = ap.parse_known_args(argv)
    if args.configs or other:
        print("deepspeed_tpu_torch.analysis: the graph lint and the "
              "planners of a DeepSpeed config are not ported to "
              "deepspeed_tpu_torch yet (ROADMAP.md, Queue 1 item 14); "
              "only --concurrency runs", file=sys.stderr)
        return 1
    if not args.concurrency:
        ap.print_usage(sys.stderr)
        print("deepspeed_tpu_torch.analysis: nothing to do (pass "
              "--concurrency)", file=sys.stderr)
        return 1

    from deepspeed_tpu_torch import analysis
    from deepspeed_tpu_torch.analysis import concurrency as conc
    paths = args.concurrency_paths or conc.control_plane_paths()
    try:
        rep = conc.check_paths(paths, suppress=args.suppress)
    except Exception as e:  # noqa: BLE001 - the CLI's failure exit
        print(f"== concurrency: ANALYSIS FAILED ==\n   "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1
    if args.json_out:
        print(json.dumps({
            "config": None,
            "subject": "concurrency",
            "mode": args.mode,
            "paths": [os.path.relpath(p) for p in paths],
            "findings": [{
                "code": f.code, "severity": f.severity,
                "message": f.message, "path": f.path,
                "source": f.source, "pass": f.pass_name,
            } for f in rep.sorted()],
            "suppressed_count": rep.suppressed_count,
            "errors": len(rep.errors),
            "warnings": len(rep.warnings),
        }, sort_keys=True))
    else:
        print(f"== concurrency lint: {len(paths)} control-plane "
              f"module(s) ==")
        text = rep.format(min_severity=analysis.INFO if args.verbose
                          else analysis.WARNING)
        if text == "no findings" and rep.infos:
            text = (f"no warning/error findings "
                    f"({len(rep.infos)} info — use --verbose)")
        print(text)
        print(rep.summary())
        print()
    if args.mode == "error" and rep.errors:
        print(f"concurrency lint: {len(rep.errors)} error-severity "
              f"finding(s) — failing (--mode error)", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
