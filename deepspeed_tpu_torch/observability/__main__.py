"""JSONL event-log validator CLI.

``python -m deepspeed_tpu_torch.observability <events.jsonl> [...]`` — validates
every line of each telemetry event log.  Streams may interleave the six
event schemas (``dstpu.telemetry.window`` v1/v2, ``dstpu.telemetry.fleet``
v2, ``dstpu.telemetry.startup`` v2, ``dstpu.telemetry.serve`` v1/v2/v3,
``dstpu.telemetry.request`` v1, ``dstpu.telemetry.router`` v1 —
observability/schema.py, each on its own version track); v1 window-only
logs from before the fleet layer still validate, as do serve
logs without the later columns.  A fleet-serve run's one stream holds
router windows next to each replica's serve/request events.  The
per-file summary is version-aware (``3 serve v3, 8 request v1, …``).
Exit codes:
0 = every file valid and non-empty, 2 = any problem — invalid lines,
unknown schemas, unreadable or EMPTY files (the CI observability smoke
job's gate, pinned by tests/test_fleet.py).  Needs no torch — it is a
pure-JSON check usable on artifact files anywhere.
"""

from __future__ import annotations

import argparse
import sys

from deepspeed_tpu_torch.observability import schema


def _summary(path: str) -> str:
    counts = schema.count_by_schema_version(path)
    short = {schema.SCHEMA_ID: "window", schema.FLEET_SCHEMA_ID: "fleet",
             schema.STARTUP_SCHEMA_ID: "startup",
             schema.SERVE_SCHEMA_ID: "serve",
             schema.REQUEST_SCHEMA_ID: "request",
             schema.ROUTER_SCHEMA_ID: "router"}
    parts = [f"{n} {short.get(sid, sid)}"
             + (f" v{version}" if version is not None else "")
             for (sid, version), n in sorted(counts.items(),
                                             key=lambda kv: -kv[1])]
    return ", ".join(parts) or "0 events"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.observability",
        description="Validate telemetry JSONL event logs (schemas: "
                    "%s v1/v2, %s v2, %s v2, %s v1/v2/v3, %s v1, %s v1)"
                    % (schema.SCHEMA_ID, schema.FLEET_SCHEMA_ID,
                       schema.STARTUP_SCHEMA_ID, schema.SERVE_SCHEMA_ID,
                       schema.REQUEST_SCHEMA_ID, schema.ROUTER_SCHEMA_ID))
    parser.add_argument("paths", nargs="+", help="JSONL event log(s)")
    args = parser.parse_args(argv)

    rc = 0
    for path in args.paths:
        problems = schema.validate_jsonl(path)
        if not problems:
            print(f"{path}: OK ({_summary(path)})")
            continue
        rc = 2
        for line_no, msg in problems:
            where = f"{path}:{line_no}" if line_no else path
            print(f"{where}: {msg}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
