"""``python -m deepspeed_tpu_torch.analysis`` — graph-lint and plan a
DeepSpeed config, or lint the serving control plane's locks.

For each config a representative model is built (from the path:
``*serve*`` serves a tiny GPT-2 through the inference engine, ``*bert*``
trains a tiny BertForPreTraining, ``*gpt*`` a tiny GPT-2, anything else
the examples/simple MLP), the engine's programs are traced (fake: nothing
runs) and the findings are printed.

    python -m deepspeed_tpu_torch.analysis --device cpu examples/gpt2/ds_config_fleet_serve.json
    python -m deepspeed_tpu_torch.analysis --plan --profile h100 <config>
    python -m deepspeed_tpu_torch.analysis --plan --json --device cpu <config>
    python -m deepspeed_tpu_torch.analysis --concurrency --mode error

``--device`` (default ``cuda``) is where the engine is built: on the card
the trace holds fake CUDA tensors (the programs the card would run); on
``cpu`` the CPU's.  ``--plan`` adds the capacity plan (peak memory,
persistent state, bytes on the wire), gated against ``--profile``'s memory;
``--dispatch`` the stability pass and the priced host timeline; ``--json``
one JSON line per config.  A config at ``model_parallel_size`` (or pipe or
sequence parallelism) above 1 runs as that many gloo ranks under the
port's launcher; model rank 0 prints.

Exit status: 0 clean (or ``--mode warn``), 2 when error-severity findings
survive suppression in ``--mode error``, 1 on usage or analysis failure.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

_CHILD = "DSTPU_ANALYSIS_RANKS"


def _infer_family(path: str, override: str) -> str:
    if override != "auto":
        return override
    tokens = re.split(r"[^a-z0-9]+", os.path.basename(path.lower()))
    if "serve" in tokens or "serving" in tokens:
        return "serve"
    base = path.lower()
    if "bert" in base:
        return "bert"
    if "gpt" in base:
        return "gpt2"
    return "mlp"


def _ranks_of(cfg: dict) -> int:
    n = 1
    for k in ("model_parallel_size", "pipeline_parallel_size",
              "context_parallel_size"):
        n *= int(cfg.get(k, 1) or 1)
    return n


def _build_train(family: str, seq_len: int, device):
    import numpy as np
    import torch
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    if family == "gpt2":
        from deepspeed_tpu_torch.models import GPT2
        model = GPT2.from_size("tiny", generator=gen)

        def make_batch(b):
            t = torch.from_numpy(rng.integers(
                0, model.config.vocab_size, (b, seq_len)).astype(np.int64))
            return (t, t.clone())
        return model, make_batch
    if family == "bert":
        from deepspeed_tpu_torch.models import BertForPreTraining
        model = BertForPreTraining.from_size("tiny", generator=gen)

        def make_batch(b):
            ids = rng.integers(0, model.config.vocab_size, (b, seq_len))
            labels = np.where(rng.random((b, seq_len)) < 0.15, ids, -1)
            return tuple(torch.from_numpy(a.astype(np.int64)) for a in (
                ids, np.ones((b, seq_len)), np.zeros((b, seq_len)),
                labels))
        return model, make_batch
    from deepspeed_tpu_torch.examples.train_simple import HIDDEN, MLP
    model = MLP(generator=gen)

    def make_batch(b):
        return (torch.from_numpy(rng.normal(size=(b, HIDDEN)).astype(
                    np.float32)),
                torch.from_numpy(rng.normal(size=(b,)).astype(np.float32)))
    return model, make_batch


def _analyze_config(path, family, seq_len, suppress, plan, profile,
                    dispatch, device):
    """(filtered report, CapacityPlan | None, dispatch plans | None), or
    None on a follower rank."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.analysis import profiles as prof_mod
    with open(path) as f:
        cfg = json.load(f)
    # the CLI gates itself: the engine must not raise on its own keys
    cfg.pop("graph_lint", None)
    an_cfg = cfg.pop("analysis", None) or {}
    cfg.pop("compile_cache", None)
    profile = profile or an_cfg.get("profile")
    family = _infer_family(path, family)
    cap = dplans = None
    if family == "serve":
        from deepspeed_tpu_torch.inference.engine import InferenceEngine
        from deepspeed_tpu_torch.models import GPT2
        engine = InferenceEngine(GPT2.from_size("tiny", device="meta"),
                                 config=cfg, device=device)
        prof = (prof_mod.resolve(profile, engine.device) if profile
                else prof_mod.default_profile(engine.device))

        def work(e):
            rep = e.run_graph_lint()
            c = d = None
            if plan:
                c = e.plan_capacity(profile=prof)
                rep.extend(c.to_report(subject="serve"))
            if dispatch:
                rep.extend(e.run_stability())
                d = e.plan_dispatch(profile=prof)
                for p in d.values():
                    rep.extend(p.to_report())
            return rep, c, d
        out = engine.lead(work)
        if out is None:
            return None
        rep, cap, dplans = out
    else:
        model, make_batch = _build_train(family, seq_len, device)
        engine, _, _, _ = dst.initialize(model=model, config=cfg,
                                         device=device)
        micro = engine.train_micro_batch_size_per_gpu()
        full = make_batch(micro * engine.gradient_accumulation_steps())
        rep = engine.run_graph_lint(make_batch(micro))
        prof = (prof_mod.resolve(profile, engine.device) if profile
                else prof_mod.default_profile(engine.device))
        if plan:
            cap = engine.plan_capacity(full, profile=prof)
            rep.extend(cap.to_report(subject="train_batch"))
        if dispatch:
            rep.extend(engine.run_stability(full))
            dplans = {"train_batch": engine.plan_dispatch(full,
                                                          profile=prof)}
            rep.extend(dplans["train_batch"].to_report())
        if engine.global_rank != 0:
            return None
    rep.subject = f"{path} (model={family})"
    return rep.filtered(suppress), cap, dplans


def _config_ranks(path: str) -> int:
    try:
        with open(path) as f:
            return _ranks_of(json.load(f))
    except (OSError, ValueError):
        return 1


def _relaunch(argv, n: int) -> int:
    """This CLI again as ``n`` gloo ranks under the port's launcher."""
    env = dict(os.environ)
    env[_CHILD] = str(n)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.launcher.run",
           "--num_gpus", str(n), os.path.abspath(__file__)] + list(argv)
    return subprocess.call(cmd, env=env)


def _findings(rep):
    return [{"code": f.code, "severity": f.severity, "message": f.message,
             "path": f.path, "source": f.source, "pass": f.pass_name}
            for f in rep.sorted()]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.analysis",
        description="Statically analyze the programs a DeepSpeed config "
                    "builds on the port (collectives, precision, "
                    "transfers, shard specs, capacity, dispatch), or the "
                    "serving control plane's locks.")
    ap.add_argument("configs", nargs="*", help="DeepSpeed JSON configs")
    ap.add_argument("--mode", choices=("warn", "error"), default="warn",
                    help="'error': exit 2 on error-severity findings; "
                         "'warn' (default): report only")
    ap.add_argument("--model", default="auto",
                    choices=("auto", "mlp", "gpt2", "bert", "serve"),
                    help="representative model (default: from the path)")
    ap.add_argument("--seq-len", type=int, default=64,
                    help="sequence length of the synthetic batch")
    ap.add_argument("--device", default="cuda",
                    help="where the engine is built (cuda: the card's "
                         "programs, fake; cpu: the CPU's)")
    ap.add_argument("--suppress", action="append", default=[],
                    help="rule-code prefix to suppress (repeatable)")
    ap.add_argument("--verbose", "-v", action="store_true",
                    help="include info-severity findings in the report")
    ap.add_argument("--plan", action="store_true",
                    help="the capacity plan, gated against --profile")
    ap.add_argument("--dispatch", action="store_true",
                    help="the stability pass and the priced host timeline")
    ap.add_argument("--profile", default=None,
                    help="capacity profile (h100, cpu; a JAX TPU name "
                         "resolves to the device's)")
    ap.add_argument("--concurrency", action="store_true",
                    help="the host-concurrency lint over the control "
                         "plane's sources")
    ap.add_argument("--concurrency-path", action="append", default=[],
                    dest="concurrency_paths", metavar="FILE",
                    help="analyze these Python files instead of the "
                         "shipped control plane (repeatable)")
    ap.add_argument("--json", action="store_true", dest="json_out",
                    help="one machine-readable JSON line per config")
    ap.add_argument("--local_rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not args.configs and not args.concurrency:
        ap.print_usage(sys.stderr)
        print("deepspeed_tpu_torch.analysis: nothing to do (pass configs "
              "or --concurrency)", file=sys.stderr)
        return 1
    if (args.plan or args.dispatch) and not args.configs:
        ap.print_usage(sys.stderr)
        print("deepspeed_tpu_torch.analysis: --plan needs a config "
              "(--dispatch too)", file=sys.stderr)
        return 1
    if args.configs and args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("deepspeed_tpu_torch.analysis: no CUDA device here; "
                  "pass --device cpu", file=sys.stderr)
            return 1

    from deepspeed_tpu_torch import analysis
    if os.environ.get(_CHILD) is None and args.configs:
        multi = [p for p in args.configs if _config_ranks(p) > 1]
        if multi:
            others = [a for a in argv if a not in args.configs]
            rcs = [_relaunch(others + [p], _config_ranks(p))
                   for p in multi]
            rest = [p for p in args.configs if p not in multi]
            if rest or args.concurrency:
                rcs.append(main(others + rest))
            return max(rcs)
    leader = int(os.environ.get("DSTPU_PROCESS_ID", "0") or 0) == 0
    total_errors, failed = 0, []
    if args.concurrency and leader:
        from deepspeed_tpu_torch.analysis import concurrency as conc
        paths = args.concurrency_paths or conc.control_plane_paths()
        try:
            rep = conc.check_paths(paths, suppress=args.suppress)
        except Exception as e:  # noqa: BLE001 - the CLI's failure exit
            print(f"== concurrency: ANALYSIS FAILED ==\n   "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            failed.append("--concurrency")
            rep = None
        if rep is not None:
            if args.json_out:
                print(json.dumps({
                    "config": None, "subject": "concurrency",
                    "mode": args.mode,
                    "paths": [os.path.relpath(p) for p in paths],
                    "findings": _findings(rep),
                    "suppressed_count": rep.suppressed_count,
                    "errors": len(rep.errors),
                    "warnings": len(rep.warnings),
                }, sort_keys=True))
            else:
                print(f"== concurrency lint: {len(paths)} control-plane "
                      f"module(s) ==")
                text = rep.format(min_severity=analysis.INFO
                                  if args.verbose else analysis.WARNING)
                if text == "no findings" and rep.infos:
                    text = (f"no warning/error findings "
                            f"({len(rep.infos)} info — use --verbose)")
                print(text)
                print(rep.summary())
                print()
            total_errors += len(rep.errors)
    for path in args.configs:
        try:
            out = _analyze_config(path, args.model, args.seq_len,
                                  args.suppress, args.plan, args.profile,
                                  args.dispatch, args.device)
        except Exception as e:  # noqa: BLE001 - keep analyzing the others
            print(f"== {path}: ANALYSIS FAILED ==\n   {type(e).__name__}: "
                  f"{e}", file=sys.stderr)
            failed.append(path)
            continue
        if out is None:
            continue                    # a follower rank prints nothing
        rep, cap, dplans = out
        if args.json_out:
            print(json.dumps({
                "config": path, "subject": rep.subject, "mode": args.mode,
                "device": args.device, "findings": _findings(rep),
                "suppressed_count": rep.suppressed_count,
                "errors": len(rep.errors), "warnings": len(rep.warnings),
                "plan": cap.to_json() if cap is not None else None,
                "dispatch": ({k: p.to_json() for k, p in dplans.items()}
                             if dplans is not None else None),
            }, sort_keys=True))
        else:
            print(f"== graph lint: {rep.subject} ==")
            text = rep.format(min_severity=analysis.INFO if args.verbose
                              else analysis.WARNING)
            if text == "no findings" and rep.infos:
                text = (f"no warning/error findings "
                        f"({len(rep.infos)} info — use --verbose)")
            print(text)
            print(rep.summary())
            if cap is not None:
                print("-- capacity plan --")
                print(cap.format_table())
            if dplans is not None:
                for p in dplans.values():
                    print("-- dispatch plan --")
                    print(p.format_table())
            print()
        total_errors += len(rep.errors)
    if failed:
        print(f"graph lint: analysis failed for {len(failed)} config(s): "
              f"{', '.join(failed)}", file=sys.stderr)
        return 1
    if args.mode == "error" and total_errors:
        print(f"graph lint: {total_errors} error-severity finding(s) — "
              f"failing (--mode error)", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
