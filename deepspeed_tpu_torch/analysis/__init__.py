"""deepspeed_tpu_torch.analysis: graph lint, the planners and the
host-concurrency lint.

The port of ``deepspeed_tpu/analysis/``.  The JAX passes walk a jaxpr; the
port's walk a dispatch-level trace of its own programs (``graph``: one run
under a recording dispatch mode inside ``FakeTensorMode``, so nothing is
computed and no collective reaches the wire).

* ``passes``       - the four lint passes (``collective.*``,
  ``precision.*``, ``transfer.*``, ``shardspec.*``);
* ``memplan``      - the predicted per-device peak (live bytes over the
  fake trace) and the ``CapacityPlan`` (``memory.*``);
* ``commplan``     - bytes on the wire per step and axis (``comm.wire``);
* ``dispatchplan`` - the priced host timeline and the ``FenceModel``
  (``dispatch.*``);
* ``stability``    - the CUDA graphs and kernel libraries a run builds,
  and the placement checks (``stability.*``);
* ``profiles``     - the ``h100`` and ``cpu`` capacity profiles;
* ``report``, ``concurrency``, ``lockwatch`` - findings, the serving
  control plane's lock lint, the runtime lock sanitizer.

Both engines gate on the config's ``graph_lint`` and ``analysis`` sections
(``off`` / ``warn`` / ``error``) once per program kind and batch format,
as the JAX engines do, and expose ``run_graph_lint``, ``plan_capacity``,
``plan_dispatch`` and ``run_stability`` (the serving engine also
``predict_executables``).

JAX rules with no PyTorch counterpart, which the port never emits:

=================================  =======================================
rule                               why
=================================  =======================================
``transfer.donation``              PyTorch has no buffer donation: eager
                                   ops write in place or allocate
``stability.donation-cache-quirk`` no donation and no persistent
                                   executable cache (CUDA graphs live in
                                   the process)
``collective.branch-mismatch``     a trace runs one branch; the ranks'
                                   branches are compared as traces
                                   (``collective.divergent-order``)
``transfer.debug-callback``        no ``jax.debug`` callbacks: a print of
                                   a device value is a host read
                                   (``transfer.host-callback``)
=================================  =======================================
"""

from __future__ import annotations

import contextlib
import logging
from typing import Dict, Optional

from deepspeed_tpu_torch.analysis import concurrency  # noqa: F401
from deepspeed_tpu_torch.analysis import lockwatch  # noqa: F401
from deepspeed_tpu_torch.analysis import report  # noqa: F401
from deepspeed_tpu_torch.analysis.concurrency import ConcurrencyLintError
from deepspeed_tpu_torch.analysis.report import (ERROR, INFO, WARNING,
                                                 Finding, GraphLintError,
                                                 MemoryPlanError, Report,
                                                 ShardSpecError)

logger = logging.getLogger(__name__)

MODES = ("off", "warn", "error")

#: JAX rule codes the port has no counterpart of (see the docstring)
NO_COUNTERPART = ("transfer.donation", "stability.donation-cache-quirk",
                  "collective.branch-mismatch", "transfer.debug-callback")

__all__ = [
    "ERROR", "WARNING", "INFO", "Finding", "Report", "GraphLintError",
    "MemoryPlanError", "ShardSpecError", "ConcurrencyLintError", "MODES",
    "NO_COUNTERPART", "analyze_trace", "analyze_step", "analyze_engine",
    "analyze_engine_train_batch", "analyze_engine_train_many",
    "check_shard_specs", "validate_specs_or_raise", "dispatch_report",
    "trace_engine", "concurrency", "lockwatch", "report",
]


def analyze_trace(trace, subject: str = "") -> Report:
    """The precision and transfer passes over one trace (the collective
    pass compares ranks: :func:`lint_traces`)."""
    from deepspeed_tpu_torch.analysis import passes
    rep = Report(subject=subject or trace.subject)
    passes.check_precision(trace, rep)
    passes.check_transfers(trace, rep)
    return rep


def lint_traces(traces: Dict[str, object], known_groups=None,
                control_group=None, rank: int = 0, failure=None) -> Report:
    """All three trace passes over ``traces`` (subject -> trace), the
    collective pass exchanging with every rank once.  ``failure``: this
    rank's tracing error, exchanged (as no programs) before it is raised,
    so that no rank waits on it."""
    from deepspeed_tpu_torch.analysis import passes
    rep = Report(subject=", ".join(traces) or "lint")
    passes.check_collectives(traces, rep, known_groups=known_groups,
                             control_group=control_group, rank=rank)
    if failure is not None:
        raise failure
    for subject, tr in traces.items():
        rep.extend(analyze_trace(tr, subject))
    return rep


def analyze_step(fn, args=(), subject: str = "", fake: bool = True,
                 known_groups=None, control_group=None,
                 rank: int = 0) -> Report:
    """Trace ``fn(*args)`` and run the passes (``args`` become fakes)."""
    from deepspeed_tpu_torch.analysis import graph as G
    mode = G.new_fake_mode() if fake else None
    memo: dict = {}
    fargs = G.fake_tree(tuple(args), mode, memo) if fake else tuple(args)
    with G.recording(subject or "program", fake=fake, mode=mode,
                     arguments=list(G.tree_tensors(fargs))) as rec:
        fn(*fargs)
    return lint_traces({rec.subject: rec.trace()}, known_groups,
                       control_group, rank)


def check_shard_specs(mesh_shape, specs, tree, subject: str = "",
                      where: str = "") -> Report:
    """Pass 4 standalone: specs against axis sizes and value shapes."""
    from deepspeed_tpu_torch.analysis import passes
    rep = Report(subject=subject)
    passes.check_shard_specs(dict(mesh_shape), specs, tree, rep,
                             where=where)
    return rep


def validate_specs_or_raise(mesh_shape, specs, tree, where: str = "") -> None:
    """Raise :class:`ShardSpecError` naming the offending leaf, spec and
    axis (always on, whatever ``graph_lint.mode``)."""
    rep = check_shard_specs(mesh_shape, specs, tree, where=where)
    errs = rep.errors
    if errs:
        raise ShardSpecError(
            f"invalid sharding for {where or 'shard_map operands'} "
            f"({len(errs)} problem(s)):\n"
            + "\n".join("  - " + f.message for f in errs))


# ------------------------------------------------------- the engine's state

class _QuietTelemetry:
    """The telemetry an engine sees while one of its programs is traced:
    no spool, no scalars, no reads."""

    spool = None
    spool_active = False

    def defers_overflow(self, engine) -> bool:
        return False

    def __getattr__(self, name):
        return lambda *a, **k: None


@contextlib.contextmanager
def fake_engine(engine, mode):
    """The training engine with its state (module parameters, masters,
    moments, loss scale, accumulators) replaced by fakes for the duration;
    the real state is untouched and every attribute is restored after,
    with the resilience counters.  Yields the list of fake state tensors
    (the programs' arguments)."""
    from deepspeed_tpu_torch.analysis import graph as G
    from deepspeed_tpu_torch.resilience import COUNTERS
    saved = dict(engine.__dict__)
    counters = dict(COUNTERS.__dict__)
    memo: dict = {}
    try:
        with G.fake_modules([engine.module], mode, memo) as fakes:
            state = G.fake_attrs(
                engine, [n for n in saved if n not in (
                    "module", "_client_model", "_telemetry")], mode, memo)
            engine.__dict__.update(
                _telemetry=_QuietTelemetry(), summary_writer=None,
                _watchdog=None, _in_fused=True)
            yield list(fakes) + state
    finally:
        engine.__dict__.clear()
        engine.__dict__.update(saved)
        COUNTERS.__dict__.update(counters)


def _micro_slices(engine, batch):
    gas = engine.gradient_accumulation_steps()
    mb = batch[0].shape[0] // gas
    return [tuple(x[i * mb:(i + 1) * mb] for x in batch)
            for i in range(gas)]


def trace_engine(engine, batch, kinds=("train_batch",), fake: bool = True,
                 k: int = 1) -> Dict[str, object]:
    """Traces of the engine's programs on ``batch`` (``train_batch`` format
    for ``train_batch`` / ``train_many``, one micro batch otherwise):
    ``train_batch`` (gas micro steps and the boundary), ``train_many``
    (``k`` of them), ``fwdbwd`` + ``step`` (the split API) or ``eval``.
    ``fake=False`` runs the programs for real (a test's reference:
    it trains the engine)."""
    from deepspeed_tpu_torch.analysis import graph as G
    batch = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
    batch = tuple(engine._to_device(x) for x in batch)
    mode = G.new_fake_mode() if fake else None
    out: Dict[str, object] = {}
    ctx = fake_engine(engine, mode) if fake else _real_engine(engine)
    with ctx as state:
        memo: dict = {}
        fbatch = G.fake_tree(batch, mode, memo) if fake else batch
        args = list(state) + list(fbatch)
        if not fake:
            args += list(_real_state(engine))
        was_training = engine.training

        def rec(subject):
            return G.recording(
                subject, fake=fake, mode=mode,
                arguments=args + list(G.tree_tensors(engine._acc)))
        try:
            if "train_batch" in kinds or "train_many" in kinds:
                engine.training = True
                kind = "train_many" if "train_many" in kinds else \
                    "train_batch"
                with rec(kind) as r:
                    for _ in range(k if kind == "train_many" else 1):
                        for micro in _micro_slices(engine, fbatch):
                            engine.backward(engine.forward(*micro))
                        engine._boundary_update()
                out[kind] = r.trace()
            if "fwdbwd" in kinds:
                engine.training = True
                with rec("fwdbwd") as r:
                    engine.backward(engine.forward(*fbatch))
                out["fwdbwd"] = r.trace()
                if "step" in kinds:
                    with rec("step") as r:
                        engine._boundary_update()
                    out["step"] = r.trace()
            if "eval" in kinds:
                engine.training = False
                with rec("eval") as r:
                    engine.forward(*fbatch)
                out["eval"] = r.trace()
        finally:
            engine.training = was_training
    return out


@contextlib.contextmanager
def _real_engine(engine):
    saved = engine._in_fused
    engine._in_fused = True
    try:
        yield []
    finally:
        engine._in_fused = saved


def _real_state(engine):
    from deepspeed_tpu_torch.analysis import graph as G
    yield from engine.module.parameters()
    for n, v in engine.__dict__.items():
        if n not in ("module", "_client_model", "_telemetry"):
            yield from G.tree_tensors(v)


def known_groups(topology) -> Dict[str, tuple]:
    """The topology's groups by axis (``data:within`` / ``data:across``
    are data sub-groups)."""
    import torch.distributed as dist
    out = {}
    for axis, attr in (("data", "group"), ("model", "model_group"),
                       ("pipe", "pipe_group"), ("seq", "seq_group"),
                       ("data:within", "within"),
                       ("data:across", "across")):
        g = getattr(topology, attr, None)
        if g is not None:
            try:
                out[axis] = tuple(dist.get_process_group_ranks(g))
            except Exception:  # noqa: BLE001 - not a started group
                pass
    return out


def _lint_engine_traces(engine, traces, failure=None) -> Report:
    return lint_traces(traces, known_groups(engine.topology),
                       control_group=None, rank=engine.global_rank,
                       failure=failure)


def _device_batch(engine, batch):
    batch = batch if isinstance(batch, (tuple, list)) else (batch,)
    return tuple(engine._to_device(x) for x in batch)


def analyze_engine(engine, batch, train: bool = True,
                   include_step: bool = True) -> Report:
    """Shard specs, then the passes over the split-API programs (one micro
    batch: ``fwdbwd`` and, with ``include_step``, ``step``) or ``eval``,
    plus the master-dtype contract."""
    kinds = ((("fwdbwd", "step") if include_step else ("fwdbwd",))
             if train else ("eval",))
    return engine._lint(_device_batch(engine, batch), kinds)


def analyze_engine_train_batch(engine, batch) -> Report:
    """The passes over the ``train_batch`` program (gas micro steps and the
    boundary in one trace)."""
    return engine._lint(_device_batch(engine, batch), ("train_batch",))


def analyze_engine_train_many(engine, batches) -> Report:
    """The passes over ``train_many``: K ``train_batch`` steps traced in
    one run (the port's serial loop)."""
    batches = list(batches)
    return engine._lint(_device_batch(engine, batches[0]), ("train_many",),
                        k=len(batches))


def _shard_spec_report(engine) -> Report:
    """Pass 4 over the parameters' model-axis cuts and the batch's
    sequence cuts (the JAX engine's spec check, on the port's dims)."""
    from deepspeed_tpu_torch.analysis import passes
    rep = Report(subject="shard-specs")
    specs = engine._param_specs
    if specs is not None and engine.mp_world_size > 1:
        import types
        flat = {n: types.SimpleNamespace(shape=s)
                for n, s in engine._global_shapes.items()}
        passes.check_shard_specs(
            {"model": engine.mp_world_size},
            {n: passes.dim_specs(specs.get(n)) for n in flat}, flat, rep,
            where="params")
    return rep


def _master_dtype_report(engine) -> Report:
    """``precision.master-dtype``: the fp32 masters bf16 / fp16 training
    converges on."""
    import torch
    rep = Report(subject="precision")
    master = ({"flat": engine.master_flat} if engine.zero_flat
              else (engine.master or {}))
    bad = [k for k, v in master.items()
           if isinstance(v, torch.Tensor) and v.dtype != torch.float32]
    if bad:
        rep.add(
            "precision.master-dtype", ERROR,
            f"master weights are expected in fp32 but "
            f"{bad[:3]}{'...' if len(bad) > 3 else ''} are not - "
            f"low-precision masters silently stall convergence",
            pass_name="precision")
    return rep


def dispatch_report(rep: Report, mode: str, where: str = "",
                    log: Optional[logging.Logger] = None,
                    label: str = "graph lint",
                    info_hint: Optional[str] = None,
                    error_cls=None) -> Report:
    """Apply a ``warn``/``error`` gate: log warnings and errors in
    ``warn`` mode, raise ``error_cls`` (default :class:`GraphLintError`)
    on error findings in ``error`` mode."""
    log = log or logger
    if mode == "off" or not len(rep):
        return rep
    worst = rep.errors or rep.warnings
    if worst or rep.infos:
        hint = info_hint or "the report's format() shows them"
        body = (rep.format(min_severity=WARNING) if worst else
                f"{len(rep.infos)} info-severity finding(s); {hint}")
        log.log(logging.WARNING if worst else logging.INFO,
                "%s%s: %s\n%s", label,
                f" [{where}]" if where else "", rep.summary(), body)
    if mode == "error":
        rep.raise_on_error(where=where, error_cls=error_cls)
    return rep
