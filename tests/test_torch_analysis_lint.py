"""The port's graph lint (``deepspeed_tpu_torch/analysis/``) in one process,
after ``tests/test_graph_lint.py``.

* Precision: a seeded fp32 product of upcast bf16 operands on fake CUDA
  tensors is ``precision.upcast-dot`` (ERROR); ``bmm`` with ``out_dtype``,
  the repaired serving scores (``models/layers._scores``) and the einsum
  attention's scores (``_QKScores``) are clean; a down-cast launders the
  taint, an elementwise op carries it; ``_scores`` on the CPU is the fp32
  einsum it was, bitwise.
* Transfers: a stray host read in a program is ``transfer.host-callback``;
  the same read through ``observability.fences`` is clean.
* The engine gate: error mode raises at the first call of a program (and
  again on a retry), warn mode logs and trains, suppression and off mode
  are silent, the split API and eval are gated too.
* Shard specs: the port's pass gives the JAX pass's findings, word for
  word, on the same specs and shapes.
* The shipped ``graph_lint: error`` training configs train on fp32 copies
  with the JAX driver's losses (``rtol=1e-4``, as
  ``tests/test_torch_examples.py``), and the CLI (``--plan --dispatch
  --json --device cpu``, the mp 2 configs as two ranks) exits 0 on all
  seven shipped ``graph_lint: error`` configs, with the multiset of rule
  codes the JAX CLI's calls give on the same file (see
  ``test_cli_rule_codes_match_jax``).
* The rule table names every JAX rule the port does not emit.
"""

import importlib.util
import json
import logging
import math
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.analysis import passes as jpasses
from deepspeed_tpu.analysis import report as jreport
from jax.sharding import PartitionSpec as JP

import deepspeed_tpu_torch
from deepspeed_tpu_torch import analysis
from deepspeed_tpu_torch.analysis import passes
from deepspeed_tpu_torch.analysis.passes import PartitionSpec
from deepspeed_tpu_torch.models import layers as L
from deepspeed_tpu_torch.observability import fences
from deepspeed_tpu_torch.ops import dispatch_attention as dattn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
BF16 = torch.bfloat16


def _codes(rep, severity=None):
    return sorted(f.code for f in rep
                  if severity is None or f.severity == severity)


def _cuda(*shape):
    return torch.empty(shape, dtype=BF16, device="cuda")


# ================================================================ precision

def _upcast():
    torch.mm(_cuda(8, 16).float(), _cuda(16, 4).float())


def _out_dtype():
    torch.bmm(_cuda(2, 8, 16), _cuda(2, 16, 4), out_dtype=torch.float32)


def _scores_decode():
    L._scores(_cuda(3, 4, 16), _cuda(3, 32, 4, 16), "bnd,btnd->bnt")


def _scores_extend():
    L._scores(_cuda(3, 5, 4, 16), _cuda(3, 32, 4, 16), "bend,btnd->bent")


def _qk_scores():
    dattn._QKScores.apply(_cuda(2, 8, 4, 16), _cuda(2, 8, 4, 16))


def _laundered():
    x = _cuda(8, 16).float().exp().to(BF16)
    torch.mm(x, _cuda(16, 4))


def _through_elementwise():
    x = _cuda(8, 16).float() * 2.0
    torch.mm(x, _cuda(16, 4).float())


@pytest.mark.parametrize("fn,want", [
    (_upcast, ["precision.upcast-dot"]),
    (_out_dtype, []),
    (_scores_decode, []),
    (_scores_extend, []),
    (_qk_scores, []),
    (_laundered, []),
    (_through_elementwise, ["precision.upcast-dot"]),
])
def test_upcast_dot_on_fake_cuda_tensors(fn, want):
    """Fake CUDA tensors (nothing is computed: this host has no card)."""
    rep = analysis.analyze_step(fn, subject=fn.__name__)
    assert _codes(rep, analysis.ERROR) == want


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_kernel_is_one_operator_in_the_trace(device):
    """A kernel wrapper is the operator ``dstpu::<kernel>``: one op of
    kind ``kernel`` whose only allocation is its output, and a library
    only where the kernel launches (on the CPU its plain version runs)."""
    from deepspeed_tpu_torch.analysis import graph, stability
    from deepspeed_tpu_torch.ops import block_attention as battn
    with graph.recording("block", mode=graph.new_fake_mode()) as rec:
        q = torch.empty((2, 64, 4, 64), dtype=BF16, device=device)
        mask = torch.ones((2, 64), device=device)
        battn.block_fwd(q, q, q, mask, False)
    tr = rec.trace()
    ops = [o for o in tr.ops if o.kind == "kernel"]
    assert [o.name for o in ops] == ["dstpu.block_fwd.default"]
    assert ops[0].outputs[0].shape == (2, 64, 4, 64)
    qbytes = 2 * 64 * 4 * 64 * 2
    assert tr.peak_bytes == 2 * qbytes + 2 * 64 * 4   # q, o and the mask
    assert stability.libraries_of([tr]) == (
        ["block_attention"] if device == "cuda" else [])


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("eq,qshape", [("bnd,btnd->bnt", (3, 4, 16)),
                                       ("bend,btnd->bent", (3, 5, 4, 16))])
def test_scores_unchanged_on_the_cpu(dtype, eq, qshape):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(qshape, generator=g).to(dtype)
    k = torch.randn((3, 32, 4, 16), generator=g).to(dtype)
    want = torch.einsum(eq, q.float(), k.float()) / math.sqrt(16)
    assert torch.equal(L._scores(q, k, eq), want)


def test_cpu_upcast_dot_is_info():
    """On the CPU the fp32 copies are the only route: INFO, not ERROR."""
    def prog(a, b):
        torch.mm(a.float(), b.float())
    rep = analysis.analyze_step(prog, (torch.zeros(8, 16, dtype=BF16),
                                       torch.zeros(16, 4, dtype=BF16)))
    assert _codes(rep, analysis.INFO) == ["precision.upcast-dot"]
    assert not rep.errors


# ================================================================ transfers

@pytest.mark.parametrize("through_fences", [False, True])
def test_host_read_in_a_program(through_fences):
    f0 = fences.FENCE_COUNT

    def prog(x):
        s = x.sum()
        return fences.read_scalar(s) if through_fences else s.item()
    rep = analysis.analyze_step(prog, (torch.ones(4),))
    assert _codes(rep, analysis.ERROR) == (
        [] if through_fences else ["transfer.host-callback"])
    assert fences.FENCE_COUNT == f0        # a fake trace waited on nothing


def test_python_scalar_into_a_graphed_program():
    """``transfer.weak-type``: a CUDA graph bakes a Python scalar in."""
    from deepspeed_tpu_torch.analysis import graph

    def prog(t):
        graphs = graph.TracedGraphs()
        for key, inputs in ((("extend", False), (t, 3)),
                            (("decode", False), (t, t))):
            graphs[key] = types.SimpleNamespace(fn=lambda *a: a[0] + 1)
            graphs[key](*inputs)
    rep = analysis.analyze_step(prog, (torch.zeros(2),))
    assert _codes(rep, analysis.WARNING) == ["transfer.weak-type"]


# ============================================================ engine gates

class _StrayRead(torch.nn.Module):
    """A linear regression whose forward reads its loss on the host (the
    seeded ``transfer.host-callback``) unless ``clean``."""

    def __init__(self, clean=False):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((8, 1), 0.1))
        self.clean = clean

    def forward(self, x, y):
        loss = ((x @ self.w)[:, 0] - y).pow(2).mean()
        if not self.clean:
            self.last = float(loss.detach())
        return loss


def _engine(mode, clean=False, suppress=()):
    section = {"mode": mode, "suppress": list(suppress)}
    return deepspeed_tpu_torch.initialize(
        model=_StrayRead(clean), device="cpu", config={
            "train_micro_batch_size_per_gpu": 4,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
            "graph_lint": section})[0]


def _batch():
    g = torch.Generator().manual_seed(1)
    return torch.randn(4, 8, generator=g), torch.randn(4, generator=g)


@pytest.mark.parametrize("case", ["error_raises", "sticky", "warn_trains",
                                  "suppressed", "off", "split_api", "eval",
                                  "clean_error_trains"])
def test_engine_gate(case, caplog):
    b = _batch()
    if case in ("error_raises", "sticky", "split_api", "eval"):
        eng = _engine("error")
        w0 = eng.module.w.detach().clone()
        for _ in range(2 if case == "sticky" else 1):
            with pytest.raises(analysis.GraphLintError,
                               match="transfer.host-callback"):
                if case == "split_api":
                    eng(*b)
                elif case == "eval":
                    eng.eval()
                    eng(*b)
                else:
                    eng.train_batch(b)
        assert torch.equal(eng.module.w, w0)           # nothing trained
        if case == "error_raises":
            # the library surface, as the JAX package's names it
            for rep in (analysis.analyze_engine(eng, b),
                        analysis.analyze_engine_train_batch(eng, b),
                        analysis.analyze_engine_train_many(eng, [b, b])):
                assert "transfer.host-callback" in _codes(rep)
        return
    if case == "warn_trains":
        with caplog.at_level(logging.WARNING):
            eng = _engine("warn")
            eng.train_batch(b)
        assert "transfer.host-callback" in caplog.text
        return
    eng = {"suppressed": lambda: _engine("error", suppress=["transfer"]),
           "off": lambda: _engine("off"),
           "clean_error_trains": lambda: _engine("error", clean=True)}[case]()
    losses = [float(eng.train_batch(b)) for _ in range(3)]
    assert losses[-1] < losses[0]
    rep = eng.run_graph_lint(b)
    assert bool(rep.errors) == (case == "off")


# ============================================================= shard specs

def _spec_cases():
    mesh = {"data": 2, "model": 2}
    shapes = {"blocks": {"w": (2, 32, 64), "b": (2, 63)},
              "wte": (64, 32), "wpe": (16, 32)}
    return {
        "clean": (mesh, {"blocks": {"w": (None, None, "model"),
                                    "b": (None,)},
                         "wte": ("model",), "wpe": ()}, shapes),
        "unknown_axis": (mesh, {"wte": ("expert",)}, {"wte": (64, 32)}),
        "rank": (mesh, {"wpe": (None, None, "model")}, {"wpe": (16, 32)}),
        "indivisible": (mesh, {"blocks": {"b": (None, "model")}},
                        {"blocks": {"b": (2, 63)}}),
        "prefix": (mesh, {"blocks": (None, ("data", "model"))}, shapes),
    }


@pytest.mark.parametrize("case", sorted(_spec_cases()))
def test_shard_spec_findings_match_jax(case):
    mesh, specs, shapes = _spec_cases()[case]

    def tree(x, leaf):
        if isinstance(x, dict):
            return {k: tree(v, leaf) for k, v in x.items()}
        return leaf(x)
    mine = analysis.Report()
    passes.check_shard_specs(
        mesh, tree(specs, lambda s: PartitionSpec(*s)),
        tree(shapes, lambda s: torch.empty(s, device="meta")), mine,
        where="params")
    theirs = jreport.Report()
    jpasses.check_shard_specs(
        mesh, tree(specs, lambda s: JP(*s)),
        tree(shapes, lambda s: jax.ShapeDtypeStruct(s, np.float32)),
        theirs, where="params")
    key = [(f.code, f.severity, f.message, f.path) for f in mine]
    assert key == [(f.code, f.severity, f.message, f.path) for f in theirs]
    assert bool(key) == (case != "clean")


def test_validate_specs_or_raise_names_the_leaf():
    with pytest.raises(analysis.ShardSpecError, match=r"\['b'\]"):
        analysis.validate_specs_or_raise(
            {"model": 2}, {"b": PartitionSpec("model")},
            {"b": torch.empty(3, device="meta")}, where="params")


# =============================================================== rule table

def test_rule_table_names_every_no_counterpart_rule():
    readme = open(os.path.join(ROOT, "README.md")).read()
    for code in analysis.NO_COUNTERPART:
        assert f"``{code}``" in analysis.__doc__
        assert code in readme


# ====================================================== the shipped configs

def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _copy(tmp_path, rel, **over):
    """An fp32 copy of a shipped config that keeps its ``graph_lint``."""
    cfg = json.load(open(os.path.join(EXAMPLES, rel)))
    for key in ("fp16", "bf16", "observability"):
        cfg.pop(key, None)
    cfg.update(over)
    assert cfg["graph_lint"] == "error"
    path = tmp_path / os.path.basename(rel)
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("rel", ["simple/ds_config_fleet.json",
                                 "simple/ds_config_telemetry.json",
                                 "simple/ds_config_multistep.json"])
def test_shipped_lint_configs_train_like_jax(rel, tmp_path, capsys,
                                             monkeypatch):
    """``train_simple`` on both packages (the JAX driver on one device)."""
    from deepspeed_tpu_torch.examples import train_simple
    over = {}
    if "multistep" in rel:
        # the shape both engines' train_many take (test_torch_examples)
        over = dict(gradient_accumulation_steps=1, train_batch_size=32)
    cfg = _copy(tmp_path, rel, **over)
    if "multistep" in rel:
        c = json.load(open(cfg))
        c.pop("scheduler")
        open(cfg, "w").write(json.dumps(c))
    steps = 20 if "multistep" in rel else 4
    jmod = _load("simple/train_simple.py", "jax_train_simple_lint")
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [jmod.__file__, "--deepspeed_config",
                                      cfg, "--steps", str(steps),
                                      "--ckpt_dir", str(tmp_path / "j")])
    with monkeypatch.context() as mp:
        devices = jax.devices
        mp.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
        jmod.main()
    out = capsys.readouterr().out
    want = [(int(s), float(l)) for s, l in
            re.findall(r"step +(\d+)  loss ([\d.]+)", out)]
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jmod.MLP().init_params(jax.random.PRNGKey(0)))
    got, _ = train_simple.main(
        ["--deepspeed_config", cfg, "--steps", str(steps), "--ckpt_dir",
         str(tmp_path / "t"), "--device", "cpu"], model_parameters=params)
    assert want and [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=1e-4, atol=6e-6)


#: every shipped config that sets ``graph_lint`` to ``error``; the two at
#: ``model_parallel_size`` 2 run as two gloo ranks under the port's launcher
SHIPPED_LINT_CONFIGS = [
    "simple/ds_config_fleet.json", "simple/ds_config_multistep.json",
    "simple/ds_config_telemetry.json", "gpt2/ds_config_fleet_serve.json",
    "gpt2/ds_config_multistep.json", "gpt2/ds_config_serve.json",
    "gpt2/ds_config_serve_spec.json"]

#: INFO classes left out of the count on both sides, each with its reason.
#: Their ERROR and WARNING findings are counted like any other.
UNCOUNTED_INFO = {
    # the CPU profile's quirk: this host has no bf16 product with an fp32
    # result, so the port's CPU route and the plain versions that stand in
    # for the kernels copy their operands to fp32 before the product,
    # where XLA-CPU upcasts inside the dot, out of the JAX lint's sight
    "precision.upcast-dot",
    # counted per aten op against per jaxpr equation: autograd's backward
    # casts and the plain versions that stand in for the kernels
    # (``block_*_plain``, one ``pallas_call`` equation in JAX) are ops of
    # their own in the port's trace
    "precision.upcast",
    "precision.lowp-accum",
}


def _jax_cli_findings(path):
    """The JAX CLI's findings on ``path`` (``--plan --dispatch``, the
    CLI's defaults), computed here by the library calls its ``main``
    makes for one config."""
    from deepspeed_tpu.analysis import __main__ as jcli
    rep, _, _ = jcli._analyze_config(path, "auto", 64, [], plan=True,
                                     profile=None, dispatch=True)
    return [(f.severity, f.code) for f in rep.findings]


def _counted(findings):
    counted, uncounted = {}, set()
    for sev, code in findings:
        if code in analysis.NO_COUNTERPART:
            continue
        if sev == "info" and code in UNCOUNTED_INFO:
            uncounted.add(code)
            continue
        counted[(sev, code)] = counted.get((sev, code), 0) + 1
    return counted, uncounted


@pytest.mark.parametrize("rel", SHIPPED_LINT_CONFIGS)
def test_cli_rule_codes_match_jax(rel, capfd):
    """The port's CLI (``--plan --dispatch --json --device cpu --mode
    error``) against the JAX CLI's library calls on the same config file:
    the multiset of rule codes by severity is equal, less the
    no-counterpart rules and the INFO classes of ``UNCOUNTED_INFO``; of
    those, every class JAX reports the port reports too."""
    from deepspeed_tpu_torch.analysis.__main__ import main
    path = os.path.join(EXAMPLES, rel)
    assert main(["--plan", "--dispatch", "--json", "--device", "cpu",
                 "--mode", "error", path]) == 0
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1                     # model rank 0 alone prints
    doc = json.loads(lines[0])
    got, got_info = _counted((f["severity"], f["code"])
                             for f in doc["findings"])
    want, want_info = _counted(_jax_cli_findings(path))
    assert got == want
    assert want_info <= got_info
    assert doc["errors"] == 0 and doc["plan"]["fits"]
