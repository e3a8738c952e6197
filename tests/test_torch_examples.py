"""The port's example drivers against the JAX package's, on the CPU.

``deepspeed_tpu_torch/examples/train_simple.py``, ``train_gpt2.py`` and
``serve_gpt2.py`` run beside ``examples/simple/train_simple.py``,
``examples/gpt2/train_gpt2.py`` and ``examples/gpt2/serve_gpt2.py`` (loaded
from their files and run in this process), on the same configs and the
same JAX-init weights (the port drivers take them as
``model_parameters``):

* the trainers' printed losses agree in fp32 with ``rtol=1e-4`` (the two
  frameworks sum in other orders; the JAX drivers print 4-5 decimals, so
  those lines are held to the printed precision), the final losses with
  ``rtol=1e-4``; ``train_simple`` on its K = 1 loop and on the
  ``train_many`` branch, ``train_gpt2`` dense (its ``--moe-experts`` and
  ``--micro-batches`` families train on the port alone, at pp 1 and ep 1);
* ``serve_gpt2``'s greedy tokens, one replica and ``--fleet 2
  --prefill-replicas 1``, equal the JAX driver's on the JAX driver's
  ``--prepare`` checkpoint (and each fleet equals its single replica);
* ``serve_gpt2`` at model_parallel_size 2, two CPU ranks under the
  port's launcher, prints the JAX driver's tokens at mp 2 on the same
  lint-free copy of ``ds_config_serve.json``; with ``--fleet 2`` (two
  replicas on the same two ranks) and with ``--verify-identity`` it
  prints the port driver's tokens at mp 1 with the same flag;
* the shipped serving configs serve with their ``graph_lint`` and
  ``analysis`` at ``error`` (ROADMAP.md Queue 1 item 14, ported): on fp32
  copies that keep them, at their model_parallel_size, with the JAX
  driver's tokens.

The configs are copies of the shipped ones with fp16 / bf16 off (the
comparison is in fp32), and for the serving configs with
``graph_lint`` and ``analysis`` removed and ``model_parallel_size`` too,
but for the mp 2 test and the shipped-config test.  The drivers'
multi-rank training runs (pp 2, ep 2) are left to
``tests/test_torch_pipeline.py`` and ``tests/test_torch_moe.py``, which
hold the same models at those meshes over gloo.
"""

import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest

import jax

from deepspeed_tpu_torch.examples import serve_gpt2, train_gpt2, train_simple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test runs torch on one intra-op thread: the suite runs six
    workers on the host's cores, where torch's default of one thread a
    core makes these small models' steps contend (x10-40 their time)."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _one_device(mp):
    """The JAX drivers build their mesh over ``jax.devices()``: the test
    rig's 8 virtual CPU devices would make a JAX run dp 8 (another row
    split of each micro-step) where the port's runs dp 1."""
    devices = jax.devices
    mp.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])


def _jax_main(mod, argv, capsys, monkeypatch):
    """Run a JAX driver's ``main()`` on ``argv`` on one device; returns its
    stdout."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    with monkeypatch.context() as mp:
        _one_device(mp)
        mod.main()
    return capsys.readouterr().out


def _fp32_copy(tmp_path, rel, name, **over):
    cfg = json.load(open(os.path.join(EXAMPLES, rel)))
    for key in ("fp16", "bf16", "model_parallel_size", "graph_lint",
                "analysis", "observability", "compile_cache"):
        cfg.pop(key, None)
    if "inference" in cfg:
        cfg["inference"]["dtype"] = "float32"
    cfg.update(over)
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return str(path)


def _printed(out, pattern):
    return [(int(m.group(1)), float(m.group(2)))
            for m in re.finditer(pattern, out)]


def _final(out, label):
    return float(re.search(rf"^{label}: (\S+)$", out, re.M).group(1))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


@pytest.mark.parametrize("config", ["loop", "train_many"])
def test_train_simple_matches_the_jax_driver(tmp_path, capsys, monkeypatch,
                                             config):
    jmod = _load("simple/train_simple.py", "jax_train_simple")
    if config == "loop":
        cfg = _fp32_copy(tmp_path, "simple/ds_config.json", "simple.json")
    else:
        # K = 2 a dispatch; gas 1 and no LR schedule, the multistep
        # config's shape that both engines' train_many take
        cfg = _fp32_copy(tmp_path, "simple/ds_config_multistep.json",
                         "multistep.json", gradient_accumulation_steps=1,
                         train_batch_size=32)
        json_cfg = json.load(open(cfg))
        json_cfg.pop("scheduler")
        open(cfg, "w").write(json.dumps(json_cfg))
    # the K = 2 branch prints at the blocks that cross a multiple of 20
    steps = 4 if config == "loop" else 20
    out = _jax_main(jmod, ["--deepspeed_config", cfg, "--steps",
                           str(steps), "--ckpt_dir", str(tmp_path / "j")],
                    capsys, monkeypatch)
    want = _printed(out, r"step +(\d+)  loss ([\d.]+)")
    params = _np_tree(jmod.MLP().init_params(jax.random.PRNGKey(0)))
    got, final = train_simple.main(
        ["--deepspeed_config", cfg, "--steps", str(steps), "--ckpt_dir",
         str(tmp_path / "t"), "--device", "cpu"], model_parameters=params)
    assert [s for s, _ in got] == [s for s, _ in want] and want
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=1e-4, atol=6e-6)
    np.testing.assert_allclose(final, _final(out, "final loss"), rtol=1e-4)
    # the saved checkpoint resumes: a second run starts at --steps
    capsys.readouterr()
    train_simple.main(["--deepspeed_config", cfg, "--steps", str(steps),
                       "--ckpt_dir", str(tmp_path / "t"), "--device", "cpu"])
    assert f"at step {steps}" in capsys.readouterr().out


def test_train_gpt2_matches_the_jax_driver(tmp_path, capsys, monkeypatch):
    """The dense GPT-2 on the shipped config's recipe, 8 rows a step (its
    32, cut for the suite's time)."""
    jmod = _load("gpt2/train_gpt2.py", "jax_train_gpt2")
    cfg = _fp32_copy(tmp_path, "gpt2/ds_config.json", "gpt2.json",
                     zero_optimization={"stage": 0}, train_batch_size=8)
    argv = ["--deepspeed_config", cfg, "--steps", "3"]
    out = _jax_main(jmod, argv, capsys, monkeypatch)
    want = _printed(out, r"step +(\d+)  lm loss ([\d.]+)")
    jmodel = jmod.GPT2.from_size("tiny", vocab_size=jmod.VOCAB,
                                 max_seq_len=jmod.SEQ)
    params = _np_tree(jmodel.init_params(jax.random.PRNGKey(0)))
    got, final = train_gpt2.main(argv + ["--device", "cpu"],
                                 model_parameters=params)
    assert [s for s, _ in got] == [s for s, _ in want] and want
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=1e-4, atol=6e-5)
    np.testing.assert_allclose(final, _final(out, "final lm loss"),
                               rtol=1e-4)


@pytest.mark.parametrize("moe,micro,cls", [
    (4, 0, "GPT2MoE"), (0, 2, "GPT2Pipelined"), (4, 2, "GPT2MoEPipelined")])
def test_train_gpt2_model_families(tmp_path, monkeypatch, moe, micro, cls):
    """``--moe-experts`` / ``--micro-batches`` pick the model family (at pp
    1 and ep 1 here; their meshes over several ranks are held by
    tests/test_torch_moe.py and test_torch_pipeline.py) and train."""
    cfg = _fp32_copy(tmp_path, "gpt2/ds_config.json", "gpt2.json",
                     zero_optimization={"stage": 0}, train_batch_size=8)
    built = []
    real = train_gpt2.build_model
    monkeypatch.setattr(train_gpt2, "build_model",
                        lambda *a, **k: built.append(real(*a, **k))
                        or built[-1])
    printed, final = train_gpt2.main(
        ["--deepspeed_config", cfg, "--steps", "2", "--moe-experts",
         str(moe), "--micro-batches", str(micro), "--device", "cpu"])
    assert type(built[0]).__name__ == cls
    assert printed and np.isfinite(final) and final < printed[0][1]


def _served(out):
    return {int(m.group(1)): json.loads(m.group(2)) for m in re.finditer(
        r"^  req (\d+): prompt\[\d+\] -> (\[[^\]]*\])", out, re.M)}


@pytest.fixture(scope="module")
def jax_served(tmp_path_factory):
    """The JAX driver's checkpoint (``--prepare``, 3 steps) and its tokens
    served from it, one replica and a disaggregated fleet of 2."""
    tmp = tmp_path_factory.mktemp("jserve")
    mp = pytest.MonkeyPatch()
    try:
        mp.syspath_prepend(os.path.join(EXAMPLES, "gpt2"))
        _one_device(mp)
        jmod = _load("gpt2/serve_gpt2.py", "jax_serve_gpt2")
        ck = str(tmp / "ck")
        single = _fp32_copy(tmp, "gpt2/ds_config_serve.json", "serve.json")
        fleet = _fp32_copy(tmp, "gpt2/ds_config_fleet_serve.json",
                           "fleet.json")
        runs = {}
        for name, argv in (
                ("prepare", ["--prepare", "--ckpt", ck, "--steps", "3"]),
                ("single", ["--ckpt", ck, "--deepspeed_config", single,
                            "--requests", "4"]),
                ("fleet", ["--ckpt", ck, "--deepspeed_config", fleet,
                           "--requests", "4", "--fleet", "2",
                           "--prefill-replicas", "1"])):
            mp.setattr(sys, "argv", [jmod.__file__, *argv])
            import contextlib
            import io
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert not jmod.main()
            runs[name] = buf.getvalue()
    finally:
        mp.undo()
    return ck, single, fleet, runs


@pytest.mark.parametrize("mode", ["single", "fleet"])
def test_serve_gpt2_matches_the_jax_driver(jax_served, capsys, mode):
    ck, single, fleet, runs = jax_served
    want = _served(runs[mode])
    argv = ["--ckpt", ck, "--requests", "4", "--device", "cpu"]
    if mode == "single":
        argv += ["--deepspeed_config", single]
    else:
        argv += ["--deepspeed_config", fleet, "--fleet", "2",
                 "--prefill-replicas", "1", "--verify-identity"]
    capsys.readouterr()
    assert serve_gpt2.main(argv) == 0
    out = capsys.readouterr().out
    assert len(want) == 4 and _served(out) == want
    assert _served(runs["single"]) == _served(runs["fleet"])
    if mode == "fleet":
        summary = json.loads([ln for ln in out.splitlines()
                              if ln.startswith("{")][-1])
        assert summary["handoffs"] == 4 and summary["prefill_replicas"] == 1
        assert "identity: 4 requests identical" in out


def test_serve_gpt2_prepares_a_checkpoint_the_jax_driver_serves(
        jax_served, tmp_path, capsys, monkeypatch):
    """The port driver's ``--prepare`` (bf16, ZeRO-1) writes a checkpoint
    that both drivers serve with the same tokens."""
    _, single, _, _ = jax_served
    ck = str(tmp_path / "ck")
    assert serve_gpt2.main(["--prepare", "--ckpt", ck, "--steps", "2",
                            "--device", "cpu"]) == 0
    capsys.readouterr()
    assert serve_gpt2.main(["--ckpt", ck, "--deepspeed_config", single,
                            "--requests", "4", "--device", "cpu"]) == 0
    mine = _served(capsys.readouterr().out)
    monkeypatch.syspath_prepend(os.path.join(EXAMPLES, "gpt2"))
    jmod = _load("gpt2/serve_gpt2.py", "jax_serve_gpt2")
    out = _jax_main(jmod, ["--ckpt", ck, "--deepspeed_config", single,
                           "--requests", "4"], capsys, monkeypatch)
    assert len(mine) == 4 and _served(out) == mine


@pytest.mark.parametrize("config,item", [
    ("ds_config_serve.json", "item 14"),
    ("ds_config_serve_spec.json", "item 14"),
    ("ds_config_fleet_serve.json", "item 14"),
])
def test_shipped_serving_configs_are_refused_by_name(jax_served, config,
                                                     item, tmp_path,
                                                     monkeypatch, capsys):
    """The shipped serving configs, which item 14 (graph lint and the
    planners) used to refuse, now serve: on fp32 copies (exact tokens)
    that keep ``graph_lint`` and ``analysis`` at ``error`` with profile
    ``v4-8`` and the configs' ``model_parallel_size``; the mp 2 configs as
    two CPU ranks under the port's launcher.  The tokens equal the JAX
    driver's on the same copy (at mp 2 over two of the rig's devices)."""
    import socket
    import subprocess
    ck = jax_served[0]
    shipped = json.load(open(os.path.join(EXAMPLES, "gpt2", config)))
    mp_size = int(shipped.get("model_parallel_size", 1))
    over = {"graph_lint": shipped["graph_lint"],
            "analysis": shipped["analysis"]}
    if mp_size > 1:
        over["model_parallel_size"] = mp_size
    assert over["graph_lint"]["mode"] == over["analysis"]["mode"] == "error"
    cfg = _fp32_copy(tmp_path, f"gpt2/{config}", "copy.json", **over)
    argv = ["--ckpt", ck, "--deepspeed_config", cfg, "--requests", "4"]
    if "fleet" in config:
        argv += ["--fleet", "2", "--prefill-replicas", "1"]
    monkeypatch.syspath_prepend(os.path.join(EXAMPLES, "gpt2"))
    jmod = _load("gpt2/serve_gpt2.py", "jax_serve_gpt2")
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [jmod.__file__, *argv])
    with monkeypatch.context() as mp:
        devices = jax.devices
        mp.setattr(jax, "devices",
                   lambda *a, **k: devices(*a, **k)[:mp_size])
        assert not jmod.main()
    want = _served(capsys.readouterr().out)
    if mp_size == 1:
        assert serve_gpt2.main(argv + ["--device", "cpu"]) == 0
        got = _served(capsys.readouterr().out)
    else:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        proc = subprocess.run(
            [sys.executable, "-m", "deepspeed_tpu_torch.launcher.run",
             "--hostfile", str(tmp_path / "missing"), "--num_gpus",
             str(mp_size), "--master_port", str(port),
             os.path.join(ROOT, "deepspeed_tpu_torch", "examples",
                          "serve_gpt2.py"), *argv, "--device", "cpu"],
            capture_output=True, text=True, timeout=240, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
                     OMP_NUM_THREADS="1"))
        assert proc.returncode == 0, proc.stderr[-3000:]
        got = _served(proc.stdout)
    assert len(want) == 4 and got == want


def test_serve_gpt2_at_mp2_on_two_ranks(jax_served, tmp_path, monkeypatch,
                                        capsys):
    """``serve_gpt2`` at model_parallel_size 2: two CPU ranks under the
    port's launcher, on a lint-free fp32 copy of ``ds_config_serve.json``
    that keeps its ``model_parallel_size`` 2.  Model rank 0 alone prints,
    and its tokens are the JAX driver's on the same copy (at mp 2, over
    two of the rig's devices)."""
    import socket
    import subprocess
    ck = jax_served[0]
    cfg = _fp32_copy(tmp_path, "gpt2/ds_config_serve.json", "mp2.json",
                     model_parallel_size=2)
    monkeypatch.syspath_prepend(os.path.join(EXAMPLES, "gpt2"))
    jmod = _load("gpt2/serve_gpt2.py", "jax_serve_gpt2")
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [jmod.__file__, "--ckpt", ck,
                                      "--deepspeed_config", cfg,
                                      "--requests", "4"])
    with monkeypatch.context() as mp:
        devices = jax.devices
        mp.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:2])
        assert not jmod.main()
    want = _served(capsys.readouterr().out)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.run",
         "--hostfile", str(tmp_path / "missing"), "--num_gpus", "2",
         "--master_port", str(port),
         os.path.join(ROOT, "deepspeed_tpu_torch", "examples",
                      "serve_gpt2.py"),
         "--ckpt", ck, "--deepspeed_config", cfg, "--requests", "4",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("serving tag") == 1
    summary = json.loads([ln for ln in proc.stdout.splitlines()
                          if ln.startswith("{")][-1])
    assert summary["mp"] == 2
    assert len(want) == 4 and _served(proc.stdout) == want


@pytest.mark.parametrize("mode", ["fleet", "verify_identity"])
def test_serve_gpt2_fleet_and_identity_at_mp2(jax_served, tmp_path, capsys,
                                              mode):
    """``serve_gpt2 --fleet 2`` and ``--verify-identity`` at
    model_parallel_size 2: two CPU ranks under the port's launcher, every
    replica on both (rank 0 leads each, rank 1 follows each on a thread of
    its own).  Both exit 0, model rank 0 alone prints, and the tokens are
    the driver's at model_parallel_size 1 on the same checkpoint, with the
    same flag."""
    import socket
    import subprocess
    ck = jax_served[0]
    mp1 = _fp32_copy(tmp_path, "gpt2/ds_config_serve.json", "mp1.json")
    mp2 = _fp32_copy(tmp_path, "gpt2/ds_config_serve.json", "mp2.json",
                     model_parallel_size=2)
    flag = ["--fleet", "2"] if mode == "fleet" else ["--verify-identity"]
    argv = ["--ckpt", ck, "--requests", "4", *flag, "--device", "cpu"]
    capsys.readouterr()
    assert serve_gpt2.main(argv + ["--deepspeed_config", mp1]) == 0
    want = _served(capsys.readouterr().out)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.run",
         "--hostfile", str(tmp_path / "missing"), "--num_gpus", "2",
         "--master_port", str(port),
         os.path.join(ROOT, "deepspeed_tpu_torch", "examples",
                      "serve_gpt2.py"), *argv, "--deepspeed_config", mp2],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads([ln for ln in proc.stdout.splitlines()
                          if ln.startswith("{")][-1])
    if mode == "fleet":
        assert proc.stdout.count("fleet: 2 decode/mixed") == 1
        assert summary["n_replicas"] == 2
        assert summary["tokens_per_sec_per_chip"] == pytest.approx(
            summary["tokens_per_sec"] / 4, abs=0.01)
    else:
        assert proc.stdout.count("serving tag") == 1
        assert summary["mp"] == 2
        assert "identity: 4 requests bitwise-identical" in proc.stdout
    assert len(want) == 4 and _served(proc.stdout) == want
