"""The port's checkpoints: the ``DSTPUCK1`` container, tags, the one-card
engine save/load, and files crossing between the port and the JAX package.

Tolerances: a resume on the port is bit-exact (``torch.equal``); a JAX
checkpoint loaded by the port trains its next 3 steps within ``rtol 1e-5``
of the JAX engine's losses (fp32, the frameworks' float sums differ in
order); a port checkpoint loaded by the JAX engine gives every module leaf,
master and moment bytewise equal to what the port held.
"""

import collections
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import BertForPreTraining as JBert
from deepspeed_tpu.parallel.topology import make_mesh
from deepspeed_tpu_torch import checkpoint as ck
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.data import ArrayDataset
from deepspeed_tpu_torch.models import BertForPreTraining as TBert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ, MICRO, GAS, NPRED = 512, 64, 2, 2, 8
TINY = dict(max_seq_len=SEQ, vocab_size=VOCAB, num_layers=2, hidden_size=64,
            num_heads=4)


def config(dtype="fp32", opt="Lamb", **extra):
    params = {"lr": 1e-3, "weight_decay": 0.01, "eps": 1e-6}
    if opt == "Lamb":
        params.update(max_coeff=0.5, min_coeff=0.08)
    cfg = {"train_batch_size": MICRO * GAS,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": opt, "params": params},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_min_lr": 0.0,
                                    "warmup_max_lr": 1e-3,
                                    "warmup_num_steps": 4}},
           "steps_per_print": 10 ** 9}
    if dtype == "bf16":
        cfg["bf16"] = {"enabled": True}
    cfg.update(extra)
    return cfg


def jax_params(seed=0):
    jm = JBert.from_size("tiny", **TINY)
    return jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(seed)))


def batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = MICRO * GAS
        ids = rng.integers(0, VOCAB, size=(rows, SEQ)).astype(np.int32)
        mask = np.ones((rows, SEQ), np.int32)
        tt = np.zeros((rows, SEQ), np.int32)
        pos = np.stack([rng.choice(SEQ, size=NPRED, replace=False)
                        for _ in range(rows)]).astype(np.int32)
        out.append((ids, mask, tt, pos, np.take_along_axis(ids, pos, 1),
                    np.ones((rows, NPRED), np.float32)))
    return out


def torch_engine(cfg, params=None, seed=0, training_data=None):
    gen = torch.Generator().manual_seed(seed)
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        config=cfg, model=TBert.from_size("tiny", generator=gen, **TINY),
        model_parameters=params, training_data=training_data, device="cpu")
    return engine, loader


def jax_engine(cfg, params):
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg, model=JBert.from_size("tiny", **TINY),
        model_parameters=params, mesh=make_mesh(devices=jax.devices()[:1]))
    return engine


def flat_np(tree):
    return weights.flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


# ------------------------------------------------------------ container

def test_container_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    state = {
        "f32": torch.tensor(rng.normal(size=(40, 7)).astype(np.float32)),
        "bf16": torch.tensor(rng.normal(size=(3,))).bfloat16(),
        "bf16_big": torch.tensor(rng.normal(size=(300,))).bfloat16(),
        "i32": torch.arange(5, dtype=torch.int32),
        "np_big": rng.normal(size=(200,)),
        "np_small": np.arange(3, dtype=np.int64),
        "nested": [1, (2.5, "x"), {"k": None}],
        # a user tuple that looks like a chunk reference stays user data
        "fake_ref": ("__dstpu_chunk__", 16, "float32", (1,)),
    }
    path = str(tmp_path / "c.pt")
    ck._write_file(path, state)
    got = ck._load_obj(path)
    assert isinstance(got["bf16"], ck.Bf16Chunk)     # chunked though small
    assert isinstance(got["f32"], np.memmap)
    for k in ("f32", "bf16", "bf16_big", "i32"):
        t = ck.to_tensor(got[k])
        assert t.dtype == state[k].dtype and torch.equal(t, state[k]), k
    np.testing.assert_array_equal(got["np_big"], state["np_big"])
    np.testing.assert_array_equal(got["np_small"], state["np_small"])
    assert got["nested"] == state["nested"]
    assert got["fake_ref"] == state["fake_ref"]


def _run(code):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)


def test_bf16_round_trips_without_ml_dtypes(tmp_path):
    """The port writes and reads bf16 with ml_dtypes unimportable."""
    path = tmp_path / "b.pt"
    res = _run(f"""
        import sys
        sys.modules["ml_dtypes"] = None          # import raises
        import torch
        from deepspeed_tpu_torch import checkpoint as ck
        t = torch.linspace(-3, 3, 1000).bfloat16()
        ck._write_file({str(path)!r}, {{"w": t, "s": t[:4]}})
        got = ck._load_obj({str(path)!r})
        assert torch.equal(ck.to_tensor(got["w"]), t)
        assert torch.equal(ck.to_tensor(got["s"]), t[:4])
        print("ok")
    """)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def test_inline_bf16_of_the_jax_writer_needs_ml_dtypes(tmp_path):
    import ml_dtypes
    from deepspeed_tpu import checkpoint as jck
    small = np.linspace(-1, 1, 8).astype(ml_dtypes.bfloat16)
    path = str(tmp_path / "j.pt")
    jck._save_obj(path, {"s": small})          # 16 bytes: inlined
    got = ck.to_tensor(ck._load_obj(path)["s"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  small.astype(np.float32))
    res = _run(f"""
        import sys
        sys.modules["ml_dtypes"] = None
        from deepspeed_tpu_torch import checkpoint as ck
        ck._load_obj({path!r})
    """)
    assert res.returncode != 0
    assert "needs the ml_dtypes package" in res.stderr


def _tamper_header(path, fn):
    """Rewrite the pickled header of a container file through ``fn``."""
    with open(path, "rb") as f:
        raw = f.read()
    off = int.from_bytes(raw[8:16], "little")
    header = fn(pickle.loads(raw[off:]))
    with open(path, "wb") as f:
        f.write(raw[:off])
        pickle.dump(header, f)


@pytest.mark.parametrize("bad,match", [
    (("__dstpu_chunk__", 10 ** 9, "float32", (100,)), "outside the payload"),
    (("__dstpu_chunk__", 2, "float32", (100,)), "outside the payload"),
    (("__dstpu_chunk__", 16, "float32", (-1,)), "malformed chunk ref"),
    (("__dstpu_chunk__", 16, "notadtype", (4,)), "unknown dtype"),
])
def test_malformed_chunk_refs_raise(tmp_path, bad, match):
    path = str(tmp_path / "c.pt")
    ck._write_file(path, {"w": torch.ones(100)})
    _tamper_header(path, lambda h: dict(h, w=bad))
    with pytest.raises(ValueError, match=match):
        ck._load_obj(path)


def test_truncated_chunk_raises_a_read_error(tmp_path):
    path = str(tmp_path / "c.pt")
    ck._write_file(path, {"w": torch.ones(1000)})
    ref = ck._load_obj(path)["w"]
    with open(path, "r+b") as f:       # cut the payload under the view
        f.truncate(int(ref.offset) + 100)
    with pytest.raises(ck.CheckpointReadError, match="truncated"):
        ck._readinto(ref, np.empty(1000, np.float32))


def test_forbidden_globals_and_namedtuples_are_refused(tmp_path):
    path = str(tmp_path / "evil.pt")
    with open(path, "wb") as f:
        f.write(b"DSTPUCK1" + (16).to_bytes(8, "little"))
        pickle.dump({"x": os.system}, f)
    with pytest.raises(pickle.UnpicklingError, match="forbidden global"):
        ck._load_obj(path)
    Pair = collections.namedtuple("Pair", "a b")
    with pytest.raises(TypeError, match="namedtuple"):
        ck._write_file(str(tmp_path / "n.pt"), {"p": Pair(1, 2)})
    engine, _ = torch_engine(config())
    with pytest.raises(TypeError, match="namedtuple"):
        engine.save_checkpoint(str(tmp_path / "ck"),
                               client_state={"p": [Pair(1, 2)]})


# ------------------------------------------------------------ engine

def test_tags_latest_and_missing(tmp_path):
    d = str(tmp_path / "ck")
    assert torch_engine(config())[0].load_checkpoint(d) == (None, None)
    engine, _ = torch_engine(config())
    data = batches(2)
    engine.train_batch(data[0])
    engine.save_checkpoint(d, tag="one", client_state={"n": 1})
    engine.train_batch(data[1])
    engine.save_checkpoint(d, client_state={"n": 2})
    assert open(os.path.join(d, "latest")).read() == "global_step2"
    assert ck.list_tags(d) == ["global_step2", "one"]
    assert ck.validate_tag(d, "one") and not ck.validate_tag(d, "nope")
    fresh, _ = torch_engine(config(), seed=3)
    path, cs = fresh.load_checkpoint(d)
    assert path.endswith("global_step2") and cs == {"n": 2}
    assert fresh.global_steps == 2
    path, cs = fresh.load_checkpoint(d, tag="one")
    assert cs == {"n": 1} and fresh.global_steps == 1
    assert fresh.load_checkpoint(d, tag="nope") == (None, None)
    # a pointer at a vanished tag falls back to the newest valid one
    with open(os.path.join(d, "latest"), "w") as f:
        f.write("gone")
    assert ck.find_latest_valid_tag(d) in ("one", "global_step2")
    assert fresh.load_checkpoint(d)[0] is not None


def test_load_without_optimizer_states_rederives_masters(tmp_path):
    d = str(tmp_path / "ck")
    src, _ = torch_engine(config("bf16"))
    src.train_batch(batches(1)[0])
    src.save_checkpoint(d)
    dst, _ = torch_engine(config("bf16"), seed=5)
    dst.load_checkpoint(d, load_optimizer_states=False)
    for name, p in dst.module.named_parameters():
        assert torch.equal(p, dict(src.module.named_parameters())[name])
        assert torch.equal(dst.master[name], p.float())
        assert not dst.opt_state.m[name].any()
    assert dst.opt_state.step == 0


@pytest.mark.parametrize("fields,error,match", [
    # a ZeRO-1/2 save's optimizer state lives in its partition files,
    # which an engine without ZeRO cannot take (the JAX package's error)
    pytest.param({"zero_enabled": True, "zero_stage": 1, "optimizer": None},
                 ValueError, "stage 1/2", id="fields0-Queue 1 item 6"),
    # tensor parallelism is ported (Queue 1 item 10): a header that claims
    # mp 2 needs model rank 1's file, which this save does not have
    pytest.param({"mp_world_size": 2}, FileNotFoundError,
                 "mp_rank_01_model_states", id="fields1-Queue 1 item 10"),
    # pipeline parallelism is ported (Queue 1 item 11,
    # tests/test_torch_pipeline_ckpt.py): a header that claims pp 2 needs
    # stage 1's file, which this save does not have
    pytest.param({"pp_world_size": 2}, FileNotFoundError,
                 "pp_stage_01_mp_rank_00_model_states",
                 id="fields2-Queue 1 item 11"),
    # ZeRO-3 is ported (Queue 1 item 11, tests/test_torch_zero3_*.py): a
    # header whose module is a partition marker needs the shard files,
    # which this save does not have
    pytest.param({"zero3_native": True,
                  "module": ("__dstpu_zero3_part__", 0, 2)},
                 FileNotFoundError, "zero3_dp_rank_0_row_00_states",
                 id="fields3-Queue 1 item 11"),
])
def test_zero_mp_and_pp_checkpoints_raise(tmp_path, fields, error, match):
    d = str(tmp_path / "ck")
    engine, _ = torch_engine(config())
    engine.save_checkpoint(d, tag="t")
    _tamper_header(ck.model_file(d, "t"), lambda h: dict(h, **fields))
    with pytest.raises(error, match=match):
        engine.load_checkpoint(d)


def test_zero_checkpoint_weights_only_loads(tmp_path):
    d = str(tmp_path / "ck")
    src, _ = torch_engine(config())
    src.save_checkpoint(d, tag="t")
    _tamper_header(ck.model_file(d, "t"), lambda h: dict(
        h, zero_enabled=True, zero_stage=2, optimizer=None))
    dst, _ = torch_engine(config(), seed=2)
    assert dst.load_checkpoint(d, load_optimizer_states=False)[0]
    for k in src.master:
        assert torch.equal(dst.master[k], src.master[k])


@pytest.mark.parametrize("async_save", [False, True])
def test_cpu_resume_is_bit_exact(tmp_path, async_save):
    """Run A: 6 steps through the loader, a save after step 3.  Run B: a
    fresh engine from another seed loads it, restores the loader, takes
    steps 4-6.  Losses and every optimizer state equal bitwise."""
    rng = np.random.default_rng(0)
    rows = 64
    ids = rng.integers(0, VOCAB, (rows, SEQ)).astype(np.int32)
    pos = np.stack([rng.choice(SEQ, NPRED, replace=False)
                    for _ in range(rows)]).astype(np.int32)
    ds = ArrayDataset(ids, np.ones_like(ids), np.zeros_like(ids), pos,
                      np.take_along_axis(ids, pos, 1),
                      np.ones((rows, NPRED), np.float32))
    cfg = config("bf16", activation_checkpointing={"enabled": True,
                                                   "policy": "selective"})
    d = str(tmp_path / "ck")

    def steps(engine, it, n):
        out = []
        for _ in range(n):
            for _ in range(GAS):
                loss = engine(*next(it))
                engine.backward(loss)
                engine.step()
            out.append(loss.detach())
        return out

    a, la = torch_engine(cfg, training_data=ds)
    it = iter(la)
    steps(a, it, 3)
    a.save_checkpoint(d, client_state={"data": la.state_dict()},
                      async_save=async_save)
    a.checkpoint_wait()
    assert a.last_save_bytes > 0
    want = steps(a, it, 3)
    b, lb = torch_engine(cfg, seed=1, training_data=ds)
    _, cs = b.load_checkpoint(d)
    lb.load_state_dict(cs["data"])
    got = steps(b, iter(lb), 3)
    assert all(torch.equal(x, y) for x, y in zip(want, got))
    for k in a.master:
        for x, y in ((a.master, b.master), (a.opt_state.m, b.opt_state.m),
                     (a.opt_state.v, b.opt_state.v),
                     (dict(a.module.named_parameters()),
                      dict(b.module.named_parameters()))):
            assert torch.equal(x[k], y[k]), k
    assert a.opt_state.step == b.opt_state.step == 6
    for x, y in zip(a.loss_scale_state, b.loss_scale_state):
        assert torch.equal(x, y)
    assert a.optimizer.param_groups == b.optimizer.param_groups
    assert a.lr_scheduler.state_dict() == b.lr_scheduler.state_dict()


def test_optimizer_state_dict_round_trips():
    a, _ = torch_engine(config("bf16"))
    a.train_batch(batches(1)[0])
    sd = {k: v for k, v in a.optimizer.state_dict().items()}
    snap = {"opt_state": {"step": sd["opt_state"]["step"],
                          "m": {k: t.clone() for k, t in
                                sd["opt_state"]["m"].items()},
                          "v": {k: t.clone() for k, t in
                                sd["opt_state"]["v"].items()}},
            "loss_scale_state": sd["loss_scale_state"],
            "master": {k: t.clone() for k, t in sd["master"].items()}}
    b, _ = torch_engine(config("bf16"), seed=4)
    b.optimizer.load_state_dict(snap)
    assert b.opt_state.step == 1
    for k in a.master:
        assert torch.equal(a.master[k], b.master[k])
        assert torch.equal(a.opt_state.v[k], b.opt_state.v[k])
        assert torch.equal(dict(b.module.named_parameters())[k],
                           a.master[k].bfloat16())


def test_module_tree_transfer(tmp_path):
    d = str(tmp_path / "ck")
    src, _ = torch_engine(config("bf16"))
    src.save_checkpoint(d, tag="pre")
    tag, tree = ck.load_params_only(d, dtype=torch.float32)
    assert tag == "pre" and tree["blocks"]["qkv_w"].dtype == torch.float32
    module = ck.load_module_tree(d)
    assert module["wte"].dtype == torch.bfloat16
    module["wte"] = module["wte"][:8]           # a shape that cannot transfer
    dst, _ = torch_engine(config("bf16"), seed=7)
    loaded, skipped = ck.init_from_module_tree(dst, module)
    assert skipped == ["['wte']"] and len(loaded) == 21
    p = dict(dst.module.named_parameters())
    assert torch.equal(p["blocks.fc_w"],
                       dict(src.module.named_parameters())["blocks.fc_w"])
    assert torch.equal(dst.master["blocks.fc_w"], p["blocks.fc_w"].float())


# ------------------------------------------------------ across packages

def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """The JAX engine (ZeRO off, LAMB, fp32) trains 2 steps and saves; the
    port loads it into an engine from other weights; the next 3 steps'
    losses agree within rtol 1e-5."""
    d = str(tmp_path / "ck")
    data = batches(5)
    cfg = config()
    je = jax_engine(cfg, jax_params())
    for b in data[:2]:
        je.train_batch(b)
    je.save_checkpoint(d, client_state={"k": [1, 2]})
    te, _ = torch_engine(cfg, seed=9)
    _, cs = te.load_checkpoint(d)
    assert cs == {"k": [1, 2]} and te.global_steps == 2
    assert te.opt_state.step == 2
    for k, v in flat_np(je.master).items():
        np.testing.assert_array_equal(te.master[k].numpy(), v)
    want = [float(je.train_batch(b)) for b in data[2:]]
    got = [float(te.train_batch(b)) for b in data[2:]]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_jax_bf16_checkpoint_loads_in_the_port(tmp_path):
    """bf16: the JAX writer chunks the large leaves and inlines the small
    ones (as ml_dtypes arrays); the port reads both bytewise."""
    d = str(tmp_path / "ck")
    cfg = config("bf16")
    je = jax_engine(cfg, jax_params())
    je.train_batch(batches(1)[0])
    je.save_checkpoint(d)
    te, _ = torch_engine(cfg, seed=9)
    te.load_checkpoint(d)
    params = dict(te.module.named_parameters())
    for k, v in flat_np(je.params).items():
        np.testing.assert_array_equal(
            params[k].view(torch.int16).numpy(),
            v.view(np.int16), err_msg=k)
    for tree, live in ((je.master, te.master), (je.opt_state.m,
                                                te.opt_state.m)):
        for k, v in flat_np(tree).items():
            np.testing.assert_array_equal(live[k].numpy(), v)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_port_checkpoint_loads_in_jax_bytewise(tmp_path, dtype):
    d = str(tmp_path / "ck")
    cfg = config(dtype)
    te, _ = torch_engine(cfg)
    for b in batches(2):
        te.train_batch(b)
    te.save_checkpoint(d, client_state={"note": "port"})
    je = jax_engine(cfg, jax_params(seed=3))
    path, cs = je.load_checkpoint(d)
    assert cs == {"note": "port"} and je.global_steps == 2
    assert int(je.opt_state.step) == 2
    params = {k: p.detach() for k, p in te.module.named_parameters()}
    for k, v in flat_np(je.params).items():
        want = params[k]
        if dtype == "bf16":
            assert v.dtype.name == "bfloat16"
            np.testing.assert_array_equal(
                v.view(np.int16), want.view(torch.int16).numpy(), err_msg=k)
        else:
            np.testing.assert_array_equal(v, want.numpy(), err_msg=k)
    for tree, live in ((je.master, te.master), (je.opt_state.m,
                                                te.opt_state.m),
                       (je.opt_state.v, te.opt_state.v)):
        for k, v in flat_np(tree).items():
            np.testing.assert_array_equal(v, live[k].numpy(), err_msg=k)
    assert (je.lr_scheduler.state_dict()
            == te.lr_scheduler.state_dict())
    assert float(je.loss_scale_state.cur_scale) == float(
        te.loss_scale_state.cur_scale)
