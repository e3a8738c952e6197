"""ZeRO-3 checkpoint files of the port against the JAX package's.

The tiny fp32-computing GPT-2 of ``tests/test_torch_zero.py`` trains at
stage 3 on gloo CPU ranks, each global batch 16 rows (dp 2: gas 2; dp 4:
gas 1; micro-batch 4).  Each rank writes only its shards
(``zero3_dp_rank_{dp}_row_00_states.pt``); the model-state file carries
the replicated leaves and the partition markers.  Held here:

* a bitwise resume: fresh engines that load the step-2 save take step 3
  with the losses and shards of the run that saved;
* port -> JAX and JAX -> port at dp 2: the JAX engine's load of the
  port's save equals the port's rehydrated leaves bitwise, and each side's
  step 3 from the other's save agrees with the other's step 3 within
  ``rtol=1e-5`` (losses) and ``LOW_PRECISION`` (masters and moments);
* cross-dp: a dp 4 save loads at dp 2 and a dp 2 save at dp 4, and step 3
  agrees with the saving run's within ``CROSS_DP``: dp 2 at gas 2 rounds
  each micro-step's two-rank sum to bf16 where dp 4 at gas 1 rounds the
  four-rank sum once, so a gradient whose partial sums cancel can differ
  by an ulp of the partials, far more than of itself.  Its first moment
  then differs by ``(1 - beta1)`` times that (measured 1.14e-5 on one of
  2,048 elements of ``wte``; allowed 5e-5, an ulp of a 0.1 partial), and
  through Adam one step moves a master by up to ~lr * (1 - beta1) * that
  / sqrt(v) (measured 1.75e-5 on one of 8,192; allowed lr / 10, where a
  dropped or misplaced update moves elements by lr).  Cross-stage: a stage-3 save loads at stage 0 in one
  process (its step-3 loss on rank 1's rows equals rank 1's within
  ``rtol=1e-6``), a stage-1 engine refuses the save's optimizer state
  with the JAX engine's message and takes its weights, and a stage-1 save
  into a stage-3 engine behaves as the JAX package's
  ``test_zero3_stage12_checkpoint_rejected`` says;
* a save of the same tag at dp 2 after one at dp 4 leaves no stale shard
  file;
* ZeRO-3 x MP: a dp 2 x mp 2 save (a shard file per (dp rank, row) and a
  model-state file per model rank) loads in the JAX engine at dp 2, mp 1
  as the global leaves the four ranks held, bitwise.
"""

import jax
import numpy as np
import pytest

import deepspeed_tpu_torch
from deepspeed_tpu_torch import checkpoint as ck
from deepspeed_tpu_torch import weights
from deepspeed_tpu_torch.models import GPT2
from test_torch_zero import (LOW_PRECISION, MICRO, RTOL, TINY, config,
                             init_params, jax_engine, lm_data, rank_inputs)
from test_torch_zero3_train import jax_leaves
from torch_ranks import run_ranks

STEPS, ROWS = 3, 16
#: (rtol, atol) of the cross-dp comparisons (see the module docstring)
CROSS_DP = dict(LOW_PRECISION, master=(RTOL, 1e-4), m=(4e-3, 5e-5))


def z3config(dp, stage=3):
    return config(dp, ROWS // (dp * MICRO), "bf16",
                  {"stage": stage, "overlap_comm": False})


def joined(outs, key, dims):
    """The global leaves of the ranks' shards ``<key>/<name>``."""
    names = [k[len(key) + 1:] for k in outs[0] if k.startswith(key + "/")]
    return {n: np.concatenate([o[f"{key}/{n}"] for o in outs],
                              axis=dims[n]) if dims[n] >= 0
            else outs[0][f"{key}/{n}"] for n in names}


def assert_close(got, want, what, tols=LOW_PRECISION):
    for key, leaves in want.items():
        rtol, atol = tols[key]
        for name, x in leaves.items():
            np.testing.assert_allclose(got[key][name], x, rtol=rtol,
                                       atol=atol,
                                       err_msg=f"{what} {key} {name}")


def state_of(outs, prefix=""):
    dims = {k[len(prefix) + 6:]: int(v) for k, v in outs[0].items()
            if k.startswith(prefix + "z3dim/")}
    sub = [{k[len(prefix):]: v for k, v in o.items() if k.startswith(prefix)}
           for o in outs]
    return {key: joined(sub, key, dims) for key in ("master", "m", "v")}


def rehydrated(path, tag):
    """The port's reader on a save: the global fp32 master/m/v trees."""
    st = ck._read_state(path, tag)["optimizer"]
    out = {"master": st["master"], "m": st["opt_state"]["m"],
           "v": st["opt_state"]["v"]}
    return {k: {n: ck.to_tensor(x).numpy()
                for n, x in weights.flatten_tree(t).items()}
            for k, t in out.items()}


def _runs(o, n):
    return [{k.split("/", 1)[1]: v for k, v in o.items()
             if k.startswith(f"{i}/")} for i in range(n)]


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    """The JAX save and the port's launches (see the module docstring)."""
    root = tmp_path_factory.mktemp("z3ck")
    params = init_params()
    toks, labels = lm_data(STEPS, ROWS)
    inputs = rank_inputs(params, toks, labels)
    jdir, p2, p4 = (str(root / n) for n in ("jax", "port2", "port4"))

    jeng = jax_engine(z3config(2), 2, params)
    jl = [float(jeng.train_batch((toks[i], labels[i]))) for i in range(2)]
    jeng.save_checkpoint(jdir, tag="j")
    jl.append(float(jeng.train_batch((toks[2], labels[2]))))
    res = {"jax_losses": jl, "jax": jax_leaves(jeng), "dirs": (jdir, p2, p4),
           "data": (toks, labels)}

    def step3(cfg, load):
        return {"config": cfg, "steps": 1, "first_batch": 2,
                "fp32_compute": True, "load": load}

    res["dp2"] = [_runs(o, 3) for o in run_ranks(root / "l1", 2, {
        "scenario": "train", "runs": [
            {"config": z3config(2), "steps": STEPS, "fp32_compute": True,
             "save_after": 2, "save_dir": p2, "save_tag": "t2"},
            step3(z3config(2), p2), step3(z3config(2), jdir)]}, inputs)]
    res["dp4"] = [_runs(o, 2) for o in run_ranks(root / "l2", 4, {
        "scenario": "train", "runs": [
            {"config": z3config(4), "steps": STEPS, "fp32_compute": True,
             "save_after": 2, "save_dir": p4, "save_tag": "t4"},
            step3(z3config(4), p2)]}, inputs)]
    # dp 2 from the dp 4 save, then a save of the same tag at dp 2
    res["dp2_from4"] = [_runs(o, 1) for o in run_ranks(root / "l3", 2, {
        "scenario": "train", "runs": [
            dict(step3(z3config(2), p4), save_after=1, save_dir=p4,
                 save_tag="t4")]}, inputs)]
    return res


def test_files_and_bitwise_resume(saves):
    dp2 = saves["dp2"]
    files = str(dp2[0][0]["files"]).split("\n")
    assert files == ["mp_rank_00_model_states.pt",
                     "zero3_dp_rank_0_row_00_states.pt",
                     "zero3_dp_rank_1_row_00_states.pt"]
    for rank in dp2:
        run, resumed = rank[0], rank[1]
        assert np.array_equal(resumed["losses"], run["losses"][2:])
        for k in run:
            if k.split("/")[0] in ("master", "m", "v"):
                assert np.array_equal(resumed[k], run[k]), k
        assert int(resumed["step"]) == int(run["step"]) == STEPS


def test_port_save_loads_in_jax(saves):
    jdir, p2, _ = saves["dirs"]
    toks, labels = saves["data"]
    jeng = jax_engine(z3config(2), 2, init_params(1))
    jeng.load_checkpoint(p2, tag="t2")
    port = rehydrated(p2, "t2")
    loaded = jax_leaves(jeng)
    for key in ("master", "m", "v"):
        for name, x in loaded[key].items():
            assert np.array_equal(x, port[key][name]), (key, name)
    # the module's bf16 weights: the port's rehydrated param leaves
    module = weights.flatten_tree(ck.load_module_tree(p2, "t2"))
    for name, x in weights.flatten_tree(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), jeng.params)).items():
        assert np.array_equal(x, module[name].float().numpy()), name
    jl = float(jeng.train_batch((toks[2], labels[2])))
    dp2 = saves["dp2"]
    np.testing.assert_allclose(
        jl, np.mean([r[0]["losses"][2] for r in dp2]), rtol=RTOL)
    assert_close(jax_leaves(jeng), state_of([r[0] for r in dp2]),
                 "JAX from the port's save vs the port")


def test_jax_save_loads_in_the_port(saves):
    dp2 = saves["dp2"]
    np.testing.assert_allclose(np.mean([r[2]["losses"][0] for r in dp2]),
                               saves["jax_losses"][2], rtol=RTOL)
    assert_close(state_of([r[2] for r in dp2]), saves["jax"],
                 "the port from JAX's save vs JAX")


def test_cross_dp(saves):
    dp2, dp4 = saves["dp2"], saves["dp4"]
    # dp 2 -> dp 4: the dp 4 step 3 from the dp 2 save against dp 2's
    assert_close(state_of([r[1] for r in dp4]), state_of([r[0] for r in dp2]),
                 "dp 4 from the dp 2 save", CROSS_DP)
    # dp 4 -> dp 2
    back = saves["dp2_from4"]
    assert_close(state_of([r[0] for r in back]),
                 state_of([r[0] for r in dp4]), "dp 2 from the dp 4 save",
                 CROSS_DP)
    # the dp 2 save of the same tag removed dp 4's rank 2 and 3 files
    files = str(back[0][0]["files"]).split("\n")
    assert files == ["mp_rank_00_model_states.pt",
                     "zero3_dp_rank_0_row_00_states.pt",
                     "zero3_dp_rank_1_row_00_states.pt"]


def _fp32_gpt2():
    from torch_rank_worker import Fp32GPT2
    return Fp32GPT2.from_size("tiny", **TINY)


def test_cross_stage(saves):
    _, p2, _ = saves["dirs"]
    toks, labels = saves["data"]
    want = rehydrated(p2, "t2")
    # 3 -> 0 at dp 1: the whole leaves, and rank 1's rows give rank 1's
    # step-3 loss (its last micro-step is rows 12-16)
    e0 = deepspeed_tpu_torch.initialize(
        config=config(1, 4, "bf16"), model=_fp32_gpt2(), device="cpu")[0]
    e0.load_checkpoint(p2, tag="t2")
    for key, tree in (("master", e0.master), ("m", e0.opt_state.m),
                      ("v", e0.opt_state.v)):
        for name, t in tree.items():
            assert np.array_equal(t.numpy(), want[key][name]), (key, name)
    loss = float(e0.train_batch((toks[2], labels[2])))
    np.testing.assert_allclose(loss, saves["dp2"][1][0]["losses"][2],
                               rtol=1e-6)
    # 3 -> 1: the optimizer state is refused with the JAX message, the
    # weights load
    e1 = deepspeed_tpu_torch.initialize(
        config=config(1, 4, "bf16", {"stage": 1}), model=_fp32_gpt2(),
        device="cpu")[0]
    with pytest.raises(ValueError, match="saved at ZeRO stage 3"):
        e1.load_checkpoint(p2, tag="t2")
    e1.load_checkpoint(p2, tag="t2", load_optimizer_states=False)
    module = weights.flatten_tree(ck.load_module_tree(p2, "t2"))
    flat = np.concatenate([module[n].float().numpy().reshape(-1)
                           for n in e1.flat_meta.names])
    assert np.array_equal(e1.master_flat.numpy()[:flat.size], flat)


def test_stage12_save_into_stage3_behaves_as_jax(tmp_path):
    """The JAX package's ``test_zero3_stage12_checkpoint_rejected``."""
    toks, labels = lm_data(1, ROWS)
    cfg1 = config(1, 4, "fp16", {"stage": 1})
    e1 = deepspeed_tpu_torch.initialize(
        config=cfg1, model=GPT2.from_size("tiny", **TINY),
        model_parameters=init_params(), device="cpu")[0]
    e1.train_batch((toks[0], labels[0]))
    e1.save_checkpoint(str(tmp_path), tag="t")
    e3 = deepspeed_tpu_torch.initialize(
        config=config(1, 4, "fp16", {"stage": 3}),
        model=GPT2.from_size("tiny", **TINY), device="cpu")[0]
    with pytest.raises(ValueError, match="stage 1/2"):
        e3.load_checkpoint(str(tmp_path), tag="t")
    path, _ = e3.load_checkpoint(str(tmp_path), tag="t",
                                 load_optimizer_states=False)
    assert path is not None
    for name, p in e3.module.named_parameters():
        ref = dict(e1.module.named_parameters())[name]
        assert np.array_equal(p.detach().float().numpy(),
                              ref.detach().float().numpy())


def test_dp2_x_mp2_save_loads_in_jax(tmp_path):
    """ZeRO-3 x MP: four ranks (dp 2 x mp 2) each write their shard file
    (rows 00 and 01, dp ranks 0 and 1) and the two model ranks their
    model-state files; the JAX engine (stage 3, dp 2, mp 1) rehydrates
    and combines them into the global leaves the ranks held, bitwise."""
    params = init_params()
    toks, labels = lm_data(2, ROWS)
    path = str(tmp_path / "ck")
    outs = run_ranks(tmp_path / "l", 4, {
        "scenario": "train", "config": z3config(2), "steps": 2, "mp": 2,
        "fp32_compute": True, "save_after": 2, "save_dir": path,
        "save_tag": "x"}, rank_inputs(params, toks, labels))
    assert str(outs[0]["files"]).split("\n") == [
        "mp_rank_00_model_states.pt", "mp_rank_01_model_states.pt"] + [
        f"zero3_dp_rank_{d}_row_{r:02d}_states.pt"
        for d in range(2) for r in range(2)]
    specs = weights.flatten_tree(GPT2.from_size("tiny",
                                                **TINY).partition_specs())
    # ranks r = dp_rank * 2 + mp_rank: join each model rank's data shards,
    # then the model ranks by the specs
    local = [state_of([outs[m], outs[2 + m]]) for m in range(2)]
    jeng = jax_engine(z3config(2), 2, init_params(1))
    jeng.load_checkpoint(path, tag="x")
    loaded = jax_leaves(jeng)
    for key in ("master", "m", "v"):
        for name, x in loaded[key].items():
            parts = [local[m][key][name] for m in range(2)]
            want = (np.concatenate(parts, axis=specs[name])
                    if specs[name] is not None else parts[0])
            assert np.array_equal(x, want), (key, name)
