#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of the repository, with one NVIDIA Hopper card visible:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero before the
last line):

1. env: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: nvcc compiles deepspeed_tpu_torch/csrc/fused_optim.cu for sm_90a.
3. tiny_parity: a tiny BERT trained 3 steps on the card and on the CPU
   (the kernels' plain versions) from the same weights must agree.
4. train: BERT-large pretraining (seq 128, bf16, LAMB lr 4e-3 max_coeff
   0.5 min_coeff 0.08, 20 masked positions, ZeRO off, micro-batch 32,
   gas 2) through ``deepspeed_tpu_torch.initialize`` + ``train_batch`` for
   6 steps from seeded random weights; losses finite, and every LAMB step
   through the kernels (launch counts = 22 leaves x 6 steps).
5. kernels: each kernel against its plain version on the real BERT-large
   leaves, grads and moments after step 6, with times (CUDA events, median),
   the least time the card could take (bound) and a library yardstick.
6. profile: 3 more LAMB steps of the same engine under torch.profiler:
   device busy ms per step, busy share, top CUDA kernels by device time.
7. adam: 2 AdamW steps of BERT-large, every step through the Adam kernel.

Then one line with the card's name and power limit, one JSON line with
every kernel, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.

fp32 matrix products run in full fp32 (TF32 off for matmul and cuDNN) so the
fp32 comparisons hold to fp32 tolerances.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): device memory bandwidth and fp32
# arithmetic outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

SEQ, NPRED, MICRO, GAS, STEPS, ADAM_STEPS = 128, 20, 32, 2, 6, 2
TINY = dict(max_seq_len=64, vocab_size=512, num_layers=2, hidden_size=128,
            num_heads=4)
# (bytes, flops) per parameter of each kernel: read each input once, write
# each output once (csrc/fused_optim.cu header)
KERNELS = {
    "lamb_phase1": dict(bytes=28, flops=16,
                        replaces="deepspeed_tpu/ops/pallas_optim.py:68"),
    "lamb_phase2": dict(bytes=12, flops=2,
                        replaces="deepspeed_tpu/ops/pallas_optim.py:105"),
    "adam": dict(bytes=28, flops=17,
                 replaces="deepspeed_tpu/ops/pallas_optim.py:167"),
}
SOURCE = "deepspeed_tpu_torch/csrc/fused_optim.cu"
# kernel vs plain on identical fp32 inputs: the kernel contracts to FMAs
# and sums the norms in another order
RTOL, ATOL = 1e-5, 1e-6


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bert_config(opt_type, params, gas=GAS, micro=MICRO, dtype="bf16"):
    cfg = {"train_batch_size": micro * gas,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": opt_type, "params": params},
           "activation_checkpointing": False,
           "steps_per_print": 10 ** 9}
    if dtype == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


def mlm_batch(rows, seq, vocab, npred, seed=0):
    """The masked-positions MLM batch bench.py builds (numpy, seeded)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(rows, seq)).astype(np.int32)
    mask = np.ones((rows, seq), np.int32)
    tt = np.zeros((rows, seq), np.int32)
    pos = np.stack([rng.choice(seq, size=npred, replace=False)
                    for _ in range(rows)]).astype(np.int32)
    mlm_ids = np.take_along_axis(ids, pos, axis=1)
    return (ids, mask, tt, pos, mlm_ids, np.ones((rows, npred), np.float32))


def make_engine(cfg, device, size="large", seed=0, params=None, **over):
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import BertForPreTraining
    gen = torch.Generator(device=device).manual_seed(seed)
    model = BertForPreTraining.from_size(size, generator=gen, device=device,
                                         **over)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        config=cfg, model=model, model_parameters=params, device=device)
    return engine


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def phase_tiny_parity(device):
    """3 LAMB steps of a tiny fp32 BERT on ``device`` and on the CPU."""
    import numpy as np

    from deepspeed_tpu_torch import weights
    cfg = bert_config("Lamb", {"lr": 1e-3, "eps": 1e-6, "max_coeff": 0.5,
                               "min_coeff": 0.08, "weight_decay": 0.01},
                      micro=4, dtype="fp32")
    ref = make_engine(cfg, "cpu", size="tiny", **TINY)
    params = weights.params_to_numpy(ref.module)
    dev = make_engine(cfg, device, size="tiny", params=params, **TINY)
    losses = []
    for step in range(3):
        batch = mlm_batch(8, TINY["max_seq_len"], TINY["vocab_size"], 8,
                          seed=100 + step)
        losses.append((float(dev.train_batch(batch)),
                       float(ref.train_batch(batch))))
    worst = 0.0
    for k, want in ref.master.items():
        got = dev.master[k].cpu()
        err = (got - want).abs() - (ATOL * 10 + 1e-4 * want.abs())
        worst = max(worst, float(err.max()))
    ok = worst <= 0 and all(
        abs(a - b) <= 1e-4 * abs(b) for a, b in losses)
    emit("tiny_parity", losses=losses, masters_rtol=1e-4,
         masters_atol=ATOL * 10, ok=ok)
    if not ok or not np.isfinite(losses).all():
        raise AssertionError("tiny BERT on the card disagrees with the CPU")


def phase_train(device):
    import numpy as np
    import torch

    from deepspeed_tpu_torch.ops import cuda_optim
    cfg = bert_config("Lamb", {"lr": 4e-3, "max_coeff": 0.5,
                               "min_coeff": 0.08})
    engine = make_engine(cfg, device, max_seq_len=SEQ)
    n_leaves = len(engine.master)
    n_params = engine.num_parameters()
    vocab = engine.module.config.vocab_size
    batch = mlm_batch(MICRO * GAS, SEQ, vocab, NPRED)
    sync(device)
    cuda_optim.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = engine.train_batch(batch)
        sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = dict(cuda_optim.LAUNCHES)
    want = n_leaves * STEPS
    ok = (np.isfinite(losses).all() and launches["lamb_phase1"] == want
          and launches["lamb_phase2"] == want and launches["adam"] == 0)
    emit("train", model="bert-large", seq=SEQ, micro_batch=MICRO, gas=GAS,
         dtype="bf16", optimizer="Lamb", params=n_params, leaves=n_leaves,
         losses=losses, step_ms=step_ms,
         samples_per_s_steady=(MICRO * GAS * (STEPS - 1)
                               / (sum(step_ms[1:]) / 1e3)),
         peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30
         if torch.device(device).type == "cuda" else None,
         launches=launches, expected_launches=want, ok=bool(ok))
    if not ok:
        raise AssertionError(f"train phase failed: losses {losses}, "
                             f"launches {launches}, expected {want}")
    return engine, batch, launches


def _time_ms(fn, device, reps=7):
    """Median CUDA-event time of ``fn`` (after one warm-up call)."""
    import torch
    fn()
    if torch.device(device).type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_err(got, want):
    """(max abs err, max rel err, within tolerance) over tensor pairs; the
    relative error divides by max(|want|, ATOL / RTOL), so values near zero
    count by their absolute error."""
    abs_err, rel_err, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        d = (g - w).abs()
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err,
                      float((d / w.abs().clamp_min(ATOL / RTOL)).max()))
        ok = ok and bool((d <= ATOL + RTOL * w.abs()).all())
    return abs_err, rel_err, ok


def _bound_ms(name, n):
    k = KERNELS[name]
    return max(n * k["bytes"] / HBM_BYTES_PER_S,
               n * k["flops"] / FP32_FLOP_PER_S) * 1e3


def phase_kernels(engine, batch, device, lamb_launches):
    """Each kernel against its plain version on the BERT-large state."""
    import torch

    from deepspeed_tpu_torch.ops import cuda_optim
    from deepspeed_tpu_torch.ops import optim as optim_mod

    # one micro-batch of grads on top of the state after the last step
    engine.backward(engine(*(x[:MICRO] for x in batch)))
    grads, engine._acc = engine._acc, None
    names = list(engine.master)
    g = [grads[k] for k in names]
    n = sum(t.numel() for t in g)
    st = engine.opt_state
    lamb = engine.base_optimizer
    adam = optim_mod.AdamW(lr=1e-4, weight_decay=0.01)
    idx = range(len(names))

    def scalars(opt):
        ss = opt._step_size(opt.lr, st.step + 1, opt.beta1, opt.beta2)
        rows = [(opt.beta1, opt.beta2, ss, opt.weight_decay, opt.lr)] * len(g)
        # the unscale-and-clip divisor as the engine passes it: on device
        return cuda_optim.make_scalars(
            rows, torch.tensor(2.0, device=device), device)

    def state_copy():
        return [[t[k].clone() for k in names]
                for t in (engine.master, st.m, st.v)]

    lamb_kw = dict(min_coeff=lamb.min_coeff, max_coeff=lamb.max_coeff)
    # the plain and the kernel route each keep their own phase-1 outputs
    outs = {"kernel": [None] * len(g), "plain": [None] * len(g)}

    def lamb_fns(p, m, v, scal):
        def phase1(route, fn):
            def run():
                for i in idx:
                    outs[route][i] = fn(p[i], g[i], m[i], v[i], scal[i],
                                        eps=lamb.eps)
            return run

        def phase2(route, fn):
            def run():
                for i in idx:
                    u, parts = outs[route][i]
                    fn(p[i], u, parts, scal[i], **lamb_kw)
            return run
        return {
            "lamb_phase1": (phase1("kernel", cuda_optim.lamb_phase1),
                            phase1("plain", cuda_optim.lamb_phase1_plain)),
            "lamb_phase2": (phase2("kernel", cuda_optim.lamb_phase2),
                            phase2("plain", cuda_optim.lamb_phase2_plain)),
        }

    def adam_fns(p, m, v, scal):
        def run(fn):
            def go():
                for i in idx:
                    fn(p[i], g[i], m[i], v[i], scal[i], eps=adam.eps,
                       decoupled=True)
            return go
        return {"adam": (run(cuda_optim.fused_adam_update),
                         run(cuda_optim.adam_plain))}

    results = []
    for opt, make_fns, launches in ((lamb, lamb_fns, lamb_launches),
                                    (adam, adam_fns, None)):
        scal = scalars(opt)
        # correctness: one full update, kernel and plain, identical inputs
        kstate, pstate = state_copy(), state_copy()
        kfns, pfns = make_fns(*kstate, scal), make_fns(*pstate, scal)
        for name in kfns:
            kfns[name][0]()
            pfns[name][1]()
        sync(device)
        errs = {out: _max_err(a, b) for out, a, b in
                zip("pmv", kstate, pstate)}
        del kstate, kfns
        # timing, in place on the plain route's copy
        lib = None
        if opt is adam:
            lib_params = [t.clone().requires_grad_() for t in pstate[0]]
            for t, gr in zip(lib_params, g):
                t.grad = gr
            lib = torch.optim.AdamW(lib_params, lr=opt.lr, eps=opt.eps,
                                    weight_decay=opt.weight_decay,
                                    fused=True).step
        for name, (kfn, pfn) in pfns.items():
            # plain, kernel, kernel, plain: compare within one call
            plain_a = _time_ms(pfn, device)
            kernel_a = _time_ms(kfn, device)
            kernel_b = _time_ms(kfn, device)
            plain_b = _time_ms(pfn, device)
            outs_of = {"lamb_phase1": "mv", "lamb_phase2": "p"}.get(name,
                                                                    "pmv")
            results.append({
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": KERNELS[name]["replaces"],
                "launches": None if launches is None else launches[name],
                "max_abs_err": max(errs[o][0] for o in outs_of),
                "errors": {o: {"max_abs": e[0], "max_rel": e[1],
                               "ok": e[2]} for o, e in errs.items()},
                "ms": min(kernel_a, kernel_b),
                "plain_ms": min(plain_a, plain_b),
                "bound_ms": _bound_ms(name, n), "bound_by": "bytes",
                "library_ms": _time_ms(lib, device) if lib else None,
                "elements": n, "tensors": len(g)})
        del pstate, pfns, lib
        if not all(e[2] for e in errs.values()):
            raise AssertionError(f"{opt.name} kernels disagree with their "
                                 f"plain versions beyond rtol={RTOL} "
                                 f"atol={ATOL}: {errs}")
    outs.clear()
    for r in results:
        emit("kernels", **{k: r[k] for k in (
            "name", "ms", "plain_ms", "bound_ms", "library_ms", "errors",
            "elements", "tensors")})
    return results


def phase_profile(engine, batch, device, steps=3, top=12):
    """Where a BERT-large step spends its device time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    engine.train_batch(batch)
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.train_batch(batch)
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    busy = sum(device_ms(e) for e in kernels)
    gemm = sum(device_ms(e) for e in kernels
               if "gemm" in e.key or "nvjet" in e.key)
    emit("profile", steps=steps, step_ms_profiled=wall_ms / steps,
         device_busy_ms_per_step=busy / steps,
         device_busy_share_profiled=busy / wall_ms,
         gemm_ms_per_step=gemm / steps,
         top_kernels=[{"name": e.key[:90], "calls": e.count,
                       "ms_per_step": device_ms(e) / steps}
                      for e in sorted(kernels, key=device_ms,
                                      reverse=True)[:top]])


def phase_adam(device):
    import numpy as np

    from deepspeed_tpu_torch.ops import cuda_optim
    cfg = bert_config("AdamW", {"lr": 1e-4, "weight_decay": 0.01})
    engine = make_engine(cfg, device, max_seq_len=SEQ)
    batch = mlm_batch(MICRO * GAS, SEQ, engine.module.config.vocab_size,
                      NPRED, seed=1)
    sync(device)
    cuda_optim.reset_launch_counts()
    losses = [float(engine.train_batch(batch)) for _ in range(ADAM_STEPS)]
    sync(device)
    launches = dict(cuda_optim.LAUNCHES)
    want = len(engine.master) * ADAM_STEPS
    ok = (np.isfinite(losses).all() and launches["adam"] == want
          and launches["lamb_phase1"] == 0)
    emit("adam", losses=losses, launches=launches, expected_launches=want,
         ok=bool(ok))
    if not ok:
        raise AssertionError(f"adam phase failed: {losses} {launches}")
    return launches


def main() -> int:
    if not (ROOT / "deepspeed_tpu_torch" / "csrc" / "fused_optim.cu").exists():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(deepspeed_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    emit("env", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), tf32=False)

    from deepspeed_tpu_torch.ops import cuda_optim
    t0 = time.perf_counter()
    cuda_optim.build()
    emit("build", seconds=time.perf_counter() - t0, source=SOURCE,
         flags=" ".join(cuda_optim.NVCC_FLAGS),
         ptxas=[ln.strip() for ln in cuda_optim.build_log.splitlines()
                if "registers" in ln or "spill" in ln])

    phase_tiny_parity(device)
    engine, batch, lamb_launches = phase_train(device)
    kernels = phase_kernels(engine, batch, device, lamb_launches)
    phase_profile(engine, batch, device)
    del engine
    torch.cuda.empty_cache()
    adam_launches = phase_adam(device)
    for k in kernels:
        if k["name"] == "adam":
            k["launches"] = adam_launches["adam"]

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
