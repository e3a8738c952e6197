"""Dispatch-cost pass: the static host timeline of one optimizer step.

The port of ``deepspeed_tpu/analysis/dispatchplan.py``.  Event classes:

* **dispatch**: a launch.  Eagerly a launch is one kernel launch of the
  traced program (each aten op with an output and each hand-written
  kernel: ``graph.Trace.launches``); a CUDA-graphed serving program is one
  replay per call.
* **fence**: a deliberate host wait on device data.  Every one the port
  takes routes through ``observability/fences.py``, so :class:`FenceModel`
  reproduces that counter exactly over an N-step run.
* **transfer**: host -> device staging (the batch, the tokens).
* **callback**: the spool's drain, once per report window.

The port's ``train_many`` is the serial step loop (K ``train_batch``
steps after the K batches are staged), so at K > 1 :class:`FenceModel`
predicts per-STEP fences where the JAX model predicts one per K-step
block: the skip read stays per step, and the throughput reporter keeps
its cadence.

Findings: ``dispatch.report`` (info, the priced roll-up),
``dispatch.fence-per-step`` (warning: a removable fence on every step;
the fp16 / NaN-sentinel skip read, which the port's host-gated update
needs, is not removable) and ``dispatch.callback-per-step`` (warning:
``report_window`` 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from deepspeed_tpu_torch.analysis import profiles as prof_mod
from deepspeed_tpu_torch.analysis import report as R


@dataclasses.dataclass
class DispatchEvent:
    """One host-boundary event class on the per-step timeline."""

    kind: str                   # dispatch | fence | transfer | callback
    label: str
    per_step: float
    bytes_per: int = 0
    note: str = ""
    removable: bool = True

    def cost_ms(self, profile: Optional[prof_mod.BackendProfile]
                ) -> Optional[float]:
        if profile is None:
            return None
        if self.kind == "dispatch":
            each = profile.dispatch_us / 1e3
        elif self.kind == "fence":
            each = (profile.fence_us / 1e3
                    + self.bytes_per / (profile.h2d_gibps * (1 << 30))
                    * 1e3)
        elif self.kind == "callback":
            each = profile.callback_us / 1e3
        else:
            each = (profile.dispatch_us / 1e3
                    + self.bytes_per / (profile.h2d_gibps * (1 << 30))
                    * 1e3)
        return self.per_step * each


@dataclasses.dataclass
class FenceModel:
    """Deliberate-fence arithmetic of an N-step run: the static twin of
    ``observability.fences.FENCE_COUNT``.  ``per_boundary`` fences fire on
    every boundary; the throughput reporter adds one on report boundaries
    (``local_step % steps_per_output == 0`` past ``start_step``) when the
    spool is off and something drives the timer (the port's
    ``train_batch`` does); ``flush_fences`` per ``flush_telemetry()`` that
    finds undelivered rows (the JAX flush reads the ring every time).
    ``block_steps`` is the steps per dispatch: the port's serial
    ``train_many`` fences per step all the same."""

    per_boundary: int = 0
    tput_report: bool = False
    steps_per_output: int = 0
    start_step: int = 2
    flush_fences: int = 0
    block_steps: int = 1
    #: the spool's report window: the port's flush reads the ring only
    #: when it holds rows the last window edge did not deliver
    window: int = 0

    def count(self, n_steps: int, prior_boundaries: int = 0,
              flushes: int = 0) -> int:
        total = n_steps * self.per_boundary
        if self.tput_report and self.steps_per_output > 0:
            for b in range(prior_boundaries + 1,
                           prior_boundaries + n_steps + 1):
                if b > self.start_step and b % self.steps_per_output == 0:
                    total += 1
        if self.window > 0 and (prior_boundaries + n_steps) \
                % self.window == 0:
            flushes = 0             # nothing left to deliver
        return total + flushes * self.flush_fences

    def per_step_steady(self) -> float:
        rate = float(self.per_boundary)
        if self.tput_report and self.steps_per_output > 0:
            rate += 1.0 / self.steps_per_output
        return rate


@dataclasses.dataclass
class DispatchPlan:
    """The static host timeline of one optimizer step (or one serving
    iteration), priced against a profile."""

    subject: str
    events: List[DispatchEvent]
    fence_model: FenceModel
    profile: Optional[prof_mod.BackendProfile] = None
    executables: Optional[object] = None

    def per_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0.0) + e.per_step
        return out

    def host_ms_per_step(self) -> Optional[float]:
        if self.profile is None:
            return None
        return sum(e.cost_ms(self.profile) or 0.0 for e in self.events)

    def fences_per_step(self) -> float:
        return self.fence_model.per_step_steady()

    def predict_fences(self, n_steps: int, prior_boundaries: int = 0,
                       flushes: int = 0) -> int:
        return self.fence_model.count(n_steps,
                                      prior_boundaries=prior_boundaries,
                                      flushes=flushes)

    def format_summary(self) -> str:
        pk = self.per_kind()
        t = self.host_ms_per_step()
        t_s = f", predicted host time {t:.3f} ms/step" if t is not None \
            else ""
        return (f"host/step: {pk.get('dispatch', 0):g} dispatch(es), "
                f"{self.fences_per_step():g} fence(s), "
                f"{pk.get('transfer', 0):g} transfer(s), "
                f"{pk.get('callback', 0):g} callback(s){t_s}")

    def format_table(self) -> str:
        name = self.profile.name if self.profile else "<none>"
        lines = [f"dispatch plan [{self.subject}]  profile {name}",
                 f"{'kind':<9} {'event':<22} {'per step':>9} "
                 f"{'ms/step':>9}  note"]
        for e in self.events:
            c = e.cost_ms(self.profile)
            lines.append(
                f"{e.kind:<9} {e.label:<22} {e.per_step:>9.3g} "
                f"{(f'{c:9.4f}' if c is not None else '        -')}  "
                f"{e.note}")
        t = self.host_ms_per_step()
        if t is not None:
            lines.append(f"{'total':<9} {'':<22} {'':>9} {t:>9.4f}")
        return "\n".join(lines)

    def to_report(self) -> R.Report:
        rep = R.Report(subject=self.subject)
        rep.add("dispatch.report", R.INFO, self.format_summary(),
                path=self.subject, pass_name="dispatch")
        steady = [e for e in self.events
                  if e.kind == "fence" and e.per_step >= 1.0
                  and e.removable]
        if steady:
            names = ", ".join(e.label for e in steady)
            rep.add(
                "dispatch.fence-per-step", R.WARNING,
                f"{self.subject} takes {sum(e.per_step for e in steady):g} "
                f"deliberate host fence(s) on EVERY step ({names}): each "
                f"one serializes host launches with device execution - a "
                f"fixed per-step cost gradient accumulation cannot "
                f"amortize.  The metric spool removes the per-boundary "
                f"reads (observability.report_window)",
                path=self.subject, pass_name="dispatch")
        for e in self.events:
            if e.kind == "callback" and e.per_step >= 1.0:
                rep.add(
                    "dispatch.callback-per-step", R.WARNING,
                    f"{self.subject}: {e.label} crosses the host on every "
                    f"step (report_window=1 turns the once-per-window "
                    f"drain into a per-step crossing) - raise "
                    f"observability.report_window",
                    path=self.subject, pass_name="dispatch")
        return rep

    def to_json(self) -> dict:
        out = {
            "subject": self.subject,
            "profile": self.profile.name if self.profile else None,
            "predicted_host_ms_per_step": self.host_ms_per_step(),
            "fences_per_step": self.fences_per_step(),
            "per_kind": self.per_kind(),
            "events": [{
                "kind": e.kind, "label": e.label, "per_step": e.per_step,
                "bytes_per": e.bytes_per,
                "ms_per_step": e.cost_ms(self.profile), "note": e.note,
            } for e in self.events],
            "fence_model": dataclasses.asdict(self.fence_model),
        }
        if self.executables is not None:
            out["executables"] = self.executables.to_json()
        return out


def _batch_bytes(batch) -> int:
    return sum(int(x.numel()) * x.element_size() for x in batch
               if hasattr(x, "element_size"))


def plan_engine_dispatch(engine, batch, fused: bool = True,
                         profile: Optional[prof_mod.BackendProfile] = None,
                         steps_per_dispatch: Optional[int] = None,
                         launches: Optional[int] = None) -> DispatchPlan:
    """Host timeline of one optimizer step for ``batch``'s format: the
    full ``train_batch`` batch when ``fused``, one micro batch for the
    split API.  ``launches``: the traced program's launch count (None:
    not traced, no dispatch event priced)."""
    from deepspeed_tpu_torch.analysis import stability
    if profile is None:
        profile = prof_mod.default_profile(engine.device)
    batch = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
    gas = engine.gradient_accumulation_steps()
    spool = engine._spool
    window = int(getattr(engine.config, "observability_report_window", 0))
    skip_contract = bool(engine.config.fp16_enabled or engine._nan_sentinel)
    wcb = bool(engine.wall_clock_breakdown())
    has_writer = engine.summary_writer is not None
    if steps_per_dispatch is None:
        steps_per_dispatch = int(engine.config.train_steps_per_dispatch
                                 or 1)
    k = steps_per_dispatch if fused else 1

    kind = ("train_many" if fused and k > 1
            else "train_batch" if fused else "fwdbwd+step")
    events: List[DispatchEvent] = []
    per_boundary = 0
    if launches is not None:
        events.append(DispatchEvent(
            "dispatch", kind, float(launches) / k,
            note="kernel launches of the eager step (every op of the "
                 "traced program)"))
    events.append(DispatchEvent(
        "transfer", "batch", 1.0 if fused else float(gas),
        bytes_per=_batch_bytes(batch),
        note=("full effective batch staged per step" if fused
              else "one micro batch staged per forward")))
    if skip_contract:
        per_boundary += 1
        events.append(DispatchEvent(
            "fence", "overflow-read", 1.0, removable=False,
            note="fp16/nan-sentinel skip read: the port gates the update "
                 "on the host (kept with the spool on)"))
    if has_writer and spool is None:
        per_boundary += 1
        events.append(DispatchEvent(
            "fence", "tb-loss-read", 1.0,
            note="float(loss) for the TensorBoard train_loss scalar "
                 "(spooled when report_window >= 1)"))
    if wcb:
        n = (4 if fused else 5) * gas
        per_boundary += n
        events.append(DispatchEvent(
            "fence", "wcb-timers", float(n),
            note="wall_clock_breakdown syncs forward, backward_inner, "
                 "backward_allreduce and backward every micro step (and "
                 "step on the split API)"))
    flush_fences = 0
    if spool is not None:
        events.append(DispatchEvent(
            "callback", "spool-drain", 1.0 / max(1, window),
            note="one non-blocking ring copy per report window"))
        flush_fences = 1
    timer_driven = fused or (
        getattr(engine, "training_dataloader", None) is not None
        or bool(getattr(engine.tput_timer, "initialized", False)))
    tput_report = spool is None and timer_driven
    fm = FenceModel(
        per_boundary=per_boundary, tput_report=tput_report,
        steps_per_output=int(getattr(engine.tput_timer, "steps_per_output",
                                     0) or 0),
        start_step=int(getattr(engine.tput_timer, "start_step", 2)),
        flush_fences=flush_fences, block_steps=k,
        window=window if spool is not None else 0)
    if tput_report and fm.steps_per_output > 0:
        events.append(DispatchEvent(
            "fence", "tput-report", 1.0 / fm.steps_per_output,
            note="throughput reporter fences on report boundaries only"))
    pred = stability.predict_executables(engine, [batch], fused=fused)
    return DispatchPlan(subject=kind, events=events, fence_model=fm,
                        profile=profile, executables=pred)


def plan_serve_dispatch(engine,
                        profile: Optional[prof_mod.BackendProfile] = None,
                        launches: Optional[Dict[str, int]] = None
                        ) -> Dict[str, DispatchPlan]:
    """Host timelines of the serving engine: one plan per program family
    (``prefill``: one admission; ``decode``: one iteration over every
    slot).  Graphed, a program is one replay; eagerly, its traced launches
    (``launches``: program kind -> count)."""
    from deepspeed_tpu_torch.analysis import stability
    if profile is None:
        profile = prof_mod.default_profile(engine.device)
    launches = launches or {}
    graphed = engine._graphs is not None
    pred = stability.predict_executables_serve(engine)
    slots = engine.num_slots
    vocab = int(getattr(engine.module.config, "vocab_size", 0) or 0)
    cap = engine.cache_spec.capacity

    def dispatch(kind, per, note):
        n = 1 if graphed else launches.get(kind, 0)
        return DispatchEvent(
            "dispatch", kind, per * n,
            note=(note + (" (one graph replay)" if graphed else
                          f" ({n} eager launches)")))

    prefill_events = [
        dispatch("prefill", 1.0, "the extend program at the bucket width"),
        DispatchEvent("transfer", "prompt", 1.0,
                      bytes_per=8 * engine.prefill_bucket + 4 * cap,
                      note="padded [1, bucket] token ids + the slot's "
                           "[cap] page-table row map"),
    ]
    j = int(engine.spec_draft_tokens or 0)
    if j > 0:
        prefill_events.append(dispatch(
            "draft_prefill", 1.0, "the draft's whole-prompt prefill"))
    prefill_events.append(DispatchEvent(
        "fence", "logits-read", 1.0, bytes_per=4 * vocab, removable=False,
        note="sampler data dependency: one fence per admission"))
    prefill = DispatchPlan(subject="prefill", events=prefill_events,
                           fence_model=FenceModel(per_boundary=1),
                           profile=profile, executables=pred)
    d = int(engine.decode_iters_per_dispatch or 1)
    if j > 0:
        events = [
            dispatch("spec_step", 1.0,
                     f"J={j} draft steps + the width-{j + 1} verify"),
            DispatchEvent("transfer", "tokens+masks", 1.0,
                          bytes_per=13 * slots + 4 * slots * cap,
                          note="tokens, masks, budgets, the row map"),
            DispatchEvent("fence", "tokens-read", 1.0,
                          bytes_per=5 * slots * (j + 1), removable=False,
                          note="[J+1, slots] tokens + emitted masks"),
        ]
        decode = DispatchPlan(subject="decode", events=events,
                              fence_model=FenceModel(per_boundary=1),
                              profile=profile, executables=pred)
    elif d > 1:
        events = [
            dispatch("decode_many", 1.0 / d,
                     f"D={d} decode steps, greedy on the device"),
            DispatchEvent("transfer", "tokens+masks", 1.0 / d,
                          bytes_per=13 * slots,
                          note="tokens, masks and budgets per D-block"),
            DispatchEvent("fence", "tokens-read", 1.0 / d,
                          bytes_per=5 * slots * d, removable=False,
                          note=f"[D, slots] tokens once per {d} "
                               f"iterations"),
        ]
        decode = DispatchPlan(subject="decode", events=events,
                              fence_model=FenceModel(per_boundary=1,
                                                     block_steps=d),
                              profile=profile, executables=pred)
    else:
        events = [
            dispatch("decode", 1.0, "one token step over every slot"),
            DispatchEvent("transfer", "tokens+active", 1.0,
                          bytes_per=9 * slots,
                          note="per-slot input token + active mask"),
            DispatchEvent("fence", "logits-read", 1.0,
                          bytes_per=4 * vocab * slots, removable=False,
                          note="sampler data dependency, every "
                               "iteration"),
        ]
        decode = DispatchPlan(subject="decode", events=events,
                              fence_model=FenceModel(per_boundary=1),
                              profile=profile, executables=pred)
    return {"prefill": prefill, "decode": decode}


def serve_predict_fences(plans: Dict[str, DispatchPlan], prefills: int,
                         decode_iters: int) -> int:
    """Predicted fence-counter delta of a serving run: one counted read
    per admission and per decode dispatch."""
    d = plans["decode"].fence_model.block_steps
    return (plans["prefill"].predict_fences(prefills)
            + plans["decode"].predict_fences(decode_iters // max(1, d)))
