"""Pipeline parallelism: GPipe and 1F1B schedules across stage processes.

The port of ``deepspeed_tpu/parallel/pipeline.py``.  The JAX package runs
every stage in one SPMD program: a ``lax.scan`` over ``m + pp - 1`` ticks
(``m + 2(pp - 1)`` for 1F1B) in which each stage applies its blocks and
hands the activation on with a ``ppermute``, computing garbage on the
bubble ticks and masking it out.  Here each stage is a process of the pipe
group (``topology.Topology.pipe_group``) that computes only its own
micro-batches; activations and their gradients cross between stages by
point-to-point sends (``comm.pipe_isend``, ``comm.pipe_recv``).

A schedule is one ``torch.autograd.Function`` (``_PipelineLoss``) whose
inputs are the model's parameters and whose output is the loss, the same
scalar on every stage (the JAX psum over ``pipe`` makes it pipe-uniform).
Inside, each micro-batch's stage forward is its own graph rooted at
detached leaves, and the schedule runs each backward micro-step itself
(``torch.autograd.grad``), in the order the schedule fixes: never autograd.
On a non-last stage one loss feeds both its head slice (whose backward
sends a gradient to the last stage) and its blocks (whose backward waits
on the next stage); left to autograd, two stages could each wait on the
other.  Every send is non-blocking and every receive matches a send issued
earlier in the schedule, so no stage waits on a stage that waits on it.

* **GPipe** (``schedule="gpipe"``): all forwards with their graphs, the
  head, then in the Function's backward the head's backward and every
  micro-batch's backward, last first, seeded by the incoming gradient
  (which carries the loss scale and ``1 / gas``).
* **1F1B** (``schedule="1f1b"``): the interleaved schedule of the JAX
  ``_run_1f1b``: at tick ``t`` stage ``s`` runs the forward of micro-batch
  ``t - s`` without a graph, keeping only its input, and the backward of
  micro-batch ``t - 2(pp - 1) + s``, recomputing the stage from the kept
  input, so at most ``min(m, 2 pp - 1)`` stage inputs are held.  The last
  stage needs no recompute: its backward of a micro-batch runs in the tick
  of its forward.  As in the JAX ``custom_vjp``, the gradients are
  computed in the forward with the seed ``1 / count`` and scaled by the
  incoming gradient in the backward.  Without a graph (eval) the forward
  is the GPipe forward.
* **The head** (LN, logits, cross-entropy): when the micro-batch size
  ``mb`` divides by ``pp`` each stage computes it on its ``1 / pp`` row
  slice of each finished micro-batch (GPipe: of all of them at once, the
  JAX ``collect="scatter"`` with ``pipe_scattered_loss``; 1F1B: per tick,
  the JAX sharded in-schedule head), and the partial loss sums add up over
  the pipe group.  Otherwise the last stage alone computes it, with a
  one-time warning (``warn_slow_path_once``, keys ``"gpipe_full_collect"``
  and ``"1f1b_replicated_head"``).

Each micro-batch's gradients add up in fp32 in the schedule; the
gradients of the leaves every stage holds whole (the embeddings and the
final LayerNorm) then sum over the pipe group, in fp32, before they leave
the Function, so every stage returns the true gradient of every leaf it
holds, and the engine applies no ``1 / pp`` (the JAX engine divides by pp
to undo its psum's transpose).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, Optional, Sequence

import torch

from deepspeed_tpu_torch.parallel import comm

logger = logging.getLogger(__name__)

SCHEDULES = ("gpipe", "1f1b")
#: message kinds (the tags of the point-to-point sends)
_FWD, _BWD, _HEAD, _HEAD_GRAD = 0, 1, 2, 3

_warned_slow_paths: set = set()


def warn_slow_path_once(key: str, message: str) -> None:
    """A one-time warning for a degraded schedule fallback, once per
    process and key (the JAX ``warn_slow_path_once``)."""
    if key in _warned_slow_paths:
        return
    _warned_slow_paths.add(key)
    logger.warning(message)


@dataclasses.dataclass(frozen=True)
class PipeContext:
    """This process's place in its pipeline: its ``stage`` of ``size``,
    the global ``ranks`` of the pipe group by stage, and the ``group``
    (None at one stage)."""
    stage: int = 0
    size: int = 1
    ranks: tuple = (0,)
    group: Optional[object] = None

    @classmethod
    def from_topology(cls, topo) -> "PipeContext":
        return cls(stage=topo.pp_rank, size=topo.pp,
                   ranks=tuple(topo.pipe_ranks()), group=topo.pipe_group)

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.size - 1


class _Link:
    """This stage's sends and receives: sends are issued at once and
    waited for at ``wait()``."""

    def __init__(self, pipe: PipeContext, device):
        self.pipe, self.device = pipe, device
        self._pending = []

    def send(self, x, stage: int, tag: int) -> None:
        self._pending.append(comm.pipe_isend(
            x, self.pipe.ranks[stage], self.pipe.group, tag))

    def recv(self, shape, dtype, stage: int, tag: int) -> torch.Tensor:
        return comm.pipe_recv(shape, dtype, self.device,
                              self.pipe.ranks[stage], self.pipe.group, tag)

    def wait(self) -> None:
        for p in self._pending:
            p.wait()
        self._pending = []


def _aux_terms(aux):
    """``aux`` as a list of tensors with a graph ([] for a constant)."""
    return [aux] if isinstance(aux, torch.Tensor) and aux.requires_grad \
        else []


def _aux_value(aux) -> float:
    return aux.detach().float() if isinstance(aux, torch.Tensor) else aux


class _Schedule:
    """The common state of a schedule run (see the module docstring).

    ``embed(p, i)``: micro-batch ``i``'s stage-0 input ``[mb, ...]``;
    ``stage_fn(p, x)``: this stage's blocks, ``(y, aux)``;
    ``head_fn(p, y, labels)``: the masked loss SUM of rows ``y``; ``p``
    maps each name of ``params`` to its leaf in the schedule's graphs.
    ``labels`` is ``[m, mb, ...]`` (anything the head slices by rows);
    the loss is ``sum(head sums) / count + sum(aux) / m``."""

    def __init__(self, pipe: PipeContext, params: Dict[str, torch.Tensor],
                 embed: Callable, stage_fn: Callable, head_fn: Callable,
                 labels, count, m: int, act_shape: Sequence[int],
                 act_dtype, replicated: Sequence[str]):
        self.pipe, self.names = pipe, list(params)
        self.embed, self.stage_fn, self.head_fn = embed, stage_fn, head_fn
        self.labels, self.count, self.m = labels, count, m
        self.act_shape, self.act_dtype = tuple(act_shape), act_dtype
        self.replicated = [n for n in self.names if n in set(replicated)]
        first = next(iter(params.values()))
        self.device = first.device
        self.link = _Link(pipe, self.device)
        mb = self.act_shape[0]
        self.sharded_head = pipe.size > 1 and mb % pipe.size == 0
        self.slice_rows = mb // pipe.size
        self.acc: Dict[str, torch.Tensor] = {}
        #: the most stage inputs held at once (1F1B)
        self.max_held = 0

    # ------------------------------------------------------------ helpers

    def leaves(self, tensors):
        """The schedule's leaves of the Function's inputs."""
        self.p = {n: t.detach().requires_grad_(t.requires_grad)
                  for n, t in zip(self.names, tensors)}

    def _wanted(self):
        return [n for n in self.names if self.p[n].requires_grad]

    def grad(self, outputs, seeds, extra=()):
        """The gradients of ``outputs`` (seeded by ``seeds``) added in fp32
        to the accumulators; returns those of the ``extra`` tensors."""
        names = self._wanted()
        inputs = [self.p[n] for n in names] + list(extra)
        got = torch.autograd.grad(outputs, inputs, seeds, allow_unused=True)
        for n, g in zip(names, got):
            if g is None:
                continue
            if n in self.acc:
                self.acc[n].add_(g)
            else:
                self.acc[n] = g.float() if g.dtype != torch.float32 \
                    else g.clone()
        return got[len(names):]

    def my_rows(self, x, dim=0):
        """This stage's row slice of ``x`` along ``dim``."""
        s = self.pipe.stage * self.slice_rows
        return x.narrow(dim, s, self.slice_rows)

    def scatter_rows(self, ys, dim):
        """This stage's head rows: the last stage sends every other stage
        its ``1 / pp`` slice of ``ys`` (rows along ``dim``; None on the
        other stages) and keeps its own."""
        pipe, sl = self.pipe, self.slice_rows
        if pipe.last:
            for r in range(pipe.size - 1):
                self.link.send(ys.narrow(dim, r * sl, sl), r, _HEAD)
            return self.my_rows(ys, dim)
        shape = (self.m,) * dim + (sl,) + self.act_shape[1:]
        return self.link.recv(shape, self.act_dtype, pipe.size - 1, _HEAD)

    def gather_rows(self, d_mine, dim):
        """``scatter_rows``'s inverse for the gradients: the last stage
        assembles every stage's slice (its own is ``d_mine``) and returns
        the whole; the other stages send theirs and return None."""
        pipe, sl = self.pipe, self.slice_rows
        if not pipe.last:
            self.link.send(d_mine, pipe.size - 1, _HEAD_GRAD)
            return None
        shape = list(d_mine.shape)
        shape[dim] = sl * pipe.size
        out = torch.empty(shape, dtype=self.act_dtype, device=self.device)
        for r in range(pipe.size):
            out.narrow(dim, r * sl, sl).copy_(
                d_mine if r == pipe.stage else self.link.recv(
                    d_mine.shape, self.act_dtype, r, _HEAD_GRAD))
        return out

    def head(self, y, labels):
        """The head on rows ``y`` (a leaf); returns its loss sum."""
        return self.head_fn(self.p, y, labels).float()

    def warn_unsharded(self, key, what):
        if self.pipe.size > 1 and not self.sharded_head:
            warn_slow_path_once(key, (
                f"{what}: the micro-batch size {self.act_shape[0]} is not "
                f"divisible by pp={self.pipe.size}, so the head (LN, "
                f"logits, cross-entropy) runs on the last stage alone "
                f"instead of 1/pp of its rows on every stage; pad or resize "
                f"the micro-batch to a multiple of pp"))

    def loss(self, loss_sum, aux_sum):
        """The pipe-uniform loss: the stages' sums added up."""
        tot = torch.stack([torch.as_tensor(loss_sum, dtype=torch.float32,
                                           device=self.device).reshape(()),
                           torch.as_tensor(aux_sum, dtype=torch.float32,
                                           device=self.device).reshape(())])
        if self.pipe.group is not None:
            torch.distributed.all_reduce(tot, group=self.pipe.group)
        return tot[0] / self.count + tot[1] / self.m

    def finish(self, scale=None):
        """The Function's input gradients: the fp32 accumulators (zeros
        for a leaf with none), times ``scale``, the stage-replicated ones
        summed over the pipe group."""
        self.link.wait()
        grads = []
        for n in self.names:
            g = self.acc.get(n)
            if g is None:
                g = torch.zeros(self.p[n].shape, dtype=torch.float32,
                                device=self.device)
            if scale is not None:
                g.mul_(scale)
            grads.append(g)
        comm.sum_fp32_([g for n, g in zip(self.names, grads)
                        if n in self.replicated and self.p[n].requires_grad],
                       self.pipe.group)
        self.acc = {}
        return [g if self.p[n].requires_grad else None
                for n, g in zip(self.names, grads)]

    # ------------------------------------------------------------- GPipe

    def gpipe_forward(self):
        """All forwards (with graphs when grad is enabled), then the
        head's forward; returns the loss."""
        pipe, link, m = self.pipe, self.link, self.m
        self.saved = []
        aux_sum = 0.0
        for i in range(m):
            if pipe.first:
                x = self.embed(self.p, i)
            else:
                x = link.recv(self.act_shape, self.act_dtype, pipe.stage - 1,
                              _FWD)
                x.requires_grad_(torch.is_grad_enabled())
            y, aux = self.stage_fn(self.p, x)
            aux_sum = aux_sum + _aux_value(aux)
            self.saved.append((x, y, aux))
            if not pipe.last:
                link.send(y, pipe.stage + 1, _FWD)
        self.warn_unsharded("gpipe_full_collect", "GPipe")
        self.head_in, loss_sum = None, 0.0
        if self.sharded_head:
            ys = (torch.stack([y.detach() for _, y, _ in self.saved])
                  if pipe.last else None)
            self.head_in = self.scatter_rows(ys, 1).detach().requires_grad_(
                torch.is_grad_enabled())
            lab = self.my_rows(self.labels, 1)
            loss_sum = self.head(self.head_in.flatten(0, 1),
                                 lab.flatten(0, 1))
        elif pipe.last:
            ys = torch.stack([y.detach() for _, y, _ in self.saved])
            self.head_in = ys.requires_grad_(torch.is_grad_enabled())
            loss_sum = self.head(self.head_in.flatten(0, 1),
                                 self.labels.flatten(0, 1))
        self.loss_sum = loss_sum
        if not torch.is_grad_enabled():
            self.saved = None
        link.wait()
        return self.loss(_detach(loss_sum), aux_sum)

    def gpipe_backward(self, g):
        """The head's backward, its row gradients gathered on the last
        stage, then every micro-batch's backward, last first."""
        pipe, link, m = self.pipe, self.link, self.m
        seed = g / self.count
        dys = None
        if self.head_in is not None:
            (d_in,) = self.grad(self.loss_sum, seed, extra=[self.head_in])
            dys = self.gather_rows(d_in, 1) if self.sharded_head else d_in
        self.loss_sum = self.head_in = None
        aux_seed = g / self.m
        for i in reversed(range(m)):
            x, y, aux = self.saved.pop()
            if pipe.last:
                dy = dys[i]
            else:
                dy = link.recv(self.act_shape, self.act_dtype,
                               pipe.stage + 1, _BWD)
            extra = [] if pipe.first else [x]
            aux_t = _aux_terms(aux)
            got = self.grad([y] + aux_t, [dy] + [aux_seed] * len(aux_t),
                            extra=extra)
            if not pipe.first:
                link.send(got[0], pipe.stage - 1, _BWD)
        return self.finish()

    # -------------------------------------------------------------- 1F1B

    def run_1f1b(self):
        """The interleaved schedule (see the module docstring): the loss,
        and the gradients for the seed ``1 / count`` in the
        accumulators."""
        pipe, link, m, pp, s = self.pipe, self.link, self.m, \
            self.pipe.size, self.pipe.stage
        seed = torch.reciprocal(torch.as_tensor(
            self.count, dtype=torch.float32, device=self.device))
        aux_seed = seed.new_tensor(1.0 / m)
        self.warn_unsharded("1f1b_replicated_head", "1F1B")
        ring, loss_sum, aux_sum = {}, 0.0, 0.0
        for t in range(m + 2 * (pp - 1)):
            f, b, h = t - s, t - (2 * (pp - 1) - s), t - (pp - 1)
            active_f, active_b = 0 <= f < m, 0 <= b < m
            # this tick's activation and gradient sends go out at its end,
            # after the head's, and are received at the next tick's start:
            # each pair of stages receives in the order it sends
            sends = []
            x_in = dy = None
            if active_f and not pipe.first:
                x_in = link.recv(self.act_shape, self.act_dtype, s - 1, _FWD)
            if active_b and not pipe.last:
                dy = link.recv(self.act_shape, self.act_dtype, s + 1, _BWD)
            # forward sub-step: micro-batch f enters this stage
            if active_f and pipe.last:
                # its backward runs in this tick: keep the graph
                x_b = self._stage_input(f, x_in)
                y_b, aux_b = self.stage_fn(self.p, x_b)
                y_f = y_b.detach()
            elif active_f:
                with torch.no_grad():
                    y_f, _ = self.stage_fn(self.p, self._stage_input(f, x_in))
                ring[f] = x_in
                self.max_held = max(self.max_held, len(ring))
                sends.append((y_f, s + 1, _FWD))
            # the head of micro-batch h, which the last stage finished now
            if 0 <= h < m and self.sharded_head:
                rows = self.scatter_rows(y_f if pipe.last else None,
                                         0).detach().requires_grad_()
                lsum = self.head(rows, self.my_rows(self.labels[h]))
                (d_rows,) = self.grad(lsum, seed, extra=[rows])
                loss_sum = loss_sum + lsum.detach()
                gathered = self.gather_rows(d_rows, 0)
                if pipe.last:
                    dy = gathered
            elif 0 <= h < m and pipe.last:
                rows = y_f.requires_grad_()
                lsum = self.head(rows, self.labels[h])
                (dy,) = self.grad(lsum, seed, extra=[rows])
                loss_sum = loss_sum + lsum.detach()
            # backward sub-step: micro-batch b leaves this stage
            if active_b:
                if not pipe.last:
                    x_b = self._stage_input(b, ring.pop(b))
                    y_b, aux_b = self.stage_fn(self.p, x_b)
                aux_t = _aux_terms(aux_b)
                got = self.grad([y_b] + aux_t,
                                [dy] + [aux_seed] * len(aux_t),
                                extra=[] if pipe.first else [x_b])
                aux_sum = aux_sum + _aux_value(aux_b)
                if not pipe.first:
                    sends.append((got[0], s - 1, _BWD))
                y_b = aux_b = None
            for x, stage, tag in sends:
                link.send(x, stage, tag)
        link.wait()
        return self.loss(loss_sum, aux_sum)

    def _stage_input(self, i, received):
        """Micro-batch ``i``'s input to this stage, a leaf with a graph
        when grad is enabled (stage 0: the embedding of its tokens)."""
        if self.pipe.first:
            return self.embed(self.p, i)
        return received.detach().requires_grad_(torch.is_grad_enabled())


def _detach(x):
    return x.detach() if isinstance(x, torch.Tensor) else x


class _PipelineLoss(torch.autograd.Function):
    """One schedule run as an autograd node: the inputs are the model's
    parameters, the output the pipe-uniform loss."""

    @staticmethod
    def forward(ctx, run, schedule, *tensors):
        ctx.run, ctx.schedule = run, schedule
        with torch.enable_grad():
            run.leaves(tensors)
            if schedule == "1f1b":
                return run.run_1f1b()
            return run.gpipe_forward()

    @staticmethod
    def backward(ctx, g):
        run, ctx.run = ctx.run, None
        g = g.float()
        if ctx.schedule == "1f1b":
            grads = run.finish(scale=g)
        else:
            grads = run.gpipe_backward(g)
        return (None, None, *grads)


def pipeline_loss(pipe: Optional[PipeContext], schedule: str,
                  params: Dict[str, torch.Tensor], embed: Callable,
                  stage_fn: Callable, head_fn: Callable, labels, count,
                  m: int, act_shape: Sequence[int], act_dtype,
                  replicated: Sequence[str] = (), stats: Optional[dict] = None
                  ) -> torch.Tensor:
    """The loss of ``m`` micro-batches through this stage's part of the
    pipeline under ``schedule`` (``"gpipe"`` or ``"1f1b"``), as a scalar
    whose backward gives every tensor of ``params`` its gradient (see
    ``_Schedule`` for the callables).  ``act_shape`` and ``act_dtype`` are
    one micro-batch's activation between stages; ``replicated`` names the
    leaves every stage holds whole, whose gradients sum over the pipe
    group.  ``stats``, when given, receives ``max_held_inputs``."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r} "
                         f"(expected 'gpipe' or '1f1b')")
    pipe = pipe or PipeContext()
    run = _Schedule(pipe, params, embed, stage_fn, head_fn, labels, count,
                    m, act_shape, act_dtype, replicated)
    tensors = list(params.values())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        loss = _PipelineLoss.apply(run, schedule, *tensors)
    else:
        with torch.no_grad():
            run.leaves(tensors)
            loss = run.gpipe_forward()
    if stats is not None:
        stats["max_held_inputs"] = run.max_held
    return loss
