"""SimCLR and CLIP training, counterpart of the single-device paths and
of the data-parallel SimCLR step of ``ntxent_tpu/training/trainer.py``.

* ``TrainerConfig``: batch, temperature, LARS and schedule settings;
* ``TrainState``: the model (fp32 parameters, BatchNorm statistics), its
  LARS optimizer and the step count (``create_train_state``);
* ``make_train_step``: both views through the model in ONE forward
  (``cat([v1, v2])``, so BatchNorm sees all 2B rows), the NT-Xent loss,
  the backward and the LARS update. ``use_fused=None`` picks the fused
  loss on CUDA tensors (``ops.ntxent.ntxent_loss_fused``, the hand-written
  kernels) and the oracle on the CPU, as the JAX step picks the Pallas
  kernel on a TPU and the oracle elsewhere;
* ``create_clip_train_state`` / ``make_clip_train_step`` (CLIP,
  ``trainer.py:306-370``): both towers, symmetric InfoNCE at the model's
  learnable logit scale and an AdamW update. ``use_fused=None`` picks the
  InfoNCE kernels on CUDA tensors (``ops.infonce.info_nce_fused``) and
  the oracle at temperature ``1 / scale`` on the CPU, as the JAX step
  does;
* ``make_sharded_train_step(group, temperature, loss_impl="strip",
  collective_dtype="float32", ring_chunks=None)`` (``trainer.py:421-
  600``, without the MoE loss): each rank runs both of its local views
  through the model in one forward (BatchNorm statistics across ranks
  once ``models.cross_replica_batch_norm`` gave the model the group), the
  data-parallel loss of ``loss_impl`` (``parallel.dist_loss``:
  ``"strip"``, ``"pair"``, the balanced shard-pair schedule, or
  ``"chunked"``, the ring-overlap schedule in ``ring_chunks`` chunks a
  hop), the backward, the ``pmean`` of the gradients (``_reduce_grads``,
  ``_ef_reduce_rule``) and of the BatchNorm running statistics, and the
  same LARS update on every rank. Each rank differentiates its own copy
  of the psum'd loss, so its gradients are P times its share and their
  pmean is the gradient of the global loss, as under JAX's ``shard_map``;
* ``make_sharded_clip_train_step(group, loss_impl, collective_dtype=)``
  (``trainer.py:625``, without the MoE loss): each rank runs both towers
  on its (images, tokens) shard, the InfoNCE body of ``loss_impl``
  (``"dual"``, ``parallel.dist_loss.local_infonce_dual``: only the text
  embeddings are gathered; ``"twopass"``, ``local_infonce_allgather``:
  both are gathered, each direction walked on its own), the backward,
  one ``pmean`` of every gradient (the logit scale's included) and the
  same AdamW update on every rank. As in the SimCLR step, each rank's
  gradients are P times its share (the psum of the loss and the
  all-gather's reduce-scatter carry the factor), so their pmean is the
  gradient of the global loss, as under JAX's ``shard_map`` with
  ``check_vma=False``;
* the wire (``collective_dtype``, ``trainer.py:378-395``): the loss's
  collectives, forward and backward, and the gradient pmean ride
  ``parallel.precision.collective_precision``; under int8 a state with a
  residual (``init_error_feedback``) reduces its gradients with error
  feedback (``mesh.quantized_grad_reduce_``, each gradient chunked in its
  JAX leaf's order, ``weights.flax_orders``); the running statistics'
  pmean stays float32, and a skipped step keeps the pre-step residual
  (the host guard restores it, the lag-1 guard keeps it in its flat
  buffer); ``measure_comms_overlap`` times the strip against the chunked
  loss (``trainer.py:809-880``);
* ``train_loop``: steps, loss, steps/s, images/s and the data wait every
  ``log_every``; ``stop_fn`` ends the run at a step boundary,
  ``step_hook`` runs after every step, ``watchdog`` (``utils.watchdog.
  StallWatchdog``) is beaten once a step and ``step_guard``
  (``resilience.DivergenceGuard``) sees each step's ``StepOutcome``, one
  step late under ``metrics_lag=1`` (the lag-1 drain); ``timeline``
  (``obs.StepTimeline``, ``trainer.py:995-1160``) records every step's
  data wait, device and hook time, and step 1's FLOPs for the MFU
  (``count_step_flops``);
* ``peak_flops_per_chip`` / ``peak_hbm_bytes_per_chip`` /
  ``estimate_mfu`` (``trainer.py:1376-1408``): the card's bf16 dense peak
  and memory rate by its name;
* ``fit`` (``trainer.py:1167``): checkpoint-aware training over
  ``training.checkpoint``: restore the newest valid step (or
  ``restore_step``, newer steps truncated) with the input pipeline's
  position, train to ``num_steps`` in all, save on the global step every
  ``checkpoint_every`` and at the end or at ``stop_fn``'s stop (through
  ``emergency_save`` under async saves). In a process group of more
  than one rank, rank 0 picks the step every rank restores and alone
  writes, a barrier follows its final save, and the ranks agree on a
  stop (an all-reduce of the flag each step). A ``DivergenceError`` of
  the guard leaves ``fit`` without a final save.

Training resilience (``trainer.py:52-104``, ``:133-138``, ``:202-224``):

* ``guard=True`` (``make_train_step``, ``make_sharded_train_step``): the
  step takes a trailing ``scale`` that multiplies the gradients, computes
  their global norm and ``ok = isfinite(loss) & isfinite(norm)``; a bad
  step applies no update (parameters, the optimizer's state and count,
  the BatchNorm running statistics as they were before it) and still
  advances ``state.step``. Metrics ``grad_norm`` and ``step_ok``. The
  data-parallel step decides on the pmean'd gradients and the global
  loss, so every rank decides alike. Reading ``ok`` is one host sync a
  step (the JAX guard reads its outcome every step too), made after the
  update is queued: the update runs from a snapshot that a bad step puts
  back. The unguarded step adds none. Under ``train_loop(metrics_lag=1)``
  the guarded step reads nothing: ``ok`` selects, on the device, the
  update or the snapshot of every parameter, momentum and running
  statistic, and the optimizer's count advances on the device by
  ``ok`` (``LARS.step_kept``), as the JAX step's in-jit select does;
* ``remat=True`` (all four factories): the whole encoder-and-head
  forward runs under ``torch.utils.checkpoint`` and again in the
  backward, the span ``jax.checkpoint`` wraps; the recompute leaves the
  BatchNorm running statistics alone (``models.layers.
  frozen_running_stats``) and records no collective a second time
  (``mesh.CommsAccounting.paused``), so a step moves them once and
  accounts as the plain step does;
* ``TrainerConfig.accum_steps`` > 1: the optimizer is
  ``accum.MultiSteps`` (``optax.MultiSteps``): each train step is one
  micro-batch, the optimizer steps on the mean of every ``accum_steps``
  (after the gradient pmean on the data-parallel steps); ``state.step``
  and the BatchNorm statistics move every micro-step.

Under ``train_loop(metrics_lag=1)`` with accumulation the micro-step is
decided on the device too (``MultiSteps.step_kept``): every micro-step
runs the inner update, a select keeps it only on the k-th and resets the
accumulator there, and ``ok`` keeps the whole micro-step (accumulator and
counters included) or none of it, as the JAX step's ``MultiSteps`` does
under its in-jit select.

``moe_aux_weight`` > 0 (every factory): that multiple of the switch-MoE
towers' load-balance loss (``parallel.moe.moe_aux_from``) joins the
objective and ``metrics["moe_aux"]`` reports it (``trainer.py:234-300``),
on the guarded, accumulated and lag-1 paths too. On the data-parallel
steps each rank routes its own rows, so the aux term is the per-shard
estimator; the reported loss and aux are their pmean, the optimized
objective. The tensor-parallel and fully-sharded steps are
``parallel.tp`` and ``parallel.fsdp``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import time
import weakref
from collections.abc import Callable

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.layers import BatchNorm, frozen_running_stats
from ..ops import flops as kernel_flops
from ..ops import oracle
from ..ops.infonce import info_nce_fused
from ..ops.ntxent import ntxent_loss_fused
from ..parallel.dist_loss import resolve_local_infonce, resolve_local_ntxent
from ..parallel.mesh import (
    comms_accounting,
    pmean,
    pmean_,
    quantized_grad_reduce_,
)
from ..parallel.moe import moe_aux_from
from ..parallel.mesh import rank as mesh_rank
from ..parallel.precision import collective_precision
from ..weights import flax_orders
from .accum import MultiSteps
from .adamw import AdamW
from .checkpoint import (
    AsyncCheckpointer,
    CheckpointManager,
    gather_ef_residual,
)
from .lars import LARS, cosine_warmup_schedule, exclusion_mask
from .lars import simclr_learning_rate

logger = logging.getLogger(__name__)

__all__ = ["ROADMAP_ITEMS", "StepOutcome", "TrainState", "TrainerConfig",
           "count_step_flops", "create_clip_train_state",
           "create_train_state", "estimate_mfu", "fit",
           "init_error_feedback", "make_clip_train_step",
           "make_sharded_clip_train_step", "make_sharded_train_step",
           "make_train_step", "measure_comms_overlap",
           "peak_flops_per_chip", "peak_hbm_bytes_per_chip", "train_loop"]

# What training does not port yet, by the ROADMAP.md item that will
# (every item of training is ported; the labels stay stable).
ROADMAP_ITEMS: dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class StepOutcome:
    """One completed step as the host sees it, handed to ``train_loop``'s
    ``step_guard`` (``trainer.py:52-74``). ``ok=False``: the guarded step
    found a non-finite loss or gradient norm and applied no update.
    ``grad_norm`` is None for a step built without the guard. ``lag`` is
    how many steps after its dispatch the outcome was read (1 under
    ``train_loop(metrics_lag=1)``)."""

    step: int
    loss: float
    grad_norm: float | None
    ok: bool
    lag: int = 0


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    batch_size: int = 256
    temperature: float = 0.1
    base_lr: float = 0.3
    weight_decay: float = 1e-6
    warmup_steps: int = 100
    total_steps: int = 1000
    # optimizer updates every accum_steps micro-batches (accum.MultiSteps);
    # the negatives stay within each micro-batch
    accum_steps: int = 1

    @property
    def learning_rate(self) -> float:
        return simclr_learning_rate(self.batch_size, self.base_lr)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: LARS | AdamW
    step: int = 0
    # the lag-1 guard's flat snapshot, made at its first step
    kept: _KeptUpdate | None = dataclasses.field(default=None, repr=False,
                                                 compare=False)
    # int8 error feedback: this rank's float32 compression residual of
    # each parameter, in ``model.parameters()`` order (None on any other
    # wire; ``init_error_feedback``)
    ef_residual: list[torch.Tensor] | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # the layout of a tensor-parallel or fully-sharded state
    # (``parallel.shards.Sharding``; None: every tensor whole)
    sharding: object = dataclasses.field(default=None, repr=False,
                                         compare=False)


def create_train_state(model: nn.Module, config: TrainerConfig,
                       device: torch.device) -> TrainState:
    """Model on ``device`` in train mode with SimCLR's LARS: the
    warmup-cosine schedule peaking at ``config.learning_rate`` and the
    BN/bias exclusion mask from the parameters' flax paths."""
    model = model.to(device).train()
    schedule = cosine_warmup_schedule(config.learning_rate,
                                      config.warmup_steps, config.total_steps)
    optimizer = LARS(model.named_parameters(), schedule,
                     weight_decay=config.weight_decay,
                     mask=exclusion_mask(model))
    return TrainState(model=model, optimizer=_accumulating(optimizer,
                                                           config))


def _accumulating(optimizer, config: TrainerConfig):
    """``optimizer`` itself, or ``MultiSteps`` over it when the config
    accumulates (``trainer.py:163-164``)."""
    if config.accum_steps > 1:
        return MultiSteps(optimizer, config.accum_steps)
    return optimizer


def _recompute_contexts():
    """``checkpoint``'s context_fn: nothing around the first forward; the
    recompute in the backward moves no BatchNorm running statistic and
    records no collective."""
    return contextlib.nullcontext(), _recomputing()


@contextlib.contextmanager
def _recomputing():
    with frozen_running_stats(), comms_accounting().paused():
        yield


def _forward(remat: bool, fn: Callable, *inputs):
    """``fn(*inputs)``, under ``torch.utils.checkpoint`` when ``remat``:
    only the inputs are kept, the activations are rebuilt in the
    backward. No RNG state is kept for the recompute: no tower draws
    random numbers in its forward (no dropout)."""
    if not remat:
        return fn(*inputs)
    return checkpoint(fn, *inputs, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=_recompute_contexts)


def apply_two_views(model: nn.Module, v1: torch.Tensor,
                    v2: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """Both views through the model in ONE batched forward (BatchNorm
    statistics are shared across the 2B rows); returns the stacked
    embeddings ``cat([z1, z2])``, (2B, D), the layout NT-Xent takes.
    ``remat`` rematerializes the forward in the backward."""
    return _forward(remat, model, torch.cat([v1, v2], dim=0))


def _running_stats(model: nn.Module) -> list[torch.Tensor]:
    return [b for m in model.modules() if isinstance(m, BatchNorm)
            for b in (m.running_mean, m.running_var)]


def _moved(state: TrainState) -> list[torch.Tensor]:
    """What a step moves besides the optimizer's state: the BatchNorm
    running statistics and the error-feedback residual, which a skipped
    step puts back (``trainer.py:542-544``)."""
    return _running_stats(state.model) + list(state.ef_residual or [])


def init_error_feedback(state: TrainState, group=None) -> TrainState:
    """Give ``state`` a zero error-feedback residual for
    ``collective_dtype="int8"`` (``trainer.py:171-200``): one float32
    zeros tensor a parameter on its device, this rank's slice of the JAX
    ``(P,) + param.shape`` stack (``group``, None: the default group,
    only names the world the checkpoints stack it over). Checkpoints drop
    it unless ``CheckpointManager(save_ef_residual=True)``; a restore
    without one (or from another world size) starts at zeros."""
    del group  # the residual is per rank; its world is the process group's
    state.ef_residual = [torch.zeros_like(p, dtype=torch.float32)
                         for p in state.model.parameters()]
    return state


@torch.no_grad()
def _guarded_update(state: TrainState, loss: torch.Tensor, scale: float,
                    stats_before: list[torch.Tensor]) -> dict:
    """The guard of a step whose gradients are in ``.grad``
    (``trainer.py:77-104``): scale them, take their global norm and
    ``ok``, and step the optimizer whatever ``ok`` is, from a snapshot of
    what the step moves; a bad step puts the snapshot back, and the
    BatchNorm running statistics and the error-feedback residual as
    ``stats_before`` held them.
    ``state.step`` advances either way.

    Reading (loss, norm, ok) is the step's one host sync. On the card the
    three values go to pinned memory behind an event recorded before the
    update is queued, so the host waits for the backward, not for the
    update, which the card runs while the host decides (the JAX step
    selects the update on the device). The metrics are those host
    copies."""
    grads = [p.grad for p in state.model.parameters()]
    torch._foreach_mul_(grads, scale)
    grad_norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads)))
    ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
    values = torch.stack([loss.float(), grad_norm.float(), ok.float()])
    ready = None
    if values.is_cuda:
        host = torch.empty(3, pin_memory=True)
        host.copy_(values, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
    else:
        host = values
    snapshot = state.optimizer.snapshot()
    state.optimizer.step()
    if ready is not None:
        ready.synchronize()
    if not bool(host[2]):
        state.optimizer.restore(snapshot)
        torch._foreach_copy_(_moved(state), stats_before)
    state.step += 1
    return {"loss": host[0].to(loss.dtype), "grad_norm": host[1],
            "step_ok": host[2].bool()}


def _stats_before(state: TrainState) -> list[torch.Tensor]:
    return [b.clone() for b in _moved(state)]


class _KeptUpdate:
    """What a step moves (the parameters, the momentum, under
    accumulation the accumulator and the counters, the BatchNorm running
    statistics), laid out in one flat buffer (each tensor's ``.data``
    becomes a view of it, so every holder of the tensor sees the same
    values), with a flat snapshot beside it: ``save()`` is one copy,
    ``keep_if(ok)`` one ``torch.where``, never arithmetic that lets a NaN
    through (``trainer.py:91-101``). The buffer starts with the ``inner``
    elements of the inner update (parameters, momentum), then the ``acc``
    elements of the accumulator, which ``keep_update_if(emit)`` selects
    as optax's ``MultiSteps`` does."""

    def __init__(self, tensors: list[torch.Tensor], inner: int = 0,
                 acc: int = 0):
        if len({t.data_ptr() for t in tensors}) != len(tensors):
            raise TypeError("the lag-1 guard needs untied tensors")
        with torch.no_grad():
            self.live = torch.cat([t.reshape(-1) for t in tensors])
            for t, view in zip(tensors, self.live.split(
                    [t.numel() for t in tensors])):
                t.data = view.view_as(t)
        self.saved = torch.empty_like(self.live)
        self.inner, self.acc = inner, acc

    @torch.no_grad()
    def save(self) -> None:
        self.saved.copy_(self.live)

    @torch.no_grad()
    def keep_if(self, ok: torch.Tensor) -> None:
        """Each tensor becomes ``ok ? itself : its snapshot``."""
        torch.where(ok, self.live, self.saved, out=self.live)

    @torch.no_grad()
    def keep_update_if(self, emit: torch.Tensor) -> None:
        """The inner update stays only where ``emit``; the accumulator
        becomes zero there (``MultiSteps``' ``cond``, as selects)."""
        inner = self.live[:self.inner]
        torch.where(emit, inner, self.saved[:self.inner], out=inner)
        acc = self.live[self.inner:self.inner + self.acc]
        torch.where(emit, torch.zeros((), dtype=acc.dtype,
                                      device=acc.device), acc, out=acc)


def _kept(state: TrainState) -> _KeptUpdate:
    """The state's flat snapshot, laid out at its first lag-1 step."""
    opt = state.optimizer
    if state.kept is None:
        accum = isinstance(opt, MultiSteps)
        inner = opt.inner if accum else opt
        moved = [*inner.params.values(), *inner.trace.values()]
        acc = list(opt.acc.values()) if accum else []
        tail = _moved(state)
        if accum:
            tail.append(opt.device_counters(moved[0].device))
        tensors = moved + acc + tail
        if len({(t.dtype, t.device) for t in tensors}) != 1:
            raise TypeError("the lag-1 guard snapshots tensors of one dtype "
                            "and device")
        state.kept = _KeptUpdate(tensors,
                                 inner=sum(t.numel() for t in moved),
                                 acc=sum(t.numel() for t in acc))
    return state.kept


@torch.no_grad()
def _kept_update(state: TrainState, loss: torch.Tensor, scale: float,
                 keep: _KeptUpdate) -> dict:
    """The guard of the lag-1 loop (``trainer.py:77-104``): as
    ``_guarded_update`` but decided on the device. The update runs at the
    count on the device (``LARS.step_kept``), and ``keep`` puts back
    what ``keep.save()`` held before the forward where ``ok`` is false.
    Nothing is read on the host; the metrics are device tensors, which
    the loop copies out and reads one step later."""
    grads = [p.grad for p in state.model.parameters()]
    torch._foreach_mul_(grads, scale)
    grad_norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads)))
    ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
    if isinstance(state.optimizer, MultiSteps):
        keep.keep_update_if(state.optimizer.step_kept(ok))
    else:
        state.optimizer.step_kept(ok)
    keep.keep_if(ok)
    state.step += 1
    return {"loss": loss, "grad_norm": grad_norm, "step_ok": ok}


def _guarded(state: TrainState, loss_of: Callable, v1: torch.Tensor,
             v2: torch.Tensor, scale: float, lag: bool) -> dict:
    """A guarded step's metrics, ``loss_of`` run between the snapshot of
    what a bad step puts back and the guard: on the host
    (``_guarded_update``) or, with ``lag``, on the device
    (``_kept_update``)."""
    if lag:
        keep = _kept(state)
        keep.save()
        return _kept_update(state, loss_of(state, v1, v2), scale, keep)
    before = _stats_before(state)
    return _guarded_update(state, loss_of(state, v1, v2), scale, before)


def make_train_step(temperature: float = 0.1, use_fused: bool | None = None,
                    remat: bool = False, moe_aux_weight: float = 0.0,
                    guard: bool = False) -> Callable:
    """``train_step(state, v1, v2) -> (state, {"loss": tensor})``.

    ``use_fused=None`` takes the fused loss on CUDA tensors and the
    oracle on CPU tensors; ``True`` forces the fused loss (on the CPU its
    wrappers run the kernels' plain versions). ``remat`` rematerializes
    the forward in the backward. ``guard=True`` gives ``train_step(state,
    v1, v2, scale=1.0, lag=False)``, the guarded step (``_guarded_update``;
    metrics also ``grad_norm`` and ``step_ok``), for ``train_loop(
    step_guard=resilience.DivergenceGuard(...))``; it reads ``ok`` on the
    host once a step. With ``lag=True`` (``train_loop(metrics_lag=1)``)
    it reads nothing: the update is kept or dropped on the device
    (``_kept_update``) and the metrics stay device tensors.
    ``moe_aux_weight``: see the module docstring."""
    aux = _AuxTerm(moe_aux_weight)

    def loss_of(state: TrainState, v1: torch.Tensor, v2: torch.Tensor):
        fused = use_fused if use_fused is not None \
            else v1.device.type == "cuda"
        loss_fn = ntxent_loss_fused if fused else oracle.ntxent_loss
        state.optimizer.zero_grad()
        loss = aux.add(loss_fn(apply_two_views(state.model, v1, v2, remat),
                               temperature), state.model)
        loss.backward()
        return loss.detach()

    def train_step(state: TrainState, v1: torch.Tensor, v2: torch.Tensor):
        loss = loss_of(state, v1, v2)
        state.optimizer.step()
        state.step += 1
        return state, aux.metrics({"loss": loss})

    def guarded_step(state: TrainState, v1: torch.Tensor, v2: torch.Tensor,
                     scale: float = 1.0, lag: bool = False):
        return state, aux.metrics(_guarded(state, loss_of, v1, v2, scale,
                                           lag))

    return guarded_step if guard else train_step


class _AuxTerm:
    """The MoE load-balance term of a step built with ``moe_aux_weight``:
    ``add`` puts ``weight * moe_aux_from(model)`` into the objective and
    keeps the aux value, ``metrics`` reports it as ``moe_aux``; with a
    ``group`` the reported aux is its pmean over the ranks (each rank
    routes its own rows). Inert at weight 0, as the JAX steps collect
    nothing then."""

    def __init__(self, weight: float, group=None, distributed=False):
        self.weight, self.group = float(weight), group
        self.distributed = distributed
        self.value = None

    @property
    def on(self) -> bool:
        return self.weight > 0.0

    def add(self, loss: torch.Tensor, model: nn.Module) -> torch.Tensor:
        if not self.on:
            return loss
        value = moe_aux_from(model)
        if not torch.is_tensor(value):
            value = torch.zeros((), device=loss.device)
        self.value = value.detach()
        return loss + self.weight * value

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (the loss of a sharded step) averaged over the ranks when
        the aux term makes it rank-varying (``trainer.py:507-517``)."""
        if not (self.on and self.distributed):
            return x
        with torch.no_grad(), collective_precision("float32"):
            return pmean(x.float(), self.group).to(x.dtype)

    def metrics(self, metrics: dict) -> dict:
        if self.on:
            metrics["moe_aux"] = self.mean(self.value)
        return metrics


def _wire_dtype(collective_dtype: str) -> str:
    """The wire policy's name, validated when a step is built (an unknown
    dtype raises here, not at the first collective)."""
    return collective_precision(collective_dtype).dtype


_ORDERS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _flax_orders(model: nn.Module) -> list:
    """``weights.flax_orders`` of ``model``, computed once."""
    if model not in _ORDERS:
        _ORDERS[model] = flax_orders(model)
    return _ORDERS[model]


def _reduce_grads(state: TrainState, group, wire: str) -> None:
    """The gradient pmean under the wire policy (``_ef_reduce_rule``,
    ``trainer.py:378-395``): int8 with a residual rides error feedback
    (``mesh.quantized_grad_reduce_``), any other dtype pmeans under the
    policy (int8 without a residual quantizes without feedback). Under
    int8 each gradient is chunked in its JAX leaf's order, so the scales
    are the JAX step's."""
    grads = [p.grad for p in state.model.parameters()]
    orders = _flax_orders(state.model) if wire == "int8" else None
    if wire == "int8" and state.ef_residual is not None:
        quantized_grad_reduce_(grads, state.ef_residual, group,
                               orders=orders)
        return
    with collective_precision(wire):
        pmean_(grads, group, orders=orders)


def make_sharded_train_step(group=None, temperature: float = 0.1,
                            loss_impl: str = "strip", remat: bool = False,
                            guard: bool = False,
                            collective_dtype: str = "float32",
                            ring_chunks: int | None = None,
                            moe_aux_weight: float = 0.0) -> Callable:
    """``train_step(state, v1, v2) -> (state, {"loss": tensor})`` over the
    ranks of ``group`` (``None``: the default group) with the NT-Xent
    schedule ``loss_impl`` (``"strip"``, ``"pair"`` or ``"chunked"``; an
    unknown name raises here); ``v1``, ``v2`` are this rank's rows of the
    global batch. Every rank returns the global loss and ends with the
    same parameters. ``remat`` and ``guard`` as in ``make_train_step``;
    the guard decides after the gradient and statistics pmeans, on the
    global loss (``trainer.py:524-580``), so a NaN on one rank's rows
    skips the update on every rank.

    ``ring_chunks`` is the chunk count of ``"chunked"``
    (``ops.autotune.resolve_ring_chunks`` when None); with another
    schedule it raises ``ValueError``, as in JAX (``trainer.py:482-486``).
    ``collective_dtype`` (``"float32"``, ``"bf16"``/``"bfloat16"``,
    ``"int8"``) is the wire of the loss's collectives (forward and
    backward) and of the gradient pmean (``_reduce_grads``: error
    feedback when the state carries ``ef_residual``, see
    ``init_error_feedback``); the BatchNorm statistics' pmeans stay
    float32. A skipped step keeps the pre-step residual.
    ``moe_aux_weight``: the per-shard aux estimator (module docstring)."""
    loss_body = resolve_local_ntxent(loss_impl)
    if ring_chunks is not None and loss_impl != "chunked":
        raise ValueError(f"ring_chunks tunes the chunked ring-overlap "
                         f"schedule; loss_impl={loss_impl!r} has no ring "
                         "chunks, it would be silently ignored")
    if loss_impl == "chunked":
        loss_body = functools.partial(loss_body, chunks=ring_chunks)
    wire = _wire_dtype(collective_dtype)
    aux = _AuxTerm(moe_aux_weight, group, distributed=True)

    def loss_of(state: TrainState, v1: torch.Tensor, v2: torch.Tensor):
        state.optimizer.zero_grad()
        with collective_precision(wire):
            z = apply_two_views(state.model, v1, v2, remat)
            n = v1.shape[0]
            loss = aux.add(loss_body(z[:n], z[n:], temperature, group),
                           state.model)
            loss.backward()
        _reduce_grads(state, group, wire)
        pmean_(_running_stats(state.model), group)
        return aux.mean(loss.detach())

    def train_step(state: TrainState, v1: torch.Tensor, v2: torch.Tensor):
        loss = loss_of(state, v1, v2)
        state.optimizer.step()
        state.step += 1
        return state, aux.metrics({"loss": loss})

    def guarded_step(state: TrainState, v1: torch.Tensor, v2: torch.Tensor,
                     scale: float = 1.0, lag: bool = False):
        return state, aux.metrics(_guarded(state, loss_of, v1, v2, scale,
                                           lag))

    return guarded_step if guard else train_step


def create_clip_train_state(model: nn.Module, config: TrainerConfig,
                            device: torch.device) -> TrainState:
    """CLIP model on ``device`` in train mode with the JAX CLI's optimizer:
    ``optax.adamw(cosine_warmup_schedule(base_lr, warmup, steps),
    weight_decay)`` (``cli.py:1255-1257``; no batch scaling of the lr)."""
    model = model.to(device).train()
    schedule = cosine_warmup_schedule(config.base_lr, config.warmup_steps,
                                      config.total_steps)
    optimizer = AdamW(model.named_parameters(), schedule,
                      weight_decay=config.weight_decay)
    return TrainState(model=model, optimizer=_accumulating(optimizer,
                                                           config))


def make_clip_train_step(use_fused: bool | None = None, remat: bool = False,
                         moe_aux_weight: float = 0.0) -> Callable:
    """``train_step(state, images, tokens) -> (state, {"loss": tensor})``.

    ``state.model(images, tokens)`` returns ``(image_embeds, text_embeds,
    scale)`` (``models.clip.CLIPModel``); the loss is symmetric InfoNCE at
    that scale, so the scale's gradient flows. ``use_fused=None`` takes
    the fused loss on CUDA tensors and the oracle at temperature
    ``1 / scale`` on CPU tensors; ``True`` forces the fused loss (on the
    CPU its wrappers run the kernels' plain versions). ``remat``
    rematerializes both towers in the backward (``_clip_towers``,
    ``trainer.py:306-322``). No guard: the JAX CLIP steps carry none.
    ``moe_aux_weight``: see the module docstring."""
    aux = _AuxTerm(moe_aux_weight)

    def train_step(state: TrainState, images: torch.Tensor,
                   tokens: torch.Tensor):
        fused = use_fused if use_fused is not None \
            else images.device.type == "cuda"
        state.optimizer.zero_grad()
        zi, zt, scale = _forward(remat, state.model, images, tokens)
        loss = aux.add(info_nce_fused(zi, zt, scale=scale) if fused
                       else oracle.info_nce_loss(zi, zt,
                                                 temperature=1.0 / scale),
                       state.model)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, aux.metrics({"loss": loss.detach()})

    return train_step


def make_sharded_clip_train_step(group=None, loss_impl: str = "dual",
                                 remat: bool = False,
                                 collective_dtype: str = "float32",
                                 moe_aux_weight: float = 0.0) -> Callable:
    """``train_step(state, images, tokens) -> (state, {"loss": tensor})``
    over the ranks of ``group`` (``None``: the default group); ``images``
    and ``tokens`` are this rank's rows of the global batch. The loss body
    is ``parallel.dist_loss.resolve_local_infonce(loss_impl)``
    (``trainer.py:658``): ``"dual"`` gathers the text embeddings and walks
    the block once for both directions, ``"twopass"`` gathers both
    modalities and walks it once for each. CUDA tensors run the loss
    kernels, CPU tensors their plain versions. Every rank returns the
    global loss and ends with the same parameters. ``remat``
    rematerializes both towers in the backward. ``collective_dtype``: the
    wire of the loss's gathers and of the gradient pmean, with error
    feedback when the state carries ``ef_residual``, as in
    ``make_sharded_train_step`` (``trainer.py:625-700``).
    ``moe_aux_weight``: the per-shard aux estimator, as there."""
    local_loss = resolve_local_infonce(loss_impl)
    wire = _wire_dtype(collective_dtype)
    aux = _AuxTerm(moe_aux_weight, group, distributed=True)

    def train_step(state: TrainState, images: torch.Tensor,
                   tokens: torch.Tensor):
        state.optimizer.zero_grad()
        with collective_precision(wire):
            zi, zt, scale = _forward(remat, state.model, images, tokens)
            loss = aux.add(local_loss(zi, zt, scale, group), state.model)
            loss.backward()
        _reduce_grads(state, group, wire)
        state.optimizer.step()
        state.step += 1
        return state, aux.metrics({"loss": aux.mean(loss.detach())})

    return train_step


def measure_comms_overlap(group, n_local: int, dim: int, *,
                          temperature: float = 0.1,
                          ring_chunks: int | None = None,
                          include_backward: bool = True, repeats: int = 5,
                          warmup: int = 2, seed: int = 0,
                          device=None, timeline=None) -> dict:
    """The A/B of the chunked ring schedule's overlap (``trainer.py:
    809-880``): the strip loss (one all-gather a view) against the
    chunked ring loss over the ranks of ``group`` on unit embeddings of
    ``n_local`` rows a view and width ``dim`` (forward and backward when
    ``include_backward``), each the median of ``repeats`` calls after
    ``warmup``: on CUDA events on the card, on the host clock on the CPU.
    Returns ``{"monolithic_ms", "chunked_ms", "overlap_ms",
    "overlap_frac", "chunks", "backend"}`` with ``overlap_ms =
    max(monolithic - chunked, 0)``. Its collectives are not recorded.
    With ``timeline`` (``obs.StepTimeline``) the result is also published
    (``set_comms_overlap``: the overlap gauges and one ``comms_overlap``
    event).
    """
    from ..ops.autotune import resolve_ring_chunks, time_loss
    from ..parallel.dist_loss import make_sharded_ntxent
    from ..parallel.mesh import world_size

    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend(group) == "nccl" else torch.device("cpu")
    device = torch.device(device)
    gen = torch.Generator().manual_seed(int(seed) + mesh_rank(group))

    def unit():
        z = torch.randn((int(n_local), int(dim)), generator=gen)
        return (z / z.norm(dim=-1, keepdim=True)).to(device) \
            .requires_grad_(include_backward)

    z1, z2 = unit(), unit()
    chunks = resolve_ring_chunks(2 * int(n_local), int(dim),
                                 world_size(group), torch.float32,
                                 chunks=ring_chunks)

    def timed(loss_fn) -> float:
        return time_loss(loss_fn, z1, z2, include_backward, warmup, repeats)

    with comms_accounting().paused():
        mono = timed(make_sharded_ntxent(group, temperature, impl="strip"))
        chunked = timed(make_sharded_ntxent(group, temperature,
                                            impl="chunked",
                                            ring_chunks=chunks))
    overlap = max(mono - chunked, 0.0)
    if timeline is not None:
        timeline.set_comms_overlap(overlap, monolithic_ms=mono,
                                   chunked_ms=chunked, chunks=chunks)
    return {"monolithic_ms": mono, "chunked_ms": chunked,
            "overlap_ms": overlap,
            "overlap_frac": overlap / mono if mono else 0.0,
            "chunks": int(chunks), "backend": device.type}


# (name fragments, bf16 dense FLOP/s, memory bytes/s): NVIDIA's data
# sheets; the SXM card's name says HBM3
_PEAKS = ((("h100", "pcie"), 756e12, 2.0e12),
          (("h100", "hbm3"), 989.4e12, 3.35e12),
          (("h100", "sxm"), 989.4e12, 3.35e12))
# the JAX package's placeholders for an unknown accelerator (the CPU too)
_UNKNOWN_PEAK = (100e12, 819e9)


@functools.cache
def _peaks(name: str) -> tuple[float, float]:
    lowered = name.lower()
    for keys, peak, rate in _PEAKS:
        if all(k in lowered for k in keys):
            return peak, rate
    logger.warning("no peak rates known for %r: MFU and the roofline use "
                   "the placeholders %.3g FLOP/s and %.3g B/s", name,
                   *_UNKNOWN_PEAK)
    return _UNKNOWN_PEAK


def _device_name() -> str:
    return (torch.cuda.get_device_name() if torch.cuda.is_available()
            else "cpu")


def peak_flops_per_chip() -> float:
    """Peak bf16 dense FLOP/s of the card (``trainer.py:1376``): an H100
    SXM (HBM3) 989.4e12, an H100 PCIe 756e12; any other name, the CPU
    included, the JAX package's placeholder 100e12, with a warning."""
    return _peaks(_device_name())[0]


def estimate_mfu(flops_per_step: float, steps_per_sec: float) -> float:
    return flops_per_step * steps_per_sec / peak_flops_per_chip()


def peak_hbm_bytes_per_chip() -> float:
    """Peak memory rate (bytes/s) of the card (``trainer.py:1392``): an
    H100 SXM 3.35e12, an H100 PCIe 2.0e12; otherwise the JAX package's
    placeholder 819e9. With ``peak_flops_per_chip`` it gives a step's
    roofline: below the intensity peak_flops / peak_bytes no tiling
    reaches full MFU."""
    return _peaks(_device_name())[1]


class _StepFlops:
    flops: float | None = None


@contextlib.contextmanager
def count_step_flops():
    """``with count_step_flops() as count:`` one step's FLOPs in
    ``count.flops`` when the block ends, the counterpart of the JAX
    package's XLA cost analysis of the AOT step (``trainer.py:736-763``):
    aten's matmuls and convolutions under
    ``torch.utils.flop_counter.FlopCounterMode`` (2 FLOPs a
    multiply-add, as XLA counts them; backward and ``--remat``'s
    recompute included) plus the hand-written kernels' own tally
    (``ops.flops``: the counter does not see a ``ctypes`` launch). XLA
    also counts element-wise work, which neither does. On a data-parallel
    rank the count is that rank's, per card as JAX's is per chip."""
    from torch.utils.flop_counter import FlopCounterMode

    count = _StepFlops()
    counter = FlopCounterMode(display=False)
    with counter, kernel_flops.counting() as tally:
        yield count
    count.flops = float(counter.get_total_flops()) + tally.flops


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Metrics:
    """A step's metrics on their way to the host: on the card the values
    go to pinned memory behind an event recorded after the step was
    queued, so reading them waits for that step only, not for the steps
    queued after it."""

    def __init__(self, metrics: dict):
        self.keys = [k for k in ("loss", "grad_norm", "step_ok", "moe_aux")
                     if k in metrics]
        values = torch.stack([torch.as_tensor(metrics[k]).float()
                              for k in self.keys])
        self.event = None
        if values.is_cuda:
            self.host = torch.empty(len(self.keys), pin_memory=True)
            self.host.copy_(values, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = values

    def read(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return {k: float(v) for k, v in zip(self.keys, self.host.tolist())}


def _outcome(step: int, values: dict, lag: int) -> StepOutcome:
    return StepOutcome(step=step, loss=values["loss"],
                       grad_norm=values.get("grad_norm"),
                       ok=bool(values.get("step_ok", 1.0)), lag=lag)


def train_loop(state: TrainState, data_iter, train_step: Callable,
               num_steps: int, log_every: int = 50,
               views: int = 2, ranks: int = 1,
               log: bool = True, stop_fn: Callable[[], bool] | None = None,
               step_hook: Callable[[TrainState], None] | None = None,
               watchdog=None, step_guard: Callable | None = None,
               metrics_lag: int = 0, timeline=None,
               flops_per_step: float | str | None = "auto") -> list[dict]:
    """Run ``num_steps`` steps; every ``log_every`` steps (and at the
    last) read the loss and log steps/s and images/s over the window.
    Images are those through the image encoder: ``views`` per row of the
    batch, 2 for SimCLR's two views, 1 for CLIP's (image, text) pairs,
    over all ``ranks`` of a data-parallel run (each holds the same number
    of rows). ``log=False`` keeps the records and logs nothing (every
    rank but 0). ``stop_fn`` is polled before every step and ends the run
    when it returns True; ``step_hook(state)`` runs after every step (the
    checkpoint cadence). Returns one record per log point (under
    ``metrics_lag=1`` a window ends when its last step's outcome is
    read), with the mean ms a step waited for its batch over the window
    (``data_wait_ms``) and, when the data has ``last_timing()`` (a
    prefetching pipeline), the mean host fetch and transfer dispatch ms of
    its batches (``fetch_ms``, ``transfer_ms``), and ``mfu`` once the
    step's FLOPs are known.

    After each step: ``watchdog`` (a started ``StallWatchdog``) is beaten,
    and ``step_guard`` is called with the step's ``StepOutcome`` (it may
    raise ``DivergenceError``, before the step could be saved). A guard
    with ``scale_value()`` hands its scale to the step as a trailing
    argument (a step built with ``guard=True``). Building the outcome
    reads the loss: one host sync a step, for guarded runs only.

    ``timeline`` (``obs.StepTimeline``, ``trainer.py:995-1160``) records
    every step with global step numbers (``state.step``): the data wait
    (split into host fetch and transfer with ``last_timing()``), the
    device time, the hook's time, the loss and the guard's outcome. On
    the synchronous path the device time is a ``torch.cuda.synchronize``
    bracket, one host sync a step paid only with a timeline (the JAX
    loop's ``block_until_ready``); under ``metrics_lag=1`` it is dispatch
    to ready, read on the drained step's own event: no sync is added.
    With a timeline step 1 is the counted one: the comms accounting delta
    around it goes to ``set_comms_per_step`` and, with
    ``flops_per_step="auto"``, its FLOPs are counted
    (``count_step_flops``), the card synchronized after it, and the
    ``compile`` event records its wall time: the port's first run (the
    kernel libraries loaded, cuBLAS's heuristics, the allocator warmed),
    which stands where the JAX loop's AOT compile does. A float
    ``flops_per_step`` is taken as given, None disables the MFU. Without
    a timeline nothing is counted and nothing synchronized.

    ``metrics_lag=1`` (``trainer.py:944-971``): step N-1's outcome is read
    after step N is queued, so the host does not wait for the card
    between steps. The guarded step then keeps a bad update out on the
    device (``lag=True``). ``step_guard`` sees every outcome one step
    late, never missed (the last is always drained, so a non-finite last
    step still raises); a guard's new scale reaches the steps up to two
    steps late; ``step_hook`` for step N runs after step N-1's outcome
    was read."""
    if metrics_lag not in (0, 1):
        raise ValueError(f"metrics_lag must be 0 or 1, got {metrics_lag}")
    history = []
    use_scale = step_guard is not None and hasattr(step_guard,
                                                   "scale_value")
    lag_kwargs = {"lag": True} if metrics_lag and use_scale else {}
    device = next(state.model.parameters()).device
    _sync(device)
    window = dict(start=time.perf_counter(), done=0, wait=0.0, fetch=0.0,
                  transfer=0.0, timed=0)
    rows, done = 0, 0
    comms_mark, count_flops = None, False
    if timeline is not None:
        timeline.new_attempt()  # a restart's gap is no step time
        comms_mark = comms_accounting().totals()
        count_flops = flops_per_step == "auto"
        timeline.set_flops_per_step(
            None if count_flops or flops_per_step is None
            else float(flops_per_step))
    step_flops = (None if flops_per_step in ("auto", None)
                  else float(flops_per_step))

    def check(step: int, metrics, wait: float, timing) -> dict | None:
        """A completed step (``wait``: s it waited for its batch,
        ``timing``: the data's ``last_timing()``): beat the watchdog, show
        the guard its outcome; returns the host values read, if any."""
        nonlocal done
        done += 1
        window["done"] += 1
        window["wait"] += wait
        if timing is not None:
            window["fetch"] += timing[0]
            window["transfer"] += timing[1]
            window["timed"] += 1
        if watchdog is not None:
            watchdog.beat()
        values = metrics.read() if isinstance(metrics, _Metrics) else None
        if step_guard is not None:
            if values is None:
                values = _Metrics(metrics).read()
            step_guard(_outcome(step, values, metrics_lag))
        return values

    def observe(step: int, values: dict, wait: float, timing,
                device_s: float, hook_s: float) -> None:
        """The timeline's record of a completed step."""
        ok = values.get("step_ok")
        timeline.record_step(
            step=step, loss=values["loss"], data_wait_s=wait,
            device_s=device_s, hook_s=hook_s,
            host_fetch_s=timing[0] if timing is not None else None,
            transfer_s=timing[1] if timing is not None else None,
            ok=None if ok is None else bool(ok),
            grad_norm=values.get("grad_norm"))

    def record(step: int, metrics, values, force: bool = False) -> None:
        if not (done % log_every == 0 or done == num_steps or force):
            return
        loss = (values["loss"] if values is not None
                else float(metrics["loss"]))  # synchronizes with the device
        now = time.perf_counter()
        sps = window["done"] / (now - window["start"])
        entry = {"step": step, "loss": loss, "steps_per_sec": sps,
                 "images_per_sec": sps * views * rows * ranks,
                 "data_wait_ms": window["wait"] * 1e3 / window["done"]}
        aux = (values.get("moe_aux") if values is not None
               else metrics.get("moe_aux"))
        if aux is not None:
            entry["moe_aux"] = float(aux)
        if window["timed"]:
            entry["fetch_ms"] = window["fetch"] * 1e3 / window["timed"]
            entry["transfer_ms"] = window["transfer"] * 1e3 / window["timed"]
        if step_flops:
            entry["mfu"] = estimate_mfu(step_flops, sps)
        history.append(entry)
        if log:
            logger.info("step %d loss %.4f (%.2f steps/s, %.1f "
                        "images/s)", step, loss, sps,
                        entry["images_per_sec"])
        window.update(start=now, done=0, wait=0.0, fetch=0.0, transfer=0.0,
                      timed=0)

    def drain(pending, force: bool = False) -> None:
        """Lag-1: read a queued step's outcome; its device time runs from
        its dispatch to the moment its metrics were ready."""
        step, metrics, wait, timing, t_dispatch, hook_s = pending
        values = check(step, metrics, wait, timing)
        if timeline is not None:
            observe(step, values, wait, timing,
                    time.perf_counter() - t_dispatch, hook_s)
        record(step, metrics, values, force)

    def run(v1, v2):
        if use_scale:
            return train_step(state, v1, v2, step_guard.scale_value(),
                              **lag_kwargs)
        return train_step(state, v1, v2)

    pending = None  # lag-1: a queued step, for drain()
    for _ in range(num_steps):
        if stop_fn is not None and stop_fn():
            if pending is not None:
                drain(pending, force=True)
                pending = None
            if log:
                logger.warning("stop requested: ending the run at step %d",
                               state.step)
            break
        t_fetch = time.perf_counter()
        v1, v2 = next(data_iter)
        wait = time.perf_counter() - t_fetch
        timing = (data_iter.last_timing()
                  if hasattr(data_iter, "last_timing") else None)
        rows = v1.shape[0]
        t_step = time.perf_counter()
        if count_flops:
            # step 1 with a timeline: its FLOPs, then its wall time as the
            # compile event (the card synchronized once)
            count_flops = False
            with count_step_flops() as counted:
                state, metrics = run(v1, v2)
            _sync(device)
            step_flops = counted.flops
            timeline.set_flops_per_step(step_flops)
            timeline.record_compile((time.perf_counter() - t_step) * 1e3,
                                    step_flops)
            if log:
                logger.info("counted step cost: %.3e FLOPs a card",
                            step_flops)
        else:
            state, metrics = run(v1, v2)
        if comms_mark is not None:
            timeline.set_comms_per_step(
                comms_accounting().delta(comms_mark))
            comms_mark = None
        if metrics_lag:
            queued = (state.step, _Metrics(metrics), wait, timing, t_step)
            if pending is not None:
                drain(pending)  # step N-1's outcome, step N queued
            t_hook = time.perf_counter()
            if step_hook is not None:
                step_hook(state)
            pending = queued + (time.perf_counter() - t_hook,)
            continue
        if timeline is not None:
            _sync(device)  # the device bracket: with a timeline only
        device_s = time.perf_counter() - t_step
        values = check(state.step, metrics, wait, timing)
        t_hook = time.perf_counter()
        if step_hook is not None:
            step_hook(state)
        if timeline is not None:
            values = values or _Metrics(metrics).read()
            observe(state.step, values, wait, timing, device_s,
                    time.perf_counter() - t_hook)
        record(state.step, metrics, values)
    if pending is not None:
        drain(pending, force=True)  # the last outcome is always read
    return history


def _agreed_stop(stop_fn: Callable[[], bool], group,
                 device: torch.device) -> Callable[[], bool]:
    """``stop_fn`` agreed across the ranks of ``group``: True on every
    rank once it is True on any (a MAX all-reduce of the flag), so every
    rank stops after the same step."""
    flag = torch.zeros(1, device=device)

    def agreed() -> bool:
        flag.fill_(1.0 if stop_fn() else 0.0)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return bool(flag.item())

    return agreed


def _restore(manager, state: TrainState, restore_step: int | None,
             group, distributed: bool):
    """Restore into ``state`` the step ``fit`` resumes from; returns the
    data state (or None) and whether a step was restored. Rank 0 chooses
    (the newest valid step, or ``restore_step``) and every other rank
    restores the step it chose; a restore that fails on rank 0 fails on
    every rank, so no rank waits on the others."""
    step, data_state, error = restore_step, None, None
    if mesh_rank(group) == 0:
        try:
            if restore_step is not None or manager.latest_step() is not None:
                state, data_state = manager.restore_with_data_state(
                    state, restore_step)
                step = state.step
            else:
                step = None
        except Exception as e:  # told to the other ranks, then raised
            error = e
    if distributed:
        box = [step, None if error is None else f"{type(error).__name__}: "
                                                f"{error}"]
        dist.broadcast_object_list(box, src=0, group=group)
        step, failed = box
        if error is None and failed is not None:
            raise RuntimeError(f"rank 0 could not restore: {failed}")
        if error is None and mesh_rank(group) != 0 and step is not None:
            state, data_state = manager.restore_with_data_state(state, step)
    if error is not None:
        raise error
    return data_state, step is not None


def fit(state: TrainState, data_iter, train_step: Callable, num_steps: int,
        checkpoint_dir: str | None = None, checkpoint_every: int = 500,
        log_every: int = 50, stop_fn: Callable[[], bool] | None = None,
        checkpoint_retry_policy=None, checkpoint_verify_writes: bool = True,
        async_checkpointing: bool = False,
        checkpoint_keep_last: int | None = 3,
        checkpoint_keep_every: int | None = None,
        checkpoint_mirror: str | None = None,
        restore_step: int | None = None, views: int = 2, ranks: int = 1,
        log: bool = True, group=None, checkpoint_stats: dict | None = None,
        watchdog=None, step_guard: Callable | None = None,
        checkpoint_fault_hook: Callable | None = None,
        metrics_lag: int = 0, checkpoint_save_ef: bool = False,
        timeline=None):
    """Checkpoint-aware training (``trainer.py:1167``): restore the newest
    valid checkpoint of ``checkpoint_dir`` if there is one, train to
    ``num_steps`` steps IN ALL, save every ``checkpoint_every`` global
    steps and at the end. Returns ``(state, history)``.

    ``restore_step`` pins the resume point to that step (a step no
    replica holds raises) and deletes the steps after it in both
    replicas: the replay owns the timeline. It needs ``checkpoint_dir``.
    When ``data_iter`` has ``state()`` and ``restore()``, its position is
    saved in each step and restored with it. ``stop_fn`` (a
    ``PreemptionGuard``'s ``requested``) ends the run at a step boundary;
    the stopped step is then saved, through ``emergency_save`` under
    ``async_checkpointing`` (the writer drains and the step is written
    before ``fit`` returns). ``checkpoint_keep_last`` /
    ``checkpoint_keep_every`` / ``checkpoint_mirror`` /
    ``checkpoint_verify_writes`` / ``checkpoint_retry_policy`` configure
    the ``CheckpointManager``; ``views``, ``ranks`` and ``log`` are
    ``train_loop``'s. In a process group of more than one rank (``group``,
    None: the default one) rank 0 chooses the step every rank restores
    and alone writes; a barrier follows the final save.
    ``checkpoint_stats`` (a dict) receives the manager's ``stats`` when
    ``fit`` returns: save and restore ms, the state's bytes and, under
    async saves, the ms each save held the loop. ``watchdog`` and
    ``step_guard`` go to ``train_loop``; a ``DivergenceError`` leaves
    ``fit`` without the final save (the diverged state must not become
    the newest step). ``checkpoint_fault_hook`` runs at the start of each
    physical write (the chaos plan's ``diskfull@n``). ``metrics_lag`` and
    ``timeline`` go to ``train_loop``. A sharded state
    (``state.sharding``: tensor parallelism, ZeRO-3) is saved and restored
    as its whole copy (``Sharding.gather`` / ``scatter``, collectives of
    every rank), so its steps are in the single-card format, which either
    package and either layout resumes. ``checkpoint_save_ef`` keeps the
    error-feedback residual in each step
    (``CheckpointManager(save_ef_residual=True)``); in a world of several
    ranks rank 0's decision to save is then broadcast and every rank's
    residual gathered to it before the save.
    """
    if restore_step is not None and checkpoint_dir is None:
        raise ValueError(f"restore_step={restore_step} requires "
                         "checkpoint_dir (there is no store to restore the "
                         "named step from)")
    distributed = dist.is_initialized() and dist.get_world_size(group) > 1
    device = next(state.model.parameters()).device
    if distributed and stop_fn is not None:
        stop_fn = _agreed_stop(stop_fn, group, device)
    stateful = hasattr(data_iter, "state") and hasattr(data_iter, "restore")
    manager = None
    try:
        if checkpoint_dir is not None:
            manager = CheckpointManager(
                checkpoint_dir, save_interval_steps=checkpoint_every,
                retry_policy=checkpoint_retry_policy,
                verify_writes=checkpoint_verify_writes,
                max_to_keep=checkpoint_keep_last,
                keep_every=checkpoint_keep_every,
                mirror_dir=checkpoint_mirror,
                fault_hook=checkpoint_fault_hook,
                save_ef_residual=checkpoint_save_ef)
            if async_checkpointing:
                manager = AsyncCheckpointer(manager)
            if state.sharding is None:
                data_state, restored = _restore(manager, state, restore_step,
                                                group, distributed)
            else:
                # a sharded state resumes through a whole copy: every rank
                # gathers, restores the step rank 0 chose and takes its
                # slices back
                whole = state.sharding.gather(state)
                data_state, restored = _restore(manager, whole, restore_step,
                                                group, distributed)
                if restored:
                    state.sharding.scatter(whole, state)
            if restored:
                if log:
                    logger.info("resumed from checkpoint at step %d%s",
                                state.step, " (explicit --restore-step)"
                                if restore_step is not None else "")
                if restore_step is not None and mesh_rank(group) == 0:
                    stale = manager.truncate_after(state.step)
                    if stale:
                        logger.warning("restore_step=%d: deleted %d newer "
                                       "checkpoint step(s) %s; the replay "
                                       "owns the timeline from here",
                                       restore_step, len(stale), stale)
                if stateful and data_state is not None:
                    data_iter.restore(data_state)
                    if log:
                        logger.info("data iterator repositioned: %s",
                                    data_state)
        done = state.step
        remaining = num_steps - done
        if remaining <= 0:
            if log:
                logger.info("nothing to do: checkpoint already at step %d",
                            done)
            return state, []

        gather_ef = (distributed and checkpoint_save_ef
                     and state.ef_residual is not None)
        sharded = state.sharding is not None

        def residual(s: TrainState, want: bool):
            """(rank 0's decision, ``{"ef_residual": every rank's
            residual}`` for the save, or nothing): the gather is a
            collective, so under ``gather_ef`` (and for a sharded state,
            whose whole copy is gathered) every rank takes rank 0's
            decision."""
            if not (gather_ef or (sharded and distributed)):
                return want, {}
            flag = torch.tensor([float(want)], device=device)
            dist.broadcast(flag, src=0, group=group)
            want = bool(flag.item())
            return want, ({"ef_residual": gather_ef_residual(s, group)}
                          if want and gather_ef else {})

        def saved(s: TrainState) -> TrainState:
            """What a save writes: the state, or the whole copy of a
            sharded one (the single-card format)."""
            return s.sharding.gather(s) if sharded else s

        def step_hook(s: TrainState) -> None:
            if manager is None:
                return
            want, ef = residual(s, manager.should_save(s.step))
            if want:
                manager.save(s.step, saved(s), data_state=data_iter.state()
                             if stateful else None, **ef)

        history = train_loop(state, data_iter, train_step, remaining,
                             log_every=log_every, views=views, ranks=ranks,
                             log=log, stop_fn=stop_fn, step_hook=step_hook,
                             watchdog=watchdog, step_guard=step_guard,
                             metrics_lag=metrics_lag, timeline=timeline)
        if manager is not None:
            stopped = state.step - done < remaining
            manager.wait_until_finished()
            want, ef = residual(state, manager.latest_step() != state.step)
            if want:
                data_state = data_iter.state() if stateful else None
                if async_checkpointing and stopped:
                    manager.emergency_save(state.step, saved(state),
                                           data_state=data_state, **ef)
                else:
                    manager.save(state.step, saved(state), force=True,
                                 data_state=data_state, **ef)
            if distributed:
                dist.barrier(group)
        return state, history
    finally:
        if manager is not None:
            manager.wait_until_finished()
            manager.close()
            if checkpoint_stats is not None:
                if async_checkpointing:
                    checkpoint_stats.update(manager.stats)
                    manager = manager.manager
                checkpoint_stats.update(manager.stats)
