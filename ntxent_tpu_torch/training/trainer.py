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
* ``make_sharded_train_step(group, temperature)`` (``trainer.py:425``,
  without the guard, the int8/bf16 wire or the MoE loss): each rank runs
  both of its local views through the model in one forward (BatchNorm
  statistics across ranks once ``models.cross_replica_batch_norm`` gave
  the model the group), the strip loss (``parallel.dist_loss``), the
  backward, the ``pmean`` of the gradients (``_ef_reduce_rule``) and of
  the BatchNorm running statistics, and the same LARS update on every
  rank. Each rank differentiates its own copy of the psum'd loss, so its
  gradients are P times its share and their pmean is the gradient of the
  global loss, as under JAX's ``shard_map``;
* ``make_sharded_clip_train_step(group)`` (``trainer.py:625``, the
  float32 wire, without remat or the MoE loss): each rank runs both towers
  on its (images, tokens) shard, the dual InfoNCE
  (``parallel.dist_loss.local_infonce_dual``: only the text embeddings
  are gathered), the backward, one ``pmean`` of every gradient (the logit
  scale's included) and the same AdamW update on every rank. As in the
  SimCLR step, each rank's gradients are P times its share (the psum of
  the loss and the all-gather's reduce-scatter carry the factor), so their
  pmean is the gradient of the global loss, as under JAX's ``shard_map``
  with ``check_vma=False``;
* ``train_loop``: steps, loss, steps/s and images/s every ``log_every``.

Not in this slice (``make_train_step`` raises ``NotImplementedError``
naming the ROADMAP.md item, and ``cli`` exits on the flags): the
divergence guard, rematerialization, the MoE auxiliary loss, gradient
accumulation, checkpoints. ``ROADMAP_ITEMS`` names every such item.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections.abc import Callable

import torch
from torch import nn

from ..models.layers import BatchNorm
from ..ops import oracle
from ..ops.infonce import info_nce_fused
from ..ops.ntxent import ntxent_loss_fused
from ..parallel.dist_loss import local_infonce_dual, local_ntxent_allgather
from ..parallel.mesh import pmean_
from .adamw import AdamW
from .lars import LARS, cosine_warmup_schedule, exclusion_mask
from .lars import simclr_learning_rate

logger = logging.getLogger(__name__)

__all__ = ["ROADMAP_ITEMS", "TrainState", "TrainerConfig",
           "create_clip_train_state", "create_train_state",
           "make_clip_train_step", "make_sharded_clip_train_step",
           "make_sharded_train_step", "make_train_step", "train_loop"]

# What training does not port yet, by the ROADMAP.md item that will.
ROADMAP_ITEMS = {
    "stem": "ROADMAP.md Queue A 6(b) (the space-to-depth ResNet stem)",
    "wire": "ROADMAP.md Queue A 3(e) (quantized collectives: "
            "--collective-dtype bf16/int8 with error feedback)",
    "resilience": "ROADMAP.md Queue A 7 (checkpoints and training "
                  "resilience)",
    "data": "ROADMAP.md Queue A 7 (datasets beyond --dataset synthetic)",
    "mp": "ROADMAP.md Queue A 9 (model parallelism and MoE)",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: "
                               f"{ROADMAP_ITEMS[item]}")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    batch_size: int = 256
    temperature: float = 0.1
    base_lr: float = 0.3
    weight_decay: float = 1e-6
    warmup_steps: int = 100
    total_steps: int = 1000

    @property
    def learning_rate(self) -> float:
        return simclr_learning_rate(self.batch_size, self.base_lr)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: LARS | AdamW
    step: int = 0


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
    return TrainState(model=model, optimizer=optimizer)


def apply_two_views(model: nn.Module, v1: torch.Tensor,
                    v2: torch.Tensor) -> torch.Tensor:
    """Both views through the model in ONE batched forward (BatchNorm
    statistics are shared across the 2B rows); returns the stacked
    embeddings ``cat([z1, z2])``, (2B, D), the layout NT-Xent takes."""
    return model(torch.cat([v1, v2], dim=0))


def make_train_step(temperature: float = 0.1, use_fused: bool | None = None,
                    remat: bool = False, moe_aux_weight: float = 0.0,
                    guard: bool = False) -> Callable:
    """``train_step(state, v1, v2) -> (state, {"loss": tensor})``.

    ``use_fused=None`` takes the fused loss on CUDA tensors and the
    oracle on CPU tensors; ``True`` forces the fused loss (on the CPU its
    wrappers run the kernels' plain versions)."""
    if remat:
        raise _not_ported("rematerialization (remat=True)", "resilience")
    if guard:
        raise _not_ported("the divergence guard (guard=True)", "resilience")
    if moe_aux_weight > 0.0:
        raise _not_ported("the MoE auxiliary loss", "mp")

    def train_step(state: TrainState, v1: torch.Tensor, v2: torch.Tensor):
        fused = use_fused if use_fused is not None \
            else v1.device.type == "cuda"
        loss_fn = ntxent_loss_fused if fused else oracle.ntxent_loss
        state.optimizer.zero_grad()
        loss = loss_fn(apply_two_views(state.model, v1, v2), temperature)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return train_step


def make_sharded_train_step(group=None,
                            temperature: float = 0.1) -> Callable:
    """``train_step(state, v1, v2) -> (state, {"loss": tensor})`` over the
    ranks of ``group`` (``None``: the default group) with the strip loss;
    ``v1``, ``v2`` are this rank's rows of the global batch. Every rank
    returns the global loss and ends with the same parameters."""

    def train_step(state: TrainState, v1: torch.Tensor, v2: torch.Tensor):
        state.optimizer.zero_grad()
        z = apply_two_views(state.model, v1, v2)
        n = v1.shape[0]
        loss = local_ntxent_allgather(z[:n], z[n:], temperature, group)
        loss.backward()
        pmean_([p.grad for p in state.model.parameters()], group)
        pmean_([b for m in state.model.modules() if isinstance(m, BatchNorm)
                for b in (m.running_mean, m.running_var)], group)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return train_step


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
    return TrainState(model=model, optimizer=optimizer)


def make_clip_train_step(use_fused: bool | None = None, remat: bool = False,
                         moe_aux_weight: float = 0.0) -> Callable:
    """``train_step(state, images, tokens) -> (state, {"loss": tensor})``.

    ``state.model(images, tokens)`` returns ``(image_embeds, text_embeds,
    scale)`` (``models.clip.CLIPModel``); the loss is symmetric InfoNCE at
    that scale, so the scale's gradient flows. ``use_fused=None`` takes
    the fused loss on CUDA tensors and the oracle at temperature
    ``1 / scale`` on CPU tensors; ``True`` forces the fused loss (on the
    CPU its wrappers run the kernels' plain versions)."""
    if remat:
        raise _not_ported("rematerialization (remat=True)", "resilience")
    if moe_aux_weight > 0.0:
        raise _not_ported("the MoE auxiliary loss", "mp")

    def train_step(state: TrainState, images: torch.Tensor,
                   tokens: torch.Tensor):
        fused = use_fused if use_fused is not None \
            else images.device.type == "cuda"
        state.optimizer.zero_grad()
        zi, zt, scale = state.model(images, tokens)
        loss = (info_nce_fused(zi, zt, scale=scale) if fused
                else oracle.info_nce_loss(zi, zt, temperature=1.0 / scale))
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return train_step


def make_sharded_clip_train_step(group=None) -> Callable:
    """``train_step(state, images, tokens) -> (state, {"loss": tensor})``
    over the ranks of ``group`` (``None``: the default group) with the
    dual InfoNCE; ``images`` and ``tokens`` are this rank's rows of the
    global batch. CUDA tensors run the loss kernels, CPU tensors their
    plain versions. Every rank returns the global loss and ends with the
    same parameters."""

    def train_step(state: TrainState, images: torch.Tensor,
                   tokens: torch.Tensor):
        state.optimizer.zero_grad()
        zi, zt, scale = state.model(images, tokens)
        loss = local_infonce_dual(zi, zt, scale, group)
        loss.backward()
        pmean_([p.grad for p in state.model.parameters()], group)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return train_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(state: TrainState, data_iter, train_step: Callable,
               num_steps: int, log_every: int = 50,
               views: int = 2, ranks: int = 1,
               log: bool = True) -> list[dict]:
    """Run ``num_steps`` steps; every ``log_every`` steps (and at the
    last) read the loss and log steps/s and images/s over the window.
    Images are those through the image encoder: ``views`` per row of the
    batch, 2 for SimCLR's two views, 1 for CLIP's (image, text) pairs,
    over all ``ranks`` of a data-parallel run (each holds the same number
    of rows). ``log=False`` keeps the records and logs nothing (every
    rank but 0). Returns one record per log point."""
    history = []
    device = next(state.model.parameters()).device
    _sync(device)
    last_t, last_step = time.perf_counter(), 0
    for i in range(num_steps):
        v1, v2 = next(data_iter)
        state, metrics = train_step(state, v1, v2)
        if (i + 1) % log_every == 0 or i + 1 == num_steps:
            loss = float(metrics["loss"])  # synchronizes with the device
            now = time.perf_counter()
            steps = i + 1 - last_step
            sps = steps / (now - last_t)
            entry = {"step": state.step, "loss": loss, "steps_per_sec": sps,
                     "images_per_sec": sps * views * v1.shape[0] * ranks}
            history.append(entry)
            if log:
                logger.info("step %d loss %.4f (%.2f steps/s, %.1f "
                            "images/s)", entry["step"], loss, sps,
                            entry["images_per_sec"])
            last_t, last_step = now, i + 1
    return history
