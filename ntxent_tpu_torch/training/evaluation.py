"""SSL evaluation, counterpart of ``ntxent_tpu/training/evaluation.py``:
the frozen-feature linear probe, weighted kNN and end-to-end fine-tuning
(SimCLR's three protocols), in plain PyTorch. The kernels they reach are
those of the encoder's forward (and, fine-tuning, its backward).

* ``extract_features``: the encoder in batches of one shape (the tail
  padded, its rows dropped after);
* ``linear_probe``: features standardized by the train split's
  statistics, a linear classifier trained by full-batch AdamW (optax's
  ``adamw(lr, weight_decay)``: decay on every leaf) for ``steps`` steps
  from N(0, 0.01^2) weights and zero biases;
* ``finetune``: a fresh linear head on the encoder, every weight trained
  by AdamW with decay on the kernels alone (``_decay_mask``,
  ``evaluation.py:150``: a parameter whose flax leaf is ``kernel``, and
  the head's matrix), BatchNorm in train mode, on minibatches drawn with
  replacement; accuracies with the running statistics;
* ``knn_accuracy``: cosine similarity, ``exp(s / T)``-weighted votes of
  the ``k`` nearest train features (``k`` clamped to the train split;
  among equal similarities the lower index is nearer, as ``lax.top_k``
  orders them).

A ``torch.Generator`` replaces the JAX keys; ``init`` (and ``indices``)
take the JAX package's draws where a test needs them.
"""

from __future__ import annotations

import copy
from collections.abc import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..weights import flax_paths

__all__ = ["extract_features", "finetune", "knn_accuracy", "linear_probe"]


def _batches(images, batch_size: int, device):
    """(batch on ``device`` padded to ``batch_size`` rows, real rows)."""
    images = torch.as_tensor(images)
    for start in range(0, images.shape[0], batch_size):
        batch = images[start:start + batch_size].to(device)
        rows = batch.shape[0]
        if rows < batch_size:
            pad = batch.new_zeros((batch_size - rows, *batch.shape[1:]))
            batch = torch.cat([batch, pad])
        yield batch, rows


@torch.no_grad()
def extract_features(apply_features: Callable, images, batch_size: int = 256,
                     device=None) -> torch.Tensor:
    """``apply_features(x) -> (B, F)`` over ``images`` (an array or a
    tensor, moved batch by batch to ``device``, by default the one it is
    on), in batches of ``batch_size`` rows; the tail batch padded to the
    same shape and its padding sliced off."""
    device = torch.as_tensor(images).device if device is None else device
    outs = [apply_features(batch)[:rows]
            for batch, rows in _batches(images, batch_size, device)]
    return torch.cat(outs)


def _adamw(params, lr: float, weight_decay: float) -> torch.optim.AdamW:
    """optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8): the decoupled decay
    ``lr * wd * p`` beside Adam's step."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def linear_probe(train_feats: torch.Tensor, train_labels: torch.Tensor,
                 test_feats: torch.Tensor, test_labels: torch.Tensor,
                 num_classes: int, steps: int = 500,
                 learning_rate: float = 1e-2, weight_decay: float = 1e-4,
                 generator: torch.Generator | None = None,
                 init: tuple | None = None) -> dict:
    """Train a linear classifier on frozen features; returns the train and
    test accuracies and the loss of the last step. ``init`` = (w, b)
    replaces the N(0, 0.01^2) draw from ``generator``."""
    train_feats, test_feats = train_feats.float(), test_feats.float()
    mu = train_feats.mean(0, keepdim=True)
    sd = train_feats.std(0, keepdim=True, unbiased=False) + 1e-6
    xtr, xte = (train_feats - mu) / sd, (test_feats - mu) / sd
    device = xtr.device
    if init is None:
        w = torch.randn(xtr.shape[-1], num_classes, generator=generator) \
            * 0.01
        b = torch.zeros(num_classes)
    else:
        w, b = (torch.as_tensor(t, dtype=torch.float32) for t in init)
    w = w.to(device).requires_grad_()
    b = b.to(device).requires_grad_()
    ytr = torch.as_tensor(train_labels, device=device).long()
    yte = torch.as_tensor(test_labels, device=device).long()
    opt = _adamw([w, b], learning_rate, weight_decay)
    loss = torch.zeros(())
    for _ in range(steps):
        opt.zero_grad()
        loss = F.cross_entropy(xtr @ w + b, ytr)
        loss.backward()
        opt.step()

    @torch.no_grad()
    def acc(x, y) -> float:
        return float(((x @ w + b).argmax(-1) == y).float().mean())

    return {"train_accuracy": acc(xtr, ytr), "test_accuracy": acc(xte, yte),
            "final_loss": float(loss.detach())}


def _decays(model: nn.Module) -> dict[str, bool]:
    """``_decay_mask``: True for the parameters whose flax leaf is
    ``kernel``."""
    return {name: path[-1] == "kernel"
            for name, path in flax_paths(model).items()}


def finetune(model: nn.Module, train_images, train_labels, test_images,
             test_labels, num_classes: int, steps: int = 200,
             batch_size: int = 64, learning_rate: float = 1e-3,
             generator: torch.Generator | None = None,
             init: tuple | None = None, indices=None) -> dict:
    """Attach a fresh linear head to a copy of ``model`` (with a
    ``features`` method; the caller's model is left as it was) and train
    every weight on minibatches of the train split, then report top-1
    with the BatchNorm running statistics. The head is drawn from
    ``generator`` (or ``init`` = (w, b)), then the (steps, min(batch, n))
    minibatch indices, with replacement (or ``indices``). Images are
    moved to the model's device batch by batch."""
    model = copy.deepcopy(model)
    device = next(model.parameters()).device
    train_images = torch.as_tensor(train_images)
    ytr = torch.as_tensor(train_labels).long()
    n = train_images.shape[0]
    with torch.no_grad():
        model.eval()
        feat_dim = model.features(train_images[:1].to(device)).shape[-1]
    if init is None:
        w = torch.randn(feat_dim, num_classes, generator=generator) * 0.01
        b = torch.zeros(num_classes)
    else:
        w, b = (torch.as_tensor(t, dtype=torch.float32) for t in init)
    w = w.to(device).requires_grad_()
    b = b.to(device).requires_grad_()
    if indices is None:
        indices = torch.randint(0, n, (steps, min(batch_size, n)),
                                generator=generator)
    indices = torch.as_tensor(np.array(indices, dtype=np.int64))
    decays = _decays(model)
    named = dict(model.named_parameters())
    groups = [{"params": [named[k] for k in named if decays[k]] + [w],
               "weight_decay": 1e-4},
              {"params": [named[k] for k in named if not decays[k]] + [b],
               "weight_decay": 0.0}]
    opt = _adamw(groups, learning_rate, 1e-4)
    model.train()
    loss = torch.zeros(())
    for idx in indices:
        x = train_images[idx].to(device)
        opt.zero_grad()
        loss = F.cross_entropy(model.features(x).float() @ w + b,
                               ytr[idx].to(device))
        loss.backward()
        opt.step()
    model.eval()

    @torch.no_grad()
    def acc(images, labels) -> float:
        labels = torch.as_tensor(labels).long()
        hits = 0
        for (batch, rows), start in zip(
                _batches(images, batch_size, device),
                range(0, labels.shape[0], batch_size)):
            pred = (model.features(batch).float() @ w + b).argmax(-1)[:rows]
            hits += int((pred.cpu() == labels[start:start + rows]).sum())
        return hits / max(labels.shape[0], 1)

    return {"train_accuracy": acc(train_images, ytr),
            "test_accuracy": acc(test_images, test_labels),
            "final_loss": float(loss.detach())}


@torch.no_grad()
def knn_accuracy(train_feats: torch.Tensor, train_labels: torch.Tensor,
                 test_feats: torch.Tensor, test_labels: torch.Tensor,
                 k: int = 20, temperature: float = 0.07) -> float:
    """Weighted-kNN top-1: cosine similarity, ``exp(s / T)``-weighted
    votes over the ``k`` nearest train features."""
    ytr = torch.as_tensor(train_labels, device=train_feats.device).long()
    yte = torch.as_tensor(test_labels, device=test_feats.device).long()
    num_classes = int(ytr.max()) + 1
    k = min(k, int(train_feats.shape[0]))

    def norm(x):
        x = x.float()
        return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    sims = norm(test_feats) @ norm(train_feats).T
    # lax.top_k's order: among equal similarities the lower index first
    top_s, top_i = sims.sort(dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    votes = F.one_hot(ytr[top_i], num_classes).float()
    scores = (votes * torch.exp(top_s / temperature)[..., None]).sum(1)
    return float((scores.argmax(-1) == yte).float().mean())
