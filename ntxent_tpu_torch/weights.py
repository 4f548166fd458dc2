"""Carry the JAX package's weights into the port's modules.

``load_flax_variables(model, variables)`` takes flax variables,
``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy arrays
(what ``jax.device_get`` returns), and copies them into the matching
port module: ``SimCLRModel`` (ViT or ResNet backbone), ``CLIPModel``
(ViT image tower), ``VisionTransformer``, ``ResNet``, ``TextTransformer``,
``EncoderBlock``, ``SeqParallelSelfAttention``, ``MlpBlock`` or
``ProjectionHead``. The layout differences it handles:

* ``Dense`` kernels are (in, out); torch weights are (out, in).
* ``patch_embed`` is an HWIO conv kernel (p, p, C, hidden) over NHWC
  input: flattened row-major it is the (p*p*C, hidden) product the
  port's patchify feeds.
* ``DenseGeneral`` q/k/v kernels are (hidden, H, D) with (H, D) biases;
  ``out`` is (H, D, hidden).
* BatchNorm ``scale``/``bias`` are parameters, ``mean``/``var`` live in
  ``batch_stats`` and become buffers; ``fc2`` has no bias.
* ResNet ``Conv`` kernels are HWIO; torch's are OIHW. A block's
  convolutions and norms are flax's ``Conv_i``/``BatchNorm_i`` in order
  (``convs.i``/``norms.i`` here), blocks ``BottleneckBlock_k`` or
  ``BasicBlock_k`` numbered across the stages.
* ``cls_token`` and ``pos_embed`` keep their (1, ., hidden) shapes; the
  text tower's ``Embed_0/embedding`` is the (vocab, hidden) table as is,
  and CLIP's ``logit_scale`` a scalar.

Every flax leaf must be consumed and every torch tensor filled, with
matching shapes; anything else raises.

``flax_paths(model)`` maps each torch parameter name to the path of its
flax leaf (e.g. ``backbone.blocks.0.attn.query.weight`` ->
``("backbone", "block_0", "MultiHeadDotProductAttention_0", "query",
"kernel")``), from the same layout tables: LARS derives its exclusion
mask from those paths, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .models.clip import CLIPModel, TextTransformer
from .models.long_context import SeqParallelSelfAttention
from .models.projection import ProjectionHead, SimCLRModel
from .models.resnet import ResNet
from .models.vit import EncoderBlock, MlpBlock, VisionTransformer

__all__ = ["flax_paths", "load_flax_variables"]


class _Tree:
    """Reads leaves of a nested dict by path and remembers which."""

    def __init__(self, tree: dict, root: str):
        self.tree, self.root, self.used = tree, root, set()

    def get(self, *path: str) -> np.ndarray:
        node = self.tree
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise KeyError(f"flax {self.root} has no "
                               f"{'/'.join(path)!r}")
            node = node[key]
        self.used.add(path)
        return np.array(node, dtype=np.float32)  # a writable copy

    def leaves(self, node=None, prefix=()) -> set[tuple]:
        node = self.tree if node is None else node
        if not isinstance(node, dict):
            return {prefix}
        out = set()
        for key, child in node.items():
            out |= self.leaves(child, prefix + (key,))
        return out


def _prefixed(prefix: str, tensors: dict) -> dict:
    return {f"{prefix}.{k}": v for k, v in tensors.items()}


def _dense(p: _Tree, path: tuple, bias: bool = True) -> dict:
    out = {"weight": p.get(*path, "kernel").T}
    if bias:
        out["bias"] = p.get(*path, "bias")
    return out


def _layer_norm(p: _Tree, path: tuple) -> dict:
    return {"weight": p.get(*path, "scale"), "bias": p.get(*path, "bias")}


def _attention(module, p, s, path) -> dict:
    out = {}
    for name in ("query", "key", "value"):
        kernel = p.get(*path, name, "kernel")  # (hidden, H, D)
        out[f"{name}.weight"] = kernel.reshape(kernel.shape[0], -1).T
        out[f"{name}.bias"] = p.get(*path, name, "bias").reshape(-1)
    kernel = p.get(*path, "out", "kernel")  # (H, D, hidden)
    out["out.weight"] = kernel.reshape(-1, kernel.shape[-1]).T
    out["out.bias"] = p.get(*path, "out", "bias")
    return out


def _mlp(module, p, s, path) -> dict:
    return (_prefixed("fc1", _dense(p, path + ("Dense_0",)))
            | _prefixed("fc2", _dense(p, path + ("Dense_1",))))


def _block(module, p, s, path) -> dict:
    return (_prefixed("ln1", _layer_norm(p, path + ("LayerNorm_0",)))
            | _prefixed("attn", _attention(
                module.attn, p, s,
                path + ("MultiHeadDotProductAttention_0",)))
            | _prefixed("ln2", _layer_norm(p, path + ("LayerNorm_1",)))
            | _prefixed("mlp", _mlp(module.mlp, p, s,
                                    path + ("MlpBlock_0",))))


def _blocks(module, p, s, path) -> dict:
    out = {}
    for i, block in enumerate(module.blocks):
        out |= _prefixed(f"blocks.{i}",
                         _block(block, p, s, path + (f"block_{i}",)))
    return out | _prefixed("final_ln", _layer_norm(p, path + ("final_ln",)))


def _vit(module, p, s, path) -> dict:
    kernel = p.get(*path, "patch_embed", "kernel")  # HWIO
    return {"patch_embed.weight": kernel.reshape(-1, kernel.shape[-1]).T,
            "patch_embed.bias": p.get(*path, "patch_embed", "bias"),
            "cls_token": p.get(*path, "cls_token"),
            "pos_embed": p.get(*path, "pos_embed")} | _blocks(module, p, s,
                                                             path)


def _text(module, p, s, path) -> dict:
    return {"embedding": p.get(*path, "Embed_0", "embedding"),
            "pos_embed": p.get(*path, "pos_embed")} | _blocks(module, p, s,
                                                             path)


def _clip(module, p, s, path) -> dict:
    if not isinstance(module.image_tower, VisionTransformer):
        raise TypeError(f"no flax layout for image tower "
                        f"{type(module.image_tower).__name__}")
    return (_prefixed("image_tower", _vit(module.image_tower, p, s,
                                          path + ("image_tower",)))
            | _prefixed("text_tower", _text(module.text_tower, p, s,
                                            path + ("text_tower",)))
            | _prefixed("image_proj", _dense(p, path + ("image_proj",),
                                             bias=False))
            | _prefixed("text_proj", _dense(p, path + ("text_proj",),
                                            bias=False))
            | {"logit_scale": p.get(*path, "logit_scale")})


def _batch_norm(p: _Tree, s: _Tree, path: tuple) -> dict:
    return {"weight": p.get(*path, "scale"), "bias": p.get(*path, "bias"),
            "running_mean": s.get(*path, "mean"),
            "running_var": s.get(*path, "var")}


def _conv(p: _Tree, path: tuple) -> dict:
    return {"weight": p.get(*path, "kernel").transpose(3, 2, 0, 1)}  # OIHW


def _head(module, p, s, path) -> dict:
    return (_prefixed("fc1", _dense(p, path + ("fc1",)))
            | _prefixed("bn1", _batch_norm(p, s, path + ("bn1",)))
            | _prefixed("fc2", _dense(p, path + ("fc2",), bias=False)))


def _resnet(module, p, s, path) -> dict:
    out = (_prefixed("stem_conv", _conv(p, path + ("stem_conv",)))
           | _prefixed("stem_bn", _batch_norm(p, s, path + ("stem_bn",))))
    for k, block in enumerate(module.blocks):
        bpath = path + (f"{type(block).__name__}_{k}",)
        for i in range(len(block.convs)):
            out |= _prefixed(f"blocks.{k}.convs.{i}",
                             _conv(p, bpath + (f"Conv_{i}",)))
            out |= _prefixed(f"blocks.{k}.norms.{i}",
                             _batch_norm(p, s, bpath + (f"BatchNorm_{i}",)))
        if block.proj_conv is not None:
            out |= _prefixed(f"blocks.{k}.proj_conv",
                             _conv(p, bpath + ("proj_conv",)))
            out |= _prefixed(f"blocks.{k}.proj_bn",
                             _batch_norm(p, s, bpath + ("proj_bn",)))
    return out


def _simclr(module, p, s, path) -> dict:
    backbone = next((fn for cls, fn in ((VisionTransformer, _vit),
                                        (ResNet, _resnet))
                     if isinstance(module.backbone, cls)), None)
    if backbone is None:
        raise TypeError(f"no flax layout for backbone "
                        f"{type(module.backbone).__name__}")
    return (_prefixed("backbone", backbone(module.backbone, p, s,
                                           path + ("backbone",)))
            | _prefixed("projector", _head(module.projector, p, s,
                                           path + ("projector",))))


_CONVERTERS = ((SimCLRModel, _simclr), (CLIPModel, _clip),
               (VisionTransformer, _vit), (ResNet, _resnet),
               (TextTransformer, _text),
               (EncoderBlock, _block), (SeqParallelSelfAttention, _attention),
               (MlpBlock, _mlp), (ProjectionHead, _head))


def _converter(model: nn.Module):
    convert = next((fn for cls, fn in _CONVERTERS
                    if isinstance(model, cls)), None)
    if convert is None:
        raise TypeError(f"no flax layout for {type(model).__name__}")
    return convert


class _Leaf:
    """Stands in for a flax leaf in ``flax_paths``: keeps its path through
    the layout transforms (transpose, reshape) the converters apply."""

    shape = (0,)  # read by the converters only to feed reshape

    def __init__(self, path: tuple):
        self.path = path

    @property
    def T(self) -> "_Leaf":
        return self

    def reshape(self, *shape) -> "_Leaf":
        return self

    transpose = reshape


class _PathTree:
    """A flax tree of ``_Leaf`` placeholders: ``get`` answers any path."""

    def get(self, *path: str) -> _Leaf:
        return _Leaf(path)


def flax_paths(model: nn.Module) -> dict[str, tuple[str, ...]]:
    """``{torch parameter name: flax params path}`` for every parameter
    of ``model`` (buffers such as BatchNorm statistics are not params)."""
    leaves = _converter(model)(model, _PathTree(), _PathTree(), ())
    return {name: leaves[name].path for name, _ in model.named_parameters()}


def load_flax_variables(model: nn.Module, variables: dict) -> nn.Module:
    """Copy flax ``variables`` into ``model`` in place and return it."""
    convert = _converter(model)
    params = _Tree(variables["params"], "params")
    stats = _Tree(variables.get("batch_stats", {}), "batch_stats")
    tensors = convert(model, params, stats, ())
    for tree in (params, stats):
        unused = tree.leaves() - tree.used
        if unused:
            raise KeyError(f"flax {tree.root} leaves with no torch "
                           f"counterpart: "
                           f"{sorted('/'.join(p) for p in unused)}")
    state = model.state_dict()
    missing = set(state) - set(tensors)
    if missing:
        raise KeyError(f"torch tensors not covered by the flax variables: "
                       f"{sorted(missing)}")
    with torch.no_grad():
        for key, target in state.items():
            # np.ascontiguousarray would turn a 0-d leaf into shape (1,)
            value = np.array(tensors[key], order="C")
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{key}: flax shape {value.shape} vs torch "
                                 f"{tuple(target.shape)}")
            target.copy_(torch.from_numpy(value))
    return model
