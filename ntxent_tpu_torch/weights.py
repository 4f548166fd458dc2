"""Carry the JAX package's weights into the port's modules.

``load_flax_variables(model, variables)`` takes flax variables,
``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy arrays
(what ``jax.device_get`` returns), and copies them into the matching
port module: ``SimCLRModel`` (ViT or ResNet backbone), ``CLIPModel``
(ViT image tower), ``VisionTransformer``, ``ResNet``, ``TextTransformer``,
``LongContextTransformer``, ``EncoderBlock``, ``SeqParallelSelfAttention``,
``MlpBlock`` or ``ProjectionHead``. The layout differences it handles:

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
* A switch-MoE block's MLP is ``MoEMlp_0`` with ``router``, ``w_up``,
  ``b_up``, ``w_down`` and ``b_down`` in the flax layout as they are.
* ``LongContextTransformer``'s blocks are ``LongContextBlock_i`` with
  ``LayerNorm_0``, ``SeqParallelSelfAttention_0``, ``LayerNorm_1`` and
  ``MlpBlock_0``, its final norm the tower's ``LayerNorm_0``.

Every flax leaf must be consumed and every torch tensor filled, with
matching shapes; anything else raises.

``flax_paths(model)`` maps each torch parameter name to the path of its
flax leaf (e.g. ``backbone.blocks.0.attn.query.weight`` ->
``("backbone", "block_0", "MultiHeadDotProductAttention_0", "query",
"kernel")``), from the same layout tables: LARS derives its exclusion
mask from those paths, as the JAX package does.

The way back runs the same tables: a converter states the flax shape of
every leaf it reshapes (``get(..., shape=...)``), and ``_Leaf`` records
each transform so that ``flax_variables(model)`` can undo them, giving
``{"params", "batch_stats"}`` in the flax layout. On top of both,
``train_state_dict(state)`` writes the port's ``TrainState`` in the JAX
``TrainState`` layout (``{"step", "params", "opt_state", "batch_stats",
"ef_residual"}``, ``opt_state`` that of ``optax.lars`` or
``optax.adamw``), which the checkpoints hold, and
``load_train_state_dict(state, d)`` reads one back, whichever package
wrote it.
"""

from __future__ import annotations

import logging
from collections.abc import Callable

import numpy as np
import torch
from torch import nn

from .models.clip import CLIPModel, TextTransformer
from .models.layers import SeqParallelSelfAttention
from .models.long_context import LongContextTransformer
from .models.projection import ProjectionHead, SimCLRModel
from .models.resnet import ResNet
from .models.vit import EncoderBlock, MlpBlock, VisionTransformer
from .parallel.mesh import rank, world_size
from .parallel.moe import MoEMlp

logger = logging.getLogger(__name__)

__all__ = ["flax_orders", "flax_paths", "flax_variables",
           "load_flax_variables", "load_train_state_dict",
           "train_state_dict"]


class _Tree:
    """Reads leaves of a nested dict by path and remembers which."""

    def __init__(self, tree: dict, root: str):
        self.tree, self.root, self.used = tree, root, set()

    def get(self, *path: str, shape: tuple | None = None) -> np.ndarray:
        """The leaf at ``path``; ``shape`` (its flax shape, where a
        converter reshapes it) serves the way back (``_Leaf``)."""
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
    heads = (module.num_heads, module.head_dim)
    hidden = module.num_heads * module.head_dim
    out = {}
    for name in ("query", "key", "value"):
        kernel = p.get(*path, name, "kernel",
                       shape=(hidden, *heads))  # (hidden, H, D)
        out[f"{name}.weight"] = kernel.reshape(kernel.shape[0], -1).T
        out[f"{name}.bias"] = p.get(*path, name, "bias",
                                    shape=heads).reshape(-1)
    kernel = p.get(*path, "out", "kernel", shape=(*heads, hidden))
    out["out.weight"] = kernel.reshape(-1, kernel.shape[-1]).T
    out["out.bias"] = p.get(*path, "out", "bias")
    return out


def _mlp(module, p, s, path) -> dict:
    return (_prefixed("fc1", _dense(p, path + ("Dense_0",)))
            | _prefixed("fc2", _dense(p, path + ("Dense_1",))))


def _moe(module, p, s, path) -> dict:
    # the flax layout as it is: (d, E), (E, d, f), (E, f), (E, f, d), (E, d)
    return {name: p.get(*path, name) for name in
            ("router", "w_up", "b_up", "w_down", "b_down")}


def _block(module, p, s, path,
           attention="MultiHeadDotProductAttention_0") -> dict:
    mlp = (_moe(module.mlp, p, s, path + ("MoEMlp_0",))
           if isinstance(module.mlp, MoEMlp)
           else _mlp(module.mlp, p, s, path + ("MlpBlock_0",)))
    return (_prefixed("ln1", _layer_norm(p, path + ("LayerNorm_0",)))
            | _prefixed("attn", _attention(module.attn, p, s,
                                           path + (attention,)))
            | _prefixed("ln2", _layer_norm(p, path + ("LayerNorm_1",)))
            | _prefixed("mlp", mlp))


def _blocks(module, p, s, path) -> dict:
    out = {}
    for i, block in enumerate(module.blocks):
        out |= _prefixed(f"blocks.{i}",
                         _block(block, p, s, path + (f"block_{i}",)))
    return out | _prefixed("final_ln", _layer_norm(p, path + ("final_ln",)))


def _vit(module, p, s, path) -> dict:
    size = module.patch_size
    kernel = p.get(*path, "patch_embed", "kernel", shape=(  # HWIO
        size, size, module.patch_embed.in_features // size // size,
        module.hidden_dim))
    return {"patch_embed.weight": kernel.reshape(-1, kernel.shape[-1]).T,
            "patch_embed.bias": p.get(*path, "patch_embed", "bias"),
            "cls_token": p.get(*path, "cls_token"),
            "pos_embed": p.get(*path, "pos_embed")} | _blocks(module, p, s,
                                                             path)


def _text(module, p, s, path) -> dict:
    return {"embedding": p.get(*path, "Embed_0", "embedding"),
            "pos_embed": p.get(*path, "pos_embed")} | _blocks(module, p, s,
                                                             path)


def _long_context(module, p, s, path) -> dict:
    out = {"embedding": p.get(*path, "Embed_0", "embedding"),
           "pos_embedding": p.get(*path, "pos_embedding")}
    for i, block in enumerate(module.blocks):
        out |= _prefixed(f"blocks.{i}", _block(
            block, p, s, path + (f"LongContextBlock_{i}",),
            attention="SeqParallelSelfAttention_0"))
    return out | _prefixed("out_ln", _layer_norm(p, path + ("LayerNorm_0",)))


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
               (LongContextTransformer, _long_context),
               (EncoderBlock, _block), (SeqParallelSelfAttention, _attention),
               (MlpBlock, _mlp), (ProjectionHead, _head))


def _converter(model: nn.Module):
    convert = next((fn for cls, fn in _CONVERTERS
                    if isinstance(model, cls)), None)
    if convert is None:
        raise TypeError(f"no flax layout for {type(model).__name__}")
    return convert


class _Leaf:
    """Stands in for a flax leaf: its collection (``params`` or
    ``batch_stats``), its path, its flax shape where the converter states
    it, and the layout transforms (transpose, reshape) the converter
    applies on the way to the torch tensor, so that ``to_flax`` can undo
    them. ``flax_paths`` reads only the path."""

    def __init__(self, root: str, path: tuple, shape: tuple | None = None,
                 ops: tuple = ()):
        self.root, self.path, self.shape, self.ops = root, path, shape, ops

    def _then(self, op: tuple, shape) -> "_Leaf":
        return _Leaf(self.root, self.path, shape, self.ops + (op,))

    @property
    def T(self) -> "_Leaf":
        return self._then(("T",), None if self.shape is None
                          else self.shape[::-1])

    def reshape(self, *shape) -> "_Leaf":
        if self.shape is None:
            raise TypeError(f"{'/'.join(self.path)}: the converter must state "
                            "the flax shape of a leaf it reshapes")
        size = int(np.prod(self.shape))
        known = int(np.prod([d for d in shape if d != -1]))
        new = tuple(size // known if d == -1 else d for d in shape)
        return self._then(("reshape", self.shape), new)

    def transpose(self, *axes) -> "_Leaf":
        shape = None if self.shape is None \
            else tuple(self.shape[a] for a in axes)
        return self._then(("transpose", axes), shape)

    def to_flax(self, value: np.ndarray) -> np.ndarray:
        """The flax leaf whose converted torch tensor is ``value``."""
        for op in reversed(self.ops):
            if op[0] == "T":
                value = value.T
            elif op[0] == "reshape":
                value = value.reshape(op[1])
            else:
                value = value.transpose(np.argsort(op[1]))
        return value


class _PathTree:
    """A flax tree of ``_Leaf`` placeholders: ``get`` answers any path."""

    def __init__(self, root: str = "params"):
        self.root = root

    def get(self, *path: str, shape: tuple | None = None) -> _Leaf:
        return _Leaf(self.root, path, shape)


def _layout(model: nn.Module) -> dict[str, _Leaf]:
    """``{torch state-dict name: _Leaf}`` of every tensor of ``model``."""
    return _converter(model)(model, _PathTree("params"),
                             _PathTree("batch_stats"), ())


def flax_paths(model: nn.Module) -> dict[str, tuple[str, ...]]:
    """``{torch parameter name: flax params path}`` for every parameter
    of ``model`` (buffers such as BatchNorm statistics are not params)."""
    leaves = _layout(model)
    return {name: leaves[name].path for name, _ in model.named_parameters()}


def flax_orders(model: nn.Module) -> list[torch.Tensor | None]:
    """For each parameter of ``model`` (``named_parameters`` order) the
    order in which the JAX package flattens its leaf: element j of the
    flax leaf, row-major, is element ``order[j]`` of the torch tensor,
    row-major; None where the layouts agree. The int8 wire chunks every
    gradient in this order, as the JAX two-phase all-reduce chunks its
    leaves (``parallel.mesh._Plan``)."""
    leaves = _layout(model)
    orders = []
    for name, p in model.named_parameters():
        leaf = leaves[name]
        if not leaf.ops:
            orders.append(None)
            continue
        index = np.arange(p.numel()).reshape(tuple(p.shape))
        orders.append(torch.from_numpy(np.ascontiguousarray(
            leaf.to_flax(index)).reshape(-1)))
    return orders


def _nest(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` of its own (``.numpy()`` of a CPU tensor is a
    view, which an in-place optimizer step would overwrite)."""
    if t.dtype == torch.bfloat16:
        raise TypeError("the train state holds bf16 tensors; the port keeps "
                        "fp32 parameters and optimizer state")
    return t.detach().to("cpu", copy=True).numpy()


def _to_flax(leaves: dict[str, _Leaf], tensors: dict) -> dict:
    """``{"params": .., "batch_stats": ..}`` nested numpy trees of
    ``tensors`` (torch name -> host array) in the flax layout."""
    out = {"params": {}, "batch_stats": {}}
    for name, value in tensors.items():
        leaf = leaves[name]
        _nest(out[leaf.root], leaf.path, leaf.to_flax(value))
    return out


def flax_variables(model: nn.Module) -> dict:
    """The inverse of ``load_flax_variables``: ``{"params": ...,
    "batch_stats": ...}`` of ``model`` as nested dicts of numpy arrays in
    the flax layout (host copies of their own)."""
    return _to_flax(_layout(model), {name: _host(t) for name, t in
                                     model.state_dict().items()})


def _torch_tensors(model: nn.Module, params: dict,
                   batch_stats: dict) -> dict:
    """``{torch state-dict name: numpy array}`` converted from flax
    ``params`` and ``batch_stats``: every flax leaf consumed and every
    torch tensor filled with its shape, or it raises."""
    convert = _converter(model)
    p_tree = _Tree(params, "params")
    s_tree = _Tree(batch_stats, "batch_stats")
    tensors = convert(model, p_tree, s_tree, ())
    for tree in (p_tree, s_tree):
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
    out = {}
    for key, target in state.items():
        # np.ascontiguousarray would turn a 0-d leaf into shape (1,)
        value = np.array(tensors[key], order="C")
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{key}: flax shape {value.shape} vs torch "
                             f"{tuple(target.shape)}")
        out[key] = value
    return out


def load_flax_variables(model: nn.Module, variables: dict) -> nn.Module:
    """Copy flax ``variables`` into ``model`` in place and return it."""
    tensors = _torch_tensors(model, variables["params"],
                             variables.get("batch_stats", {}))
    with torch.no_grad():
        for key, target in model.state_dict().items():
            target.copy_(torch.from_numpy(tensors[key]))
    return model


# ---------------------------------------------------------------------------
# The train state in the JAX package's checkpoint layout
# ---------------------------------------------------------------------------

def _adamw_state(opt, name: str) -> dict:
    return opt.optimizer.state.get(opt.params[name], {})


def _inner_opt_state(opt, names: list[str], params_tree) -> dict:
    """optax's chain state of the port's LARS or AdamW."""
    count = np.array(opt.count, np.int32)
    if hasattr(opt, "trace"):  # LARS
        return {"0": {"inner_state": {}}, "1": {"inner_state": {}},
                "2": {"count": count},
                "3": {"trace": params_tree(
                    {n: _host(opt.trace[n]) for n in names})}}

    def moment(key: str) -> dict:  # AdamW
        return params_tree({n: _host(_adamw_state(opt, n).get(
            key, torch.zeros_like(opt.params[n]))) for n in names})

    return {"0": {"count": count, "mu": moment("exp_avg"),
                  "nu": moment("exp_avg_sq")},
            "1": {}, "2": {"count": count}}


def _ef_tree(leaves: dict, stacked: dict) -> dict:
    """The error-feedback residual in the JAX layout: a params tree of
    ``(P,) + flax shape`` float32 stacks (``trainer.py:108-120``) from
    ``{torch parameter name: (P,) + torch shape}``."""
    tree: dict = {}
    for name, value in stacked.items():
        leaf = leaves[name]
        _nest(tree, leaf.path, np.stack([leaf.to_flax(v) for v in value])
              .astype(np.float32))
    return tree


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _ef_slice(state, saved, torch_params) -> list[np.ndarray] | None:
    """This rank's slice of a saved residual (the JAX layout), converted
    for ``state.ef_residual``; None, after a warning, when it cannot be
    used: the state has no residual, the checkpoint none (a slim save),
    or one of another world size. Follows ``_from_bytes_tolerant``
    (``ntxent_tpu/training/checkpoint.py:494-560``): the residual is
    carry-over compression noise, never worth failing a restore over."""
    if state.ef_residual is None:
        if saved is not None:
            logger.warning("checkpoint carries error-feedback residual "
                           "state the current run's state has no field "
                           "for; dropping it")
        return None
    if saved is None:
        logger.warning("checkpoint carries no error-feedback residual "
                       "state (slim save, the default, or a float32 run); "
                       "starting at zero residual")
        return None
    p = world_size()
    leading = {np.shape(x)[0] if np.ndim(x) else None
               for x in _flat_values(saved)}
    if leading != {p}:
        logger.warning("checkpoint's error-feedback residual (saved at "
                       "world %s) does not match the current topology "
                       "(world %d); resetting to zero residual",
                       sorted(leading, key=str), p)
        return None
    try:
        mine = torch_params(_tree_map(lambda x: np.asarray(x)[rank()],
                                      saved))
    except (KeyError, ValueError) as e:
        logger.warning("checkpoint's error-feedback residual does not fit "
                       "the current state (%s); resetting to zero residual",
                       e)
        return None
    names = [n for n, _ in state.model.named_parameters()]
    return [mine[n] for n in names]


def _flat_values(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _flat_values(v)
        else:
            yield v


def train_state_dict(state, ef_residual: dict | None = None) -> dict:
    """The port's ``TrainState`` as the JAX package's ``TrainState``
    serializes it (``flax.serialization.to_state_dict``): ``{"step",
    "params", "opt_state", "batch_stats", "ef_residual"}``, nested dicts
    of numpy arrays, every array a host copy of its own. ``opt_state`` is
    ``optax.lars``'s chain (``training/lars.py``: masked weight decay,
    masked trust ratio, the schedule's ``count``, the momentum ``trace``
    in the params layout) or ``optax.adamw``'s (``ScaleByAdamState``
    ``count``, ``mu``, ``nu``; the empty weight-decay state; the
    schedule's ``count``) after the optimizer's type; under gradient
    accumulation (``training.accum.MultiSteps``) ``optax.MultiSteps``'s
    ``{"mini_step", "gradient_step", "inner_opt_state": <that chain>,
    "acc_grads": <params layout>, "skip_state": {}}``. ``batch_stats`` is
    None for a model without BatchNorm (CLIP), as the JAX CLIP state
    leaves it. ``ef_residual`` is None, or, given ``{parameter name:
    every rank's residual stacked, (P,) + shape}`` (what
    ``training.checkpoint.gather_ef_residual`` returns), the int8 wire's
    error-feedback residual in the JAX layout: a params tree of ``(P,) +
    flax shape`` float32 stacks."""
    model, opt = state.model, state.optimizer
    leaves = _layout(model)
    tensors = {name: _host(t) for name, t in model.state_dict().items()}
    variables = _to_flax(leaves, tensors)
    names = [name for name, _ in model.named_parameters()]

    def params_tree(values: dict) -> dict:
        return _to_flax(leaves, values)["params"]

    if hasattr(opt, "acc"):  # MultiSteps
        opt_state = {
            "mini_step": np.array(opt.mini_step, np.int32),
            "gradient_step": np.array(opt.gradient_step, np.int32),
            "inner_opt_state": _inner_opt_state(opt.inner, names,
                                                params_tree),
            "acc_grads": params_tree({n: _host(opt.acc[n])
                                      for n in names}),
            "skip_state": {}}
    else:
        opt_state = _inner_opt_state(opt, names, params_tree)
    if any(t.is_cuda for t in model.state_dict().values()):
        torch.cuda.synchronize()  # every copy has landed on the host
    return {"step": np.array(state.step, np.int32),
            "params": variables["params"], "opt_state": opt_state,
            "batch_stats": variables["batch_stats"] or None,
            "ef_residual": None if ef_residual is None
            else _ef_tree(leaves, ef_residual)}


def _count(node: dict, where: str) -> int:
    try:
        return int(np.asarray(node["count"]))
    except (KeyError, TypeError) as e:
        raise KeyError(f"opt_state has no {where} count") from e


def _read_inner(opt, opt_state: dict, torch_params) -> Callable:
    """Convert and check the chain state of ``opt`` (LARS or AdamW) in
    ``opt_state``; returns the function that writes it into ``opt``."""
    names = list(opt.params)
    if hasattr(opt, "trace"):  # LARS
        if set(opt_state) != {"0", "1", "2", "3"} \
                or "trace" not in opt_state["3"]:
            raise KeyError(f"opt_state {sorted(opt_state)} is not "
                           "optax.lars's chain")
        count = _count(opt_state["2"], "schedule")
        trace = torch_params(opt_state["3"]["trace"])

        def write() -> None:
            for n in names:
                opt.trace[n].copy_(torch.from_numpy(trace[n]))
            opt.count = count

        return write
    if set(opt_state) != {"0", "1", "2"} or "mu" not in opt_state["0"]:
        raise KeyError(f"opt_state {sorted(opt_state)} is not "
                       "optax.adamw's chain")
    count = _count(opt_state["2"], "schedule")
    adam_count = _count(opt_state["0"], "ScaleByAdamState")
    mu = torch_params(opt_state["0"]["mu"])
    nu = torch_params(opt_state["0"]["nu"])

    def write() -> None:  # AdamW
        scalar = torch.float64 if torch.get_default_dtype() \
            == torch.float64 else torch.float32
        for n in names:
            p = opt.params[n]
            opt.optimizer.state[p] = {
                "step": torch.tensor(float(adam_count), dtype=scalar),
                "exp_avg": torch.from_numpy(mu[n]).to(p.device),
                "exp_avg_sq": torch.from_numpy(nu[n]).to(p.device)}
        opt.count = count

    return write


def load_train_state_dict(state, d: dict):
    """Load a state dict of the JAX ``TrainState`` layout (as
    ``train_state_dict`` writes it, or as the JAX package's checkpoints
    hold it) into the port's ``state`` in place: the model's parameters
    and BatchNorm statistics, the optimizer's count and momentum (LARS)
    or moments (AdamW), under accumulation also ``MultiSteps``'s counters
    and accumulated gradients, the step, and, when ``state`` carries an
    error-feedback residual, this rank's slice of the saved one (zeros,
    with a warning, when the checkpoint holds none or one of another world
    size). Every tensor is converted and checked before the first is
    written, so a state that does not fit raises and leaves ``state`` as
    it was. Returns ``state``."""
    model, opt = state.model, state.optimizer
    stats = d.get("batch_stats") or {}
    tensors = _torch_tensors(model, d["params"], stats)
    opt_state = d["opt_state"]

    def torch_params(tree: dict) -> dict:
        return _torch_tensors(model, tree, stats)

    if hasattr(opt, "acc"):  # MultiSteps
        keys = {"mini_step", "gradient_step", "inner_opt_state",
                "acc_grads"}
        if not keys <= set(opt_state):
            raise KeyError(f"opt_state {sorted(opt_state)} is not "
                           "optax.MultiSteps's state (--accum-steps of "
                           "the run that wrote it?)")
        write_inner = _read_inner(opt.inner, opt_state["inner_opt_state"],
                                  torch_params)
        acc = torch_params(opt_state["acc_grads"])
        counters = (int(np.asarray(opt_state["mini_step"])),
                    int(np.asarray(opt_state["gradient_step"])))
    else:
        write_inner = _read_inner(opt, opt_state, torch_params)
    residual = _ef_slice(state, d.get("ef_residual"), torch_params)
    step = int(np.asarray(d["step"]))
    with torch.no_grad():
        for key, target in model.state_dict().items():
            target.copy_(torch.from_numpy(tensors[key]))
        write_inner()
        if hasattr(opt, "acc"):
            for n, target in opt.acc.items():
                target.copy_(torch.from_numpy(acc[n]))
            opt.mini_step, opt.gradient_step = counters
        for i, target in enumerate(state.ef_residual or []):
            if residual is None:
                target.zero_()
            else:
                target.copy_(torch.from_numpy(residual[i]))
    state.step = step
    return state
