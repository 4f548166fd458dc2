"""Pipeline parallelism: the GPipe schedule over a group of stage ranks,
counterpart of ``ntxent_tpu/parallel/pp.py``.

Each rank of the stage group holds one stage's parameters. The batch is
split into M microbatches and the schedule runs ``M + S - 1`` ticks
(``pp.py:128-154``): at tick t, stage s applies itself to microbatch
``t - s`` (stage 0 reads it from the batch, every later stage from what
its predecessor sent at the tick before) and hands the result on with a
``mesh.ppermute`` shift; the last stage keeps its outputs, which a psum
over the stages replicates. The backward schedule is autograd's: the
transpose of a hop is the inverse hop (``mesh._PPermute``).

As in the SPMD program of JAX, every rank computes at every tick and a
select discards what the bubble ``(S - 1) / (M + S - 1)`` computes: each
rank must run the same collectives in its backward (a hop's transpose
is a send and a receive its neighbours wait for), so every rank keeps
the same graph.

The pipeline's input enters through Megatron's ``f``
(``mesh.copy_to_group``), so every stage rank sees the input's whole
gradient (only stage 0's is nonzero), as JAX's replicated input
transposes. ``remat=True`` wraps the stage in ``torch.utils.checkpoint``
(``jax.checkpoint``). A (data, stage) grid runs one pipeline per data
row: pass that row's stage group (``mesh.grid_groups``) and its rows.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from .mesh import copy_to_group, ppermute, rank, reduce_from_group, world_size

__all__ = ["make_gpipe", "pipeline_stage_params", "stack_stage_params"]


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def stack_stage_params(params_list: Sequence[Any]):
    """S per-stage trees (nested dicts of tensors, one structure) stacked
    into one tree with a leading stage axis (``pp.py:51``)."""
    return _tree_map(lambda *xs: torch.stack(xs, 0), *params_list)


def pipeline_stage_params(params: dict, num_stages: int,
                          block_prefix: str = "block_"):
    """``({leaf: (S, blocks per stage, ...)}, rest)`` of a param tree with
    ``{block_prefix}{i}`` sub-trees (``pp.py:61``): the blocks stacked
    stage-major, and everything else."""
    blocks = sorted((int(k[len(block_prefix):]), k) for k in params
                    if k.startswith(block_prefix))
    if not blocks:
        raise ValueError(f"no '{block_prefix}*' entries in params")
    n = len(blocks)
    if n % num_stages:
        raise ValueError(f"{n} blocks do not split into {num_stages} stages")
    per = n // num_stages
    stages = [stack_stage_params([params[blocks[s * per + j][1]]
                                  for j in range(per)])
              for s in range(num_stages)]
    rest = {k: v for k, v in params.items() if not k.startswith(block_prefix)}
    return stack_stage_params(stages), rest


def make_gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
               group=None, *, num_microbatches: int, remat: bool = False
               ) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """``fn(stage_params, x) -> y`` running the GPipe schedule over the
    ranks of ``group`` (``pp.py:90``). ``stage_params`` are THIS rank's
    stage's parameters (anything ``stage_fn`` takes); ``stage_fn(params,
    acts) -> acts`` keeps the activation's shape. ``x`` is the whole
    (local) batch, split into ``num_microbatches`` equal microbatches;
    ``y`` is replicated on every stage rank. Differentiable in both."""
    m = num_microbatches
    if m < 1:
        raise ValueError("num_microbatches must be >= 1")
    fn = stage_fn
    if remat:
        def fn(params, acts):
            return checkpoint(stage_fn, params, acts, use_reentrant=False)

    def pipe(stage_params, x: torch.Tensor) -> torch.Tensor:
        s_count, s = world_size(group), rank(group)
        batch = x.shape[0]
        if batch % m:
            raise ValueError(f"batch {batch} not divisible into {m} "
                             "microbatches")
        xs = copy_to_group(x, group, "stage").reshape(m, batch // m, *x.shape[1:])
        shift = [(i, i + 1) for i in range(s_count - 1)]
        first = torch.tensor(s == 0, device=x.device)
        state = torch.zeros_like(xs[0])
        outs = []
        ticks = m + s_count - 1
        for t in range(ticks):
            # stage 0 reads microbatch t (the last one again in the drain
            # ticks), every other stage what arrived; the select keeps
            # both in every rank's graph, so every rank runs the same
            # collectives backward
            out = fn(stage_params, torch.where(first, xs[min(t, m - 1)],
                                               state))
            if t >= s_count - 1:
                outs.append(out)
            if s_count > 1 and t < ticks - 1:
                state = ppermute(out, shift, group)
        last = torch.tensor(s == s_count - 1, device=x.device)
        y = torch.where(last, torch.cat(outs), torch.zeros_like(x))
        return reduce_from_group(y.reshape(x.shape), group, "stage")

    return pipe
