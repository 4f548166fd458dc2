"""The port's multi-process worlds: the global input pipeline
(``training.TwoViewPipeline`` on a rank's loader shard, the counterpart of
``ntxent_tpu/training/datasets.py:418``'s ``GlobalTwoViewPipeline``) and the multi-process flags of ``ntxent-train`` (``--coordinator``,
``--num-processes``, ``--process-id``: a ``tcp://`` rendezvous on
localhost, no launcher environment), running the ZeRO-3, Megatron and
MoE branches in a world of 2.

The views of a world of P ranks, joined in rank order, are a one-rank
run's bit for bit (each row's augmentation is drawn for its position in
the global batch). The CLI's runs in the world of 2 agree with the
single-process runs of the same flags (which warn and take the
single-card step, as the JAX CLI does on one device) at step 1 within
5e-2: the tiny towers compute in bf16, where the loss of random images at
initialization moves with the order of a sum (``chip_smoke.py``'s note
on the bf16 step); the fp32 equalities are ``test_torch_fsdp.py``'s and
``test_torch_tp.py``'s.
"""

import socket

import numpy as np
import pytest
import torch

from ntxent_tpu_torch import cli
from ntxent_tpu_torch.training import (
    ArraySource,
    StreamingLoader,
    TwoViewPipeline,
)
from ntxent_tpu_torch.training.augment import apply_view, view_params

import torch_mp_workers as workers
from test_torch_distributed import _spawn

torch.set_num_threads(1)  # see test_torch_training.py

BATCH = 8
TINY = ["--device", "cpu", "--steps", "2", "--log-every", "1",
        "--proj-hidden-dim", "16", "--proj-dim", "8", "--warmup-steps", "1"]
RUNS = {
    "fsdp": TINY + ["--model", "tiny", "--image-size", "8", "--batch", "8",
                    "--synthetic-samples", "16", "--fsdp"],
    "tp": TINY + ["--model", "vit_t16", "--vit-attention", "flash",
                  "--image-size", "16", "--batch", "4",
                  "--synthetic-samples", "8", "--parallel", "tp",
                  "--model-par", "2"],
    "clip_tp_moe": ["--objective", "clip", "--model", "tiny", "--device",
                    "cpu", "--image-size", "16", "--token-len", "16",
                    "--vocab-size", "100", "--batch", "4", "--steps", "2",
                    "--synthetic-samples", "8", "--log-every", "1",
                    "--clip-parallel", "tp", "--model-par", "2",
                    "--moe-experts", "2"],
}
LABELS = {"fsdp": "FSDP (ZeRO-3) over 2 ranks (gloo)",
          "tp": "Megatron TP over the (1, 2) (data, model) grid (gloo)",
          "clip_tp_moe": "Megatron TP over the (1, 2) (data, model) grid"}


def _store():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (32, 12, 12, 3), dtype=np.uint8)


def test_global_views_of_two_ranks_are_one_ranks(tmp_path):
    """Three global batches: the views of a world of 2 joined in rank
    order equal a one-rank ``TwoViewPipeline``'s bit for bit."""
    np.savez(tmp_path / "inputs.npz", store=_store(), batch=BATCH)
    _spawn(workers.run_views, 2, (str(tmp_path / "inputs.npz"),
                                  str(tmp_path)), tmp_path)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    one = TwoViewPipeline(StreamingLoader(ArraySource(_store()), BATCH,
                                          seed=3), torch.device("cpu"),
                          seed=4)
    for i in range(3):
        v1, v2 = next(one)
        for res in ranks:
            np.testing.assert_array_equal(res[f"v1_{i}"], v1.numpy())
            np.testing.assert_array_equal(res[f"v2_{i}"], v2.numpy())
            assert not bool(res["jax_loaded"])


def test_global_pipeline_keeps_the_loader_state_and_blur_flag():
    """A restored pipeline repeats its views, and they are the full SimCLR
    views, the Gaussian blur included (JAX's ``blur=True``): the first
    view is ``apply_view`` of every draw of the batch's generator."""
    loader = StreamingLoader(ArraySource(_store()), BATCH, seed=3)
    pipe = TwoViewPipeline(loader, torch.device("cpu"), seed=4)
    state = pipe.state()
    draws = view_params(BATCH, pipe._generator(), torch.device("cpu"))
    a, _ = next(pipe)
    pipe.restore(state)
    b, _ = next(pipe)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    images = torch.as_tensor(next(iter(StreamingLoader(
        ArraySource(_store()), BATCH, seed=3)))).float() / 255.0
    assert draws["blur"].any()
    torch.testing.assert_close(a, apply_view(images, draws), rtol=0, atol=0)


@pytest.fixture(scope="module")
def comms(tmp_path_factory):
    """``torch_mp_workers.comms_job`` in a world of 2."""
    tmp = tmp_path_factory.mktemp("comms")
    np.savez(tmp / "inputs.npz", batch=BATCH)
    _spawn(workers.run_comms, 2, (str(tmp / "inputs.npz"), str(tmp)), tmp)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _recorded(res: dict, key: str) -> tuple[int, float]:
    calls, nbytes = res.get(key, (0, 0.0))
    return int(calls), float(nbytes)


@pytest.mark.parametrize("run", ["tp", "fsdp"])
def test_a_step_records_its_model_parallel_collectives(comms, run):
    """A model-parallel step's collectives are all in the comms accounting
    at their ring-model bytes (world 2: an all-reduce counts its payload
    once, an all-gather a rank's slice once). TP at the (1, 2) grid, the
    tiny ViT at a batch of 8 a view: Megatron's g forward and f backward,
    2 of each a block, on the (2 x 8 x 5, 32) activations; split_rows's
    backward all-gather, (4, 32) a view; LARS's squared norms of the 6
    sliced kernels of a block. ZeRO-3 over 2 ranks, the tiny ResNet: the
    parameters' all-gather and the gradients' reduce-scatter, one a cut
    leaf, beside the data-parallel step's all-gathers; LARS's norms of
    every cut leaf it masks in."""
    for res in comms:
        if run == "tp":
            depth = workers.TINY_VIT["depth"]
            width = workers.TINY_VIT["hidden_dim"]
            tokens = 2 * BATCH * ((16 // workers.TINY_VIT["patch_size"]) ** 2
                                  + 1)
            proj = workers.TINY_PROJ[1]
            assert _recorded(res, "tp:tp_psum:model") \
                == (4 * depth, 4 * depth * tokens * width * 4)
            assert _recorded(res, "tp:all_gather:model") \
                == (2, 2 * (BATCH // 2) * proj * 4)
            assert _recorded(res, "tp:lars_norms:model") \
                == (6 * depth, 6 * depth * 8)
            continue
        cut, masked = int(res["zero3_calls"]), int(res["zero3_masked"])
        assert cut and masked
        calls, nbytes = _recorded(res, "dp:all_gather:data")
        assert _recorded(res, "fsdp:all_gather:data") \
            == (calls + cut, nbytes + int(res["zero3_slice_bytes"]))
        assert _recorded(res, "fsdp:psum_scatter:data") \
            == (cut, (int(res["all_bytes"]) - int(res["rest_bytes"])) / 2)
        assert _recorded(res, "fsdp:lars_norms:data") == (masked, 8 * masked)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def coordinator_world(tmp_path_factory):
    """``ntxent-train`` joined by ``--coordinator localhost:<port>
    --num-processes 2 --process-id r``: the three runs of RUNS in turn."""
    tmp = tmp_path_factory.mktemp("coordinator")
    _spawn(workers.run_coordinator, 2, (_free_port(), list(RUNS.values()),
                                        str(tmp)), tmp)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("run", list(RUNS))
def test_coordinator_flags_run_the_model_parallel_branches(
        coordinator_world, run, monkeypatch):
    """Both ranks report the same finite losses; the step-1 loss equals
    the single-process run's of the same flags within 5e-2; rank 0 logs
    the branch over gloo."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    i = list(RUNS).index(run)
    ranks = coordinator_world
    np.testing.assert_array_equal(ranks[0][f"losses{i}"],
                                  ranks[1][f"losses{i}"])
    assert np.isfinite(ranks[0][f"losses{i}"]).all()
    _, history = cli.train(cli.build_train_parser().parse_args(RUNS[run]))
    np.testing.assert_allclose(ranks[0][f"losses{i}"][0],
                               history[0]["loss"], atol=5e-2)
    assert str(ranks[0]["backend"]) == "gloo"
    assert LABELS[run] in str(ranks[0]["log"])


def test_coordinator_needs_its_partners():
    args = cli.build_train_parser().parse_args(
        RUNS["fsdp"] + ["--coordinator", "localhost:1"])
    with pytest.raises(SystemExit, match="--num-processes and --process-id"):
        cli.train(args)
