"""Training resilience in a gloo world of 2 (spawned ranks of
``torch_dist_workers.py``, no JAX in them), on the CPU.

* The guarded data-parallel step (``make_sharded_train_step(guard=True)``)
  with a NaN in rank 1's rows only: both ranks skip the update (the
  guard decides after the gradient pmean, on the global loss), end with
  identical state, and equal the JAX ``make_sharded_train_step(guard=
  True)`` on a 2-device CPU mesh (the NT-Xent Pallas kernels in interpret
  mode) within ``test_torch_resnet.py``'s train-step bound (5e-4 of each
  parameter's change plus 1e-5; the losses within 1e-5).
* ``ntxent-train --max-restarts 1 --chaos crash@3`` in the world (with
  ``--nan-policy skip --remat --accum-steps 2``): every rank holds its
  own injector, so both crash at their third batch; both restart from
  the step rank 0 picks, and the run ends at the CRC of the world's run
  without chaos.
"""

import json

import jax
import numpy as np
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ntxent_tpu.parallel.mesh import replicate_state
from ntxent_tpu.training.trainer import make_sharded_train_step as jsharded

import torch_dist_workers as workers
from test_torch_distributed import CLI_ARGV, _flatten, _spawn
from test_torch_resnet import (
    STEP_CONFIG,
    TINY_PROJ,
    _np,
    assert_same_update,
    jax_tiny_state,
    step_views,
    tiny_port_model,
    tiny_simclr_pair,
)

torch.set_num_threads(1)  # see test_torch_training.py

NAN_STEP, NAN_RANK = 1, 1
# the CLI runs take every resilience flag the data-parallel step has
RUN_ARGV = CLI_ARGV[1:] + ["--steps", "4", "--ckpt-every", "1",
                           "--ckpt-keep-last", "0", "--nan-policy", "skip",
                           "--remat", "--accum-steps", "2"]


def _crc(directory, step):
    manifests = json.loads((directory / "manifests.json").read_text())
    return manifests[str(step)]["files"]["state.msgpack"]


def test_guard_and_a_crash_restart_in_a_world_of_2(tmp_path):
    jmodel, variables, _ = tiny_simclr_pair(seed=3, axis_name="data")
    views = step_views(3, seed=5)
    inputs = {"proj": np.array(TINY_PROJ), "nan_step": np.array(NAN_STEP),
              "nan_rank": np.array(NAN_RANK),
              "v1": np.stack([v[0] for v in views]),
              "v2": np.stack([v[1] for v in views]),
              **_flatten(variables["params"], "params"),
              **_flatten(variables["batch_stats"], "batch_stats"),
              **{f"cfg:{k}": np.asarray(v) for k, v in STEP_CONFIG.items()}}
    np.savez(tmp_path / "inputs.npz", **inputs)
    clean, chaos = tmp_path / "clean", tmp_path / "chaos"
    for run in (clean, chaos):
        run.mkdir()
    _spawn(workers.run_guard, 2,
           (str(tmp_path / "inputs.npz"), str(clean),
            RUN_ARGV + ["--ckpt-dir", str(clean / "ck")]), clean)
    _spawn(workers.run_cli, 2,
           (RUN_ARGV + ["--ckpt-dir", str(chaos / "ck"), "--max-restarts",
                        "1", "--chaos", "crash@3"], str(chaos)), chaos)

    # the guard: both ranks skip step 2 and agree bit for bit
    ranks = [dict(np.load(clean / f"rank{r}.npz")) for r in range(2)]
    for res in ranks:
        assert res["guard_ok"].tolist() == [True, False, True]
        assert int(res["guard_count"]) == 2 and int(res["guard_step"]) == 3
        for key, value in ranks[0].items():
            if key.startswith(("state:", "guard_")):
                np.testing.assert_array_equal(res[key], value, err_msg=key)
    # ... and equal JAX's guarded step on a 2-device mesh
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    state = replicate_state(jax_tiny_state(jmodel, variables), mesh)
    step = jsharded(mesh, STEP_CONFIG["temperature"], interpret=True,
                    guard=True)
    shard = NamedSharding(mesh, P("data"))
    for i, (v1, v2) in enumerate(views):
        if i == NAN_STEP:
            v1 = v1.copy()
            v1[len(v1) // 2:] = np.nan  # rank 1's rows
        state, metrics = step(state, jax.device_put(v1, shard),
                              jax.device_put(v2, shard), 1.0)
        assert bool(metrics["step_ok"]) == ranks[0]["guard_ok"][i]
        if i != NAN_STEP:
            np.testing.assert_allclose(ranks[0]["guard_losses"][i],
                                       float(metrics["loss"]), atol=1e-5,
                                       rtol=0)
    model = tiny_port_model(variables)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    model.load_state_dict({k[len("state:"):]: torch.from_numpy(v)
                           for k, v in ranks[0].items()
                           if k.startswith("state:")})
    assert_same_update(model, before, tiny_port_model(
        {"params": _np(state.params),
         "batch_stats": _np(state.batch_stats)}))

    # the crash: both ranks restart from step 2 and finish at the CRC
    for r in range(2):
        log = (chaos / f"rank{r}.log").read_text()
        assert "injected crash at batch 3" in log, r
        assert "run complete at step 4 after 2 attempt(s)" in log, r
    assert "resumed from checkpoint at step 2" in (chaos /
                                                   "rank0.log").read_text()
    assert _crc(chaos / "ck", 4) == _crc(clean / "ck", 4)
