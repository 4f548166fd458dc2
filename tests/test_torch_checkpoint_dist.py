"""Data-parallel checkpoints of the port on the CPU: ``ntxent-train`` in a
gloo world of 2 (``torch_dist_workers.run_cli``) saves from rank 0, and a
relaunched world resumes it bit for bit (2 + 2 steps against 4, the
checkpoint's CRC); the world-2 step restores in a world of 1, where the
replicated state takes its place as it is and the restore logs that the
world changed.
"""

import json
import logging

import numpy as np
import pytest
import torch

from ntxent_tpu_torch import cli
from ntxent_tpu_torch.training import CheckpointManager
from ntxent_tpu_torch.utils import msgpack
from ntxent_tpu_torch.weights import train_state_dict

import torch_dist_workers as workers
from test_torch_distributed import CLI_ARGV, _spawn

torch.set_num_threads(1)  # see test_torch_training.py


def _world2(tmp_path, name, directory, steps):
    run = tmp_path / name
    run.mkdir()
    argv = CLI_ARGV[1:] + ["--steps", str(steps), "--ckpt-dir",
                           str(directory), "--ckpt-every", "2"]
    _spawn(workers.run_cli, 2, (argv, str(run)), run)
    return (run / "rank0.log").read_text()


def _state_crc(directory, step):
    manifests = json.loads((directory / "manifests.json").read_text())
    return manifests[str(step)]["files"]["state.msgpack"]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out |= _flat(v, prefix + (k,))
        return out
    return {prefix: tree}


def test_world_of_2_resumes_exactly_and_restores_at_world_1(tmp_path,
                                                             monkeypatch,
                                                             caplog):
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    _world2(tmp_path, "a", whole, 4)
    _world2(tmp_path, "b", parts, 2)
    log = _world2(tmp_path, "c", parts, 4)
    assert "resumed from checkpoint at step 2" in log
    assert _state_crc(parts, 4) == _state_crc(whole, 4)
    topology = json.loads((whole / "4" / "topology.json").read_text())
    assert topology["mesh"]["device_count"] == 2

    # the world-2 step in a world of 1: the same state, loaded as it is
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = cli.build_train_parser().parse_args(
        CLI_ARGV[1:] + ["--steps", "5", "--ckpt-dir", str(whole)])
    with caplog.at_level(logging.INFO):
        state, history = cli.train(args)
    assert "topology changed" in caplog.text
    assert "saved at world 2, restored at world 1" in caplog.text
    assert [h["step"] for h in history] == [5]
    assert np.isfinite(history[0]["loss"])

    saved = msgpack.from_bytes((whole / "4" / "state.msgpack").read_bytes())
    fresh = cli.train(cli.build_train_parser().parse_args(
        CLI_ARGV[1:] + ["--steps", "4", "--ckpt-dir", str(parts)]))[0]
    assert fresh.step == 4  # nothing to do: restored and returned
    ours = _flat(train_state_dict(fresh))
    for key, value in _flat(saved).items():
        if value is None:
            continue
        np.testing.assert_array_equal(ours[key], value, err_msg=str(key))


def test_a_missing_restore_step_fails_every_rank_of_a_world(tmp_path):
    """Rank 0 names the missing step and every rank exits non-zero at once
    (no rank waits for a broadcast that never comes, nor trains from
    scratch)."""
    directory = tmp_path / "ck"
    _world2(tmp_path, "a", directory, 2)
    run = tmp_path / "b"
    run.mkdir()
    with pytest.raises(AssertionError, match="rank exit codes"):
        _spawn(workers.run_cli, 2, (CLI_ARGV[1:] + [
            "--steps", "4", "--ckpt-dir", str(directory), "--restore-step",
            "9"], str(run)), run)
    assert CheckpointManager(directory).all_steps() == [1, 2]
