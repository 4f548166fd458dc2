"""The port's checkpoints and resume on the CPU: ``training.checkpoint``
(``CheckpointManager``, ``AsyncCheckpointer``, ``RetentionPolicy``),
``training.fit``, ``PreemptionGuard``, the pipelines' ``restore`` and
``RetryPolicy.call``.

What ``tests/test_crashsafe_checkpoint.py``, ``tests/test_preemption.py``
and ``tests/test_elastic.py`` check of the JAX package's manager, checked
of the port's: retention and collection, the staging purge, the fallback
past corrupt steps and to the mirror, the snapshot's immunity to in-place
updates, the emergency save, ``restore_step`` with truncation. A resumed
run must equal an uninterrupted one bit for bit (the same CPU arithmetic
in the same order): every tensor of the state and the checkpoint's CRC.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from ntxent_tpu_torch import cli
from ntxent_tpu_torch.parallel import mesh
from ntxent_tpu_torch.resilience import RetryBudgetExceeded, RetryPolicy
from ntxent_tpu_torch.training import checkpoint as ckpt
from ntxent_tpu_torch.training import (
    AsyncCheckpointer,
    CheckpointManager,
    PreemptionGuard,
    RetentionPolicy,
    fit,
)

torch.set_num_threads(1)  # see test_torch_training.py

REPO = Path(__file__).resolve().parent.parent
TINY_ARGV = ["--device", "cpu", "--model", "tiny", "--image-size", "8",
             "--batch", "4", "--log-every", "1", "--proj-hidden-dim", "16",
             "--proj-dim", "8", "--synthetic-samples", "8",
             "--warmup-steps", "1", "--base-lr", "3.0"]


def _args(*flags):
    return cli.build_train_parser().parse_args(TINY_ARGV + list(flags))


def _state(seed=0):
    """A fresh tiny SimCLR state (ResNet of one stage, LARS) on the CPU."""
    from ntxent_tpu_torch.training import create_train_state

    args = _args("--seed", str(seed))
    args.image_size = 8
    return create_train_state(cli.build_model(args), cli._train_config(args),
                              torch.device("cpu"))


def _pipeline(seed=0):
    args = _args("--seed", str(seed))
    args.image_size = 8
    return cli._make_pipeline(args, torch.device("cpu"))


def _step():
    from ntxent_tpu_torch.training import make_train_step

    return make_train_step(0.1)


def _tensors(state) -> dict:
    out = {f"model/{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    out |= {f"trace/{k}": v.clone()
            for k, v in state.optimizer.trace.items()}
    return out


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def _train(state, steps):
    pipe, step = _pipeline(), _step()
    for _ in range(steps):
        state, _ = step(state, *next(pipe))
    return state


def _corrupt(path: Path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))


# ---------------------------------------------------------------------------
# Retention and collection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,valid,want", [
    (RetentionPolicy(keep_last=2), None, {4, 5}),
    (RetentionPolicy(keep_last=1, keep_every=2), None, {2, 4, 5}),
    (RetentionPolicy(keep_last=2), {1, 2}, {2, 4, 5}),
    (RetentionPolicy(keep_last=None), None, {1, 2, 3, 4, 5}),
    (RetentionPolicy(keep_last=0), None, {1, 2, 3, 4, 5}),
], ids=["keep_last", "keep_every", "newest_valid", "none", "zero"])
def test_retention_policy(policy, valid, want):
    steps = [1, 2, 3, 4, 5]
    assert policy.keep(steps, lambda s: valid is None or s in valid) == want


def test_gc_applies_policy_and_prunes_manifests(tmp_path):
    state = _state()
    manager = CheckpointManager(tmp_path, max_to_keep=2)
    for step in (1, 2, 3, 4):
        assert manager.save(step, state)
    assert manager.all_steps() == [3, 4]
    manifests = json.loads((tmp_path / ckpt.MANIFEST_NAME).read_text())
    assert set(manifests) == {"3", "4"}


def test_gc_never_removes_the_only_valid_step(tmp_path):
    state = _state()
    manager = CheckpointManager(tmp_path, max_to_keep=1)
    assert manager.save(1, state)
    # a newer step that fails its checksums: step 1 must survive its GC
    manager.retention = RetentionPolicy(keep_last=None)
    assert manager.save(2, state)
    _corrupt(tmp_path / "2" / ckpt.STATE_FILE)
    manager.retention = RetentionPolicy(keep_last=1)
    manager.gc()
    assert manager.all_steps() == [1, 2]
    assert manager.latest_valid_step() == 1


def test_first_save_of_an_empty_directory_always_lands(tmp_path):
    manager = CheckpointManager(tmp_path, save_interval_steps=10)
    assert manager.should_save(3)
    assert manager.save(3, _state())
    assert not manager.should_save(4) and manager.should_save(10)


# ---------------------------------------------------------------------------
# Atomic steps: staging, filesystem errors, retries
# ---------------------------------------------------------------------------

def test_init_purges_abandoned_staging_but_keeps_live_writers(tmp_path):
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    abandoned = tmp_path / f".tmp-5-{dead.pid}-deadbeef"
    live = tmp_path / f".tmp-6-{os.getppid()}-cafef00d"
    for d in (abandoned, live):
        d.mkdir()
        (d / ckpt.STATE_FILE).write_bytes(b"partial")
    CheckpointManager(tmp_path)
    assert not abandoned.exists() and live.exists()


def test_save_returns_false_on_a_filesystem_error(tmp_path, monkeypatch):
    manager = CheckpointManager(tmp_path)

    def full(*args, **kwargs):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(manager.manager, "save", full)
    assert manager.save(1, _state(), force=True) is False
    assert manager.all_steps() == []
    # the first-save claim is released: the next save may still land
    monkeypatch.undo()
    assert manager.should_save(3)


def test_a_failed_write_leaves_no_staging_debris(tmp_path, monkeypatch):
    manager = CheckpointManager(tmp_path)

    def torn(path, tree):
        path.write_bytes(b"half")
        raise OSError("disk gone")

    monkeypatch.setattr(ckpt, "_write_state", torn)
    assert manager.save(1, _state(), force=True) is False
    assert list(tmp_path.iterdir()) == []


def test_retry_policy_retries_transient_errors():
    sleeps = []
    policy = RetryPolicy(max_attempts=3, base_delay_s=0.5, jitter=0.0,
                         sleep=sleeps.append)
    calls = []

    def flaky(x):
        calls.append(x)
        if len(calls) < 3:
            raise OSError("blip")
        return x * 2

    assert policy.call(flaky, 21) == 42 and sleeps == [0.5, 1.0]
    with pytest.raises(ValueError):  # not transient: raised at once
        policy.wrap(lambda: (_ for _ in ()).throw(ValueError("bad")))()
    clock = iter([0.0, 10.0])
    budget = RetryPolicy(base_delay_s=5.0, budget_s=1.0, sleep=sleeps.append,
                         monotonic=lambda: next(clock))
    with pytest.raises(RetryBudgetExceeded) as info:
        budget.call(lambda: (_ for _ in ()).throw(OSError("down")))
    assert isinstance(info.value.__cause__, OSError)


# ---------------------------------------------------------------------------
# Manifests: the fallback past corrupt steps, the mirror
# ---------------------------------------------------------------------------

def test_restore_falls_back_past_a_corrupt_step(tmp_path):
    state = _train(_state(), 1)
    manager = CheckpointManager(tmp_path)
    manager.save(1, state)
    want = _tensors(state)
    state = _train(state, 1)
    manager.save(2, state)
    _corrupt(tmp_path / "2" / ckpt.STATE_FILE)
    assert not manager.verify(2) and manager.latest_valid_step() == 1
    fresh, _ = manager.restore_with_data_state(_state(seed=1))
    assert fresh.step == 1
    _assert_bitwise(_tensors(fresh), want)
    assert manager.all_steps() == [1]  # the corrupt step is deleted


@pytest.mark.parametrize("damage", ["corrupt", "missing"])
def test_mirror_serves_a_bad_primary(tmp_path, damage):
    state = _train(_state(), 2)
    manager = CheckpointManager(tmp_path / "a", mirror_dir=tmp_path / "m")
    manager.save(2, state)
    assert manager.mirror_verify(2)
    if damage == "corrupt":
        _corrupt(tmp_path / "a" / "2" / ckpt.STATE_FILE)
    else:
        import shutil

        shutil.rmtree(tmp_path / "a" / "2")
    assert manager.latest_valid_step() == 2
    fresh = manager.restore(_state(seed=1))
    _assert_bitwise(_tensors(fresh), _tensors(state))
    # an explicit step reads the mirror too
    fresh = manager.restore(_state(seed=1), step=2)
    _assert_bitwise(_tensors(fresh), _tensors(state))


def test_restore_never_deletes_a_step_of_another_model(tmp_path):
    """A step that verifies but does not load (another width) is skipped,
    kept, and named when nothing else loads."""
    other = _args("--proj-dim", "4")
    other.image_size = 8
    from ntxent_tpu_torch.training import create_train_state

    wide = create_train_state(cli.build_model(other), cli._train_config(
        other), torch.device("cpu"))
    manager = CheckpointManager(tmp_path)
    manager.save(1, wide)
    with pytest.raises(RuntimeError, match="does not load"):
        manager.restore(_state())
    assert manager.all_steps() == [1]


# ---------------------------------------------------------------------------
# Async saves
# ---------------------------------------------------------------------------

def test_async_snapshot_is_immune_to_buffer_reuse(tmp_path, monkeypatch):
    """The optimizers update parameters in place; the async writer must
    write the values of the step it was handed, not later ones."""
    gate = threading.Event()
    write = ckpt._write_state

    def held(path, tree):
        assert gate.wait(30)
        return write(path, tree)

    monkeypatch.setattr(ckpt, "_write_state", held)
    state = _state()
    want = _tensors(state)
    saver = AsyncCheckpointer(CheckpointManager(tmp_path))
    try:
        assert saver.save(1, state)
        with torch.no_grad():  # what the next LARS step does, in place
            for p in state.model.parameters():
                p.add_(1.0)
            for t in state.optimizer.trace.values():
                t.add_(1.0)
        gate.set()
        saver.wait_until_finished()
    finally:
        saver.close()
    fresh = CheckpointManager(tmp_path).restore(_state(seed=1))
    _assert_bitwise(_tensors(fresh), want)


def test_emergency_save_drains_the_writer_and_saves_now(tmp_path):
    saver = AsyncCheckpointer(CheckpointManager(tmp_path))
    try:
        state = _state()
        saver.save(1, state)
        state.step = 3
        assert saver.emergency_save(3, state)
        assert saver.manager.all_steps() == [1, 3]  # on disk on return
        assert saver.verify(3)
    finally:
        saver.close()


def test_async_writer_failure_never_raises_into_the_loop(tmp_path,
                                                          monkeypatch):
    saver = AsyncCheckpointer(CheckpointManager(tmp_path))

    def boom(*args, **kwargs):
        raise RuntimeError("writer died")

    monkeypatch.setattr(saver.manager, "save", boom)
    try:
        assert saver.save(1, _state(), force=True)
        saver.wait_until_finished()
        assert isinstance(saver.last_error, RuntimeError)
    finally:
        saver.close()


# ---------------------------------------------------------------------------
# fit: exact resume, restore_step, preemption
# ---------------------------------------------------------------------------

def _fit(directory, steps, **kw):
    state = _state()
    state, history = fit(state, _pipeline(), _step(), steps,
                         checkpoint_dir=str(directory), checkpoint_every=2,
                         log_every=1, **kw)
    return state, history


def _crcs(directory):
    return json.loads((Path(directory) / ckpt.MANIFEST_NAME).read_text())


@pytest.mark.parametrize("async_checkpointing", [False, True],
                         ids=["sync", "async"])
def test_resumed_run_equals_the_uninterrupted_run(tmp_path,
                                                  async_checkpointing):
    """2 + 2 steps equal 4 steps bit for bit: every tensor of the state
    and the step-4 checkpoint's CRC, the data position included."""
    whole, _ = _fit(tmp_path / "whole", 4,
                    async_checkpointing=async_checkpointing)
    _fit(tmp_path / "parts", 2, async_checkpointing=async_checkpointing)
    resumed, history = _fit(tmp_path / "parts", 4,
                            async_checkpointing=async_checkpointing)
    assert [h["step"] for h in history] == [3, 4]
    _assert_bitwise(_tensors(resumed), _tensors(whole))
    assert _crcs(tmp_path / "parts")["4"] == _crcs(tmp_path / "whole")["4"]
    data = (tmp_path / "parts" / "4" / ckpt.DATA_STATE_FILE).read_text()
    assert '"offset": 2' in data and '"epoch": 1' in data


def test_restore_step_rewinds_and_truncates(tmp_path):
    _fit(tmp_path, 6)
    assert CheckpointManager(tmp_path).all_steps() == [2, 4, 6]
    state, history = _fit(tmp_path, 5, restore_step=2)
    assert [h["step"] for h in history] == [3, 4, 5] and state.step == 5
    assert CheckpointManager(tmp_path).all_steps() == [2, 4, 5]


def test_restore_step_needs_a_directory_and_an_existing_step(tmp_path):
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        fit(_state(), _pipeline(), _step(), 2, restore_step=1)
    _fit(tmp_path, 2)
    with pytest.raises(FileNotFoundError, match="step 7"):
        _fit(tmp_path, 8, restore_step=7)


@pytest.mark.parametrize("async_checkpointing", [False, True],
                         ids=["sync", "async"])
def test_stop_fn_ends_the_run_and_saves_the_stopped_step(
        tmp_path, monkeypatch, async_checkpointing):
    polls, emergency = [], []
    if async_checkpointing:
        real = AsyncCheckpointer.emergency_save

        def spy(self, step, state, data_state=None):
            emergency.append(step)
            return real(self, step, state, data_state)

        monkeypatch.setattr(AsyncCheckpointer, "emergency_save", spy)

    def stop():
        polls.append(1)
        return len(polls) > 3  # after three steps

    state, history = _fit(tmp_path, 10, stop_fn=stop,
                          async_checkpointing=async_checkpointing)
    assert state.step == 3 and [h["step"] for h in history] == [1, 2, 3]
    assert CheckpointManager(tmp_path).latest_valid_step() == 3
    assert emergency == ([3] if async_checkpointing else [])


def test_guard_chains_restores_and_ignores_a_second_signal():
    seen = []
    previous = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with PreemptionGuard() as guard:
            assert not guard.requested()
            os.kill(os.getpid(), signal.SIGTERM)
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.requested() and guard.preempted
        assert seen == [signal.SIGTERM]  # chained once
        os.kill(os.getpid(), signal.SIGTERM)  # the old handler is back
        assert seen == [signal.SIGTERM] * 2
    finally:
        signal.signal(signal.SIGTERM, previous)


CHILD_ARGV = ["--device", "cpu", "--model", "vit_t16", "--vit-attention",
              "flash", "--image-size", "16", "--batch", "4", "--log-every",
              "1", "--proj-hidden-dim", "32", "--proj-dim", "8",
              "--synthetic-samples", "12", "--base-lr", "3.0",
              "--warmup-steps", "1", "--steps", "16", "--ckpt-every", "4",
              "--async-ckpt"]


def _child(directory, sigterm_after=None):
    """``python -m ntxent_tpu_torch.cli train`` on one thread; with
    ``sigterm_after``, SIGTERM once it logs that step. Returns (rc,
    output lines)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ntxent_tpu_torch.cli", "train", *CHILD_ARGV,
         "--ckpt-dir", str(directory)], cwd=REPO, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if sigterm_after is not None and re.search(
                    rf"\bstep {sigterm_after} loss ", line):
                proc.send_signal(signal.SIGTERM)
                sigterm_after = None
        return proc.wait(timeout=120), lines
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_sigterm_mid_run_saves_and_the_relaunch_ends_at_the_same_crc(
        tmp_path):
    rc, _ = _child(tmp_path / "whole")
    assert rc == 0
    rc, lines = _child(tmp_path / "cut", sigterm_after=2)
    assert rc == 0, lines[-5:]
    saved = [int(m.group(1)) for line in lines for m in [re.search(
        r"run was preempted; checkpoint saved at step (\d+)", line)] if m]
    assert len(saved) == 1 and 2 <= saved[0] < 16, lines[-5:]
    assert CheckpointManager(tmp_path / "cut").latest_valid_step() == saved[0]
    rc, lines = _child(tmp_path / "cut")
    assert rc == 0, lines[-5:]
    assert _crcs(tmp_path / "cut")["16"] == _crcs(tmp_path / "whole")["16"]


# ---------------------------------------------------------------------------
# The pipelines' position and the topology record
# ---------------------------------------------------------------------------

def test_two_view_pipeline_restore_repeats_the_same_views():
    pipe = _pipeline()
    for _ in range(3):  # into the second epoch (two batches an epoch)
        next(pipe)
    state = pipe.state()
    want = [next(pipe) for _ in range(2)]
    fresh = _pipeline()
    next(fresh)  # mid-iteration: the running iterator is dropped
    fresh.restore(state)
    for (a1, a2), (b1, b2) in zip(want, [next(fresh) for _ in range(2)]):
        assert torch.equal(a1, b1) and torch.equal(a2, b2)


def test_paired_pipeline_restore_repeats_the_same_pairs():
    from ntxent_tpu_torch.training import PairedArrayLoader, PairedPipeline

    rng = np.random.default_rng(0)
    images = rng.uniform(size=(10, 4, 4, 3)).astype(np.float32)
    tokens = rng.integers(0, 9, (10, 5)).astype(np.int32)

    def make():
        return PairedPipeline(PairedArrayLoader(images, tokens, 4, seed=3),
                              torch.device("cpu"))

    pipe = make()
    next(pipe)
    state = pipe.state()
    want = [next(pipe) for _ in range(3)]
    fresh = make()
    next(fresh)
    next(fresh)
    fresh.restore(state)
    for (a1, a2), (b1, b2) in zip(want, [next(fresh) for _ in range(3)]):
        assert torch.equal(a1, b1) and torch.equal(a2, b2)


def test_topology_record_is_the_jax_layout(tmp_path):
    assert mesh.world_topology() == {"device_count": 1, "shape": None,
                                     "axis_names": None, "process_count": 1,
                                     "backend": None}
    CheckpointManager(tmp_path).save(1, _state())
    topology = json.loads((tmp_path / "1" / ckpt.TOPOLOGY_FILE).read_text())
    assert topology["version"] == 1 and topology["mesh"] == {
        "device_count": 1, "shape": None, "axis_names": None,
        "process_count": 1}
    assert "step" in topology["specs"] and all(
        v is None for v in topology["specs"].values())
    assert "opt_state/2/count" in topology["specs"]
    meta = json.loads((tmp_path / "1" / ckpt.META_FILE).read_text())
    assert meta == {"step": 1, "format": 1}
