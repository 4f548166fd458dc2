"""The port's crash-replay audit on the CPU
(``resilience.crashsim``): ``python -m ntxent_tpu_torch.cli train --device
cpu`` as child processes of the tiny model, SIGKILLed by the chaos plan's
``kill@K`` (one kill at least inside a checkpoint write, under
``NTXENT_CKPT_SLOW_MS``), no torn step after any kill, and the survivor's
final checkpoint bit-identical to an uninterrupted run's (the same CPU
arithmetic: every child runs one torch thread). Also the audit's pieces:
the scan, the fingerprint, the schedule parser (against the JAX
package's), the write throttle and the checkpoint fault hook.
"""

import json
import threading
import time

import pytest
import torch

from ntxent_tpu.resilience.crashsim import parse_schedule as jax_schedule
from ntxent_tpu_torch.resilience import FaultInjector, FaultPlan
from ntxent_tpu_torch.resilience.crashsim import (
    CrashAudit,
    CrashAuditError,
    checkpoint_fingerprint,
    main,
    parse_schedule,
    scan_checkpoint_dir,
)
from ntxent_tpu_torch.training import AsyncCheckpointer, CheckpointManager

from test_torch_checkpoint import _state

torch.set_num_threads(1)  # see test_torch_training.py

# the audit's own time limit on the CPU: it takes ~10 s on one thread per
# child; each child is also cut at CHILD_TIMEOUT_S
AUDIT_LIMIT_S = 90
CHILD_TIMEOUT_S = 60
# the audit's defaults train ResNet-50 at 224 px on the card
TINY = dict(device="cpu", model="tiny", image_size=8, batch=8)


@pytest.fixture
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("WORLD_SIZE", raising=False)


def test_crash_audit_two_kills_one_midsave(tmp_path, one_thread):
    t0 = time.monotonic()
    report = CrashAudit(tmp_path, steps=6, timeout_s=CHILD_TIMEOUT_S,
                        **TINY).audit(kills=2, midsave=1)
    assert time.monotonic() - t0 < AUDIT_LIMIT_S
    assert report.kills >= 2 and report.midsave_kills >= 1
    assert report.bit_exact and report.final_step == 6
    assert report.survivor_fingerprint == report.reference_fingerprint
    assert all(not r["torn"] for r in report.rounds)
    summary = json.loads((tmp_path / "audit_summary.json").read_text())
    assert summary["verdict"] == "PASS:bitexact"


def test_crash_audit_cli_with_one_kill(tmp_path, one_thread, capsys):
    assert main(["--workdir", str(tmp_path), "--steps", "4", "--kills", "1",
                 "--midsave", "0", "--lineages", "1", "--workers", "1",
                 "--timeout-s", str(CHILD_TIMEOUT_S), "--device", "cpu",
                 "--model", "tiny", "--image-size", "8", "--batch",
                 "8"]) == 0
    out = capsys.readouterr().out
    assert "crash audit: OK, 1 kills" in out
    assert (tmp_path / "summary_crash0.json").exists()


def _step(root, step, files):
    d = root / str(step)
    d.mkdir(parents=True)
    for name, data in files.items():
        (d / name).write_bytes(data)
    return d


def test_scan_finds_torn_steps_and_staging_debris(tmp_path):
    import zlib

    good = b"state-bytes"
    _step(tmp_path, 1, {"state.msgpack": good, "data_state.json": b"{}"})
    _step(tmp_path, 2, {"meta.json": b"{}"})  # no state file
    _step(tmp_path, 3, {"state.msgpack": b"torn"})
    (tmp_path / ".tmp-4-123-abc").mkdir()
    (tmp_path / "manifests.json").write_text(json.dumps({
        "1": {"files": {"state.msgpack": [len(good), zlib.crc32(good)]}},
        "3": {"files": {"state.msgpack": [len(good), zlib.crc32(good)]}}}))
    scan = scan_checkpoint_dir(tmp_path)
    assert scan == {"torn": ["2: missing state.msgpack",
                             "3: state.msgpack fails manifest check"],
                    "tmp": [".tmp-4-123-abc"]}
    fp = checkpoint_fingerprint(tmp_path, 1)
    assert fp["state.msgpack"] == [len(good), zlib.crc32(good)]
    assert set(fp) == {"state.msgpack", "data_state.json"}
    with pytest.raises(CrashAuditError, match="no checkpoint for step 9"):
        checkpoint_fingerprint(tmp_path, 9)


@pytest.mark.parametrize("spec", ["8,4,8", "8,4x2,8", "2x2", "bad", "3x2",
                                  ""])
def test_parse_schedule_matches_jax(spec):
    try:
        want = jax_schedule(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            parse_schedule(spec)
        assert str(ours.value) == str(e)
        return
    assert parse_schedule(spec) == want


def test_the_write_throttle_holds_a_save(tmp_path, monkeypatch):
    monkeypatch.setenv("NTXENT_CKPT_SLOW_MS", "300")
    t0 = time.monotonic()
    assert CheckpointManager(tmp_path).save(1, _state())
    assert time.monotonic() - t0 >= 0.3
    monkeypatch.setenv("NTXENT_CKPT_SLOW_MS", "not-a-number")
    assert CheckpointManager(tmp_path).save(2, _state())


@pytest.mark.parametrize("writer", ["sync", "async"])
def test_diskfull_skips_a_save_and_the_run_goes_on(tmp_path, writer):
    """The fault hook runs at the start of each physical write, on the
    async writer's thread too: ``diskfull@2`` fails the second write
    (ENOSPC), ``save`` reports it, and the next save lands."""
    injector = FaultInjector(FaultPlan.parse("diskfull@2"))
    threads = []

    def hook():
        threads.append(threading.current_thread().name)
        injector.on_checkpoint_write()

    manager = CheckpointManager(tmp_path, max_to_keep=None, fault_hook=hook)
    if writer == "async":
        manager = AsyncCheckpointer(manager)
    state = _state()
    for step in (1, 2, 3):
        manager.save(step, state)
        manager.wait_until_finished()
    manager.close()
    assert CheckpointManager(tmp_path).all_steps() == [1, 3]
    assert injector.fired == ["diskfull@2"]
    assert threads == [{"sync": "MainThread",
                        "async": "ckpt-writer"}[writer]] * 3
    if writer == "async":  # save reported it: nothing reached the thread
        assert manager.last_error is None
