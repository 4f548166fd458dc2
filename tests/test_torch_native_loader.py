"""The port's native loader (``training/native_loader.py`` over
``csrc/loader.cpp``, built with the host compiler at the first loader)
against the port's and the JAX package's ``StreamingLoader``, batch for
batch and exactly, on the CPU: two epochs, every rank of a sharded world,
a mid-epoch resume, ``drop_remainder=False``, a contiguous memmap slice.
A strided view and an in-memory array are refused with the JAX messages;
importing the module builds nothing."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ntxent_tpu.training import datasets as jdata
from ntxent_tpu_torch.training import datasets as tdata
from ntxent_tpu_torch.training import native_loader as tnative
from ntxent_tpu_torch.resilience import RetryPolicy

torch.set_num_threads(1)  # one torch thread a test worker

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def store(tmp_path):
    """A uint8 row store of (41, 6, 5, 3) on disk, as a memmap."""
    rows = np.random.default_rng(0).integers(0, 256, (41, 6, 5, 3),
                                             dtype=np.uint8)
    np.save(tmp_path / "rows.npy", rows)
    return np.load(tmp_path / "rows.npy", mmap_mode="r")


def _three(mm, batch, **kw):
    """The native loader, the port's threaded one and the JAX one."""
    shard = {}
    if "rank" in kw:
        shard = dict(shard_index=kw["rank"], shard_count=kw["world_size"])
        per = batch // kw["world_size"]
    else:
        per = batch
    extra = {k: v for k, v in kw.items() if k == "drop_remainder"}
    return (tnative.NativeStreamingLoader(mm, batch, num_threads=3,
                                          read_ahead=2, **kw),
            tdata.StreamingLoader(tdata.ArraySource(mm), batch,
                                  num_threads=2, **kw),
            jdata.StreamingLoader(jdata.ArraySource(mm), per, seed=kw.get(
                "seed", 0), **shard, **extra))


def _same(loaders, batches):
    its = [iter(x) for x in loaders]
    for _ in range(batches):
        first, *rest = [next(it) for it in its]
        for other in rest:
            np.testing.assert_array_equal(first, other)


def test_native_loader_matches_both_loaders_over_two_epochs(store):
    loaders = _three(store, 8, seed=3)
    assert loaders[0].batches_per_epoch() == 5
    _same(loaders, 11)
    assert loaders[0].state() == loaders[1].state() == loaders[2].state()


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_of_the_native_loader_gets_its_rows(store, world):
    for rank in range(world):
        _same(_three(store, 8, seed=5, rank=rank, world_size=world), 6)


def test_native_loader_resumes_mid_epoch(store):
    run = tnative.NativeStreamingLoader(store, 8, seed=9)
    it = iter(run)
    for _ in range(7):
        next(it)
    state = run.state()
    assert state == {"epoch": 1, "offset": 2, "seed": 9}
    loaders = _three(store, 8)
    for loader in loaders:
        loader.restore(state)
    its = [iter(x) for x in loaders]
    for _ in range(4):
        batch = next(it)
        for other in its:
            np.testing.assert_array_equal(batch, next(other))


def test_native_loader_without_drop_remainder(store):
    loaders = _three(store, 16, seed=2, drop_remainder=False)
    assert loaders[0].batches_per_epoch() == 3
    its = [iter(x) for x in loaders]
    sizes = []
    for _ in range(6):
        first, *rest = [next(i) for i in its]
        sizes.append(len(first))
        for other in rest:
            np.testing.assert_array_equal(first, other)
    assert sizes == [16, 16, 9, 16, 16, 9]


def test_a_contiguous_memmap_slice_gathers_its_own_rows(store):
    view = store[5:]
    native = tnative.NativeStreamingLoader(view, 8, seed=4)
    want = jdata.StreamingLoader(jdata.ArraySource(np.asarray(view)), 8,
                                 seed=4)
    _same([native, want], 8)
    # through an ArraySource, as the CLI hands it over
    _same([tnative.NativeStreamingLoader(tdata.ArraySource(view), 8,
                                         seed=4),
           jdata.StreamingLoader(jdata.ArraySource(np.asarray(view)), 8,
                                 seed=4)], 2)


def test_strided_views_and_arrays_are_refused(store):
    with pytest.raises(TypeError, match="C-contiguous memmap"):
        tnative.NativeStreamingLoader(store[::2], 4)
    with pytest.raises(TypeError, match="np.memmap-backed source"):
        tnative.NativeStreamingLoader(np.asarray(store), 4)
    with pytest.raises(TypeError, match="got ImageFolderSource"):
        tnative.NativeStreamingLoader(
            tdata.ImageFolderSource.__new__(tdata.ImageFolderSource), 4)


def test_a_refused_submission_is_retried(store, monkeypatch):
    loader = tnative.NativeStreamingLoader(
        store, 8, seed=1, retry_policy=RetryPolicy(max_attempts=3,
                                                   base_delay_s=0.0))
    calls = []
    real = loader._submit_once

    def flaky(handle, order, bi):
        calls.append(bi)
        if len(calls) == 2:
            raise OSError("native loader rejected batch submission")
        return real(handle, order, bi)

    monkeypatch.setattr(loader, "_submit_once", flaky)
    want = tdata.StreamingLoader(tdata.ArraySource(store), 8, seed=1,
                                 num_threads=1)
    _same([loader, want], 6)
    assert calls[1] == calls[2]  # the second submission, twice


def test_importing_the_native_loader_builds_nothing():
    """A fresh interpreter imports every training module with the
    compilers' process launches replaced by a failure: nothing runs."""
    code = (
        "import subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'a process was started: {a}')\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        "import ntxent_tpu_torch.training.native_loader\n"
        "import ntxent_tpu_torch.training\n"
        "import ntxent_tpu_torch.cli\n"
        "from ntxent_tpu_torch.ops import _build\n"
        "assert not any(k.startswith('host:') for k in _build._loaded)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_the_engine_is_the_ports_own_host_library():
    from ntxent_tpu_torch.ops import _build

    assert _build.HOST_SOURCES["loader"] == (
        REPO / "ntxent_tpu_torch" / "csrc" / "loader.cpp")
    assert "loader" not in _build.SOURCES  # no nvcc: not a kernel
    assert tnative.native_loader_available()
    lib = _build.load_host("loader")
    assert Path(lib._name) == _build.host_library_path("loader")
    assert lib._name.startswith(str(REPO / "build" / "torch_kernels"))
