"""The port's sources and threaded loader against the JAX package's
(``ntxent_tpu/training/datasets.py``), on the CPU at small sizes.

Sources are held byte for byte: ``ImageFolderSource`` on PNGs written here
with pillow (odd aspect ratios, an upscale, three classes, a stray file),
``Cifar10Source`` on a pickle directory written here. The threaded
``StreamingLoader`` is held batch for batch to the JAX one over two
epochs, for every rank of a sharded world, across a mid-epoch resume and
with ``drop_remainder=False``; exactly, since both gather the same rows.
"""

import pickle

import numpy as np
import pytest
import torch

from ntxent_tpu.training import datasets as jdata
from ntxent_tpu_torch.training import datasets as tdata

torch.set_num_threads(1)  # one torch thread a test worker


def _write_image_folder(root, rng):
    from PIL import Image

    sizes = {"cat": [(40, 24), (17, 31), (8, 8)],
             "dog": [(33, 33), (50, 12)],
             "emu": [(21, 64), (64, 21), (19, 20)]}
    for name, shapes in sizes.items():
        (root / name).mkdir(parents=True)
        for i, (h, w) in enumerate(shapes):
            pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(pixels).save(root / name / f"img_{i}.png")
    (root / "dog" / "notes.txt").write_text("not an image")
    (root / "stray.png").write_bytes(b"")  # not in a class directory


@pytest.mark.parametrize("size", [16, 24])
def test_image_folder_source_matches_jax_byte_for_byte(tmp_path, size):
    _write_image_folder(tmp_path, np.random.default_rng(0))
    got = tdata.ImageFolderSource(tmp_path, image_size=size)
    want = jdata.ImageFolderSource(tmp_path, image_size=size)
    assert got.class_names == want.class_names == ["cat", "dog", "emu"]
    assert got.labels_list == want.labels_list == [0, 0, 0, 1, 1, 2, 2, 2]
    np.testing.assert_array_equal(got.labels, want.labels)
    assert len(got) == len(want) == 8
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert a.dtype == np.uint8 and a.shape == (size, size, 3)
        np.testing.assert_array_equal(a, b)


def test_image_folder_source_takes_given_classes_and_refuses_empty(tmp_path):
    _write_image_folder(tmp_path, np.random.default_rng(1))
    got = tdata.ImageFolderSource(tmp_path, 8, class_names=["emu", "cat"])
    want = jdata.ImageFolderSource(tmp_path, 8, class_names=["emu", "cat"])
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got[5], want[5])
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no class directories"):
        tdata.ImageFolderSource(tmp_path / "empty")
    with pytest.raises(ValueError, match="no images found"):
        tdata.ImageFolderSource(tmp_path, class_names=["empty"])


def _write_cifar(root, rng, rows=3):
    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (rows, 3072), dtype=np.uint8),
                 b"labels": [int(x) for x in rng.integers(0, 10, rows)],
                 b"batch_label": name.encode()}
        with open(base / name, "wb") as f:
            pickle.dump(batch, f)
    return base


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("nested", [True, False])
def test_cifar10_source_matches_jax(tmp_path, train, nested):
    base = _write_cifar(tmp_path, np.random.default_rng(2))
    root = tmp_path if nested else base
    got = tdata.Cifar10Source(root, train=train)
    want = jdata.Cifar10Source(root, train=train)
    assert len(got) == len(want) == (15 if train else 3)
    assert got.images.shape == (len(got), 32, 32, 3)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got[len(got) - 1], want[len(want) - 1])


def test_array_source_keeps_labels_and_reads_memmaps(tmp_path):
    images = np.random.default_rng(3).integers(0, 256, (6, 4, 4, 3),
                                               dtype=np.uint8)
    np.save(tmp_path / "rows.npy", images)
    mm = np.load(tmp_path / "rows.npy", mmap_mode="r")
    labels = np.arange(6)
    got = tdata.ArraySource(mm, labels)
    want = jdata.ArraySource(mm, labels)
    assert got.labels is labels and len(got) == 6
    np.testing.assert_array_equal(got[4], want[4])
    assert type(got[4]) is np.ndarray


def _data(n=37, seed=7):
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, 4, 4, 3)).astype(np.uint8)


def _pairs(got, want, batches):
    for _ in range(batches):
        np.testing.assert_array_equal(next(got), next(want))


@pytest.mark.parametrize("threads,read_ahead", [(1, 1), (3, 2), (8, 4)])
def test_threaded_loader_matches_jax_over_two_epochs(threads, read_ahead):
    data = _data()
    got = iter(tdata.StreamingLoader(tdata.ArraySource(data), 8, seed=3,
                                     num_threads=threads,
                                     read_ahead=read_ahead))
    want = iter(jdata.StreamingLoader(jdata.ArraySource(data), 8, seed=3,
                                      num_threads=2))
    _pairs(got, want, 9)  # 4 batches an epoch


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_gets_the_jax_shard(world):
    data = _data(53)
    for rank in range(world):
        got = tdata.StreamingLoader(tdata.ArraySource(data), 12, seed=5,
                                    rank=rank, world_size=world,
                                    num_threads=2)
        want = jdata.StreamingLoader(jdata.ArraySource(data),
                                     12 // world, seed=5,
                                     shard_index=rank, shard_count=world)
        assert got.batches_per_epoch() == want.batches_per_epoch() == 4
        _pairs(iter(got), iter(want), 9)
        assert got.state() == want.state()


def test_resume_mid_epoch_matches_jax():
    data = _data()
    run = tdata.StreamingLoader(tdata.ArraySource(data), 8, seed=11,
                                num_threads=3)
    it = iter(run)
    for _ in range(6):  # into the second epoch
        next(it)
    state = run.state()
    assert state == {"epoch": 1, "offset": 2, "seed": 11}
    got = tdata.StreamingLoader(tdata.ArraySource(data), 8, num_threads=2)
    got.restore(state)
    want = jdata.StreamingLoader(jdata.ArraySource(data), 8, num_threads=2)
    want.restore(state)
    g, w = iter(got), iter(want)
    for _ in range(5):  # the JAX loader's and the uninterrupted run's
        batch = next(g)
        np.testing.assert_array_equal(batch, next(w))
        np.testing.assert_array_equal(batch, next(it))


def test_restore_reenters_a_running_pipeline():
    data = _data(24).astype(np.float32) / 255.0
    loader = tdata.StreamingLoader(tdata.ArraySource(data), 4, seed=2,
                                   num_threads=2)
    pipe = tdata.TwoViewPipeline(loader, "cpu", seed=1)
    first = [next(pipe) for _ in range(3)]
    pipe.restore({"epoch": 0, "offset": 1, "seed": 2})
    again = next(pipe)
    for a, b in zip(again, first[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_drop_remainder_false_yields_the_short_tail_as_jax_does():
    data = _data(19)
    got = tdata.StreamingLoader(tdata.ArraySource(data), 8, seed=4,
                                drop_remainder=False, num_threads=2)
    want = jdata.StreamingLoader(jdata.ArraySource(data), 8, seed=4,
                                 drop_remainder=False)
    assert got.batches_per_epoch() == want.batches_per_epoch() == 3
    g, w = iter(got), iter(want)
    shapes = []
    for _ in range(6):
        a, b = next(g), next(w)
        np.testing.assert_array_equal(a, b)
        shapes.append(len(a))
    assert shapes == [8, 8, 3, 8, 8, 3]
    with pytest.raises(ValueError, match="drop_remainder=True"):
        tdata.StreamingLoader(tdata.ArraySource(data), 8, rank=0,
                              world_size=2, drop_remainder=False)


def test_read_errors_reach_the_consumer_and_the_pool_stops():
    class Broken:
        def __len__(self):
            return 16

        def __getitem__(self, idx):
            if idx == 5:
                raise KeyError("row 5")
            return np.zeros((2, 2, 3), np.uint8)

    it = iter(tdata.StreamingLoader(Broken(), 16, num_threads=4))
    with pytest.raises(KeyError, match="row 5"):
        next(it)
    it.close()  # the abandoned generator shuts its pool down


def test_paired_loader_shares_the_shuffle():
    images, tokens = _data(20), np.arange(20)[:, None] * np.ones((1, 3), int)
    got = tdata.PairedArrayLoader(images, tokens, 8, seed=6)
    want = jdata.PairedArrayLoader(images, tokens, 8, seed=6)
    g, w = iter(got), iter(want)
    for _ in range(5):
        (a, s), (b, t) = next(g), next(w)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(s, t)
    assert got.state() == want.state()


def test_grain_loader_yields_whole_batches_of_the_port_sources(tmp_path):
    _write_cifar(tmp_path, np.random.default_rng(8), rows=4)
    source = tdata.Cifar10Source(tmp_path)
    batches = tdata.grain_loader(source, 6, seed=1)
    seen = []
    for _ in range(3):  # one epoch of 20 rows: 3 whole batches
        batch = np.asarray(next(batches))
        assert batch.shape == (6, 32, 32, 3) and batch.dtype == np.uint8
        seen.extend(batch)
    rows = {row.tobytes() for row in source.images}
    assert all(row.tobytes() in rows for row in seen)
    assert len({row.tobytes() for row in seen}) == 18  # no row twice


def test_device_prefetch_is_read_ahead_on_the_cpu():
    data = _data()
    loader = tdata.StreamingLoader(tdata.ArraySource(data), 8, seed=3,
                                   num_threads=2)
    pre = tdata.device_prefetch(loader, depth=3)
    jloader = jdata.StreamingLoader(jdata.ArraySource(data), 8, seed=3)
    want = iter(jloader)
    for _ in range(6):
        # the consumer's position, whatever the prefetcher read ahead
        assert pre.state() == jloader.state()
        got = next(pre)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), next(want))


def test_fetch_faults_count_every_read_of_the_loader_threads():
    """The chaos plan's fetch ordinals are counted under the loader's 16
    threads (more than the cores) with a short switch interval: every read
    counted once, each planned failure fired once and retried."""
    import sys

    from ntxent_tpu_torch.resilience import (
        FaultInjector,
        FaultPlan,
        RetryPolicy,
    )

    data = _data(64)
    injector = FaultInjector(FaultPlan.parse("fetch@3,fetch@40,fetch@90"))
    loader = tdata.StreamingLoader(
        injector.wrap_source(tdata.ArraySource(data)), 16, seed=1,
        num_threads=16, read_ahead=4,
        retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0))
    want = iter(jdata.StreamingLoader(jdata.ArraySource(data), 16, seed=1))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        it = iter(loader)
        for _ in range(8):  # two epochs: 128 reads, 3 of them retried
            np.testing.assert_array_equal(next(it), next(want))
        it.close()
    finally:
        sys.setswitchinterval(interval)
    assert sorted(injector.fired) == ["fetch@3", "fetch@40", "fetch@90"]
    assert injector._fetches >= 128 + 3
