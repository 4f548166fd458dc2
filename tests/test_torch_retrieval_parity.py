"""The port's retrieval tier against the JAX package's, module for module.

``ntxent_tpu_torch/retrieval`` is numpy and stdlib, like
``ntxent_tpu/retrieval``: the same numpy inputs go through both, and the
answers are equal exactly (``np.array_equal`` on ids, scores, centroids
and codes; ``==`` on bytes and dicts). Every file either package writes
(segments, centroid and codec snapshots, the docstore log, the shard
journal) is the other's byte for byte, and reopens in the other.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest

import ntxent_tpu.retrieval as J
import ntxent_tpu_torch.retrieval as P
from ntxent_tpu.retrieval import pq as jpq
from ntxent_tpu_torch.retrieval import pq as ppq

PACKAGES = {"jax": J, "port": P}
DIM = 16


def unit_rows(n, seed=0, dim=DIM):
    r = np.random.RandomState(seed)
    x = r.randn(n, dim).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def files(root) -> dict:
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def version_files(root) -> list:
    """``files`` with each index instance's directory nonce
    (``step-N/g-<hex>``, a uuid in both packages) taken out."""
    return sorted((re.sub(r"/g-[0-9a-f]+/", "/g-/", path), data)
                  for path, data in files(root).items())


def both(fn):
    """``fn(package, name)`` for the JAX package and the port."""
    return [fn(m, name) for name, m in PACKAGES.items()]


def assert_equal_trees(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert_equal_trees(u, v)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_equal_trees(a[k], b[k])
    else:
        assert a == b


# ---------------------------------------------------------------------------
# segments


def _fill_store(m, root):
    store = m.SegmentStore(DIM, root=root, seal_rows=16, compact_at=2)
    x = unit_rows(70, seed=2)
    sealed = []
    for lo in range(0, 70, 10):
        store.append(np.arange(lo, lo + 10, dtype=np.int64), x[lo:lo + 10])
        if store.should_seal():
            sealed.append(store.seal() is not None)
    return store, x, sealed


def test_segments_seal_reopen_and_compact_byte_for_byte(tmp_path):
    stores = both(lambda m, n: _fill_store(m, tmp_path / n))
    (sj, x, seals_j), (sp, _, seals_p) = stores
    assert seals_j == seals_p and sj.segment_count == sp.segment_count >= 3
    assert files(tmp_path / "jax") == files(tmp_path / "port")
    assert_equal_trees(sj.all_rows(), sp.all_rows())
    # each package reopens the other's sealed segments
    for writer, reader in (("jax", P), ("port", J)):
        back = reader.SegmentStore(DIM, root=tmp_path / writer)
        ids, vecs = back.all_rows()
        assert np.array_equal(ids, np.arange(ids.shape[0]))
        assert np.array_equal(vecs, x[:ids.shape[0]])
        assert back.rows == sj.rows - sj.mutable.rows
    for store in (sj, sp):
        assert store.should_compact()
        store.compact()
    assert len(sj.sealed) == len(sp.sealed) == 1
    assert sj.segment_count == sp.segment_count
    assert files(tmp_path / "jax") == files(tmp_path / "port")
    assert_equal_trees(sj.all_rows(), sp.all_rows())
    # a mutable segment alone: appends and views
    mj, mp = J.MutableSegment(DIM), P.MutableSegment(DIM)
    for seg in (mj, mp):
        seg.append(np.arange(5), x[:5])
        seg.append(np.arange(5, 9), x[5:9])
    assert_equal_trees(mj.view(), mp.view())


# ---------------------------------------------------------------------------
# IVF, PQ, the fused scan


def test_kmeans_ivf_and_brute_force_are_the_reference_s():
    x, q = unit_rows(300, seed=3), unit_rows(7, seed=4)
    ids = np.arange(300, dtype=np.int64) * 3
    out = []
    for m in (J, P):
        cents = m.kmeans(x, 12, iters=6, seed=5)
        ivf = m.IVFIndex(cents)
        ivf.add(ids[:200], x[:200])
        ivf.add(ids[200:], x[200:])
        out.append((cents, ivf.n_lists, ivf.search(q, k=6, nprobe=3),
                    ivf.search(q, k=400, nprobe=1),
                    m.brute_force_topk(q, ids, x, 9),
                    m.brute_force_topk(q, ids[:3], x[:3], 5)))
    assert_equal_trees(out[0], out[1])


@pytest.mark.parametrize("opq_iters", [0, 2])
def test_pq_codec_train_encode_adc_and_wire(tmp_path, opq_iters):
    x, q = unit_rows(400, seed=6), unit_rows(5, seed=7)
    codecs = [m.PQCodec(DIM, m=4, ksub=32, seed=3).train(
        x, kmeans_iters=6, opq_iters=opq_iters) for m in (J, P)]
    cj, cp = codecs
    assert_equal_trees(
        [cj.codebooks, cj.rotation, cj.gen, cj.m, cj.dsub, cj.bytes_per_row],
        [cp.codebooks, cp.rotation, cp.gen, cp.m, cp.dsub, cp.bytes_per_row])
    codes = cj.encode(x)
    assert codes.dtype == np.uint8 and np.array_equal(codes, cp.encode(x))
    assert_equal_trees(cj.decode(codes), cp.decode(codes))
    assert_equal_trees(cj.adc_tables(q), cp.adc_tables(q))
    assert_equal_trees(jpq.kmeans_l2(x[:, :4], 8, iters=5, seed=2),
                       ppq.kmeans_l2(x[:, :4], 8, iters=5, seed=2))
    wire = cj.to_wire()
    assert wire == cp.to_wire()
    for reader, w in ((P.PQCodec, wire), (J.PQCodec, cp.to_wire())):
        back = reader.from_wire(w)
        assert np.array_equal(back.encode(x), codes)
    for name, c in (("jax", cj), ("port", cp)):
        c.save(tmp_path / name)
    assert files(tmp_path / "jax") == files(tmp_path / "port")
    for writer, reader in (("jax", P.PQCodec), ("port", J.PQCodec)):
        back = reader.load(tmp_path / writer)
        assert_equal_trees([back.codebooks, back.rotation, back.gen],
                           [cj.codebooks, cj.rotation, cj.gen])


def _scan(m):
    x, q = unit_rows(500, seed=8), unit_rows(9, seed=9)
    cents = m.kmeans(x, 10, iters=5, seed=1)
    codec = m.PQCodec(DIM, m=8, ksub=16, seed=2).train(x, kmeans_iters=5)
    coded = m.CodedLists(cents, codec)
    for lo in (0, 300):
        src = coded.add_source(x[lo:lo + 300])
        n = min(300, 500 - lo)
        coded.add(np.arange(lo, lo + n, dtype=np.int64), x[lo:lo + n], src,
                  np.arange(n, dtype=np.int64))
    stats = {}
    got = m.batched_scan(coded, q, k=7, nprobe=4, rerank=40, stats=stats)
    wide = m.batched_scan(coded, q[:2], k=450, nprobe=1, rerank=40)
    batcher = m.ScanBatcher(lambda qq, key: m.batched_scan(
        coded, qq, k=key, nprobe=3, rerank=30), max_batch=4)
    fused = batcher.run(q[:3], 5)
    return (coded.n_lists, coded.rows, coded.memory_bytes(), got, wide, stats,
            fused, [coded.list_view(c) for c in range(coded.n_lists)])


def test_batched_scan_and_coded_lists_are_the_reference_s():
    assert_equal_trees(_scan(J), _scan(P))


# ---------------------------------------------------------------------------
# the index


INDEX_KW = dict(train_rows=64, n_centroids=8, nprobe=4, seal_rows=32,
                compact_at=2, pq_m=4, pq_ksub=16, pq_rerank=32)


def _index_run(m, root):
    x, q = unit_rows(260, seed=10), unit_rows(6, seed=11)
    metrics = m.RetrievalMetrics()
    idx = m.VectorIndex(DIM, step=3, root=root, metrics=metrics,
                        **INDEX_KW)
    idx.insert(np.arange(40), x[:40])
    below = (idx.trained, idx.search(q, 5), idx.search_exact(q, 3))
    idx.insert(np.arange(40, 200), x[40:200])
    passes = [idx.maintain()]
    while passes[-1]:
        passes.append(idx.maintain())
    idx.insert(np.arange(200, 260), x[200:])  # the live tail, unsealed
    above = (idx.trained, idx.rows, idx.search(q, 5), idx.search(q, 70),
             idx.scan_bytes_per_row(), idx.resident_bytes(),
             idx.recall_probe(k=5, sample=8), idx.store.segment_count)
    return below, above, passes, metrics.registry.collect()


def test_vector_index_below_and_above_train_rows(tmp_path):
    run_j = _index_run(J, tmp_path / "jax")
    run_p = _index_run(P, tmp_path / "port")
    assert run_j[0][0] is False and run_j[1][0] is True
    assert_equal_trees(run_j[:3], run_p[:3])
    # the metric families: the same series, the same counts
    strip = {k: v for k, v in run_j[3].items() if "ms" not in k}
    assert strip == {k: v for k, v in run_p[3].items() if "ms" not in k}
    assert files(tmp_path / "jax") == files(tmp_path / "port")
    # a trained index reopens from the other package's snapshots
    q = unit_rows(6, seed=11)
    for writer, reader in (("jax", P), ("port", J)):
        back = reader.VectorIndex(DIM, step=3, root=tmp_path / writer,
                                  **INDEX_KW)
        assert back.trained and back.trained_from_snapshot
        want = (J if reader is P else P).VectorIndex(
            DIM, step=3, root=tmp_path / writer, **INDEX_KW)
        assert back.rows == want.rows > 0  # the sealed rows
        assert_equal_trees(back.search(q, 5), want.search(q, 5))


# ---------------------------------------------------------------------------
# the versioned manager


def _reembed(rows):
    """A deterministic stand-in for the fleet's forward: the first DIM
    inputs of each row, shifted and normalized."""
    v = np.asarray(rows, np.float32).reshape(len(rows), -1)[:, :DIM] + 0.25
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _manager_script(m, root):
    inputs = np.random.RandomState(12).rand(90, 4, 4).astype(np.float32)
    emb = _reembed(inputs)
    mgr = m.IndexManager(root=root, docstore_rows=80, train_rows=40,
                         n_centroids=4, nprobe=2, seal_rows=16, pq_m=4,
                         pq_ksub=16, pq_rerank=16)
    mgr.reembed = _reembed
    out = {"before": mgr.snapshot()}
    out["ids1"] = mgr.insert(inputs[:50], emb[:50], step=1)
    out["wrong_step"] = mgr.insert(inputs[:2], emb[:2], step=9)
    out["wrong_dim"] = mgr.insert(inputs[:2], emb[:2, :8], step=1)
    mgr.maintain()
    out["search1"] = mgr.search(emb[:4], k=3)
    mgr.promote(2)
    assert mgr.wait_rebuild(30)
    out["promoted"] = mgr.snapshot()
    out["ids2"] = mgr.insert(inputs[50:90], emb[50:90], step=2)
    mgr.maintain()
    out["search2"] = mgr.search(emb[40:44], k=3)
    out["prior"] = mgr.search(emb[:4], k=3, prefer_step=1)
    out["rolled_back"] = mgr.rollback_to(1)
    out["after_rollback"] = (mgr.snapshot(), mgr.search(emb[:4], k=3))
    mgr.on_canary_rollback(5, "shadow_drift")
    assert mgr.wait_rebuild(30)
    out["after_drift"] = (mgr.snapshot(), mgr.search(emb[:4], k=3))
    mgr.mark_stale("drift")
    assert mgr.wait_rebuild(30)
    out["rebuilt"] = (mgr.snapshot(), mgr.search(emb[60:63], k=2))
    mgr.reembed = None
    mgr.mark_stale("no reembed")
    out["stale"] = (mgr.stale, mgr.search(emb[:1], k=1)["stale"])
    out["docstore"] = mgr.docstore_inputs()
    out["metrics"] = {k: v for k, v in mgr.metrics.registry.collect().items()
                      if "ms" not in k}
    mgr.stop()
    return out


def test_index_manager_insert_promote_rollback_stale_rebuild(tmp_path):
    out_j = _manager_script(J, tmp_path / "jax")
    out_p = _manager_script(P, tmp_path / "port")
    assert out_j["ids1"] == list(range(50)) and out_j["wrong_step"] == []
    assert out_j["promoted"]["active_step"] == 2
    assert out_j["after_rollback"][0]["active_step"] == 1
    assert out_j["stale"] == (True, True)
    assert_equal_trees(out_j, out_p)
    assert version_files(tmp_path / "jax") == version_files(tmp_path / "port")
    # the durable docstore reopens in the other package
    for writer, reader in (("jax", P), ("port", J)):
        back = reader.IndexManager(root=tmp_path / writer,
                                   docstore_rows=80)
        assert_equal_trees(back.docstore_inputs(), out_j["docstore"])
        assert back.snapshot()["next_id"] == 90
        back.stop()


# ---------------------------------------------------------------------------
# the shard journal and placement


def _journal(m, root):
    j = m.ShardJournal(root)
    vecs = unit_rows(6, seed=13)
    for sid, base in ((0, 0), (1, 100), (0, 10), (0, 20), (1, 110)):
        j.append(sid, np.arange(base, base + 6, dtype=np.int64), vecs, 100)
    j.ack(0, 0, 6)
    j.ack(0, 2, 6)  # above a gap: held pending
    j.ack(1, 0, 6)
    state = (j.depths(), j.totals(0), j.totals(1), j.shards())
    j.close()
    return state


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shard_journal_torn_tail_reopens_in_either_package(tmp_path,
                                                           writer):
    states = both(lambda m, n: _journal(m, tmp_path / n))
    assert_equal_trees(states[0], states[1])
    assert files(tmp_path / "jax") == files(tmp_path / "port")
    log = tmp_path / writer / "shard-0.log"
    with open(log, "r+b") as f:  # a kill mid-append: a torn last record
        f.truncate(log.stat().st_size - 13)
    replays = []
    for m in (J, P):
        j = m.ShardJournal(tmp_path / writer)
        replays.append((j.totals(0), j.depths(),
                        list(j.replay(0, from_start=True)),
                        list(j.replay(1))))
        j.close()
    assert replays[0][0] == (2, 12)  # the torn third batch is gone
    assert_equal_trees(replays[0], replays[1])


def test_journal_compaction_is_the_reference_s(tmp_path):
    def run(m, name):
        j = m.ShardJournal(tmp_path / name, compact_rows=4)
        ids = np.arange(4, dtype=np.int64)
        j.ack(0, j.append(0, ids, unit_rows(4, seed=1), 100), 4)
        j.ack(0, j.append(0, ids, unit_rows(4, seed=2), 100), 4)
        j.append(0, ids + 4, unit_rows(4, seed=3), 99)
        done = j.maybe_compact(0, 100)
        out = (done, j.totals(0), j.depth(0),
               list(j.replay(0, from_start=True)))
        j.close()
        return out

    assert_equal_trees(*both(run))
    assert files(tmp_path / "jax") == files(tmp_path / "port")


def test_shard_owner_placement_across_grow_and_shrink():
    lists = np.arange(2048)
    owners = {n: P.shard_owner(lists, n) for n in range(1, 7)}
    for n, o in owners.items():
        assert np.array_equal(o, J.shard_owner(lists, n))
        assert o.dtype == J.shard_owner(lists, n).dtype
    for n in range(1, 6):  # growing moves lists only to the new shard
        moved = owners[n] != owners[n + 1]
        assert np.all(owners[n + 1][moved] == n)
