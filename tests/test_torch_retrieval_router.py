"""The port's router over its retrieval tier against the JAX package's
router over the JAX tier: ``POST /search``, ``POST /index/insert``,
``/embed?store=true``, ``GET /index``, the trust gate on inserts, the
promote's re-embedding rebuild, the fleet-wide rollback, the drift
breach's stale flag, and the shard plane behind ``/search``.

Both routers run over the same stdlib stub workers (``test_retrieval.py``'s
``StubWorker``: a worker whose embedding space moves with its step), one
script of requests each; every answer's status and JSON body are equal.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import ntxent_tpu.retrieval as J
import ntxent_tpu_torch.retrieval as P
from ntxent_tpu.serving import router as jrouter
from ntxent_tpu_torch.serving import router as prouter

from test_retrieval import StubWorker

PACKAGES = {"jax": (jrouter, J), "port": (prouter, P)}


def _call(router, path, payload=None):
    url = f"http://127.0.0.1:{router.port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=15) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


class Rig:
    """A router of one package over a stub worker on step 1, with that
    package's ``IndexManager`` (and, with ``shards``, its shard plane)."""

    def __init__(self, name, shards=False, index=True):
        rmod, rpkg = PACKAGES[name]
        self.worker = StubWorker(step=1)
        self.pool = rmod.WorkerPool(canary_min_requests=4,
                                    canary_fraction=1.0)
        self.pool.upsert("w0", self.worker.url)
        self.pool.set_health("w0", alive=True, ready=True,
                             checkpoint_step=1)
        self.router = rmod.FleetRouter(self.pool, cache=None,
                                       example_shape=(2, 2), port=0)
        self.manager = None
        if index:
            self.manager = rpkg.IndexManager(train_rows=100_000)
            self.router.attach_index(self.manager)
        self.servers, self.fanout = [], None
        if shards:
            self.servers = [rpkg.ShardServer(4).start() for _ in range(2)]
            self.fanout = rpkg.ShardFanout(
                [s.url for s in self.servers], dim=4, train_rows=8,
                n_centroids=2, nprobe=2, pq_m=2)
            self.router.attach_shards(self.fanout)
        self.router.start()
        self.log = []

    def call(self, label, path, payload=None):
        status, body, headers = _call(self.router, path, payload)
        logged = body
        if isinstance(body, dict) and "shard_plane" in body:
            # the shards' URLs are their ports, which differ
            plane = dict(body["shard_plane"], shards=[
                {k: v for k, v in s.items() if k != "url"}
                for s in body["shard_plane"]["shards"]])
            logged = dict(body, shard_plane=plane)
        self.log.append((label, status, logged))
        return status, body, headers

    def close(self):
        self.router.close()
        if self.fanout is not None:
            self.fanout.close()
        for s in self.servers:
            s.stop()
        self.worker.close()


def _rows(seed, n):
    return np.random.RandomState(seed).rand(n, 2, 2).astype(
        np.float32).tolist()


def _surface(rig):
    rows = _rows(0, 6)
    status, body, headers = rig.call("insert", "/index/insert",
                                     {"inputs": rows})
    assert status == 200 and body["stored"] == 6
    assert body["ids"] == list(range(6)) and "X-Request-Id" in headers
    rig.call("search", "/search", {"inputs": [rows[2]], "k": 3})
    rig.call("store", "/embed?store=true", {"inputs": _rows(1, 3)})
    rig.call("plain", "/embed", {"inputs": _rows(1, 3)})
    rig.call("k0", "/search", {"inputs": [rows[0]], "k": 0})
    rig.call("no_inputs", "/search", {"k": 3})
    rig.call("array", "/search", [[0.1, 0.2]])
    rig.call("bad_rows", "/index/insert", {"inputs": [[1.0]]})
    rig.call("index", "/index")
    rig.log.append(("metrics", None, rig.router.metrics_dict()["index"]))


def _rollout(rig):
    rows = _rows(3, 8)
    rig.call("insert", "/index/insert", {"inputs": rows})
    rig.worker.step = 2  # the watcher swapped the worker
    rig.pool.set_health("w0", alive=True, ready=True, checkpoint_step=2)
    for i in range(6):  # canary outcomes -> the promote
        rig.call(f"embed{i}", "/embed", {"inputs": rows[:1]})
    assert rig.pool.trusted_step == 2 and rig.manager.active_step == 2
    assert rig.manager.wait_rebuild()
    rig.call("promoted", "/search", {"inputs": [rows[0]], "k": 3})
    rig.call("index", "/index")
    # operators force the fleet back: the pool demotes, the index
    # restores the retained step-1 version
    rig.worker.step = 1
    rig.pool.set_health("w0", alive=True, ready=True, checkpoint_step=1)
    assert rig.manager.active_step == 1
    rig.call("rolled_back", "/search", {"inputs": [rows[0]], "k": 3})
    rig.manager.reembed = None  # the stale flag must stay observable
    rig.manager.on_canary_rollback(7, "shadow_drift")
    rig.call("stale", "/search", {"inputs": [rows[0]], "k": 2})


def _gated(rig):
    rows = _rows(2, 2)
    rig.call("trusted", "/index/insert", {"inputs": rows})
    canary = StubWorker(step=2)
    try:
        rig.pool.upsert("w1", canary.url)
        rig.pool.set_health("w1", alive=True, ready=True, checkpoint_step=2)
        picked = rig.pool.pick()  # arms the canary state machine
        rig.pool.done(picked.worker_id)
        assert rig.pool.canary_step() == 2
        status, body, _ = rig.call("gated", "/index/insert",
                                   {"inputs": rows})
        assert status == 200 and body["stored"] == 0 \
            and body["reason"] == "not_trusted"
        rig.call("gated_store", "/embed?store=true", {"inputs": rows})
    finally:
        canary.close()


def _shard_plane(rig):
    rows = _rows(4, 12)
    rig.call("insert", "/index/insert", {"inputs": rows})
    rig.call("search", "/search", {"inputs": rows[:3], "k": 2})
    status, body, _ = rig.call("index", "/index")
    assert status == 200 and body["shard_plane"]["trained"] is True
    rig.servers[1].stop()  # a dead shard degrades recall, not the status
    status, body, _ = rig.call("degraded", "/search",
                               {"inputs": rows[:3], "k": 2})
    assert status == 200 and body["shards"]["degraded"] is True


def _no_index(rig):
    rig.call("search", "/search", {"inputs": [[[0.1, 0.2], [0.3, 0.4]]]})
    rig.call("insert", "/index/insert", {"inputs": _rows(0, 1)})
    rig.call("index", "/index")
    rig.call("store", "/embed?store=true", {"inputs": _rows(0, 1)})


SCRIPTS = {"surface": (_surface, {}), "rollout": (_rollout, {}),
           "gated": (_gated, {}), "shard_plane": (_shard_plane,
                                                   {"shards": True}),
           "no_index": (_no_index, {"index": False})}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_the_retrieval_surface_answers_as_the_jax_router_does(script):
    fn, kw = SCRIPTS[script]
    logs = []
    for name in PACKAGES:
        rig = Rig(name, **kw)
        try:
            fn(rig)
        finally:
            rig.close()
        logs.append(rig.log)
    assert logs[0] == logs[1]
    assert [code for _, code, _ in logs[0] if code is not None]
