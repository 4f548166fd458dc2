"""The retrieval tier in the port's fleet: its processes load no torch, and
``python -m ntxent_tpu_torch.fleet_cli --index-mem --search-shards 2
--shard-procs`` stores, searches and heals end to end on the CPU.

* **The tripwires**: a fresh interpreter that parses ``fleet_cli``'s every
  retrieval flag and builds and drives an ``IndexManager``, a
  ``ShardServer`` and a ``ShardFanout`` loads neither torch nor JAX, and
  neither does ``python -m ntxent_tpu_torch.retrieval.shard`` (a finder
  names the module that imported either, when one does).
* **End to end**: two of the port's serve workers (``--model tiny`` at
  8 px, ``--head embedding --proj-dim 8``, the plane's width) on a step
  the port saved, the in-memory index and two supervised shard processes
  with a journal. Rows go in through ``/index/insert`` and
  ``/embed?store=true``; each stored row's ``/search`` answer is the
  brute-force top 3 over the stored rows' embeddings, itself first;
  ``killshard`` SIGKILLs a shard, supervision restarts it on its port, the
  journal redelivers what it missed and every stored row finds itself
  again; neither the router nor a shard maps ``libtorch``; a SIGTERM exits
  0 and leaves no child.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ntxent_tpu_torch import cli
from ntxent_tpu_torch.obs import events
from ntxent_tpu_torch.training import CheckpointManager
from ntxent_tpu_torch.training import trainer as ttrain

from test_torch_serving_worker import WATCH_ARGV
from torch_fleet_fakes import get, post

pytestmark = pytest.mark.fleet

REPO = Path(__file__).resolve().parents[1]
LIMIT_S = 60.0
RETRIEVAL_MODULES = tuple(f"ntxent_tpu_torch.retrieval.{m}" for m in (
    "segments", "ivf", "pq", "scan", "index", "versioned", "journal",
    "shard"))

TRIPWIRE = (
    "import importlib.abc, json, sys, traceback\n"
    "leaks = []\n"
    "class Tripwire(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('torch', 'jax') and not leaks:\n"
    "            mods = [f.f_globals.get('__name__') for f, _ in\n"
    "                    traceback.walk_stack(None)]\n"
    "            leaks.append([name] + [m for m in mods if m and\n"
    "                          m.startswith('ntxent_tpu_torch')])\n"
    "        return None\n"
    "sys.meta_path.insert(0, Tripwire())\n"
    "def report():\n"
    "    return json.dumps({'leaks': leaks, 'modules': sorted(\n"
    "        m for m in sys.modules if m.split('.')[0] in\n"
    "        ('torch', 'jax', 'ntxent_tpu', 'ntxent_tpu_torch'))})\n")


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    return env


def _clean(got: dict) -> list:
    assert got["leaks"] == [], f"torch/jax imported via {got['leaks']}"
    loaded = got["modules"]
    assert [m for m in loaded if m.split(".")[0] != "ntxent_tpu_torch"] == []
    return loaded


# ---------------------------------------------------------------------------
# the tripwires


def test_fleet_cli_with_every_retrieval_flag_loads_neither_torch_nor_jax(
        tmp_path):
    code = TRIPWIRE + (
        "import numpy as np\n"
        "from ntxent_tpu_torch import fleet_cli, retrieval\n"
        "args = fleet_cli.build_fleet_parser().parse_args([\n"
        f"    '--index-dir', {str(tmp_path / 'ix')!r}, '--index-mem',\n"
        "    '--index-train-rows', '8', '--index-centroids', '2',\n"
        "    '--index-nprobe', '2', '--index-seal-rows', '8',\n"
        "    '--index-docstore-rows', '16', '--index-maintain-interval',\n"
        "    '0.5', '--index-pq-m', '4', '--search-shards', '2',\n"
        "    '--shard-procs', '--shard-journal-dir',\n"
        f"    {str(tmp_path / 'j')!r}, '--shard-repair-interval', '0.5',\n"
        "    '--slo-retrieval-degraded', '0.9',\n"
        "    '--chaos', 'killshard@2,lagshard@3'])\n"
        "for name in retrieval.__all__:\n"
        "    getattr(retrieval, name)\n"
        "from ntxent_tpu_torch.resilience import FaultInjector, FaultPlan\n"
        "FaultInjector(FaultPlan.parse(args.chaos)).on_shard_tick()\n"
        "x = np.random.RandomState(0).randn(12, 8).astype(np.float32)\n"
        "x /= np.linalg.norm(x, axis=1, keepdims=True)\n"
        "mgr = retrieval.IndexManager(root=args.index_dir,\n"
        "    train_rows=args.index_train_rows, n_centroids=2,\n"
        "    nprobe=2, seal_rows=8, pq_m=4, pq_ksub=8)\n"
        "mgr.insert(x, x, step=1); mgr.maintain()\n"
        "assert mgr.search(x[:1], k=1)['ids'][0][0] == 0\n"
        "srv = retrieval.ShardServer(8).start()\n"
        "fan = retrieval.ShardFanout([srv.url], dim=8, train_rows=8,\n"
        "    n_centroids=2, nprobe=2, pq_m=4,\n"
        "    journal_dir=args.shard_journal_dir)\n"
        "fan.activate(1); fan.insert(np.arange(12), x)\n"
        "assert fan.search(x[:1], k=1)['ids'][0][0] == 0\n"
        "fan.close(); srv.stop(); mgr.stop()\n"
        "print(report())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = _clean(json.loads(out.stdout.strip().splitlines()[-1]))
    assert set(RETRIEVAL_MODULES) <= set(loaded)
    assert "ntxent_tpu_torch.fleet_cli" in loaded


def test_a_shard_process_loads_neither_torch_nor_jax(tmp_path):
    port_file, report = tmp_path / "shard.port", tmp_path / "report.json"
    code = TRIPWIRE + (
        "import atexit, runpy\n"
        f"atexit.register(lambda: open({str(report)!r}, 'w')"
        ".write(report()))\n"
        "sys.argv = ['shard', '--dim', '8', '--port-file',\n"
        f"            {str(port_file)!r}]\n"
        "runpy.run_module('ntxent_tpu_torch.retrieval.shard',\n"
        "                 run_name='__main__', alter_sys=True)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            env=_env(), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + LIMIT_S
        while not port_file.exists() and time.monotonic() < deadline:
            assert proc.poll() is None, proc.stderr.read()
            time.sleep(0.05)
        status, _, body = get(f"http://127.0.0.1:{port_file.read_text()}"
                              "/readyz")
        assert status == 200 and json.loads(body)["ok"] is True
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    loaded = _clean(json.loads(report.read_text()))
    # (the shard module itself ran as __main__)
    assert {"ntxent_tpu_torch.retrieval.journal",
            "ntxent_tpu_torch.retrieval.pq"} <= set(loaded)
    assert "ntxent_tpu_torch.serving" not in loaded


# ---------------------------------------------------------------------------
# end to end


STORE_ARGV = ["--platform", "cpu", "--model", "tiny", "--image-size", "8",
              "--proj-hidden-dim", "16", "--proj-dim", "8", "--head",
              "embedding", "--buckets", "1,4", "--workers", "2",
              "--max-delay-ms", "2", "--health-poll", "0.2",
              "--fed-interval", "0.5", "--port", "0", "--run-id", "store",
              "--index-mem", "--index-train-rows", "16",
              "--index-centroids", "4", "--index-nprobe", "4",
              "--index-docstore-rows", "64", "--index-maintain-interval",
              "0.2", "--search-shards", "2", "--shard-procs",
              "--shard-repair-interval", "0.2",
              "--slo-retrieval-degraded", "0.9", "--chaos", "killshard@15"]


def _wait_for(fn, what, timeout_s=LIMIT_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = fn()
        if value:
            return value
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _port_step(ckpt, step: int) -> None:
    args = cli.build_serve_parser().parse_args(
        WATCH_ARGV[:WATCH_ARGV.index("--port")])
    state = ttrain.create_train_state(cli.build_model(args),
                                      ttrain.TrainerConfig(),
                                      torch.device("cpu"))
    state.step = step
    assert CheckpointManager(ckpt).save(step, state)


def _pids(router_log, marker: bytes) -> list:
    pids = []
    for r in events.read_events(str(router_log), "fleet"):
        if r.get("action") != "spawn":
            continue
        try:
            with open(f"/proc/{r['pid']}/cmdline", "rb") as f:
                if marker in f.read():
                    pids.append(r["pid"])
        except OSError:
            pass
    return pids


def _stop(proc, router_log) -> list:
    """SIGTERM the router; kill it and any child of its log still running
    when it does not exit. Returns the children that outlived it."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.communicate(timeout=LIMIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate(timeout=30)
    if not router_log.exists():
        return []
    alive = _pids(router_log, b"ntxent_tpu_torch.")
    for pid in alive:
        os.kill(pid, signal.SIGKILL)
    return alive


def test_the_fleet_stores_searches_and_heals_a_killed_shard(tmp_path):
    ckpt = tmp_path / "ck"
    _port_step(ckpt, 3)
    port_file, router_log = tmp_path / "router.port", tmp_path / "r.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "ntxent_tpu_torch.fleet_cli", *STORE_ARGV,
         "--ckpt-dir", str(ckpt), "--workdir", str(tmp_path / "wd"),
         "--port-file", str(port_file), "--log-jsonl", str(router_log),
         "--shard-journal-dir", str(tmp_path / "journal")],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    rng = np.random.default_rng(24)
    stored = {}  # id -> input row
    try:
        url = "http://127.0.0.1:" + _wait_for(
            lambda: port_file.exists() and port_file.read_text(),
            "the router's port file")

        def json_get(path):
            status, _, body = get(url + path)
            assert status == 200, body
            return json.loads(body)

        def ready():
            status, _, body = get(url + "/healthz")
            return status == 200 and json.loads(body)["workers_ready"] == 2

        _wait_for(ready, "two ready workers")

        def store(n, via):
            x = rng.uniform(-1, 1, (n, 8, 8, 3)).round(3)
            status, body, _ = post(url + via, {"inputs": x.tolist()})
            assert status == 200 and body["stored"] == n, body
            assert body["index_step"] == 3
            stored.update(zip(body["ids"], x))
            return body

        store(6, "/index/insert")
        assert "embeddings" in store(4, "/embed?store=true")
        # the shard plane trains at 16 rows; inserts go on until the
        # chaos plan's SIGKILL has landed, and some while it is down
        deaths = []
        while not deaths:
            store(2, "/index/insert")
            deaths = [r for r in events.read_events(str(router_log),
                                                    "fleet")
                      if r.get("action") == "death"]
            assert len(stored) < 400, "no killshard within the inserts"
        store(4, "/index/insert")
        assert deaths[0]["rc"] == -signal.SIGKILL

        def healed():
            plane = json_get("/index")["shard_plane"]
            return plane["journal_depth"] == 0 and all(
                s["alive"] for s in plane["shards"]) and plane

        plane = _wait_for(healed, "the shard back and its debt repaired")
        assert plane["trained"] and plane["n_shards"] == 2
        # the restarted shard came back empty: the journal redelivered
        # its whole history, through the plane's insert path
        assert plane["repaired"] > 0 and plane["dropped"] == 0
        assert plane["inserted"] >= len(stored)
        assert len(_pids(router_log, b"retrieval.shard")) == 2
        # each stored row's answer: the brute-force top 3 over the
        # stored rows' embeddings (the cache's copies of them), itself
        # first
        ids = np.asarray(sorted(stored))
        rows = np.stack([stored[i] for i in ids])
        status, body, _ = post(url + "/embed", {"inputs": rows.tolist()})
        assert status == 200 and body["cache_hits"] == len(ids)
        emb = np.asarray(body["embeddings"], np.float32)
        want = ids[np.argsort(-(emb @ emb.T), axis=1)[:, :3]]
        status, body, _ = post(url + "/search",
                               {"inputs": rows.tolist(), "k": 3})
        assert status == 200 and body["shards"] == {
            "ok": 2, "total": 2, "degraded": False}
        assert body["index_step"] == 3
        assert np.array_equal(np.asarray(body["ids"])[:, 0], ids)
        assert np.array_equal(np.asarray(body["ids"]), want)
        # no torch in the router nor in a shard: read their maps
        for pid in [proc.pid, *_pids(router_log, b"retrieval.shard")]:
            with open(f"/proc/{pid}/maps") as f:
                assert "libtorch" not in f.read(), pid
        index = json_get("/index")
        assert index["active_step"] == 3
        assert index["docstore_rows"] == min(64, len(stored))  # its bound
        metrics = json_get("/metrics")
        assert metrics["index"]["versions"]["3"]["rows"] == len(stored)
    finally:
        alive = _stop(proc, router_log)
    assert proc.returncode == 0, proc.stdout.read() if proc.stdout else ""
    assert alive == []
