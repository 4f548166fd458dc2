"""The port's serving fleet end to end on the CPU, its command line, and
the router tier's import boundary.

* **The tripwire**: a fresh interpreter imports ``fleet_cli``, the router
  tier, the fleet's ``obs`` modules and ``FaultPlan`` / ``FaultInjector``
  and loads neither torch nor JAX (a finder names the module that
  imported torch when one does).
* **The command line**: every ``ntxent-fleet`` flag of the JAX CLI parses
  with the JAX default; each retrieval flag and shard chaos action parses
  to the JAX parser's value and is accepted as the JAX CLI accepts it
  (shard chaos without ``--search-shards N --shard-procs`` ignored with
  its warning); the JAX CLI's exits on contradictory
  flags are the port's, message for message; ``cli.main(["fleet", ...])``
  reaches the same entry.
* **End to end**: ``python -m ntxent_tpu_torch.fleet_cli --platform cpu``
  over two of the port's serve workers (``--model tiny`` at 8 px) on a
  step the JAX package's ``CheckpointManager`` wrote: answers within
  2e-2 of the JAX model's apply of that step (the tolerance of
  ``test_torch_serving_worker.py``'s watcher test, the same tiny model),
  a repeated request answered from the cache bit for bit; a step the
  port wrote from the same weights with the projection's last layer
  scaled by 1.5 (the same embeddings) canaried, shadow-diffed and
  promoted fleet-wide; a step with that layer negated (drift 2) rolled
  back on the drift bar and blocked on both workers while the answers
  stay the JAX model's; ``/metrics/fleet`` holding both workers,
  ``/metrics/history`` and its spill, a SIGTERM that exits 0 and leaves
  no worker alive, and one merged Chrome trace holding every forwarded
  request id in the router's lane and a worker's.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ntxent_tpu import cli as jcli
from ntxent_tpu.models import SimCLRModel as JaxSimCLR
from ntxent_tpu.training.checkpoint import CheckpointManager as JaxManager
from ntxent_tpu.training.trainer import TrainerConfig as JaxConfig
from ntxent_tpu.training.trainer import create_train_state as jax_state
from ntxent_tpu_torch import cli
from ntxent_tpu_torch import fleet_cli
from ntxent_tpu_torch.obs import events, trace
from ntxent_tpu_torch.obs.history import MetricHistory

from ntxent_tpu_torch.training import CheckpointManager
from ntxent_tpu_torch.training import trainer as ttrain

from test_torch_serving_worker import WATCH_ARGV
from torch_fleet_fakes import get, post

pytestmark = pytest.mark.fleet

REPO = Path(__file__).resolve().parents[1]
ROUTER_TIER = ("ntxent_tpu_torch.fleet_cli", "ntxent_tpu_torch.serving.router",
               "ntxent_tpu_torch.serving.fleet", "ntxent_tpu_torch.serving.cache",
               "ntxent_tpu_torch.serving.shadow",
               "ntxent_tpu_torch.serving.autoscale",
               "ntxent_tpu_torch.obs.aggregate", "ntxent_tpu_torch.obs.slo",
               "ntxent_tpu_torch.obs.history", "ntxent_tpu_torch.obs.trace",
               "ntxent_tpu_torch.obs.exporters")
EMBED_ATOL = 2e-2
LIMIT_S = 60.0


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    return env


# ---------------------------------------------------------------------------
# the import boundary


def test_the_router_tier_loads_neither_torch_nor_jax():
    code = (
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
        "import ntxent_tpu_torch.fleet_cli\n"
        "from ntxent_tpu_torch.serving import (AutoscaleController,\n"
        "    EmbeddingCache, FleetRouter, ServingFleet, ShadowMirror,\n"
        "    TenantAdmission, TokenBucket, WorkerPool, cosine_drift,\n"
        "    flash_crowd, parse_tenant_quotas)\n"
        "from ntxent_tpu_torch.obs import (AlertStore, AnomalyDetector,\n"
        "    FleetAggregator, Forecaster, HistoryRecorder, MetricHistory,\n"
        "    Objective, SLOEngine, export_merged_chrome_trace,\n"
        "    merge_states)\n"
        "from ntxent_tpu_torch.resilience import FaultInjector, FaultPlan\n"
        f"for name in {ROUTER_TIER!r}:\n"
        "    importlib.import_module(name)\n"
        "FaultInjector(FaultPlan.parse('killworker@1')).on_fleet_tick()\n"
        "print(json.dumps({'leaks': leaks, 'modules': sorted(\n"
        "    m for m in sys.modules if m.split('.')[0] in\n"
        "    ('torch', 'jax', 'ntxent_tpu', 'ntxent_tpu_torch'))}))\n")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    seconds = time.monotonic() - t0
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["leaks"] == [], f"torch/jax imported via {got['leaks']}"
    loaded = got["modules"]
    assert [m for m in loaded if m.split(".")[0] != "ntxent_tpu_torch"] == []
    assert set(ROUTER_TIER) <= set(loaded)
    assert "ntxent_tpu_torch.api" not in loaded
    assert seconds < 30.0  # no multi-second torch import on the way


def test_the_lazy_exports_still_resolve():
    import ntxent_tpu_torch
    from ntxent_tpu_torch import obs, resilience, serving

    assert ntxent_tpu_torch.ntxent_loss_fused.__module__.startswith(
        "ntxent_tpu_torch")
    for package in (ntxent_tpu_torch, obs, resilience, serving):
        for name in package.__all__:
            if name != "__version__":
                assert getattr(package, name) is not None, name
        assert set(package.__all__) <= set(dir(package))
        with pytest.raises(AttributeError):
            package.no_such_name  # noqa: B018


# ---------------------------------------------------------------------------
# the command line


def _defaults(parser) -> dict:
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_every_jax_fleet_flag_parses_with_the_jax_default():
    port = _defaults(fleet_cli.build_fleet_parser())
    jax = _defaults(jcli.build_fleet_parser())
    assert port == jax
    port_flags = {s for a in fleet_cli.build_fleet_parser()._actions
                  for s in a.option_strings}
    jax_flags = {s for a in jcli.build_fleet_parser()._actions
                 for s in a.option_strings}
    assert port_flags == jax_flags
    assert cli.fleet_main is fleet_cli.fleet_main
    assert cli.build_fleet_parser is fleet_cli.build_fleet_parser
    assert cli.MODEL_CHOICES is fleet_cli.MODEL_CHOICES


RETRIEVAL_ARGV = {
    "index_dir": ["--index-dir", "x"], "index_mem": ["--index-mem"],
    "index_train_rows": ["--index-train-rows", "5"],
    "index_centroids": ["--index-centroids", "5"],
    "index_nprobe": ["--index-nprobe", "5"],
    "index_seal_rows": ["--index-seal-rows", "5"],
    "index_docstore_rows": ["--index-docstore-rows", "5"],
    "index_maintain_interval": ["--index-maintain-interval", "5"],
    "index_pq_m": ["--index-pq-m", "0"],
    "search_shards": ["--search-shards", "2"],
    "shard_procs": ["--shard-procs"],
    "shard_journal_dir": ["--shard-journal-dir", "x"],
    "shard_repair_interval": ["--shard-repair-interval", "5"],
    "slo_retrieval_degraded": ["--slo-retrieval-degraded", "0.9"],
}


# the JAX CLI's defaults of the retrieval tier's flags
RETRIEVAL_DEFAULTS = {
    "index_dir": None, "index_mem": False, "index_train_rows": 2048,
    "index_centroids": 64, "index_nprobe": 16, "index_seal_rows": 4096,
    "index_docstore_rows": 65536, "index_maintain_interval": 2.0,
    "index_pq_m": 8, "search_shards": 0, "shard_procs": False,
    "shard_journal_dir": None, "shard_repair_interval": 1.0,
    "slo_retrieval_degraded": None}


def test_the_retrieval_flags_are_live_with_the_jax_defaults():
    assert set(RETRIEVAL_DEFAULTS) == set(RETRIEVAL_ARGV)
    for table in ("FLEET_UNPORTED", "FLEET_ROADMAP_ITEMS"):
        assert not hasattr(fleet_cli, table)
    port = _defaults(fleet_cli.build_fleet_parser())
    jax = _defaults(jcli.build_fleet_parser())
    for dest, default in RETRIEVAL_DEFAULTS.items():
        assert port[dest] == jax[dest] == default


@pytest.mark.parametrize("argv", [
    *RETRIEVAL_ARGV.values(), ["--chaos", "killworker@3,killshard@2"],
    ["--chaos", "lagshard@1"]], ids=lambda a: a[0] + a[-1])
def test_each_retrieval_flag_is_accepted_as_the_jax_cli_accepts_it(
        tmp_path, caplog, argv):
    """The flag parses to the JAX parser's value and passes every check
    the JAX CLI makes before it starts anything: both CLIs go on to the
    same later exit (a replica router over a missing pool), and a shard
    chaos action without ``--search-shards N --shard-procs`` is ignored
    with the JAX CLI's warning."""
    parsed = [vars(build().parse_args(argv)) for build in (
        jcli.build_fleet_parser, fleet_cli.build_fleet_parser)]
    assert parsed[0] == parsed[1]
    messages = []
    for main in (jcli.fleet_main, fleet_cli.fleet_main):
        caplog.clear()
        with pytest.raises(SystemExit) as e:
            main([*argv, "--attach-workdir", str(tmp_path / "nope")])
        messages.append((str(e.value), "need --search-shards N with "
                         "--shard-procs — ignored here" in caplog.text))
    assert messages[0] == messages[1]
    assert "does not exist" in messages[1][0]
    assert messages[1][1] == (argv[0] == "--chaos")


@pytest.mark.parametrize("argv", [
    ["--slo-availability", "0.99", "--fed-interval", "0"],
    ["--slo-drift", "0.1", "--fed-interval", "0"],
    ["--autoscale", "--fed-interval", "0"],
    ["--predict-horizon", "30"],
    ["--autoscale", "--min-workers", "3", "--max-workers", "2"],
    ["--workers", "0"], ["--buckets", "1,x"], ["--buckets", "0,4"],
    ["--tenant-quota", "a=x"], ["--chaos", "nope@1"],
], ids=lambda a: "_".join(a))
def test_contradictory_flags_exit_as_the_jax_cli_does(tmp_path, argv):
    """Each exits before any worker starts, with the JAX CLI's message."""
    messages = []
    for main in (jcli.fleet_main, fleet_cli.fleet_main):
        with pytest.raises((SystemExit, ValueError)) as e:
            main([*argv, "--workdir", str(tmp_path / "w"), "--port", "0"])
        messages.append(str(e.value))
    assert messages[1] == messages[0]
    assert list((tmp_path / "w").glob("*.port")) == []


def test_attach_mode_refuses_autoscale_and_ignores_fleet_chaos(tmp_path,
                                                               caplog):
    with pytest.raises(SystemExit, match="does not exist"):
        fleet_cli.fleet_main(["--attach-workdir", str(tmp_path / "nope")])
    (tmp_path / "pool").mkdir()
    with pytest.raises(SystemExit, match="--attach-workdir"):
        fleet_cli.fleet_main(["--attach-workdir", str(tmp_path / "pool"),
                              "--autoscale", "--chaos", "killworker@3"])
    assert "ignored in --attach-workdir mode" in caplog.text
    with pytest.raises(SystemExit, match="--platform tpu"):
        fleet_cli.fleet_main(["--platform", "tpu"])


# ---------------------------------------------------------------------------
# end to end over the port's serve workers


FLEET_ARGV = ["--platform", "cpu", "--model", "tiny", "--image-size", "8",
              "--proj-hidden-dim", "16", "--proj-dim", "8", "--head",
              "embedding", "--buckets", "1,4", "--workers", "2",
              "--max-delay-ms", "2", "--watch-poll", "0.2",
              "--worker-stagger", "4", "--health-poll", "0.2",
              "--canary-fraction", "0.5", "--canary-min-requests", "4",
              "--shadow-fraction", "1.0", "--shadow-min-samples", "4",
              "--shadow-max-drift", "0.5", "--fed-interval", "0.5",
              "--slo-availability", "0.99", "--slo-latency-ms", "5000",
              "--autoscale", "--min-workers", "1", "--max-workers", "2",
              "--scale-idle-ticks", "1000000", "--port", "0",
              "--run-id", "e2e"]


def _wait_for(fn, what, timeout_s=LIMIT_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = fn()
        if value:
            return value
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _jax_step(directory, step: int):
    """A JAX --model tiny SimCLR state at its initial statistics, saved by
    the JAX manager; returns (flax model, variables). (Its embeddings are
    nonzero: the running statistics of a fresh state keep the ReLUs
    open.)"""
    jmodel = JaxSimCLR(encoder=jcli._make_encoder("tiny", 8),
                       proj_hidden_dim=16, proj_dim=8)
    jstate = jax_state(jmodel, jax.random.PRNGKey(5), (1, 8, 8, 3),
                       JaxConfig())
    manager = JaxManager(directory)
    assert manager.save(step, jstate, force=True)
    manager.close()
    return jmodel, {"params": jstate.params,
                    "batch_stats": jstate.batch_stats}


def _derived_step(ckpt, step: int, scale: float):
    """Step 3's weights with the projection's last layer times ``scale``,
    saved by the port's manager at ``step``."""
    args = cli.build_serve_parser().parse_args(
        WATCH_ARGV[:WATCH_ARGV.index("--port")])
    model = cli.build_model(args)
    CheckpointManager(ckpt).restore_variables(model, step=3)
    with torch.no_grad():
        model.projector.fc2.weight.mul_(scale)
    state = ttrain.create_train_state(model, ttrain.TrainerConfig(),
                                      torch.device("cpu"))
    state.step = step
    assert CheckpointManager(ckpt).save(step, state)


def _stop(proc, router_log) -> None:
    """The router and, on a failed case, the workers it spawned: a
    SIGTERM stops both; a router that does not exit is killed, and so is
    any worker of its log still running."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.communicate(timeout=LIMIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate(timeout=30)
    if not router_log.exists():
        return
    for r in events.read_events(str(router_log), "fleet"):
        if r.get("action") != "spawn":
            continue
        try:  # a worker still running, not a pid the system reused
            with open(f"/proc/{r['pid']}/cmdline", "rb") as f:
                if b"ntxent_tpu_torch.cli" in f.read():
                    os.kill(r["pid"], signal.SIGKILL)
        except OSError:
            pass


def _json(url):
    status, _, body = get(url)
    return status, json.loads(body) if body else None


def test_the_fleet_serves_the_jax_step_then_promotes_a_port_step(tmp_path):
    ckpt = tmp_path / "ck"
    jmodel, variables = _jax_step(ckpt, 3)
    workdir, port_file = tmp_path / "wd", tmp_path / "router.port"
    router_log, history_dir = tmp_path / "router.jsonl", tmp_path / "hist"
    proc = subprocess.Popen(
        [sys.executable, "-m", "ntxent_tpu_torch.fleet_cli", *FLEET_ARGV,
         "--ckpt-dir", str(ckpt), "--workdir", str(workdir), "--port-file",
         str(port_file), "--log-jsonl", str(router_log), "--history-dir",
         str(history_dir)],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (4, 8, 8, 3)).round(3)
    rids = []
    try:
        url = "http://127.0.0.1:" + _wait_for(
            lambda: port_file.exists() and port_file.read_text(),
            "the router's port file")

        def health():
            status, body = _json(url + "/healthz")
            return status == 200 and body["workers_ready"] == 2 and body

        assert _wait_for(health, "two ready workers")["trusted_step"] == 3

        def embed(rows, rid):
            status, body, headers = post(url + "/embed",
                                         {"inputs": rows.tolist()},
                                         {"X-Request-Id": rid})
            assert status == 200, body
            assert headers["X-Request-Id"] == rid
            rids.append((rid, body["cache_hits"] < len(rows)))
            return body

        want = np.asarray(jmodel.apply(variables, x.astype(np.float32),
                                       train=False))
        assert np.abs(np.linalg.norm(want, axis=1) - 1).max() < 1e-5
        first = embed(x, "jax-0")
        np.testing.assert_allclose(first["embeddings"], want, rtol=0,
                                   atol=EMBED_ATOL)
        again = embed(x, "jax-1")  # every row from the cache
        assert again["cache_hits"] == 4
        assert again["embeddings"] == first["embeddings"]
        part = embed(np.concatenate([x[:2], x[:2] + 0.5]), "jax-2")
        assert part["cache_hits"] == 2
        assert part["embeddings"][:2] == first["embeddings"][:2]

        def roll_until(done, what):
            n = iter(range(10**6))
            return _wait_for(lambda: embed(rng.uniform(-1, 1, (
                2, 8, 8, 3)).round(3), f"{what}-{next(n)}") and done(),
                what)

        def steps():
            _, m = _json(url + "/metrics")
            return m, {w: v["checkpoint_step"]
                       for w, v in m["workers"].items()}

        # step 5, the same embeddings: w0 adopts it at once (the canary),
        # w1 4 s later; mirrored rows diff it, the verdict promotes it
        _derived_step(ckpt, 5, 1.5)
        roll_until(lambda: steps()[0]["trusted_step"] == 5, "promote")
        metrics, served = steps()
        verdict = metrics["last_verdict"]
        assert verdict["step"] == 5 and verdict["reason"] == \
            "error_rate+drift" and verdict["drift_p99"] < 1e-4, verdict
        _wait_for(lambda: steps()[1] == {"w0": 5, "w1": 5}, "w1 on 5")
        np.testing.assert_allclose(embed(x, "promoted")["embeddings"],
                                   want, rtol=0, atol=EMBED_ATOL)
        # step 7, the last layer negated: rolled back on the drift bar
        # before w1's stagger passes, blocked on both workers
        _derived_step(ckpt, 7, -1.0)
        roll_until(lambda: 7 in steps()[0]["bad_steps"], "rollback")
        metrics, _ = steps()
        verdict = metrics["last_verdict"]
        assert verdict["step"] == 7 and verdict["reason"] == \
            "shadow_drift" and verdict["drift_p99"] > 1.9, verdict
        _wait_for(lambda: steps()[1] == {"w0": 5, "w1": 5}, "the revert")
        for worker in metrics["workers"].values():
            status, body, _ = post(worker["url"] + "/rollback", {"step": 7})
            assert status == 200 and body["blocked_steps"] == [7]
            assert body["checkpoint_step"] == 5
        np.testing.assert_allclose(embed(x, "reverted")["embeddings"],
                                   want, rtol=0, atol=EMBED_ATOL)
        assert metrics["shadow"]["mirrored"] >= 2

        def federated():
            status, _, text = get(url + "/metrics/fleet")
            text = text.decode()
            return status == 200 and all(
                f'serving_requests_total{{instance="{w}"}}' in text
                or f'instance="{w}"' in text for w in ("w0", "w1")) and text

        assert "fleet_requests_total" in _wait_for(federated,
                                                   "a federated view")
        status, alerts = _json(url + "/alerts")
        assert status == 200 and "availability" not in alerts["firing"]
        status, history = _json(url + "/metrics/history")
        assert status == 200 and "fleet_request_rate" in \
            history["series_names"]
        status, ctype, csv = get(
            url + "/metrics/history?series=fleet_request_rate&format=csv")
        assert status == 200 and ctype == "text/csv"
        pids = [r["pid"] for r in events.read_events(str(router_log),
                                                     "fleet")
                if r.get("action") == "spawn"]
        assert len(pids) == 2
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=LIMIT_S)
        assert proc.returncode == 0, out[-3000:]
    finally:
        _stop(proc, router_log)
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    # the spill reopens: the rollup store survives the router
    reopened = MetricHistory(spill_dir=str(history_dir))
    assert "fleet_request_rate" in reopened.series_names()
    # one merged trace: the router's lane and the workers'
    merged = tmp_path / "merged.json"
    logs = [str(router_log)] + sorted(str(p) for p in workdir.glob("w*.jsonl"))
    assert len(logs) == 3
    assert trace.main(["--merge", *logs, "-o", str(merged)]) == 0
    got = json.loads(merged.read_text())
    lanes = {e["args"]["name"]: e["pid"] for e in got["traceEvents"]
             if e.get("name") == "process_name"}
    by_lane = {}
    for e in got["traceEvents"]:
        rid = e.get("args", {}).get("request_id")
        if e.get("cat") == "span" and rid:
            by_lane.setdefault(e["pid"], set()).add(rid)
    worker_rids = by_lane.get(lanes["w0"], set()) | by_lane.get(
        lanes["w1"], set())
    for rid, forwarded in rids:
        assert rid in by_lane[lanes["router"]]
        assert (rid in worker_rids) == forwarded, rid
