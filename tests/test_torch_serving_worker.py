"""Weight swaps, the checkpoint watcher, supervised serving and /metrics
of the port's serving stack on the CPU.

* ``swap_variables``: an unchanged layout is copied in (``"reused"``, no
  first run), a changed one is run on every rung before it is published
  (``"warmed"``), the previous module's keys leave the cache.
* ``CheckpointWatcher`` under the real serve entry point (``--watch-ckpt``
  on an empty directory: random weights first): it adopts a step that
  the JAX package's ``CheckpointManager`` wrote (embeddings as the JAX
  model's apply gives them, within 2e-2 as ``test_torch_checkpoint_
  interop.py`` holds them), then one the port wrote; replies carry
  ``X-Checkpoint-Step``; ``POST /rollback`` reverts and blocks the step,
  which is never adopted again.
* A wedged device call trips the stall watchdog: ``/healthz`` answers
  ``"stalled"``, a fresh batcher serves (``tests/test_serving.py:418``),
  also while the wedged forward still holds the engine's forward lock.
* ``/metrics`` negotiation (JSON, Prometheus by query or Accept, raw
  state), and the port's ``ServingMetrics`` against the JAX package's for
  the same request sizes on the same ladder: the same ``to_dict`` keys
  and the same counter values.

Each HTTP or threaded case runs under its own time limit.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from ntxent_tpu import cli as jcli
from ntxent_tpu.models import SimCLRModel as JaxSimCLR
from ntxent_tpu.serving import InferenceEngine as JaxEngine
from ntxent_tpu.training.checkpoint import CheckpointManager as JaxManager
from ntxent_tpu.training.trainer import TrainerConfig as JaxConfig
from ntxent_tpu.training.trainer import create_train_state as jax_state
from ntxent_tpu_torch import cli
from ntxent_tpu_torch.obs import PROMETHEUS_CONTENT_TYPE
from ntxent_tpu_torch.serving import (
    EmbeddingServer,
    InferenceEngine,
    ServingMetrics,
)
from ntxent_tpu_torch.training import CheckpointManager
from ntxent_tpu_torch.training import trainer as ttrain

from test_torch_cli import _within_limit

torch.set_num_threads(1)  # one torch thread a test worker

LIMIT_S = 60.0  # each HTTP or threaded case's own time limit


def _linear(dim=3, seed=0):
    model = nn.Linear(2, dim, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(
            np.random.RandomState(seed).rand(dim, 2).astype(np.float32)))
    return model


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


# ---------------------------------------------------------------------------
# swap_variables


def test_an_unchanged_layout_is_reused_without_a_first_run():
    eng = InferenceEngine(_linear(), (2,), buckets=(1, 2), device="cpu")
    eng.warmup()
    compiles = eng.metrics.compiles
    x = np.ones((1, 2), np.float32)
    out0 = eng.embed(x)
    new = {"weight": eng.model.weight.detach() + 1.0}
    assert eng.swap_variables(new) == "reused"
    out1 = eng.embed(x)
    assert eng.metrics.compiles == compiles
    assert not np.allclose(out0, out1)
    np.testing.assert_allclose(out1, x @ new["weight"].numpy().T,
                               rtol=1e-6)
    assert eng.metrics.model_swaps == 1
    assert eng.variables["weight"].data_ptr() != \
        eng.model.weight.data_ptr()  # a host copy


def test_a_changed_layout_is_warmed_before_it_is_published():
    eng = InferenceEngine(_linear(), (2,), buckets=(1, 2), device="cpu")
    eng.warmup()
    compiles = eng.metrics.compiles
    old_keys = set(eng._cache)
    assert eng.swap_variables(_linear(dim=5, seed=1)) == "warmed"
    assert eng.metrics.compiles == compiles + 2  # the whole ladder first
    out = eng.embed(np.ones((2, 2), np.float32))
    assert out.shape == (2, 5)
    assert eng.metrics.compiles == compiles + 2  # and nothing after
    assert not old_keys & set(eng._cache)  # the old module's keys left
    prom = eng.metrics.render_prometheus()
    assert 'serving_model_swaps_total{mode="warmed"} 1' in prom
    # the first new rung differs from its old key by the layout, the next
    # from the first new one by its shape (the nearest prior signature)
    assert 'serving_compiles_by_cause_total{reason="structure"} 1' in prom


def test_concurrent_chunks_never_mix_two_swapped_weight_sets():
    """Stress: more embedding threads than cores, a short switch interval,
    and a thread swapping two weight sets in: every 4-row chunk equals
    one set's output, never a blend (a torn copy would)."""
    import sys

    eng = InferenceEngine(_linear(dim=64), (2,), buckets=(4,),
                          device="cpu")
    sets = [{"weight": eng.model.weight.detach().clone()},
            {"weight": eng.model.weight.detach().clone() * -3.0 + 1.0}]
    x = np.random.RandomState(1).rand(12, 2).astype(np.float32)
    wants = [x @ s["weight"].numpy().T for s in sets]
    stop, bad, outs = threading.Event(), [], []

    def embedder():
        while not stop.is_set():
            outs.append(eng.embed(x))

    def swapper():
        i = 0
        while not stop.is_set():
            i += 1
            eng.swap_variables(sets[i % 2])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=embedder) for _ in range(8)]
        threads.append(threading.Thread(target=swapper))
        for th in threads:
            th.start()
        time.sleep(1.5)
        stop.set()
        for th in threads:
            th.join(30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    for out in outs:
        for c in range(0, 12, 4):
            if not any(np.allclose(out[c:c + 4], w[c:c + 4], rtol=1e-6)
                       for w in wants):
                bad.append(out[c:c + 4])
    assert len(outs) > 8 and not bad
    assert eng.metrics.model_swaps > 2
    assert eng.h2d_bytes == eng.metrics.device_calls * 4 * 2 * 4


class _Casting(nn.Module):
    """A linear layer that computes in its weights' dtype."""

    def __init__(self):
        super().__init__()
        self.lin = _linear()

    def forward(self, x):
        return self.lin(x.to(self.lin.weight.dtype)).float()


def test_a_state_dict_of_another_dtype_loads_into_a_warmed_copy():
    eng = InferenceEngine(_Casting(), (2,), buckets=(1, 2), device="cpu")
    eng.warmup()
    wide = {k: v.to(torch.float64) * 2 for k, v in
            eng.model.state_dict().items()}
    assert eng.swap_variables(wide) == "warmed"
    assert eng.model.lin.weight.dtype == torch.float64
    x = np.ones((2, 2), np.float32)
    np.testing.assert_allclose(eng.embed(x),
                               x @ wide["lin.weight"].numpy().T, rtol=1e-6)
    assert eng.version == 1 and eng.metrics.compiles == 4


# ---------------------------------------------------------------------------
# the checkpoint watcher, through the serve entry point

WATCH_ARGV = ["--device", "cpu", "--model", "tiny", "--image-size", "8",
              "--proj-hidden-dim", "16", "--proj-dim", "8", "--port", "0",
              "--head", "embedding", "--buckets", "1,4", "--watch-ckpt",
              "--watch-poll", "3600"]


def _jax_step(directory, step):
    """A JAX --model tiny SimCLR state with trained-looking statistics,
    saved by the JAX manager; returns (flax model, variables)."""
    jmodel = JaxSimCLR(encoder=jcli._make_encoder("tiny", 8),
                       proj_hidden_dim=16, proj_dim=8)
    jstate = jax_state(jmodel, jax.random.PRNGKey(5), (1, 8, 8, 3),
                       JaxConfig())
    rng = np.random.default_rng(6)
    jstate = jstate.replace(batch_stats=jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.uniform(0.5, 1.5, np.shape(v)),
                              jnp.float32), jstate.batch_stats))
    manager = JaxManager(directory)
    assert manager.save(step, jstate, force=True)
    manager.close()
    return jmodel, {"params": jstate.params,
                    "batch_stats": jstate.batch_stats}


def _port_step(directory, step, args):
    """The port's own TrainState of the same model, other weights, saved
    by the port's manager; returns its model in eval mode."""
    model = cli.build_model(args)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    state = ttrain.create_train_state(model, ttrain.TrainerConfig(),
                                      torch.device("cpu"))
    state.step = step
    assert CheckpointManager(directory).save(step, state)
    return state.model.eval()


def test_the_watcher_adopts_jax_and_port_steps_and_rolls_back(tmp_path):
    directory = tmp_path / "ck"
    args = cli.build_serve_parser().parse_args(
        WATCH_ARGV + ["--ckpt-dir", str(directory)])
    server = cli.build_server(args).start()
    url = f"http://127.0.0.1:{server.port}"
    watcher = server.reloader
    x = np.random.default_rng(3).uniform(-1, 1, (3, 8, 8, 3)).astype(
        np.float32)

    def run():
        code, headers, body = _post(f"{url}/embed",
                                    {"inputs": x.tolist()})
        assert code == 200 and "X-Checkpoint-Step" not in headers
        random_out = np.asarray(body["embeddings"])
        assert watcher.poll_once() is False  # nothing on disk yet

        jmodel, variables = _jax_step(directory, 3)
        assert watcher.poll_once() is True
        code, headers, body = _post(f"{url}/embed", {"inputs": x.tolist()})
        assert code == 200 and headers["X-Checkpoint-Step"] == "3"
        want = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                       train=False), np.float32)
        np.testing.assert_allclose(body["embeddings"], want, atol=2e-2,
                                   rtol=0)
        assert np.abs(want - random_out).max() > 1e-2

        port_model = _port_step(directory, 5, args)
        assert watcher.poll_once() is True
        code, headers, body = _post(f"{url}/embed", {"inputs": x.tolist()})
        assert headers["X-Checkpoint-Step"] == "5"
        with torch.inference_mode():
            port_want = port_model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(body["embeddings"], port_want,
                                   atol=1e-5, rtol=0)
        _, _, health = _get(f"{url}/healthz")
        assert json.loads(health)["checkpoint_step"] == 5

        code, headers, body = _post(f"{url}/rollback", {"step": 5})
        assert code == 200 and body == {"rolled_back": True,
                                        "checkpoint_step": 3,
                                        "blocked_steps": [5]}
        assert headers["X-Checkpoint-Step"] == "3"
        code, headers, body = _post(f"{url}/embed", {"inputs": x.tolist()})
        np.testing.assert_allclose(body["embeddings"], want, atol=2e-2,
                                   rtol=0)
        assert watcher.poll_once() is False  # 5 is blocked
        assert _post(f"{url}/rollback", {"step": "x"})[0] == 400
        code, _, body = _post(f"{url}/rollback", {"step": 4})
        assert body["rolled_back"] is False and body["blocked_steps"] == [
            4, 5]
        m = server.metrics.to_dict()
        assert m["checkpoint_step"] == 3 and m["model_swaps"] == 3
        prom = server.metrics.render_prometheus()
        assert "serving_rollbacks_total 1" in prom
        assert 'serving_model_swaps_total{mode="reused"} 3' in prom
        assert watcher.swaps == 2 and watcher.rollbacks == 1

    try:
        _within_limit(run, LIMIT_S)
    finally:
        server.close()


def test_a_step_that_does_not_load_is_blocked_and_no_watcher_is_404(
        tmp_path):
    directory = tmp_path / "ck"
    args = cli.build_serve_parser().parse_args(
        WATCH_ARGV + ["--ckpt-dir", str(directory), "--no-warmup"])
    server = cli.build_server(args)
    other = cli.build_serve_parser().parse_args(
        WATCH_ARGV + ["--ckpt-dir", str(directory), "--proj-dim", "4"])
    _port_step(directory, 2, other)  # another head width
    try:
        assert server.reloader.poll_once() is False
        assert server.reloader.blocked_steps == {2}
    finally:
        server.close()
    plain = EmbeddingServer(InferenceEngine(_linear(), (2,), buckets=(1,),
                                            device="cpu"), port=0).start()
    try:
        code, _, body = _within_limit(lambda: _post(
            f"http://127.0.0.1:{plain.port}/rollback", {}), LIMIT_S)
        assert code == 404 and "--watch-ckpt" in body["error"]
    finally:
        plain.close()


def test_an_empty_directory_without_watching_still_exits(tmp_path):
    args = cli.build_serve_parser().parse_args(
        [a for a in WATCH_ARGV if a != "--watch-ckpt"]
        + ["--ckpt-dir", str(tmp_path / "none")])
    with pytest.raises(SystemExit, match="no checkpoint under"):
        cli.build_server(args)
    args = cli.build_serve_parser().parse_args(WATCH_ARGV)
    with pytest.raises(SystemExit, match="requires --ckpt-dir"):
        cli.build_server(args)


# ---------------------------------------------------------------------------
# supervision


class _WedgeEngine:
    """Engine stand-in whose device call blocks while ``release`` is
    clear."""

    def __init__(self):
        self.metrics = ServingMetrics()
        self.example_shape = (2,)
        self.max_bucket = 4
        self.buckets = (4,)
        self.device = torch.device("cpu")
        self.release = threading.Event()
        self.release.set()

    def embed(self, x, n_requests=1):
        self.metrics.dispatch(n_requests)
        assert self.release.wait(30)
        return x * 2.0


def test_a_stalled_batcher_is_restarted_while_the_listener_stays_up():
    eng = _WedgeEngine()
    srv = EmbeddingServer(eng, port=0, max_delay_s=0.01, queue_size=4,
                          stall_timeout_s=0.5, max_restarts=1)
    srv.start()
    first = srv.batcher
    loop = threading.Thread(target=srv.serve_forever, daemon=True)
    loop.start()
    url = f"http://127.0.0.1:{srv.port}"

    def run():
        while srv.batcher in (None, first):
            time.sleep(0.01)
        wedged = srv.batcher
        eng.release.clear()  # wedge the next device call
        wedged.submit_async(np.ones((1, 2), np.float32))
        statuses = set()
        while srv.batcher in (None, wedged):
            statuses.add(json.loads(_get(f"{url}/healthz")[2])["status"])
            time.sleep(0.02)
        eng.release.set()
        assert "stalled" in statuses
        out = srv.batcher.submit(np.ones((1, 2), np.float32), timeout_s=5)
        np.testing.assert_allclose(out, 2.0)
        code, _, body = _post(f"{url}/embed", {"inputs": [[1.0, 2.0]]})
        assert code == 200 and body["embeddings"] == [[2.0, 4.0]]

    try:
        _within_limit(run, LIMIT_S)
    finally:
        eng.release.set()
        srv.shutdown()
        loop.join(20)
        srv.close()
    assert not loop.is_alive()


def test_a_forward_wedged_under_the_lock_does_not_block_the_restart():
    """The real engine, wedged inside its forward (under the forward
    lock): the fresh batcher of the next attempt answers while the wedged
    chunk still holds the lock, and a weight swap waits for it."""
    eng = InferenceEngine(_linear(), (2,), buckets=(1, 4), device="cpu")
    eng.warmup()
    srv = EmbeddingServer(eng, port=0, max_delay_s=0.01, queue_size=4,
                          stall_timeout_s=0.5, max_restarts=1)
    srv.start()
    first = srv.batcher
    loop = threading.Thread(target=srv.serve_forever, daemon=True)
    loop.start()
    url = f"http://127.0.0.1:{srv.port}"
    real_launch, release, entered = eng._launch, threading.Event(), \
        threading.Event()
    x = np.ones((1, 2), np.float32)
    want = x @ eng.model.weight.detach().numpy().T

    def wedged(exe, args):
        if not entered.is_set():
            entered.set()
            assert release.wait(LIMIT_S)
        return real_launch(exe, args)

    def run():
        while srv.batcher in (None, first):
            time.sleep(0.01)
        wedged_batcher = srv.batcher
        eng._launch = wedged
        wedged_batcher.submit_async(x)
        assert entered.wait(10)
        statuses = set()
        while srv.batcher in (None, wedged_batcher):
            statuses.add(json.loads(_get(f"{url}/healthz")[2])["status"])
            time.sleep(0.02)
        assert "stalled" in statuses
        # the wedged chunk still holds the lock's read side
        assert not release.is_set()
        out = srv.batcher.submit(x, timeout_s=5)
        np.testing.assert_allclose(out, want, rtol=1e-6)
        code, _, body = _post(f"{url}/embed", {"inputs": [[1.0, 1.0]]})
        assert code == 200
        np.testing.assert_allclose(body["embeddings"], want, rtol=1e-6)
        swapped = []
        swapper = threading.Thread(target=lambda: swapped.append(
            eng.swap_variables({"weight": eng.model.weight.detach() * 2})))
        swapper.start()
        swapper.join(0.3)
        assert swapper.is_alive() and not swapped  # the writer waits
        release.set()
        swapper.join(10)
        assert swapped == ["reused"]

    try:
        _within_limit(run, LIMIT_S)
    finally:
        release.set()
        eng._launch = real_launch
        srv.shutdown()
        loop.join(20)
        srv.close()
    assert not loop.is_alive()


# ---------------------------------------------------------------------------
# /metrics


def test_metrics_negotiation_over_http():
    eng = InferenceEngine(_linear(), (2,), buckets=(1, 4), device="cpu")
    srv = EmbeddingServer(eng, port=0, max_delay_s=0.0).start()
    srv.metrics.set_run_id("r7")
    url = f"http://127.0.0.1:{srv.port}"

    def run():
        assert _post(f"{url}/embed", {"inputs": [[1.0, 2.0]]})[0] == 200
        code, headers, text = _get(f"{url}/metrics")
        assert code == 200 and headers["Content-Type"] == "application/json"
        m = json.loads(text)
        assert m["run_id"] == "r7" and m["responses"] == 1
        for query, accept in (("?format=prometheus", None),
                              ("", "text/plain")):
            code, headers, text = _get(f"{url}/metrics{query}",
                                       {"Accept": accept} if accept else {})
            assert headers["Content-Type"] == PROMETHEUS_CONTENT_TYPE
            assert 'serving_run_info{run_id="r7"} 1' in text
            assert "serving_responses_total 1" in text
            assert "serving_compile_cache_entries 1" in text  # bucket 1
        code, _, text = _get(f"{url}/metrics?format=state")
        names = {m["name"] for m in json.loads(text)["metrics"]}
        assert {"serving_latency_ms", "serving_requests_total"} <= names

    try:
        _within_limit(run, LIMIT_S)
    finally:
        srv.close()


SIZES = (3, 5, 1, 16, 70, 4, 2, 9)


def _counters(m: dict) -> dict:
    """A to_dict without the wall-clock and latency values."""
    out = {k: v for k, v in m.items() if k not in ("uptime_s",
                                                     "latency_ms")}
    out["latency_counts"] = {k: v["count"]
                             for k, v in m["latency_ms"].items()}
    return out


def test_serving_metrics_equal_the_jax_ones_for_the_same_sizes():
    w = np.random.RandomState(0).rand(2, 3).astype(np.float32)
    jeng = JaxEngine(lambda v, x: x @ v, jnp.asarray(w), (2,),
                     buckets=(1, 4, 16, 64))
    model = nn.Linear(2, 3, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w.T))
    eng = InferenceEngine(model, (2,), buckets=(1, 4, 16, 64),
                          device="cpu")
    for e in (jeng, eng):
        e.warmup()
        e.metrics.queue_capacity = 8
        e.metrics.set_run_id("same")
        for i, n in enumerate(SIZES):
            x = np.random.RandomState(i).rand(n, 2).astype(np.float32)
            e.embed(x, n_requests=1 + i % 3)
            e.metrics.request_accepted()
            e.metrics.queue_wait(1.0)
            e.metrics.request_done(2.0, ok=i != 4)
        e.metrics.request_rejected("queue_full")
        e.metrics.request_rejected("deadline")
        e.metrics.set_checkpoint_step(7)
    ours, theirs = eng.metrics.to_dict(), jeng.metrics.to_dict()
    assert list(ours) == list(theirs)
    assert _counters(ours) == _counters(theirs)
    assert ours["compile"] == {"compiles": 4, "cache_hits": 9}
    prom = eng.metrics.render_prometheus()
    series = {line.split(" ")[0] for line in prom.splitlines()
              if not line.startswith("#")}
    jseries = {line.split(" ")[0] for line in
               jeng.metrics.render_prometheus().splitlines()
               if not line.startswith("#")}
    assert series == jseries
