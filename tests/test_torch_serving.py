"""The port's serving stack on the CPU: engine, micro-batcher, HTTP server
and CLI (ntxent_tpu_torch.serving, ntxent_tpu_torch.cli).

Small ViT-B-shaped tower (patch 4, image 16, hidden 32, 2 blocks, 4
heads, MLP 64, projection 64 -> 16) in fp32, so that padding and batching
can only change the summation order: outputs agree with a direct call
within 1e-5. The HTTP test serves weights carried from the JAX model and
holds the answers to JAX's own embeddings within 2e-5.
"""

import functools
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

from ntxent_tpu.models import SimCLRModel as JaxSimCLR
from ntxent_tpu.models.vit import VisionTransformer as JaxViT
from ntxent_tpu_torch import cli
from ntxent_tpu_torch.models import (
    SimCLRModel,
    VisionTransformer,
    init_weights,
)
from ntxent_tpu_torch.resilience import RetryPolicy
from ntxent_tpu_torch.serving import (
    DeadlineExceededError,
    EmbeddingServer,
    InferenceEngine,
    MicroBatcher,
    QueueFullError,
    ServingMetrics,
)
from ntxent_tpu_torch.utils.capability import resolve_device
from ntxent_tpu_torch.weights import load_flax_variables

pytestmark = pytest.mark.serving

IMAGE = 16
SHAPE = (IMAGE, IMAGE, 3)
EMBED_ATOL = 2e-2  # bf16 embeddings, as the CLI's ViT serve test holds
SMALL = dict(patch_size=4, hidden_dim=32, depth=2, num_heads=4, mlp_dim=64)


def _model(seed=0):
    enc = VisionTransformer(image_size=IMAGE, attention_impl="flash",
                            dtype=torch.float32, **SMALL)
    model = SimCLRModel(enc, 64, 16, dtype=torch.float32)
    return init_weights(model, torch.Generator().manual_seed(seed))


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n,) + SHAPE).astype(
        np.float32)


def _direct(model, x):
    """The model's own forward in eval mode, as the engine serves it (a
    module in train mode normalizes with batch statistics)."""
    with torch.inference_mode():
        return model.eval()(torch.from_numpy(x)).numpy()


class _StubEngine:
    """Engine stand-in whose device call blocks until released."""

    def __init__(self):
        self.metrics = ServingMetrics()
        self.example_shape = SHAPE
        self.max_bucket = 4
        self.buckets = (4,)
        self.device = torch.device("cpu")
        self.release = threading.Event()
        self.started = threading.Event()
        self.seen_rows: list[float] = []

    def embed(self, x, n_requests=1):
        self.metrics.dispatch(n_requests)
        self.started.set()
        self.release.wait(10)
        self.seen_rows.extend(float(v) for v in x[:, 0, 0, 0])
        return x.reshape(x.shape[0], -1)[:, :2]


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# -- engine ------------------------------------------------------------------
def test_padding_and_chunking_give_the_direct_rows():
    model = _model()
    engine = InferenceEngine(model, SHAPE, buckets=(1, 4, 16), device="cpu")
    x = _rows(37)
    got = engine.embed(x, n_requests=3)
    np.testing.assert_allclose(got, _direct(model, x), rtol=0, atol=1e-5)
    m = engine.metrics.to_dict()
    # 37 rows -> chunks of 16, 16 and 5 (bucket 16, 11 padded rows).
    assert m["device_calls"] == 3 and m["dispatches"] == 1
    assert m["buckets"]["16"] == {"calls": 3, "rows_real": 37,
                                  "rows_padded": 11,
                                  "padding_waste": round(11 / 48, 4)}
    assert m["batch_fill_ratio"] == 3.0
    for n in (1, 3, 4):
        np.testing.assert_allclose(engine.embed(x[:n]), _direct(model, x[:n]),
                                   rtol=0, atol=1e-5)
    assert engine.bucket_for(3) == 4 and engine.bucket_for(16) == 16
    with pytest.raises(ValueError):
        engine.bucket_for(17)
    with pytest.raises(ValueError, match="trailing shape"):
        engine.embed(np.zeros((2, 8, 8, 3), np.float32))


def test_features_head_and_warmup():
    model = _model()
    engine = InferenceEngine(model, SHAPE, method="features",
                             buckets=(2, 8), device="cpu")
    engine.warmup()
    assert engine.metrics.device_calls == 0  # warmup is not traffic
    x = _rows(3)
    with torch.inference_mode():
        want = model.features(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(engine.embed(x), want, rtol=0, atol=1e-5)


def test_update_variables_swaps_weights():
    engine = InferenceEngine(_model(seed=0), SHAPE, buckets=(4,),
                             device="cpu")
    other = _model(seed=1)
    x = _rows(2)
    before = engine.embed(x)
    engine.update_variables(other.state_dict())
    assert engine.version == 1
    np.testing.assert_allclose(engine.embed(x), _direct(other, x), rtol=0,
                               atol=1e-5)
    assert np.abs(before - engine.embed(x)).max() > 1e-3


# -- batcher -----------------------------------------------------------------
def test_full_queue_rejects_with_retry_after():
    stub = _StubEngine()
    policy = RetryPolicy(base_delay_s=0.2, jitter=0.0)
    batcher = MicroBatcher(stub, max_batch=1, max_delay_s=0.0, queue_size=2,
                           retry_policy=policy)
    try:
        first = batcher.submit_async(_rows(1))
        assert stub.started.wait(5)  # the worker holds request 1
        batcher.submit_async(_rows(1))
        batcher.submit_async(_rows(1))
        with pytest.raises(QueueFullError) as err:
            batcher.submit_async(_rows(1))
        assert err.value.retry_after_s == pytest.approx(0.2)
        assert stub.metrics.rejected_queue_full == 1
        stub.release.set()
        assert first.done.wait(5) and first.error is None
    finally:
        stub.release.set()
        batcher.close()


def test_deadline_expired_in_queue_never_reaches_the_model():
    stub = _StubEngine()
    batcher = MicroBatcher(stub, max_batch=1, max_delay_s=0.0, queue_size=4)
    try:
        first = batcher.submit_async(np.full((1,) + SHAPE, 1.0, np.float32))
        assert stub.started.wait(5)
        late = batcher.submit_async(np.full((1,) + SHAPE, 2.0, np.float32),
                                    timeout_s=0.05)
        time.sleep(0.2)  # the deadline passes while request 2 is queued
        stub.release.set()
        assert first.done.wait(5) and late.done.wait(5)
        assert isinstance(late.error, DeadlineExceededError)
        assert stub.seen_rows == [1.0]
        assert stub.metrics.rejected_deadline == 1
    finally:
        stub.release.set()
        batcher.close()


def test_concurrent_requests_coalesce_and_split_back():
    model = _model()
    engine = InferenceEngine(model, SHAPE, buckets=(1, 4, 16), device="cpu")
    batcher = MicroBatcher(engine, max_delay_s=0.3, queue_size=16)
    xs = [_rows(n, seed=n) for n in (1, 2, 3, 4)]
    out = [None] * len(xs)
    try:
        threads = [threading.Thread(
            target=lambda i=i: out.__setitem__(i, batcher.submit(xs[i],
                                                                timeout_s=10)))
            for i in range(len(xs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert not any(th.is_alive() for th in threads)
        for x, got in zip(xs, out):
            np.testing.assert_allclose(got, _direct(model, x), rtol=0,
                                       atol=1e-5)
        assert engine.metrics.to_dict()["batch_fill_ratio"] > 1.0
    finally:
        batcher.close()


# -- HTTP --------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_model_and_server():
    enc = functools.partial(JaxViT, attention_impl="flash",
                            dtype=jnp.float32, **SMALL)
    jmodel = JaxSimCLR(encoder=enc, proj_hidden_dim=64, proj_dim=16,
                       dtype=jnp.float32)
    variables = jax.tree_util.tree_map(np.array, jax.device_get(
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1,) + SHAPE),
                    train=False)))
    model = load_flax_variables(_model(), variables)
    engine = InferenceEngine(model, SHAPE, buckets=(1, 4, 16), device="cpu")
    server = EmbeddingServer(engine, port=0, max_delay_s=0.05,
                             max_request_rows=20).start()
    try:
        yield jmodel, variables, server, f"http://127.0.0.1:{server.port}"
    finally:
        server.close()


def test_embed_over_http_matches_jax(jax_model_and_server):
    jmodel, variables, server, url = jax_model_and_server
    x = _rows(5, seed=3)
    code, headers, body = _post(f"{url}/embed",
                                {"inputs": x.tolist(), "timeout_ms": 20000},
                                {"X-Request-Id": "abc123"})
    assert code == 200, body
    assert headers["X-Request-Id"] == "abc123"
    assert body["dim"] == 16 and body["rows"] == 5
    want = np.asarray(jmodel.apply(variables, x, train=False))
    np.testing.assert_allclose(np.asarray(body["embeddings"]), want,
                               rtol=0, atol=2e-5)
    # One example without the batch dimension.
    code, headers, body = _post(f"{url}/embed", {"inputs": x[0].tolist()})
    assert code == 200 and body["rows"] == 1 and headers["X-Request-Id"]
    np.testing.assert_allclose(np.asarray(body["embeddings"]), want[:1],
                               rtol=0, atol=2e-5)


def test_http_status_routes_and_errors(jax_model_and_server):
    _, _, server, url = jax_model_and_server
    assert _get(f"{url}/healthz") == (200, {"status": "serving",
                                            "ready": True,
                                            "checkpoint_step": None})
    assert _get(f"{url}/readyz")[0] == 200
    code, metrics = _get(f"{url}/metrics")
    assert code == 200
    for key in ("requests", "responses", "dispatches", "device_calls",
                "batch_fill_ratio", "padding_waste", "queue_depth",
                "queue_capacity", "buckets", "latency_ms"):
        assert key in metrics
    assert set(metrics["latency_ms"]) == {"total", "queue_wait", "device"}
    assert _get(f"{url}/nope")[0] == 404
    assert _post(f"{url}/nope", {})[0] == 404
    assert _post(f"{url}/embed", {"no_inputs": 1})[0] == 400
    assert _post(f"{url}/embed", {"inputs": [1.0, 2.0]})[0] == 400
    assert _post(f"{url}/embed",
                 {"inputs": np.zeros((2, 8, 8, 3)).tolist()})[0] == 400
    code, _, body = _post(f"{url}/embed",
                          {"inputs": np.zeros((21,) + SHAPE).tolist()})
    assert code == 413 and "cap" in body["error"]
    server.begin_warmup()
    try:
        code, headers, _ = _post(f"{url}/embed",
                                 {"inputs": _rows(1).tolist()})
        assert code == 503 and "Retry-After" in headers
        assert _get(f"{url}/readyz")[0] == 503
    finally:
        server.end_warmup()


def test_http_full_queue_answers_429_with_retry_after():
    stub = _StubEngine()
    stub.max_bucket, stub.buckets = 1, (1,)
    server = EmbeddingServer(stub, port=0, max_batch=1, max_delay_s=0.0,
                             queue_size=1,
                             retry_policy=RetryPolicy(base_delay_s=0.5,
                                                      jitter=0.0)).start()
    url = f"http://127.0.0.1:{server.port}/embed"
    results = []
    try:
        hold = threading.Thread(target=lambda: results.append(
            _post(url, {"inputs": _rows(1).tolist()})))
        hold.start()
        assert stub.started.wait(5)  # request 1 is on the "device"
        queued = threading.Thread(target=lambda: results.append(
            _post(url, {"inputs": _rows(1).tolist()})))
        queued.start()
        deadline = time.monotonic() + 5
        while server.batcher.metrics.queue_depth < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        code, headers, body = _post(url, {"inputs": _rows(1).tolist()})
        assert code == 429
        assert float(headers["Retry-After"]) == pytest.approx(0.5)
        assert body["retry_after_s"] == pytest.approx(0.5)
        stub.release.set()
        hold.join(10)
        queued.join(10)
        assert sorted(r[0] for r in results) == [200, 200]
    finally:
        stub.release.set()
        server.close()


# -- CLI and the device rule -------------------------------------------------
def test_cli_server_on_cpu_serves_embeddings():
    args = cli.build_serve_parser().parse_args(
        ["--model", "vit_t16", "--image-size", "16", "--vit-attention",
         "flash", "--head", "embedding", "--buckets", "1,4", "--port", "0",
         "--proj-hidden-dim", "32", "--proj-dim", "8", "--device", "cpu"])
    assert args.max_delay_ms == 5.0 and args.queue_size == 64
    server = cli.build_server(args).start()
    try:
        code, _, body = _post(f"http://127.0.0.1:{server.port}/embed",
                              {"inputs": _rows(3).tolist()})
        assert code == 200 and body["dim"] == 8 and body["rows"] == 3
        emb = np.asarray(body["embeddings"])
        np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0,
                                   atol=1e-5)
        # Seeded random weights: the same seed builds the same model.
        again = cli.build_model(args)
        np.testing.assert_allclose(_direct(again, _rows(3)), emb, rtol=0,
                                   atol=2e-2)
    finally:
        server.close()


def test_serve_defaults_to_resnet50_as_in_the_jax_cli():
    from ntxent_tpu.cli import build_serve_parser as jax_serve_parser

    args = cli.build_serve_parser().parse_args([])
    assert args.model == jax_serve_parser().parse_args([]).model == \
        "resnet50"
    args.image_size = 224
    model = cli.build_model(args)
    assert type(model.backbone).__name__ == "ResNet"
    assert model.backbone.hidden_dim == 2048
    assert not model.backbone.small_images


RESNET_SERVE_ARGV = ["--model", "tiny", "--image-size", "8", "--head",
                     "embedding", "--buckets", "1,4", "--port", "0",
                     "--proj-hidden-dim", "32", "--proj-dim", "16",
                     "--device", "cpu"]


def test_resnet_embed_over_http_matches_the_jax_serving_engine():
    """``ntxent-serve --model tiny`` (a one-stage ResNet) on the flax
    variables of the JAX CLI's same model, against the JAX serving
    engine's embeddings: BatchNorm on the running statistics in both.
    Both compute in bf16 -> EMBED tolerance 2e-2."""
    from ntxent_tpu.cli import _make_encoder
    from ntxent_tpu.serving import InferenceEngine as JaxEngine

    jmodel = JaxSimCLR(encoder=_make_encoder("tiny", 8), proj_hidden_dim=32,
                       proj_dim=16)
    variables = jax.tree_util.tree_map(np.array, jax.device_get(
        jmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, 8, 8, 3)),
                    train=False)))
    stats = variables["batch_stats"]
    rng = np.random.default_rng(5)
    variables["batch_stats"] = jax.tree_util.tree_map(  # non-trivial stats
        lambda v: (rng.uniform(0.5, 1.5, v.shape) if v.ndim and
                   v.min() == 1 else rng.normal(0, 0.1, v.shape)
                   ).astype(np.float32), stats)
    x = rng.uniform(size=(3, 8, 8, 3)).astype(np.float32)
    want = JaxEngine(lambda v, b: jmodel.apply(v, b, train=False),
                     variables, (8, 8, 3), buckets=(1, 4)).embed(x)
    args = cli.build_serve_parser().parse_args(RESNET_SERVE_ARGV)
    server = cli.build_server(args)
    load_flax_variables(server.engine.model, variables)
    server.start()
    try:
        code, _, body = _post(f"http://127.0.0.1:{server.port}/embed",
                              {"inputs": x.tolist()})
    finally:
        server.close()
    assert code == 200 and body["rows"] == 3 and body["dim"] == 16
    np.testing.assert_allclose(np.asarray(body["embeddings"]), want,
                               rtol=0, atol=EMBED_ATOL)


@pytest.mark.parametrize("flags,match", [
    (["--stem", "space_to_depth"], r"ROADMAP.md Queue A 6\(b\)"),
    # a checkpoint directory without a step: nothing to serve
    (["--ckpt-dir", "ckpt"], "no checkpoint under ckpt"),
    (["--vit-attention", "flash"], "ViT encoders only")])
def test_resnet_serve_refuses_what_it_cannot_serve(flags, match):
    args = cli.build_serve_parser().parse_args(RESNET_SERVE_ARGV + flags)
    with pytest.raises(SystemExit, match=match):
        cli.build_server(args)


def test_bad_bucket_list_exits():
    args = cli.build_serve_parser().parse_args(
        ["--buckets", "4,x", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.build_server(args)


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(_model(), SHAPE)
    args = cli.build_serve_parser().parse_args(
        ["--model", "vit_t16", "--image-size", "16", "--port", "0"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.build_server(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.serve_main(["--model", "vit_t16", "--image-size", "16",
                        "--port", "0"])


def test_resolve_device_pins_fp32_numerics():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        assert resolve_device("cpu") == torch.device("cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with pytest.raises(ValueError):
        resolve_device("mps")
