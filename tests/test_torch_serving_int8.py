"""The int8 serving rung of the port (``InferenceEngine(dtype=torch.int8)``,
``--dtype int8``) on the CPU.

* ``quantize_host`` is bit for bit the JAX engine's ``_quantize_host``
  (per example, symmetric, ``np.rint``, clipped to +-127, scale
  ``max(amax, 1e-30) / 127``) on seeded chunks with zero (padding) rows,
  tiny and huge magnitudes.
* The int8 engine against the JAX package's int8 ``InferenceEngine`` on
  the same fp32 weights (the small flash ViT of ``test_torch_serving.py``,
  its weights carried by ``weights.load_flax_variables``): both dequantize
  the same int8 payload and scales in float32, so the embeddings agree
  within 2e-5, as the fp32 HTTP test holds them.
* The drift of the int8 rung against the float32 rung of the same
  weights: the largest per-row cosine distance < 0.05, the JAX package's
  bar (``tests/test_quant.py:566-575``); the chunk crosses to the device
  in ~4x fewer bytes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.models import SimCLRModel as JaxSimCLR
from ntxent_tpu.models.vit import VisionTransformer as JaxViT
from ntxent_tpu.serving import InferenceEngine as JaxEngine
from ntxent_tpu_torch.serving import InferenceEngine, quantize_host
from ntxent_tpu_torch.weights import load_flax_variables

from test_torch_serving import SHAPE, SMALL, _model, _rows

torch.set_num_threads(1)  # one torch thread a test worker

DRIFT_MAX = 0.05  # the JAX package's int8 drift bar (cosine distance)


def _chunks():
    rng = np.random.default_rng(12)
    yield rng.normal(size=(4,) + SHAPE).astype(np.float32)
    mixed = rng.uniform(-3, 3, size=(5,) + SHAPE).astype(np.float32)
    mixed[1] = 0.0  # a padding row
    mixed[2] *= 1e-20
    mixed[3] *= 1e20
    yield mixed
    yield (rng.integers(-127, 128, size=(3,) + SHAPE) / 7.0).astype(
        np.float32)


def _jax_engine(dtype, variables=None, jmodel=None):
    if jmodel is None:
        return JaxEngine(lambda v, x: x, {}, SHAPE, buckets=(1, 4),
                         dtype=dtype)
    return JaxEngine(lambda v, x: jmodel.apply(v, x, train=False),
                     variables, SHAPE, buckets=(1, 4), dtype=dtype)


@pytest.mark.parametrize("index", [0, 1, 2])
def test_host_quantization_is_bit_for_bit_the_jax_one(index):
    x = list(_chunks())[index]
    q, scale = quantize_host(x, len(SHAPE))
    jq, jscale = _jax_engine(jnp.int8)._quantize_host(x)
    assert q.dtype == jq.dtype == np.int8
    assert scale.dtype == jscale.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale.view(np.uint32),
                                  jscale.view(np.uint32))
    port = InferenceEngine(_model(), SHAPE, dtype=torch.int8, device="cpu")
    pq, pscale = port._quantize_host(x)
    np.testing.assert_array_equal(pq, q)
    np.testing.assert_array_equal(pscale, scale)
    assert np.abs(q).max() <= 127


@pytest.fixture(scope="module")
def jax_pair():
    enc = functools.partial(JaxViT, attention_impl="flash",
                            dtype=jnp.float32, **SMALL)
    jmodel = JaxSimCLR(encoder=enc, proj_hidden_dim=64, proj_dim=16,
                       dtype=jnp.float32)
    variables = jax.tree_util.tree_map(np.array, jax.device_get(
        jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1,) + SHAPE),
                    train=False)))
    return jmodel, variables, load_flax_variables(_model(), variables)


def test_int8_engine_matches_the_jax_int8_engine(jax_pair):
    jmodel, variables, model = jax_pair
    x = _rows(6, seed=4)
    want = _jax_engine(jnp.int8, variables, jmodel).embed(x)
    eng = InferenceEngine(model, SHAPE, buckets=(1, 4), dtype=torch.int8,
                          device="cpu")
    got = eng.embed(x)
    assert got.shape == (6, 16) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # 6 rows -> chunks of 4 and 2 (padded to 4): int8 payload + scales
    assert eng.h2d_bytes == 2 * (4 * int(np.prod(SHAPE)) + 4 * 4)
    m = eng.metrics.to_dict()
    assert m["device_calls"] == 2 and m["compile"]["compiles"] == 1


def test_int8_drift_against_float32_is_under_the_bar(jax_pair):
    _, _, model = jax_pair
    f32 = InferenceEngine(model, SHAPE, buckets=(1, 4, 16),
                          device="cpu")
    q8 = InferenceEngine(model, SHAPE, buckets=(1, 4, 16),
                         dtype=torch.int8, device="cpu")
    f32.warmup()
    q8.warmup()
    x = _rows(37, seed=8)
    a, b = f32.embed(x), q8.embed(x)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(b, axis=1))
    drift = float((1.0 - cos).max())
    assert drift < DRIFT_MAX, drift
    assert drift > 0.0  # quantization moved the inputs
    ratio = f32.h2d_bytes / q8.h2d_bytes
    assert 3.9 < ratio < 4.0, ratio
    # the rungs' first runs are keys of their own dtype
    assert f32.metrics.compiles == q8.metrics.compiles == 3
    assert next(iter(q8._cache))[1] == "int8"
