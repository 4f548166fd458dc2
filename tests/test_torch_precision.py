"""The port's wire policy (``ntxent_tpu_torch.parallel.precision``) against
``ntxent_tpu.parallel.precision``.

``quantize_int8`` and ``dequantize_int8`` must equal the JAX functions
bit for bit on the CPU (both round half to even, both divide by the same
float32 scale): random rows at several scales and widths, all-zero rows,
rows holding +-amax and exact halves. Eligibility, the context's
validation, its alias and its nesting are held to the JAX module's.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.parallel import precision as jprec
from ntxent_tpu_torch.parallel import precision as tprec

torch.set_num_threads(1)  # see test_torch_training.py


def _both(x: np.ndarray):
    qj, sj = jprec.quantize_int8(jnp.asarray(x))
    qt, st = tprec.quantize_int8(torch.from_numpy(x))
    return (np.asarray(qj), np.asarray(sj)), (qt.numpy(), st.numpy())


@pytest.mark.parametrize("shape,scale", [((16, 2048), 3.0), ((7, 129), 1e-3),
                                         ((64, 512), 40.0), ((3, 5, 33), 1.0),
                                         ((1024,), 0.5)])
def test_quantize_int8_is_bit_for_bit_jax(shape, scale):
    x = (np.random.default_rng(sum(shape)).standard_normal(shape)
         * scale).astype(np.float32)
    (qj, sj), (qt, st) = _both(x)
    assert qt.dtype == np.int8 and st.dtype == np.float32
    assert st.shape == shape[:-1] + (1,)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(
        tprec.dequantize_int8(torch.from_numpy(qt), torch.from_numpy(st))
        .numpy(), np.asarray(jprec.dequantize_int8(jnp.asarray(qj),
                                                   jnp.asarray(sj))))


def test_all_zero_rows_quantize_to_zeros_with_finite_scales():
    x = np.zeros((4, 128), np.float32)
    x[2] = np.linspace(-1, 1, 128)
    (qj, sj), (qt, st) = _both(x)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st, sj)
    assert not qt[[0, 1, 3]].any() and np.all(np.isfinite(st))
    out = tprec.dequantize_int8(torch.from_numpy(qt), torch.from_numpy(st))
    assert not out[[0, 1, 3]].any()


def test_amax_rows_and_exact_halves_round_half_to_even():
    """+-amax maps to +-127; values at k + 0.5 steps round to even."""
    x = np.array([[127.0, -127.0, 63.5, -0.5, 0.5, 1.5, 2.5, -2.5],
                  [-4.0, 4.0, 2.0, -2.0, 0.0, 1.0, 3.0, -1.0]], np.float32)
    (qj, sj), (qt, st) = _both(x)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st, sj)
    assert qt[0].tolist() == [127, -127, 64, 0, 0, 2, 2, -2]
    assert qt[1, :2].tolist() == [-127, 127]
    assert np.abs(qt.astype(np.int32)).max() <= 127  # -128 never made


def test_round_trip_error_is_at_most_half_a_scale():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 2048)).astype(np.float32) * 3)
    q, s = tprec.quantize_int8(x)
    err = (tprec.dequantize_int8(q, s) - x).abs()
    assert float((err - s / 2).max()) <= 1e-6


def test_bf16_input_quantizes_as_its_float32_values():
    x = torch.randn(8, 256, generator=torch.Generator().manual_seed(1))
    xb = x.to(torch.bfloat16)
    q, s = tprec.quantize_int8(xb)
    (qj, sj), _ = _both(xb.float().numpy())
    np.testing.assert_array_equal(q.numpy(), qj)
    np.testing.assert_array_equal(s.numpy(), sj)
    assert tprec.dequantize_int8(q, s, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("shape,dtype,want", [
    ((32, 64), torch.float32, True),      # 2048 elements
    ((1024,), torch.float32, True),       # at the floor
    ((1023,), torch.float32, False),
    ((4, 4), torch.float32, False),       # small
    ((64, 64), torch.int32, False),       # integer
    ((64, 64), torch.bfloat16, True),
    ((), torch.float32, False),           # 0-d
])
def test_eligibility_matches_jax(shape, dtype, want):
    t = torch.zeros(shape, dtype=dtype)
    assert tprec.quantizable(t) is want
    jdtype = {torch.float32: jnp.float32, torch.int32: jnp.int32,
              torch.bfloat16: jnp.bfloat16}[dtype]
    assert jprec.quantizable(jnp.zeros(shape, jdtype)) is want


def test_python_scalars_and_non_tensors_are_not_eligible():
    assert not tprec.quantizable(1.0)
    assert not tprec.quantizable(np.zeros((64, 64), np.float32))
    assert tprec.quantizable(torch.zeros(8, 8), min_elems=64)
    assert tprec.MIN_QUANT_ELEMS == jprec.MIN_QUANT_ELEMS == 1024
    assert tprec.COLLECTIVE_DTYPES == jprec.COLLECTIVE_DTYPES


def test_context_validates_aliases_and_nests():
    assert tprec.collective_dtype() == "float32"
    with tprec.collective_precision("bfloat16") as ctx:
        assert ctx.dtype == "bf16" and tprec.collective_dtype() == "bf16"
        with tprec.collective_precision("int8"):
            assert tprec.collective_dtype() == "int8"
        assert tprec.collective_dtype() == "bf16"
    assert tprec.collective_dtype() == "float32"
    for bad in ("fp8", "float16", "int4"):
        with pytest.raises(ValueError, match="collective dtype"):
            tprec.collective_precision(bad)
        with pytest.raises(ValueError):
            jprec.collective_precision(bad)


def test_policy_is_thread_local():
    """Another thread sees float32 inside this thread's context: why an
    autograd backward, which may run on a thread of its own, must carry
    the dtype of its forward."""
    seen = []
    with tprec.collective_precision("int8"):
        t = threading.Thread(target=lambda: seen.append(
            tprec.collective_dtype()))
        t.start()
        t.join()
        assert tprec.collective_dtype() == "int8"
    assert seen == ["float32"]
