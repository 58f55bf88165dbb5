"""The port's gather shims and the dense/q8 codec API against the JAX
package on the same numpy inputs, through the plain versions the kernel
wrappers take for CPU tensors.  The JAX gathers run their Pallas kernel
in interpret mode, as the package's own tests do; its q8 quantizer
divides as the eager reference does (``torch_port_helpers``), except in
the test that holds the port to the jitted shim as is."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import comm as jcomm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch import comm as tcomm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

from torch_port_helpers import jax_reference, to_np  # noqa: E402

# (R, C, B): prime R, odd C, B = 1, a one-column leaf, all kept
COMPACT = [(5, 33, 12), (13, 10, 1), (7, 64, 32), (3, 9, 9), (1, 2, 1)]
ANY_RANK = [(), (7,), (1, 1), (3, 5, 7), (4, 2, 3, 9), (64, 10)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16),
          "int8": (np.int8, jnp.int8, torch.int8),
          "uint8": (np.uint8, jnp.uint8, torch.uint8)}


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.standard_normal(shape) * scale, np.float32)


def _idx(C, B, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(C, B, replace=False)).astype(np.int32)


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    np_t, j_t, t_t = DTYPES[dtype]
    if np_t is not np.float32:
        x = np.asarray(np.round(x * 40), np.int64).astype(np_t)
    return jnp.asarray(x, j_t), torch.from_numpy(x).to(t_t)


def _same(t, j):
    assert tuple(t.shape) == tuple(j.shape)
    np.testing.assert_array_equal(to_np(t.float() if t.dtype ==
                                        torch.bfloat16 else t),
                                  np.asarray(j, np.float32)
                                  if j.dtype == jnp.bfloat16 else
                                  np.asarray(j))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("R,C,B", COMPACT)
def test_gather_rows_equals_reference(R, C, B, dtype):
    jx, tx = _pair(_x((R, C), R + C), dtype)
    idx = _idx(C, B, B)
    _same(ops.gather_rows(tx, torch.from_numpy(idx)),
          jops.gather_rows(jx, jnp.asarray(idx)))


@pytest.mark.parametrize("shape,B", [((4, 16, 5), 8), ((2, 3, 9, 1), 4),
                                     ((7, 3), 1), ((3, 3, 8, 10), 3)])
def test_compact_and_expand_groups_equal_reference(shape, B):
    x = _x(shape, 1)
    idx = _idx(shape[-2], B, 2)
    jc = jops.compact_groups(jnp.asarray(x), jnp.asarray(idx))
    tc = ops.compact_groups(torch.from_numpy(x), torch.from_numpy(idx).long())
    _same(tc, jc)
    je = jops.expand_groups(jc, jnp.asarray(idx), shape[-2])
    _same(ops.expand_groups(tc, torch.from_numpy(idx), shape[-2]), je)


@pytest.mark.parametrize("R,C,B", COMPACT)
def test_gather_quantize_and_scatter_dequantize_equal_reference(R, C, B):
    x, idx = _x((R, C), 7, 30.0), _idx(C, B, 3)
    with jax_reference(ieee_quantize=True):
        jq, js = jops.gather_quantize(jnp.asarray(x), jnp.asarray(idx))
    jout = jops.scatter_dequantize(jq, js, jnp.asarray(idx), C)
    tq, ts = ops.gather_quantize(torch.from_numpy(x), torch.from_numpy(idx))
    _same(tq, jq)
    _same(ts, js)
    _same(ops.scatter_dequantize(tq, ts, torch.from_numpy(idx), C), jout)


def test_gather_quantize_within_an_ulp_of_jitted_reference():
    """vs the jitted shim, whose scale is max*(1/127) (fault B): scales to
    one ulp, q one step apart at most, and only where the scales differ."""
    x, idx = _x((16, 64), 19, 5.0), _idx(64, 32, 3)
    jq, js = map(np.asarray, jops.gather_quantize(jnp.asarray(x),
                                                  jnp.asarray(idx)))
    tq, ts = ops.gather_quantize(torch.from_numpy(x), torch.from_numpy(idx))
    ts = to_np(ts)
    assert np.all(np.abs(ts - js) <= np.spacing(np.abs(js)))
    dq = np.abs(to_np(tq).astype(np.int32) - jq.astype(np.int32))
    same = np.broadcast_to(ts == js, dq.shape)
    assert np.all(dq[same] == 0) and np.all(dq <= 1)


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_gather_quantize_nonfinite_rows_equal_eager_reference(value):
    """A row holding NaN or inf at a kept column keeps the reference's
    values: NaN or inf scale, q = 0 where the quotient is NaN, and the
    expansion NaN on that row's dropped channels too."""
    x, idx = _x((4, 10), 5), np.array([0, 3, 4, 9], np.int32)
    x[1, 3] = value
    jq, js = jref.gather_quantize_ref(jnp.asarray(x), jnp.asarray(idx))
    tq, ts = ops.gather_quantize(torch.from_numpy(x), torch.from_numpy(idx))
    _same(tq, jq)
    _same(ts, js)
    jout = jops.scatter_dequantize(jq, js, jnp.asarray(idx), 10)
    tout = ops.scatter_dequantize(tq, ts, torch.from_numpy(idx), 10)
    _same(tout, jout)
    assert np.isnan(to_np(tout)[1]).any()


@pytest.mark.parametrize("shape", ANY_RANK)
def test_dequantize_rows_equals_reference(shape):
    x = _x(shape, 11, 4.0)
    with jax_reference(ieee_quantize=True):
        jq, js = jops.quantize_rows(jnp.asarray(x))
    tq, ts = ops.quantize_rows(torch.from_numpy(x))
    _same(ops.dequantize_rows(tq, ts), jops.dequantize_rows(jq, js))


@pytest.mark.parametrize("spec", ["dense", "compact", "q8", "compact+q8"])
def test_encode_decode_equal_reference(spec):
    jc, tc = jcomm.get_codec(spec), tcomm.get_codec(spec)
    for shape in ANY_RANK:
        x = _x(shape, 13, 3.0)
        with jax_reference(ieee_quantize=True):
            jpay = jc.encode(jnp.asarray(x))
            jdec = jc.decode(jpay, like=jnp.asarray(x))
        tpay = tc.encode(torch.from_numpy(x))
        tdec = tc.decode(tpay, like=torch.from_numpy(x))
        for t, j in zip(*(p if isinstance(p, tuple) else (p,)
                          for p in (tpay, jpay))):
            _same(t, j)
        _same(tdec, jdec)
        if "q8" not in spec:
            np.testing.assert_array_equal(to_np(tdec), x)


@pytest.mark.parametrize("spec", ["dense", "compact", "q8", "compact+q8"])
def test_encode_compact_decode_expand_equal_reference(spec):
    jc, tc = jcomm.get_codec(spec), tcomm.get_codec(spec)
    for R, C, B in COMPACT:
        x, idx = _x((R, C), 17, 2.0), _idx(C, B, R)
        with jax_reference(ieee_quantize=True):
            jpay = jc.encode_compact(jnp.asarray(x), jnp.asarray(idx))
            jout = jc.decode_expand(jpay, jnp.asarray(idx), C,
                                    like=jnp.asarray(x))
        ti = torch.from_numpy(idx).long()
        tpay = tc.encode_compact(torch.from_numpy(x), ti)
        tout = tc.decode_expand(tpay, ti, C, like=torch.from_numpy(x))
        for t, j in zip(*(p if isinstance(p, tuple) else (p,)
                          for p in (tpay, jpay))):
            _same(t, j)
        _same(tout, jout)
