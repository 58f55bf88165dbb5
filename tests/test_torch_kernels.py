"""The port's kernel shims against the JAX package's references, through
the plain versions the wrappers take for CPU tensors.  The CUDA kernels
against their plain versions are in ``test_torch_kernels_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import ops, wire  # noqa: E402

from torch_port_helpers import to_np  # noqa: E402

# the shapes of tests/test_kernels.py::test_prox_sgd_update_shim, plus
# stacked (W, ...) leaves as local_step passes them and 0-D leaves
SHIM_CASES = [
    ((4, 3, 8, 16), (1, 3, 1, 1)),    # layer-wise adaptive rho
    ((4, 16), (1, 1)),                # bias-like leaf
    ((4,), (1,)),                     # 1-D leaf (one padded row)
    ((4, 3, 8, 16), (1, 3, 1, 16)),   # rho varies on minor axis: plain
    ((8,), (8,)),                     # 1-D leaf, per-element rho: plain
    ((16, 3, 3, 3, 64), (1, 1, 1, 1, 1)),   # stacked HWIO conv leaf
    ((16, 10), (1, 1)),               # stacked bias
    ((), ()),                         # 0-D leaf
]
QUANT_SHAPES = [(1, 1), (1, 7), (3, 1), (5, 33), (16, 128), (7, 257),
                (64, 10)]
ANY_RANK = [(), (7,), (1, 1), (3, 5, 7), (4, 2, 3, 9), (4, 1, 10)]


def _inputs(shape, rshape, seed=0):
    rng = np.random.default_rng(seed)
    xs = [np.asarray(rng.standard_normal(shape), np.float32)
          for _ in range(5)]
    rho = np.asarray(rng.random(rshape) + 0.1, np.float32)
    return xs, rho


@pytest.mark.parametrize("shape,rshape", SHIM_CASES)
def test_prox_sgd_update_matches_reference(shape, rshape):
    xs, rho = _inputs(shape, rshape)
    eta = np.float32(3e-3)
    tr, mr = jref.fused_prox_sgd_ref(*map(jnp.asarray, xs), eta=eta,
                                     rho=jnp.asarray(rho), momentum=0.9)
    t, m = ops.prox_sgd_update(*map(torch.from_numpy, xs),
                               torch.from_numpy(rho), float(eta),
                               momentum=0.9)
    assert tuple(t.shape) == np.shape(tr) and tuple(m.shape) == np.shape(mr)
    np.testing.assert_allclose(to_np(t), np.asarray(tr), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(m), np.asarray(mr), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 128), (6, 128, 256), (128,), (7,), ()])
def test_fused_prox_sgd_scalar_entry_matches_reference(shape):
    xs, _ = _inputs(shape, ())
    t, m = ops.fused_prox_sgd(*map(torch.from_numpy, xs), eta=1e-2, rho=1e-3,
                              momentum=0.9)
    tr, mr = jref.fused_prox_sgd_ref(*map(jnp.asarray, xs), eta=1e-2,
                                     rho=1e-3, momentum=0.9)
    np.testing.assert_allclose(to_np(t), np.asarray(tr), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(m), np.asarray(mr), rtol=1e-6, atol=1e-6)


def test_prox_sgd_update_without_momentum_or_consensus():
    """Missing operands take the reference's plain semantics."""
    xs, _ = _inputs((4, 8), ())
    th, g, z, u, _ = map(torch.from_numpy, xs)
    t, m = ops.prox_sgd_update(th, g, None, None, None, None, 1e-2)
    assert m is None
    np.testing.assert_allclose(to_np(t), to_np(th - 1e-2 * g), rtol=1e-6)
    t, m = ops.prox_sgd_update(th, g, z, u, None, torch.tensor(0.3), 1e-2)
    assert m is None
    np.testing.assert_allclose(
        to_np(t), to_np(th - 1e-2 * (g + 0.3 * (th - z + u))), rtol=1e-5,
        atol=1e-6)


def _quant_input(shape, seed):
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-3, 3)
    return np.asarray(rng.standard_normal(shape) * scale, np.float32)


@pytest.mark.parametrize("shape", QUANT_SHAPES)
@pytest.mark.parametrize("levels", [127, 7])
def test_quantize_rows_equals_eager_reference(shape, levels):
    for seed in range(4):
        x = _quant_input(shape, seed)
        qr, sr = jref.quantize_rows_ref(jnp.asarray(x), levels)
        q, s = wire.quantize_rows(torch.from_numpy(x), levels=levels)
        np.testing.assert_array_equal(to_np(q), np.asarray(qr))
        np.testing.assert_array_equal(to_np(s), np.asarray(sr))


NONFINITE = [("nan", np.nan), ("inf", np.inf), ("-inf", -np.inf)]


def _nonfinite_input(value, C):
    """Four rows of width C; row 1 holds ``value`` at two columns."""
    x = _quant_input((4, C), 5)
    x[1, 0] = x[1, C // 2] = value
    return x


@pytest.mark.parametrize("name,value", NONFINITE)
@pytest.mark.parametrize("C", [1, 33])
def test_quantize_rows_nonfinite_row_equals_eager_reference(name, value, C):
    """A non-finite row keeps the reference's values: a NaN scale for a
    NaN row, an inf scale for an inf row, and q = 0 wherever the quotient
    is NaN; the other rows are untouched."""
    x = _nonfinite_input(value, C)
    qr, sr = jref.quantize_rows_ref(jnp.asarray(x))
    q, s = wire.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(to_np(q), np.asarray(qr))
    np.testing.assert_array_equal(to_np(s), np.asarray(sr))
    assert not np.isfinite(to_np(s)[1, 0])


@pytest.mark.parametrize("shape", ANY_RANK)
def test_quantize_rows_any_rank_matches_jitted_shim(shape):
    """vs the jitted JAX shim, whose scale is max*(1/127): the scales agree
    to one ulp, and q differs only by one step where that ulp moves a
    value across a rounding boundary."""
    for seed in range(8):
        x = _quant_input(shape, seed)
        qj, sj = jops.quantize_rows(jnp.asarray(x))
        q, s = ops.quantize_rows(torch.from_numpy(x))
        sj, qj = np.asarray(sj), np.asarray(qj)
        assert q.shape == qj.shape and s.shape == sj.shape
        s = to_np(s)
        np.testing.assert_array_less(np.abs(s - sj),
                                     np.spacing(np.abs(sj)) * 1.5)
        same = np.broadcast_to(s == sj, qj.shape)
        dq = np.abs(to_np(q).astype(np.int32) - qj.astype(np.int32))
        assert np.all(dq[same] == 0) and np.all(dq <= 1)


def test_launch_counts_do_not_move_on_the_cpu():
    ops.reset_launch_counts()
    ops.prox_sgd_update(*[torch.ones(4, 8)] * 5, torch.tensor(0.1), 1e-2)
    ops.quantize_rows(torch.ones(4, 8))
    assert ops.launch_counts() == {"fused_prox_sgd": 0,
                                   "fused_prox_sgd_dyn": 0,
                                   "quantize_rows": 0}
