"""The port's ResNet against the JAX reference on carried-across weights:
leaf layout, forward, loss and per-leaf gradients, and the "SAME" padding
of strided convs."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.hsadmm import flatten as j_flatten  # noqa: E402
from repro.models import build as j_build  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

from torch_port_helpers import np_flat, to_np  # noqa: E402


@pytest.mark.parametrize("arch,smoke", [("resnet18", False),
                                        ("resnet18", True),
                                        ("resnet152", True)])
def test_leaf_keys_and_shapes_equal_reference(arch, smoke):
    jb = j_build(get_config(arch, smoke=smoke))
    ref = {k: tuple(v.shape) for k, v in j_flatten(
        jax.eval_shape(jb.init, jax.random.PRNGKey(0))).items()}
    tb = t_build(t_get_config(arch, smoke=smoke))
    assert tb.shapes == ref
    p = tb.init(torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == ref
    if arch == "resnet18" and not smoke:
        assert len(ref) == 62
        assert sum(int(np.prod(s)) for s in ref.values()) == 11_173_962


@pytest.fixture(scope="module", params=["resnet18", "resnet152"])
def carried(request):
    """JAX init weights of the smoke config, carried into the port, and a
    batch of the synthetic stream."""
    jb = j_build(get_config(request.param, smoke=True))
    tb = t_build(t_get_config(request.param, smoke=True))
    p_np = jax.device_get(jb.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {"images": np.asarray(rng.standard_normal((4, 16, 16, 3)),
                                  np.float32),
             "labels": np.asarray(rng.integers(0, 10, 4), np.int32)}
    return jb, tb, p_np, batch


def test_forward_and_loss_match_reference(carried):
    jb, tb, p_np, batch = carried
    tp = convert.params_from_jax(p_np, device="cpu")
    jl = jcnn.forward(jb.cfg, jax.tree.map(jnp.asarray, p_np),
                      jnp.asarray(batch["images"]))
    tl = tcnn.forward(tb.cfg, tp, torch.from_numpy(batch["images"]))
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)
    jb_ = {k: jnp.asarray(v) for k, v in batch.items()}
    tb_ = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        float(tb.train_loss(tp, tb_)),
        float(jb.train_loss(jax.tree.map(jnp.asarray, p_np), jb_)),
        rtol=1e-5)
    assert float(tcnn.accuracy(tb.cfg, tp, tb_)) == \
        float(jcnn.accuracy(jb.cfg, jax.tree.map(jnp.asarray, p_np), jb_))


def test_grads_match_reference(carried):
    jb, tb, p_np, batch = carried
    jg = jax.grad(jb.train_loss)(jax.tree.map(jnp.asarray, p_np),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    tg = torch.func.grad(tb.train_loss)(
        convert.params_from_jax(p_np, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    ref = np_flat(jg)
    assert set(tg) == set(ref)
    for k, v in ref.items():
        scale = np.abs(v).max()
        np.testing.assert_allclose(to_np(tg[k]), v, rtol=1e-4,
                                   atol=1e-6 * max(scale, 1e-3), err_msg=k)


@pytest.mark.parametrize("hw,k,stride", [(16, 3, 2), (15, 3, 2), (8, 1, 2),
                                         (16, 3, 1), (9, 3, 3)])
def test_conv_pads_like_jax_same(hw, k, stride):
    rng = np.random.default_rng(1)
    x = np.asarray(rng.standard_normal((2, hw, hw, 5)), np.float32)
    w = np.asarray(rng.standard_normal((k, k, 5, 6)), np.float32)
    ref = np.asarray(jcnn.conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = to_np(tcnn.conv(torch.from_numpy(x), torch.from_numpy(w), stride))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if (hw, k, stride) == (16, 3, 2):
        # PyTorch's symmetric padding=1 is NOT JAX's (0, 1) here
        sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                       padding=1).permute(0, 2, 3, 1)
        assert np.abs(to_np(sym) - ref).max() > 1.0


def test_group_norm_matches_reference():
    rng = np.random.default_rng(2)
    x = np.asarray(rng.standard_normal((2, 4, 4, 32)) * 3 + 1, np.float32)
    sc = np.asarray(rng.standard_normal(32), np.float32)
    bi = np.asarray(rng.standard_normal(32), np.float32)
    ref = jcnn.group_norm(*map(jnp.asarray, (x, sc, bi)), 8)
    got = tcnn.group_norm(*map(torch.from_numpy, (x, sc, bi)), 8)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError):
        tcnn.group_norm(torch.from_numpy(x), torch.from_numpy(sc),
                        torch.from_numpy(bi), 7)


def test_init_is_seeded_and_device_independent():
    tb = t_build(t_get_config("resnet18", smoke=True))
    a = tb.init(torch.Generator().manual_seed(3), "cpu")
    b = tb.init(torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.all(a["gn0/scale"] == 1) and torch.all(a["fc_b"] == 0)
    fan_in = 3 * 3 * 3
    assert abs(float(a["stem"].std()) * fan_in ** 0.5 - 1.0) < 0.2
