"""Per-layer recomputation (``ArchConfig.remat``) in the port against the
JAX package.

The reference wraps each LM layer in ``jax.checkpoint`` when
``cfg.remat`` (its default).  The port's bundle then hands out a
:class:`repro_torch.models.api.Staged` loss, and
``core.hsadmm.grad_and_value`` takes a layer-by-layer pullback that keeps
only each block's input and recomputes the block in the backward (under
the workers' ``vmap``, where ``torch.utils.checkpoint`` does not run).

* tinyllama smoke (8 query heads in 4 GQA groups) and mamba2 smoke, f32,
  two workers under ``vmap`` as ``local_step`` runs them, with
  ``grad_accum`` 1 and 2: the loss and every gradient at ``remat=True``
  bit-equal to ``remat=False``;
* the same gradients against the JAX ``train_loss`` at ``remat=True``
  (one worker's, as the mean of its sequences' own) within the
  families' f32 tolerances (``tests/test_torch_transformer.py``,
  ``tests/test_torch_ssm.py``);
* the config's default and the bundles: an LM's ``train_loss`` is staged
  exactly when ``remat`` is set; ResNet, which the reference never
  recomputes, keeps its plain loss.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import vmap  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import build as j_build  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import hsadmm as ths  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402
from repro_torch.models.api import Staged  # noqa: E402

from torch_port_helpers import np_flat, perturbed, to_np  # noqa: E402

LM = {"tinyllama-1.1b": dict(n_heads=8, n_kv_heads=4), "mamba2-780m": {}}
W, B, T = 2, 2, 24      # workers, sequences a worker, tokens a sequence


def _grads(loss_fn, ga: int):
    vg = ths.accumulated(loss_fn, ga) if ga > 1 \
        else ths.grad_and_value(loss_fn)
    return vmap(vg)


@pytest.fixture(scope="module", params=sorted(LM))
def model(request):
    """Both packages' smoke model of one LM family at remat=True from
    JAX-drawn, perturbed weights; two workers' parameters (the second
    scaled by 1.01) and their token batches; the JAX loss and gradients
    of worker 0's sequences one at a time (their mean is the loss and the
    gradient of the whole batch, and of its two microbatches: every
    sequence has T - 1 targets)."""
    arch = request.param
    jb = j_build(get_config(arch, smoke=True).replace(**LM[arch]))
    assert jb.cfg.remat
    p = perturbed(jax.device_get(jax.jit(jb.init)(jax.random.PRNGKey(0))),
                  seed=2)
    cfg = t_get_config(arch, smoke=True).replace(**LM[arch])
    base = convert.params_from_jax(p, device="cpu")
    theta = {k: torch.stack([v, v * 1.01]) for k, v in base.items()}
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab, size=(W, B, T)).astype(np.int32)
    vg = jax.jit(jax.value_and_grad(jb.train_loss))
    jp = jax.tree.map(jnp.asarray, p)
    parts = [vg(jp, {"tokens": jnp.asarray(toks[0, i:i + 1])})
             for i in range(B)]
    flat = [np_flat(jax.device_get(g)) for _, g in parts]
    return dict(arch=arch, cfg=cfg, theta=theta,
                batch={"tokens": torch.from_numpy(toks).long()},
                jloss=sum(float(l) for l, _ in parts) / B,
                jgrads={k: sum(f[k] for f in flat) / B for k in flat[0]},
                port={})


def _port(model, ga: int, remat: bool = True):
    """The port's (grads, losses) of both workers, computed once."""
    key = (ga, remat)
    if key not in model["port"]:
        tb = t_build(model["cfg"].replace(remat=remat))
        assert isinstance(tb.train_loss, Staged) == remat
        model["port"][key] = _grads(tb.train_loss, ga)(model["theta"],
                                                       model["batch"])
    return model["port"][key]


@pytest.mark.parametrize("ga", [1, 2])
def test_remat_is_bit_equal_to_the_plain_backward(model, ga):
    g1, l1 = _port(model, ga)
    g0, l0 = _port(model, ga, remat=False)
    assert torch.equal(l1, l0)
    assert set(g1) == set(g0) == set(model["theta"])
    for k in g0:
        assert torch.equal(g1[k], g0[k]), k


@pytest.mark.parametrize("ga", [1, 2])
def test_remat_matches_reference_gradients(model, ga):
    """Worker 0's loss and gradients at remat=True against the JAX
    ``train_loss`` (itself at remat=True)."""
    g, loss = _port(model, ga)
    np.testing.assert_allclose(float(loss[0]), model["jloss"], rtol=1e-5)
    assert set(g) == set(model["jgrads"])
    for k, want in model["jgrads"].items():
        got = to_np(g[k][0])
        if model["arch"].startswith("mamba2"):
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_remat_defaults_and_families():
    for arch in LM:
        assert t_get_config(arch).remat and t_get_config(arch, smoke=True).remat
        assert isinstance(t_build(t_get_config(arch, smoke=True))
                          .train_loss, Staged)
    rn = t_build(t_get_config("resnet18", smoke=True))
    assert rn.cfg.remat and not isinstance(rn.train_loss, Staged)
