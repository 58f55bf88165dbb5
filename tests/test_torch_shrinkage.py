"""The port's compaction / zero-fill recovery and byte accounting against
the JAX reference."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import shrinkage as jsh  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.core.masks import MaskSyncConfig, budget  # noqa: E402
from repro.models import build as j_build  # noqa: E402

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import shrinkage as tsh  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402

from torch_port_helpers import np_flat, to_np  # noqa: E402


def _nested(flat):
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("arch,smoke", [("resnet18", True),
                                        ("resnet152", True)])
def test_compact_expand_params_equal_reference(arch, smoke):
    b = t_build(t_get_config(arch, smoke=smoke))
    rng = np.random.default_rng(0)
    p = {k: np.asarray(rng.standard_normal((2,) + tuple(s)), np.float32)
         for k, s in b.shapes.items()}
    idxs_np = {}
    for r in b.plan.rules:
        sc = rng.random((r.groups,)).astype(np.float32)
        _, idx = jsp.topk_mask(jnp.asarray(sc), r.keep)
        idxs_np[r.name] = np.array(idx)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    t_idx = {k: torch.tensor(v).long() for k, v in idxs_np.items()}
    j_idx = {k: jnp.asarray(v) for k, v in idxs_np.items()}
    fulls = {r.name: r.groups for r in b.plan.rules}

    jc = jsh.compact_params(_nested(p), b.plan, j_idx, offset=1)
    tc = tsh.compact_params(tp, b.plan, t_idx, offset=1)
    for k, v in np_flat(jc).items():
        np.testing.assert_array_equal(to_np(tc[k]), v, err_msg=k)
    je = jsh.expand_params(jc, b.plan, j_idx, fulls, offset=1)
    te = tsh.expand_params(tc, b.plan, t_idx, fulls, offset=1)
    for k, v in np_flat(je).items():
        np.testing.assert_array_equal(to_np(te[k]), v, err_msg=k)


@pytest.mark.parametrize("shards,stack", [(1, 0), (1, 1), (2, 0), (4, 1)])
def test_compact_expand_leaf_stacked_and_balanced(shards, stack):
    rng = np.random.default_rng(1)
    L, C, keep = 3, 16, 8
    x = np.asarray(rng.standard_normal((2, L, 5, C)), np.float32)
    scores = rng.random((L, C) if stack else (C,)).astype(np.float32)
    _, idx = jsp.topk_mask(jnp.asarray(scores), keep, shards)
    idx = np.array(idx)
    ax = 3
    jc = jsh.compact_leaf(jnp.asarray(x), jnp.asarray(idx), ax, stack, 1,
                          shards)
    tc = tsh.compact_leaf(torch.from_numpy(x), torch.from_numpy(idx).long(),
                          ax, stack, 1, shards)
    np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
    je = jsh.expand_leaf(jc, jnp.asarray(idx), ax, C, stack, 1, shards)
    te = tsh.expand_leaf(tc, torch.from_numpy(idx).long(), ax, C, stack, 1,
                         shards)
    np.testing.assert_array_equal(to_np(te), np.asarray(je))


@pytest.mark.parametrize("codec", [None, "dense", "q8", "compact+q8"])
def test_plan_bytes_resnet18_full_equal_reference(codec):
    tb = t_build(t_get_config("resnet18"))
    jb = j_build(get_config("resnet18"))
    budgets = {r.name: budget(r, MaskSyncConfig()) for r in jb.plan.rules}
    jshapes = jax_shapes(jb)
    assert tb.shapes == jshapes
    assert tsh.plan_payload_shapes(tb.shapes, tb.plan, budgets) == \
        jsh.plan_payload_shapes(jshapes, jb.plan, budgets)
    got = tsh.plan_bytes(tb.shapes, tb.plan, budgets, "float32", codec=codec)
    ref = jsh.plan_bytes(jshapes, jb.plan, budgets, "float32", codec=codec)
    assert got == ref and all(isinstance(v, int) for v in got)


@pytest.mark.parametrize("mode", ["score_consensus", "bitwise_or"])
def test_mask_sync_bytes_resnet18_full_equal_reference(mode):
    tb = t_build(t_get_config("resnet18"))
    jb = j_build(get_config("resnet18"))
    assert tsh.mask_sync_bytes(tb.shapes, tb.plan, mode) == \
        jsh.mask_sync_bytes(tb.shapes, jb.plan, mode) == \
        (960 if mode == "score_consensus" else 30)


def jax_shapes(jb):
    import jax
    from repro.core.hsadmm import flatten
    tree = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    return {k: tuple(v.shape) for k, v in flatten(tree).items()}
