"""The port's sparsity plans, scores, top-k masks, projection and mask
synchronization against the JAX reference."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import coupling as jcoup  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.models import build as j_build  # noqa: E402

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import coupling as tcoup  # noqa: E402
from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.models import build as t_build  # noqa: E402

from torch_port_helpers import np_flat, to_np  # noqa: E402

ARCHS = [("resnet18", False), ("resnet18", True), ("resnet152", True)]


def _rule_fields(r):
    return (r.name, tuple((la.key, la.axis) for la in r.leaves),
            tuple((la.key, la.axis) for la in r.followers), r.groups, r.keep,
            r.stack_ndims, r.shards, r.group_size, r.compactable)


@pytest.mark.parametrize("arch,smoke", ARCHS)
def test_plan_equals_reference(arch, smoke):
    jplan = j_build(get_config(arch, smoke=smoke)).plan
    tplan = t_build(t_get_config(arch, smoke=smoke)).plan
    assert [_rule_fields(r) for r in tplan.rules] == \
        [_rule_fields(r) for r in jplan.rules]


def test_resnet18_full_has_eight_coupling_classes():
    plan = t_build(t_get_config("resnet18")).plan
    assert plan.names == ("cnn:stem", "cnn:mid0", "cnn:mid1", "cnn:out1",
                          "cnn:mid2", "cnn:out2", "cnn:mid3", "cnn:out3")


def _params(shapes, lead, seed):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.standard_normal((lead,) + tuple(s)),
                          np.float32) for k, s in shapes.items()}


def _nested(flat):
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return out


@pytest.fixture(scope="module")
def smoke():
    b = t_build(t_get_config("resnet18", smoke=True))
    p = _params(b.shapes, 3, 0)
    return b, p, _nested(p), {k: torch.from_numpy(v) for k, v in p.items()}


def test_group_scores_match_reference(smoke):
    b, _, jp, tp = smoke
    for rule in b.plan.rules:
        js = jsp.group_scores(jp, rule, offset=1)
        ts = tsp.group_scores(tp, rule, offset=1)
        np.testing.assert_allclose(to_np(ts), np.asarray(js), rtol=1e-6,
                                   err_msg=rule.name)


def test_apply_mask_rule_matches_reference(smoke):
    b, _, jp, tp = smoke
    for rule in b.plan.rules:
        s = tsp.group_scores(tp, rule, offset=1)
        mask, _ = tsp.topk_mask(s, rule.keep, rule.shards)
        jout = jsp.apply_mask_rule(jp, rule, jnp.asarray(to_np(mask)), 1)
        tout = tsp.apply_mask_rule(tp, rule, mask, 1)
        for k, v in np_flat(jout).items():
            np.testing.assert_array_equal(to_np(tout[k]), v, err_msg=k)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_topk_mask_matches_reference_with_ties(shards):
    rng = np.random.default_rng(3)
    # few distinct values: most groups tie with several others
    scores = rng.integers(0, 4, size=(5, 3, 16)).astype(np.float32)
    for keep in (4, 8, 12):
        jm, ji = jsp.topk_mask(jnp.asarray(scores), keep, shards)
        tm, ti = tsp.topk_mask(torch.from_numpy(scores), keep, shards)
        np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
        np.testing.assert_array_equal(to_np(tm), np.asarray(jm))


@pytest.mark.parametrize("mode", ["score_consensus", "bitwise_or"])
def test_sync_masks_and_drift_match_reference(smoke, mode):
    b, _, jp, tp = smoke
    cfg_j = jmasks.MaskSyncConfig(mode=mode)
    cfg_t = tmasks.MaskSyncConfig(mode=mode)
    for rule in b.plan.rules:
        assert tmasks.budget(rule, cfg_t) == jmasks.budget(rule, cfg_j)
        scores = tsp.group_scores(tp, rule, offset=1)
        ji, jv, jm = jmasks.sync_masks(jnp.asarray(to_np(scores)), rule,
                                       cfg_j)
        ti, tv, tm = tmasks.sync_masks(scores, rule, cfg_t)
        np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
        np.testing.assert_array_equal(to_np(tv), np.asarray(jv))
        np.testing.assert_array_equal(to_np(tm), np.asarray(jm))
        prev = np.zeros(to_np(tm).shape, np.float32)
        prev[..., ::3] = 1.0
        assert float(tmasks.mask_drift(torch.from_numpy(prev), tm)) == \
            float(jmasks.mask_drift(jnp.asarray(prev), jm))


def test_channel_idx_and_mask_match_reference(smoke):
    b, *_ = smoke
    rule = b.plan.rules[0]
    idx = np.array([[0, 2], [1, 3]], np.int32)
    np.testing.assert_array_equal(
        to_np(tsp.channel_idx(rule, torch.from_numpy(idx).long())),
        np.asarray(jsp.channel_idx(rule, jnp.asarray(idx))))
    mask = np.array([[1, 0, 1, 0]], np.float32)
    np.testing.assert_array_equal(
        to_np(tsp.channel_mask(rule, torch.from_numpy(mask))),
        np.asarray(jsp.channel_mask(rule, jnp.asarray(mask))))


@pytest.mark.parametrize("dim,rate,multiple", [(64, 0.5, 8), (10, 0.3, 1),
                                               (3, 0.5, 8), (512, 0.25, 1)])
def test_keep_count_matches_reference(dim, rate, multiple):
    assert tsp.keep_count(dim, rate, multiple) == \
        jsp.keep_count(dim, rate, multiple)


def test_compaction_order_is_refused_alike():
    """A rule stacked over an axis another rule compacts must come first;
    both packages refuse the other order."""
    def plan(mod_sp):
        stacked = mod_sp.GroupRule(
            "moe_ffn", (mod_sp.LeafAxis("w", 2),), groups=8, keep=4,
            stack_ndims=2)
        experts = mod_sp.GroupRule(
            "experts", (mod_sp.LeafAxis("w", 1),), groups=4, keep=2,
            stack_ndims=1)
        return mod_sp.SparsityPlan((experts, stacked))
    with pytest.raises(ValueError):
        jcoup.validate_compaction_order(plan(jsp))
    with pytest.raises(ValueError):
        tcoup.validate_compaction_order(plan(tsp))
    tcoup.validate_compaction_order(dataclasses.replace(
        plan(tsp), rules=plan(tsp).rules[::-1]))
