"""The port's fault-tolerance policies (``repro_torch.dist.ft``) against
the JAX package's ``repro.dist.ft``: every policy's weight vectors, the
spec strings and their round trip, class weights, and the errors."""
import json

import numpy as np
import pytest

from repro.dist import ft as jft
from repro_torch.dist import ft as tft

# each case builds one policy from either module
POLICIES = {
    "healthy": lambda m: m.healthy(),
    "fail_window": lambda m: m.fail_window({1: (2, 5), 3: (0, 12)}),
    "fail_window_out_of_range": lambda m: m.fail_window({7: (0, 100)}),
    "straggler_const": lambda m: m.straggler_decay({2: 0.25}),
    "straggler_halflife": lambda m: m.straggler_decay({0: 0.5, 9: 0.1},
                                                      halflife=4),
    "constant": lambda m: m.constant([0.5, 1.0, 0.25]),
    "compose": lambda m: m.compose(m.fail_window({0: (3, 7)}),
                                   m.straggler_decay({1: 0.5}, halflife=2),
                                   m.constant([1.0, 1.0, 0.75])),
    "compose_empty": lambda m: m.compose(),
    "class_scoped": lambda m: m.class_scoped(
        {"ffn": m.straggler_decay({1: 0.25}, halflife=4),
         "heads": m.fail_window({0: (2, 5)})}),
    "compose_scoped": lambda m: m.compose(
        m.straggler_decay({3: 0.5}),
        m.class_scoped({"ffn": m.constant([0.5, 1, 1, 1])}),
        m.class_scoped({"ffn": m.constant([0.5, 1, 1, 1]),
                        "heads": m.constant([1, 0.25, 1, 1])})),
}
WORKERS = (1, 4, 16)


@pytest.mark.parametrize("W", WORKERS)
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_vectors_equal_reference(name, W):
    tp, jp = POLICIES[name](tft), POLICIES[name](jft)
    for k in range(12):
        t, j = tp(k, W), jp(k, W)
        assert isinstance(t, np.ndarray) and t.dtype == np.float32
        assert t.shape == (W,)
        np.testing.assert_array_equal(t, j, err_msg=f"k={k}")
        if getattr(jp, "per_class", False):
            tc, jc = tp.class_weights(k, W), jp.class_weights(k, W)
            assert set(tc) == set(jc)
            for cls in jc:
                assert tc[cls].dtype == np.float32
                np.testing.assert_array_equal(tc[cls], jc[cls],
                                              err_msg=f"{cls} k={k}")


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_spec_equals_reference_and_round_trips(name):
    tp, jp = POLICIES[name](tft), POLICIES[name](jft)
    assert getattr(tp, "spec", None) == getattr(jp, "spec", None)
    assert getattr(tp, "per_class", False) == getattr(jp, "per_class", False)
    if getattr(tp, "spec", None) is None:   # the empty compose has none
        return
    tp2 = tft.from_spec(tp.spec)
    assert tp2.spec == tp.spec
    assert getattr(tp2, "per_class", False) == getattr(tp, "per_class",
                                                       False)
    for k in (0, 3, 6, 11):
        np.testing.assert_array_equal(tp2(k, 4), jft.from_spec(jp.spec)(k, 4))
        if getattr(tp, "per_class", False):
            a, b = tp2.class_weights(k, 4), tp.class_weights(k, 4)
            assert set(a) == set(b)
            for cls in a:
                np.testing.assert_array_equal(a[cls], b[cls])


def test_from_spec_reads_the_reference_grammar():
    spec = ('fail_window:{"0": [10, 20]}|straggler_decay:'
            + json.dumps({"halflife": 8, "stragglers": {"3": 0.25}},
                         sort_keys=True))
    tp, jp = tft.from_spec(spec), jft.from_spec(spec)
    assert tp.spec == jp.spec == spec
    for k in range(0, 30, 3):
        np.testing.assert_array_equal(tp(k, 4), jp(k, 4))


@pytest.mark.parametrize("build,match", [
    (lambda m: m.class_scoped(
        {"ffn": m.compose(m.healthy(), m.straggler_decay({0: 0.5}))}),
     "composed"),
    (lambda m: m.class_scoped(
        {"ffn": lambda k, W: np.ones((W,), np.float32)}), "no .spec"),
    (lambda m: m.from_spec(""), "empty ft policy spec"),
    (lambda m: m.from_spec("healthy|bogus:{}"), "unknown ft policy"),
])
def test_errors_equal_reference(build, match):
    with pytest.raises(ValueError, match=match):
        build(jft)
    with pytest.raises(ValueError, match=match):
        build(tft)


def test_policy_module_is_numpy_only():
    """The port's copy imports neither torch nor anything of JAX."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(tft))
    mods = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods <= {"__future__", "json", "typing", "numpy"}, mods
