"""The port's KLL sketch (``deequ_tpu_torch.ops.kll``: the plain versions of
the ``kll_sample`` and ``kll_compact`` kernels on the CPU) against the JAX
reference's ``kll_update`` and ``kll_merge``.

Every comparison is bit-exact on every leaf of the state: the items' layout
(not only each level's multiset), sizes, parities, the update counter, the
count, and the bits of g_min and g_max. Both packages get the same seeded
numpy batches, one batch at a time, at the same batch size. The reference
functions run jitted, as the JAX package's engine runs them (eagerly they
re-trace their loops on every call).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deequ_tpu.ops import kll as J
from deequ_tpu_torch.convert import from_reference, to_reference
from deequ_tpu_torch.kernels.kll_sample import kll_sample, sample_level
from deequ_tpu_torch.ops import kll as T

jax_update = jax.jit(J.kll_update)
jax_merge = jax.jit(J.kll_merge)

LEAVES = ("items", "sizes", "parity", "ticks", "count", "g_min", "g_max")
F32_MAX = float(np.finfo(np.float32).max)


def _assert_same_state(js, ts) -> None:
    assert ts.sketch_size == js.sketch_size
    for name in LEAVES:
        want = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name


def _fold_both(batches, k: int, js=None, ts=None):
    """Fold ``(values, valid)`` batches into a JAX and a port sketch,
    comparing the states after every batch."""
    js = J.kll_init(k) if js is None else js
    ts = T.kll_init(k) if ts is None else ts
    for values, valid in batches:
        js = jax_update(js, jnp.asarray(values), jnp.asarray(valid))
        ts = T.kll_update(ts, torch.from_numpy(values), torch.from_numpy(valid))
        _assert_same_state(js, ts)
    return js, ts


def _normal_batches(rng, n: int, count: int, p_valid: float = 1.0):
    return [
        (rng.normal(100.0, 30.0, n), rng.random(n) < p_valid) for _ in range(count)
    ]


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("j", [0, 2, 5])
@pytest.mark.parametrize("plus", [0, 1])
def test_update_matches_jax_at_power_of_two_boundaries(k, j, plus):
    """n = k * 2^j picks exactly k items at level j; one more row moves the
    batch a level up, to 2^(j+1) strides and about k / 2 items."""
    n = k * 2**j + plus
    assert sample_level(n, k) == j + plus
    rng = np.random.default_rng(1000 * k + 10 * j + plus)
    _fold_both(_normal_batches(rng, n, 9), k)


@pytest.mark.parametrize("k", [8, 16])
def test_update_cascades_several_levels_deep(k):
    """Many small batches: compactions ripple up through several levels."""
    rng = np.random.default_rng(k)
    js, ts = _fold_both(_normal_batches(rng, 3 * k, 120, p_valid=0.9), k)
    assert int(np.count_nonzero(np.asarray(js.sizes))) >= 4
    assert int(np.asarray(js.sizes)[0]) <= k


def _edge_batch(case: str, rng, n: int):
    v = rng.normal(0.0, 1.0, n)
    valid = rng.random(n) < 0.85
    if case == "signed_zeros":
        zeros = rng.random(n) < 0.4
        v[zeros] = np.where(rng.random(int(zeros.sum())) < 0.5, -0.0, 0.0)
    elif case == "nan_and_inf":
        v[rng.random(n) < 0.1] = np.nan
        v[rng.random(n) < 0.05] = np.inf
        v[rng.random(n) < 0.05] = -np.inf
    elif case == "beyond_f32":
        v[rng.random(n) < 0.1] = 1e300
        v[rng.random(n) < 0.1] = -7e200
        v[rng.random(n) < 0.05] = np.nextafter(F32_MAX, np.inf)
        v[rng.random(n) < 0.05] = -F32_MAX
    elif case == "all_masked":
        valid[:] = False
    elif case == "all_nan":
        v[:] = np.nan
    return v, valid


EDGE_CASES = ["signed_zeros", "nan_and_inf", "beyond_f32", "all_masked", "all_nan"]


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_update_matches_jax_on_edge_values(case, k):
    """Signed zeros keep their bits and order, NaN is left out, +-inf and
    values beyond the float32 range clip to +-f32 max in the items while
    g_min and g_max keep them exactly; an all-masked batch only ticks."""
    rng = np.random.default_rng(EDGE_CASES.index(case) + 17 * k)
    batches = [_edge_batch(case, rng, 5 * k + 3) for _ in range(14)]
    js, ts = _fold_both(batches, k)
    if case in ("all_masked", "all_nan"):
        assert int(ts.count) == 0 and float(ts.g_min) == np.inf


@pytest.mark.parametrize("k", [8, 16])
def test_update_matches_jax_on_one_row_batches(k):
    rng = np.random.default_rng(5 + k)
    batches = [
        (np.array([v]), np.array([bool(ok)]))
        for v, ok in zip(rng.choice([0.0, -0.0, 1.5, -2.0, np.nan], 40), rng.random(40) < 0.9)
    ]
    _fold_both(batches, k)


def test_mixed_batch_sizes_and_a_signed_zero_min():
    k = 8
    rng = np.random.default_rng(99)
    batches = []
    for n in (1, 7, 8, 9, 63, 64, 65, 300, 2, 128):
        v = rng.normal(0, 1, n)
        v[: n // 2] = np.where(rng.random(n // 2) < 0.5, 0.0, -0.0)
        batches.append((v, np.ones(n, dtype=bool)))
    js, ts = _fold_both(batches, k)
    assert np.signbit(float(ts.g_min)) or float(ts.g_min) < 0


def _states(k: int, seed: int, batches: int = 12):
    rng = np.random.default_rng(seed)
    data = _normal_batches(rng, 5 * k, batches, p_valid=0.9)
    for v, _ in data[::3]:
        v[::4] = -0.0
    return _fold_both(data, k)


@pytest.mark.parametrize("k", [8, 16])
def test_merge_matches_jax(k):
    ja, ta = _states(k, 1)
    jb, tb = _states(k, 2, batches=17)
    _assert_same_state(jax_merge(ja, jb), T.kll_merge(ta, tb))
    _assert_same_state(jax_merge(jb, ja), T.kll_merge(tb, ta))
    # a merge with an empty sketch keeps the items and XORs no parity
    _assert_same_state(jax_merge(ja, J.kll_init(k)), T.kll_merge(ta, T.kll_init(k)))


@pytest.mark.parametrize("k", [8, 16])
def test_merge_of_states_carried_across_packages(k):
    """A port state goes to JAX and back through ``convert.py``; merges on
    either side of the carry agree bit for bit."""
    ja, ta = _states(k, 3)
    jb, tb = _states(k, 4)
    name, leaves = to_reference(tb)
    assert name == "KLLSketchState"
    jb_carried = J.KLLSketchState(*(jnp.asarray(x) for x in leaves), sketch_size=k)
    _assert_same_state(jb_carried, tb)
    merged_in_jax = jax_merge(ja, jb_carried)
    back = from_reference("KLLSketchState", [np.asarray(x) for x in
                                             (getattr(merged_in_jax, f) for f in LEAVES)])
    assert back.sketch_size == k
    _assert_same_state(merged_in_jax, back)
    _assert_same_state(merged_in_jax, T.kll_merge(ta, tb))
    # and the carried state folds on like the one it came from
    rng = np.random.default_rng(8)
    _fold_both(_normal_batches(rng, 4 * k, 3), k, merged_in_jax, back)


def test_compactor_buffers_match_jax():
    js, ts = _states(8, 6, batches=30)
    assert T.compactor_buffers(ts) == J.compactor_buffers(js)


def test_empty_batch_samples_nothing():
    ticks = torch.zeros((), dtype=torch.int32)
    out = kll_sample(torch.empty(0, dtype=torch.float64), torch.empty(0, dtype=torch.bool),
                     None, None, ticks, 8)
    assert out.meta.tolist() == [0, 0, 0]
    assert torch.isinf(out.samples).all()
    assert out.minmax.tolist() == [float("inf"), float("-inf")]


def test_wrappers_refuse_bad_inputs():
    ticks = torch.zeros((), dtype=torch.int32)
    rows = torch.ones(4, dtype=torch.bool)
    # float64 values, or float32 in the 32-bit accumulator mode; no other
    with pytest.raises(TypeError):
        kll_sample(torch.ones(4, dtype=torch.float16), rows, None, None, ticks, 8)
    with pytest.raises(TypeError):
        kll_sample(torch.ones(4, dtype=torch.int32), rows, None, None, ticks, 8)
    with pytest.raises(ValueError):
        kll_sample(torch.ones(4, dtype=torch.float64), rows, None, None, ticks, 0)
    with pytest.raises(ValueError):
        T.kll_merge(T.kll_init(8), T.kll_init(16))
