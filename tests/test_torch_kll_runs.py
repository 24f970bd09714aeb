"""The plain versions of K5 ``kll_compact``'s ingest and merge entries
against the JAX reference, on the inputs K5's kernel design is most
sensitive to.

The kernel sorts a level by merging its natural runs (a level is the odd
tail followed by appended sorted runs), so these cases vary the runs: the
sample sizes m of 0, 1, k, 2k and 4k, the level h rising and falling
between samples, a top level filled to its capacity 4k where appends drop
items, samples of one value, samples mixing -0.0 and +0.0 across runs, an
unsorted sample (the function allows one), and merges of states folded
from many small batches, whose levels hold many runs. The kernel is held
to these plain versions bit for bit on the card (``test_torch_cuda.py``,
``chip_smoke.py`` phase 2); here the plain versions are held to the
reference.

Every comparison is bit-exact on every leaf of the state. Both packages get
the same seeded numpy inputs; the reference's functions run jitted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deequ_tpu.ops import kll as J
from deequ_tpu_torch.kernels.kll_compact import kll_compact_ingest_plain, kll_compact_merge_plain
from deequ_tpu_torch.ops import kll as T
from deequ_tpu_torch.runners.engine import stack_samples

jax_ingest = jax.jit(J.kll_ingest_sampled)
jax_update = jax.jit(J.kll_update)
jax_merge = jax.jit(J.kll_merge)

LEAVES = ("items", "sizes", "parity", "ticks", "count", "g_min", "g_max")


def _assert_same_leaves(js, leaves) -> None:
    for name, got in zip(LEAVES, leaves):
        want = np.asarray(getattr(js, name))
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name


def _sample_values(case: str, b: int, m: int, rng) -> np.ndarray:
    """The m float64 items of sample b: ascending (stable, -0.0 equal to
    +0.0) but for the unsorted case's third sample."""
    if case == "one value":
        return np.full(m, 2.5)
    v = rng.normal(b % 5, 40.0, m)
    if case == "signed zeros":
        v = np.where(rng.random(m) < 0.5, -0.0, 0.0)
        some = rng.random(m) < 0.3
        v[some] = rng.normal(0.0, 1.0, int(some.sum()))
    if m >= 3 and b % 4 == 1:
        v[:3] = [np.inf, -1e300, 5e38]  # clipped to the float32 range
    if case == "unsorted" and b == 2:
        return v
    return v[np.argsort(v + 0.0, kind="stable")]


#: (m, h) of each sample, by case; k = the sketch size
def _schedule(case: str, k: int) -> list:
    if case == "m of 0, 1, k, 2k, 4k":
        return [(m, h) for h in (0, 1) for m in (0, 1, k, 2 * k, 4 * k)]
    if case == "h rising and falling":
        return [(k + 3 * i, h) for i, h in enumerate((0, 1, 2, 3, 2, 1, 0, 3, 0, 1))]
    if case == "top level at capacity":
        return [(2 * k, 3)] * 3 + [(4 * k, 3), (k, 2), (4 * k, 3)]
    return [(int(m), h) for m, h in zip((k, 2 * k, k + 1, 2 * k - 1, k // 2, 2 * k, k),
                                        (0, 0, 1, 0, 1, 1, 0))]


INGEST_CASES = ["m of 0, 1, k, 2k, 4k", "h rising and falling", "top level at capacity",
                "one value", "signed zeros", "unsorted"]


@pytest.mark.parametrize("k", [16, 40])
@pytest.mark.parametrize("case", INGEST_CASES)
def test_ingest_plain_matches_jax_applied_in_order(case, k):
    """Two stacked sketches take their samples in one chunk through the
    plain ingest entry; the reference applies ``kll_ingest_sampled`` to
    each sketch sample by sample."""
    levels = 4 if case == "top level at capacity" else 12
    width = 4 * k
    rng = np.random.default_rng(INGEST_CASES.index(case) * 100 + k)
    chunk = []
    for _ in range(2):
        row = []
        for b, (m, h) in enumerate(_schedule(case, k)):
            vals = _sample_values(case, b, m, rng)
            items = np.full(width, np.inf)
            items[:m] = vals
            lo, hi = (float(vals.min()), float(vals.max())) if m else (np.inf, -np.inf)
            row.append((items, m, h, m << h, lo, hi))
        chunk.append(row)
    sketches = [torch.stack(list(col)).contiguous()
                for col in zip(*(T.kll_init(k, levels).tensors() for _ in range(2)))]
    kll_compact_ingest_plain(sketches, stack_samples(chunk, width, lambda t: t), k)
    for s, row in enumerate(chunk):
        js = J.kll_init(k, levels)
        for items, m, h, nv, lo, hi in row:
            js = jax_ingest(js, jnp.asarray(items), jnp.int32(m), jnp.int32(h), jnp.int64(nv),
                            jnp.float64(lo), jnp.float64(hi))
        _assert_same_leaves(js, [leaf[s] for leaf in sketches])
    if case == "top level at capacity":
        assert int(sketches[1][0, levels - 1]) == width  # the top level is full


def _folded(k: int, n: int, batches: int, seed: int, zeros: bool):
    """A sketch folded from many batches of n rows in both packages: every
    batch appends a run, so the levels hold many of them."""
    rng = np.random.default_rng(seed)
    js, ts = J.kll_init(k), T.kll_init(k)
    for _ in range(batches):
        v = rng.normal(10.0, 3.0, n)
        if zeros:
            v[rng.random(n) < 0.4] = 0.0
            v[rng.random(n) < 0.4] = -0.0
        valid = rng.random(n) < 0.95
        js = jax_update(js, jnp.asarray(v), jnp.asarray(valid))
        ts = T.kll_update(ts, torch.from_numpy(v), torch.from_numpy(valid))
    _assert_same_leaves(js, ts.tensors())
    return js, ts


def _merged_runs(a, b) -> int:
    """The most runs a level of the merge of a and b starts its
    compaction with: a's level, then b's, split at every descent."""
    most = 0
    for level in range(a.items.shape[0]):
        x = np.concatenate([t.items[level, :int(t.sizes[level])].numpy() for t in (a, b)])
        if x.size:
            most = max(most, 1 + int(np.count_nonzero(np.diff(x + 0.0) < 0)))
    return most


@pytest.mark.parametrize("zeros", [False, True], ids=["normal", "signed zeros"])
@pytest.mark.parametrize("k,n,batches", [(16, 2, 45), (32, 5, 90), (64, 3, 150)])
def test_merge_plain_matches_jax_on_levels_of_many_runs(k, n, batches, zeros):
    """Both orders of the merge of two such sketches, and a sketch merged
    with itself."""
    ja, ta = _folded(k, n, batches, seed=k + n, zeros=zeros)
    jb, tb = _folded(k, n + 1, batches + 7, seed=3 * k + n, zeros=zeros)
    assert _merged_runs(ta, tb) >= 3
    for jx, jy, tx, ty in ((ja, jb, ta, tb), (jb, ja, tb, ta), (ja, ja, ta, ta)):
        _assert_same_leaves(jax_merge(jx, jy), kll_compact_merge_plain(tx.tensors(),
                                                                       ty.tensors(), k))
