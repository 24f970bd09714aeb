"""The plain versions of the mesh's kernel entries (K8's butterfly and
stacked-carry entries, K5's stacked merge) against a left-to-right fold
built from the states' own ``merge``, bit for bit, on the CPU; each entry
at n = 1 against today's entry. The kernels themselves are held against
these plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py phase 9)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
import deequ_tpu_torch.analyzers as T
from deequ_tpu_torch.analyzers.base import pack_states, unpack_stacked
from deequ_tpu_torch.analyzers.states import leaves, with_leaves
from deequ_tpu_torch.kernels.kll_compact import kll_compact_merge, kll_compact_merge_stacked
from deequ_tpu_torch.kernels.state_fold import (
    MAX_SHARDS,
    state_fold,
    state_fold_butterfly,
    state_fold_carry,
    state_fold_carry_stacked,
)
from deequ_tpu_torch.ops.kll import kll_init, kll_update

pytestmark = pytest.mark.mesh

same = chip_smoke.same_state_bits
fold = chip_smoke.sequential_fold


def every_shard(states: list, n_dev: int) -> list:
    """Every shard's final accumulator of the collective merge's schedule,
    built from the states' own merge."""
    k = len(states) // n_dev
    acc = [fold(states[s * k:(s + 1) * k]) for s in range(n_dev)]
    if n_dev > 1 and n_dev & (n_dev - 1) == 0:
        shift = 1
        while shift < n_dev:
            acc = [acc[s].merge(acc[s ^ shift]) for s in range(n_dev)]
            shift <<= 1
    elif n_dev > 1:
        acc = [fold(acc)] * n_dev
    return acc


@pytest.mark.parametrize("n_dev,k", [(8, 1), (4, 2), (3, 2), (2, 3), (5, 1), (16, 1)])
def test_butterfly_plain_equals_every_shards_fold(n_dev, k):
    groups = chip_smoke.carry_groups(T, n_dev * k, seed=n_dev * 10 + k)
    jobs = [states for _, states in groups]
    mats, slots, places = pack_states(jobs)
    rows = state_fold_butterfly(*mats, slots, n_dev)
    assert all(r.shape[0] == n_dev for r in rows)
    got = unpack_stacked([states[0] for states in jobs], places, rows)
    for (a, states), stacked in zip(groups, got):
        want = every_shard(states, n_dev)
        for s in range(n_dev):
            shard = with_leaves(stacked, [leaf[s] for leaf in leaves(stacked)])
            assert same(shard, want[s]), (a, s)


def test_butterfly_at_one_shard_is_the_fold():
    groups = chip_smoke.carry_groups(T, 7, seed=3)
    mats, slots, _ = pack_states([states for _, states in groups])
    rows = state_fold_butterfly(*mats, slots, 1)
    for r, f in zip(rows, state_fold(*mats, slots)):
        assert r[0].numpy().tobytes() == f.numpy().tobytes()


def test_butterfly_rejects_bad_meshes():
    groups = chip_smoke.fold_groups(T, 6, seed=1)
    mats, slots, _ = pack_states([states for _, states in groups])
    with pytest.raises(ValueError, match="split"):
        state_fold_butterfly(*mats, slots, 4)
    with pytest.raises(ValueError, match="split"):
        state_fold_butterfly(*mats, slots, MAX_SHARDS + 1)


@pytest.mark.parametrize("n_dev,local", [(8, 4), (3, 2), (1, 5)])
def test_carry_stacked_plain_equals_each_shards_flagged_fold(n_dev, local):
    """Shard s folds its own slice of the chunk, only the flagged rows."""
    rng = np.random.default_rng(n_dev)
    groups = chip_smoke.carry_groups(T, n_dev * (local + 1), seed=n_dev)
    jobs = [states for _, states in groups]
    carries = [[states[s] for s in range(n_dev)] for states in jobs]
    parts = [states[n_dev:] for states in jobs]
    mats, slots, places = pack_states(carries)
    carry = [m.contiguous() for m in mats]
    part_mats = pack_states(parts)[0]
    flags = torch.from_numpy(rng.random(n_dev * local) < 0.7)
    flags[0] = True
    state_fold_carry_stacked(carry, part_mats, slots, flags)
    got = unpack_stacked([states[0] for states in jobs], places, carry)
    for (a, states), c_states, p_states, stacked in zip(groups, carries, parts, got):
        for s in range(n_dev):
            rows = [p_states[s * local + j] for j in range(local) if flags[s * local + j]]
            want = fold([c_states[s]] + rows)
            shard = with_leaves(stacked, [leaf[s] for leaf in leaves(stacked)])
            assert same(shard, want), (a, s)


def test_carry_stacked_at_one_shard_is_the_carry_entry():
    groups = chip_smoke.carry_groups(T, 9, seed=5)
    mats, slots, _ = pack_states([states for _, states in groups])
    one = [m[:1].contiguous() for m in mats]
    row = [m[0].contiguous() for m in mats]
    parts = [m[1:].contiguous() for m in mats]
    state_fold_carry_stacked(one, parts, slots)
    state_fold_carry(row, parts, slots)
    for a, b in zip(one, row):
        assert a[0].numpy().tobytes() == b.numpy().tobytes()


def test_carry_stacked_rejects_bad_inputs():
    groups = chip_smoke.fold_groups(T, 6, seed=2)
    mats, slots, _ = pack_states([states for _, states in groups])
    carry = [m[:2].contiguous() for m in mats]
    with pytest.raises(ValueError, match="same number"):
        state_fold_carry_stacked(carry, [m[:3].contiguous() for m in mats], slots)
    with pytest.raises(ValueError, match="flags"):
        state_fold_carry_stacked(carry, [m[:4].contiguous() for m in mats], slots,
                                 torch.ones(3, dtype=torch.bool))


def sketches(n: int, k: int = 32, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rows = int(rng.integers(0, 600))
        values = torch.from_numpy(rng.normal(i, 10, rows))
        out.append(kll_update(kll_init(k), values, torch.ones(rows, dtype=torch.bool),
                              None, torch.from_numpy(rng.random(rows) < 0.9)))
    return out


def test_kll_merge_stacked_plain_equals_one_pair_merges():
    a, b = sketches(8, seed=1), sketches(8, seed=2)
    stack = [torch.stack(col) for col in zip(*(s.tensors() for s in a))]
    other = [torch.stack(col) for col in zip(*(s.tensors() for s in b))]
    got = kll_compact_merge_stacked(stack, other, 32)
    for i in range(8):
        want = kll_compact_merge(a[i].tensors(), b[i].tensors(), 32)
        for g, w in zip(got, want):
            assert g[i].numpy().tobytes() == w.numpy().tobytes()
    # the inputs are left as they were
    assert all(torch.equal(x, y) for x, y in
               zip(stack, [torch.stack(col) for col in zip(*(s.tensors() for s in a))]))


def test_kll_merge_stacked_rejects_unequal_stacks():
    a, b = sketches(2, seed=1), sketches(3, seed=2)
    with pytest.raises(ValueError):
        kll_compact_merge_stacked([torch.stack(c) for c in zip(*(s.tensors() for s in a))],
                                  [torch.stack(c) for c in zip(*(s.tensors() for s in b))], 32)
