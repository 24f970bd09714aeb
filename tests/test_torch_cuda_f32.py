"""The float32 entries of the CUDA kernels (the reference's 32-bit
accumulator mode, ``DEEQU_TPU_NO_X64``) against their plain versions, on
the card.

K1's one-launch and stacked entries, K4, K5's update, merge, stacked merge
and ingest, and K8's fold, carry, butterfly and stacked carry take their
float32 instantiation for float32 inputs in either mode, so these cases run
in a 64-bit process: ``chip_smoke.check_f32_kernels`` (phase 19 (a) of
``chip_smoke.py``) casts a config-2 batch's features, sketches and packed
states to float32 / int32 and holds every entry to its plain version:
counts, min, max, registers, KLL items and every state leaf bit for bit,
sums and moments within ``chip_smoke.F32_KERNEL_RTOL`` (1e-5) of the
magnitudes that bound their rounding. Each entry counts its launches
under its ``_f32`` name (K1's float32 launch counts none under
``scan_reduce``).

Every test here is marked ``cuda`` and skips without a CUDA device; the
kernels are CUDA C++ and have no CPU build.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
import deequ_tpu_torch as dq
from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyScan
from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
from deequ_tpu_torch.kernels.scan_reduce import KIND_MOMENTS, Slot, scan_reduce, scan_reduce_plain
from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers

ROWS = 300_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch_rows", [1 << 16, 1 << 18])
def test_every_float32_entry_matches_its_plain_version(cuda_device, batch_rows):
    table = chip_smoke.build_table(ROWS, seed=batch_rows)
    data = dq.Dataset.from_arrow(table)
    check = chip_smoke.build_check(dq, ROWS)
    analyzers = list(dict.fromkeys(collect_required_analyzers([check])))
    battery = [a for a in analyzers if isinstance(a, ScanShareableAnalyzer)]
    battery += [DeviceFrequencyScan(c, data.dictionary_size(c)) for c in ("cat_small", "cat_large")]
    reset_launch_counts()
    measured = chip_smoke.check_f32_kernels(torch, dq, data, battery, batch_rows, quick=True)
    counts = launch_counts()
    assert set(measured) == set(chip_smoke.F32_ENTRIES)
    for name in chip_smoke.F32_ENTRIES:
        assert counts[name] > 0, name
        assert measured[name]["f64_ms"] > 0.0, name  # the float64 entry, same inputs


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 4097, 1_000_003])
def test_scan_reduce_f32_min_max_keys_keep_the_nan_and_zero_order(cuda_device, n):
    """K1's 32-bit order keys: NaN skipped by min (NaN when nothing else),
    NaN propagating through max, -0.0 below +0.0, the infinities at the
    ends; the kernel equals the plain version bit for bit."""
    rng = np.random.default_rng(n)
    v = rng.normal(0.0, 3.0, n).astype(np.float32)
    for value, p in ((0.0, 0.1), (-0.0, 0.1), (np.nan, 0.01), (np.inf, 0.001),
                     (-np.inf, 0.001)):
        v[rng.random(n) < p] = value
    vals = torch.from_numpy(v).to(cuda_device)
    nan_only = torch.full((n,), float("nan"), dtype=torch.float32, device=cuda_device)
    zeros = torch.from_numpy(np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)).to(
        cuda_device)
    rows = torch.from_numpy(rng.random(n) < 0.97).to(cuda_device)
    sel = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
    lens = torch.from_numpy(rng.integers(0, 90, n).astype(np.int32)).to(cuda_device)
    slots = [Slot(KIND_MOMENTS, sel=sel, vals=vals), Slot(KIND_MOMENTS, vals=nan_only),
             Slot(KIND_MOMENTS, sel=sel, vals=zeros), Slot(KIND_MOMENTS, sel=sel, vals=lens)]
    reset_launch_counts()
    ki, kf = scan_reduce(slots, rows)
    assert launch_counts()["scan_reduce_f32"] == 1 and launch_counts()["scan_reduce"] == 0
    pi, pf = scan_reduce_plain(slots, rows)
    torch.cuda.synchronize()
    assert ki.dtype == torch.int32 and kf.dtype == torch.float32
    assert torch.equal(ki, pi)
    for col in (1, 2):  # NaN equal to NaN whatever its payload
        assert chip_smoke.same_tensor_bits([kf[:, col]], [pf[:, col]]), col
