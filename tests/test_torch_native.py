"""The port's native host library (``deequ_tpu_torch/native``) against the
reference's (``deequ_tpu.native``, built from the same source with the
same g++ line) and against the port's numpy versions (``native/plain.py``),
bit for bit, for every export; the feature functions that go through it
against their Python bodies; and a failed build raising.

Inputs are made with numpy from a seed: strings with nulls, empty strings
and multi-byte UTF-8, float64 with NaN, signed zeros and infinities,
integers above 2^53. ``u64_value_counts`` returns its keys in the kernel's
partition and probe order, which the numpy version reproduces.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest

import deequ_tpu.native.lib as R
import deequ_tpu.runners.features as JF
import deequ_tpu_torch.native as N
import deequ_tpu_torch.runners.features as TF
from deequ_tpu_torch.data import Column, ColumnKind
from deequ_tpu_torch.native import plain as P
from deequ_tpu_torch.native import build
from deequ_tpu_torch.ops.hashing import xxhash64_strings, xxhash64_strings_plain

REPO = Path(__file__).resolve().parent.parent


def _strings(n: int = 1500, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    values = []
    for i in range(n):
        kind = i % 10
        if kind == 0:
            values.append(None)
        elif kind == 1:
            values.append("")
        elif kind == 2:
            values.append(str(rng.integers(-10**9, 10**9)))
        elif kind == 3:
            values.append(f"{rng.normal():.6f}")
        elif kind == 4:
            values.append("true" if i % 4 == 0 else "false")
        elif kind == 5:
            values.append("héllo wörld ünïcode ✓ 数据 " * (i % 5 + 1))
        elif kind == 6:
            values.append("x" * (i % 100) + "-" + str(i))
        elif kind == 7:
            values.append("- 5" if i % 2 else "+ 3.14")
        elif kind == 8:
            values.append(f"user{i % 37}@example{i % 3}.com")
        else:
            values.append("٥" if i % 3 else "12\n")
    return np.array(values, dtype=object)


def _floats(n: int = 2003, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.normal(3.0, 50.0, n)
    v[rng.random(n) < 0.05] = np.nan
    v[rng.random(n) < 0.02] = np.inf
    v[rng.random(n) < 0.02] = -np.inf
    v[:6] = [0.0, -0.0, -0.0, 0.0, 1e308, -1e308]
    v[rng.random(n) < 0.05] = -0.0
    return v


def _finite(n: int = 2003, seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.normal(-7.0, 1e3, n)
    v[rng.random(n) < 0.05] = -0.0
    v[rng.random(n) < 0.05] = 0.0
    return v


def _big_ints(n: int = 2003, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.integers(-(2**62), 2**62, n)
    v[:4] = [2**53 + 1, 2**53 + 3, -(2**53) - 1, 2**63 - 1]
    return v


def _mask(n: int, seed: int = 4, p: float = 0.9) -> np.ndarray:
    return np.random.default_rng(seed).random(n) < p


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


S = _strings()
SM = _mask(len(S))
F = _floats()
FM = _mask(len(F))
KEYS = np.random.default_rng(5).integers(0, 2**64 - 1, 50_000, dtype=np.uint64) % np.uint64(9000)

#: every export, each on several inputs: (export, case) -> arguments
CASES = {
    ("native_xxhash64_strings", "strings"): (S, 42),
    ("native_xxhash64_strings", "arrow"): (pa.array(S.tolist()), 7),
    ("native_classify_types", "strings"): (S, SM),
    ("native_classify_types", "java regex"): (
        np.array(["5\n", "٥", "１２", "5", "1.5", " 5", "+ 5", "--5", ".", "true", "True", ""],
                 dtype=object), np.ones(12, dtype=bool)),
    ("native_string_lengths", "strings"): (S, SM),
    ("native_hll_pack_numeric", "float64"): (F, FM, 42),
    ("native_hll_pack_numeric", "int64 above 2^53"): (_big_ints(), None, 42),
    ("native_hll_pack_strings", "strings"): (S, SM, 42),
    ("native_block_stats", "float64"): (F, FM),
    ("native_block_stats", "float64 unmasked"): (_finite(), None),
    ("native_block_stats", "float32"): (_finite().astype(np.float32), FM),
    ("native_block_stats", "int64 above 2^53"): (_big_ints(), FM),
    ("native_block_stats", "int32"): (_big_ints().astype(np.int32), FM),
    ("native_block_stats", "all masked"): (F, np.zeros(len(F), dtype=bool)),
    ("native_block_stats", "all NaN"): (np.full(17, np.nan), None),
    ("native_block_comoments", "float64"): (F, np.roll(F, 5), FM),
    ("native_block_comoments", "finite"): (_finite(), _finite(seed=9), FM),
    ("native_block_hll", "float64"): (F, FM, 42),
    ("native_block_hll", "int64"): (_big_ints(), FM, 42),
    ("native_block_hll_strings", "strings"): (S, SM, 42),
    ("native_block_kll_sample", "k 64"): (F, FM, 64, 3),
    ("native_block_kll_sample", "k 2048"): (_finite(), None, 2048, 11),
    ("native_block_kll_sample", "dense k 8"): (_finite(), FM, 8, 2**32 + 5),
    ("native_block_kll_sample", "empty"): (F[:0], None, 16, 0),
    ("native_block_kll_pick", "float64"): (F, FM, 64, 5, int(np.count_nonzero(FM & ~np.isnan(F)))),
    ("native_block_kll_pick", "int64"): (_big_ints(), FM, 32, 6, int(np.count_nonzero(FM))),
    ("native_block_kll_pick", "unmasked"): (_finite(), None, 16, 7, len(_finite())),
    ("native_dict_masked_bincount", "codes"): (
        np.random.default_rng(6).integers(-2, 70, 4000).astype(np.int32), _mask(4000), 64),
    ("native_pattern_match", "email"): (S, SM, r"^[a-z0-9]+@[a-z0-9]+\.com$"),
    ("native_pattern_match", "unicode digits"): (S, SM, r"\d+"),
    ("native_pattern_match", "empty match"): (S, None, r"x*"),
    ("native_u64_value_counts", "counts"): (KEYS[:20_000], None),
    ("native_u64_value_counts", "partitioned"): (KEYS, None),
    ("native_u64_value_counts", "weights"): (
        KEYS[:40_000], np.random.default_rng(7).integers(1, 1000, 40_000)),
}


def test_every_export_has_cases():
    assert {name for name, _ in CASES} == set(N.EXPORTS)
    for name in N.EXPORTS:
        assert callable(getattr(N, name)) and callable(getattr(P, f"{name}_plain"))


@pytest.mark.parametrize("name,case", sorted(CASES))
def test_native_matches_reference_and_plain(name, case):
    args = CASES[(name, case)]
    got = getattr(N, name)(*args)
    assert _same(got, getattr(R, name)(*args)), "differs from the reference's library"
    assert _same(got, getattr(P, f"{name}_plain")(*args)), "differs from the numpy version"


def test_block_stats_of_integers_keep_their_dtype():
    """Integers above 2^53 read in their own dtype round once, to float64."""
    v = np.array([2**53 + 1, 2**53 + 3, 5], dtype=np.int64)
    stats = N.native_block_stats(v, None)
    assert stats[3] == float(2**53 + 4) and stats[2] == 5.0
    assert _same(stats, R.native_block_stats(v, None))


def test_fma_is_correctly_rounded():
    from fractions import Fraction

    rng = np.random.default_rng(8)
    a, b = rng.normal(size=4000), rng.normal(size=4000)
    c = -(a * b) * (1 + rng.integers(-3, 4, 4000) * 2.0 ** -52)
    got = P.fma(a, b, c)
    want = [float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)]
    assert got.tolist() == want


def test_pattern_match_routes():
    N.reset_pattern_routes()
    N.native_pattern_match(S, SM, r"v\d+")
    assert N.pattern_routes()["pcre2"] == 1
    # PCRE2 refuses \u escapes, which Python's re takes: every row by re
    pattern = r"w\u00f6rld"
    got = N.native_pattern_match(S, SM, pattern)
    assert N.pattern_routes() == {"pcre2": 1, "re": 1}
    assert R.native_pattern_match(S, SM, pattern) is None  # the reference falls back too
    assert _same(got, P.native_pattern_match_plain(S, SM, pattern)) and got.any()
    assert _same(got, JF.regex_matches(S, SM, pattern))


def test_pattern_match_rechecks_invalid_utf8_under_re():
    data = b"ab\xffcd" + b"abc"
    offsets = np.array([0, 5, 8], dtype=np.int64)
    arr = pa.LargeStringArray.from_buffers(2, pa.py_buffer(offsets.tobytes()), pa.py_buffer(data))
    got = N.native_pattern_match(arr, None, "b")
    assert got.tolist() == [True, True]


def test_u64_value_counts_agree_with_the_sorted_counts():
    keys, counts = N.native_u64_value_counts(KEYS, None)
    order = np.argsort(keys)
    from deequ_tpu_torch.analyzers.grouping import _u64_value_counts_plain

    want_k, want_c = _u64_value_counts_plain(KEYS, None)
    assert _same(keys[order], want_k) and _same(counts[order], want_c)


# ---------------------------------------------------------------------------
# the feature functions against their Python bodies and the reference's
# ---------------------------------------------------------------------------


def test_xxhash64_strings_matches_python():
    assert _same(xxhash64_strings(S), xxhash64_strings_plain(S))
    arr = pa.array(["a", None, "None", ""])
    got = xxhash64_strings(arr, 42)
    assert _same(got, xxhash64_strings_plain(arr, 42)) and got[1] == 42 and got[2] != 42


@pytest.mark.parametrize("fn", ["classify", "lengths", "regex"])
def test_feature_functions_match_python(fn):
    if fn == "classify":
        got = TF.classify_type_codes(S, SM, ColumnKind.STRING)
        want = TF.classify_type_codes_plain(S, SM, ColumnKind.STRING)
        ref = JF.classify_type_codes(S, SM, __import__("deequ_tpu.data").data.ColumnKind.STRING)
    elif fn == "lengths":
        got = TF.string_lengths(S, SM)
        want = TF.string_lengths_plain(S, SM)
        ref = JF.string_lengths(S, SM)
    else:
        got = TF.regex_matches(S, SM, r"[a-z]+\d")
        want = TF.regex_matches_plain(S, SM, r"[a-z]+\d")
        ref = JF.regex_matches(S, SM, r"[a-z]+\d")
    assert _same(got, want) and _same(got, ref)


@pytest.mark.parametrize("kind,values", [
    ("string", S),
    ("fractional", F),
    ("integral", _big_ints()),
    ("boolean", np.arange(300) % 3 == 0),
    ("int32", _big_ints().astype(np.int32)),
])
def test_hll_packed_matches_python(kind, values):
    col_kind = {"string": ColumnKind.STRING, "fractional": ColumnKind.FRACTIONAL,
                "boolean": ColumnKind.BOOLEAN}.get(kind, ColumnKind.INTEGRAL)
    mask = _mask(len(values), 12)
    if kind == "string":
        mask &= np.array([v is not None for v in values])  # a column masks its nulls
    if kind == "fractional":
        mask &= ~np.isnan(values)  # numpy hashes every NaN as the canonical one
    col = Column("c", col_kind, values, mask)
    assert _same(TF._hll_packed(col), TF._hll_packed_plain(col))


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def test_the_build_fails_loudly(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native build failed"):
        build.build(force=True)
    monkeypatch.setattr(build, "CXX", "g++")
    monkeypatch.setattr(build, "SOURCE", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        build.build(force=True)
    assert not list(tmp_path.glob("*.so*"))


def test_loading_with_a_broken_compiler_raises(tmp_path):
    code = (
        "import numpy as np\n"
        "from pathlib import Path\n"
        "import deequ_tpu_torch.native as n\n"
        "from deequ_tpu_torch.native import build\n"
        f"build.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "build.CXX = '/nonexistent/g++'\n"
        "n.native_block_stats(np.zeros(3), None)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "native build failed" in out.stderr


def test_the_source_is_the_reference_source():
    ours = (REPO / "deequ_tpu_torch/native/src/host_kernels.cpp").read_bytes()
    assert ours == (REPO / "deequ_tpu/native/src/host_kernels.cpp").read_bytes()
    assert build.CXX_FLAGS == ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
