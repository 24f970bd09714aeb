"""In-process columnar ingestion: any columnar payload becomes a
:class:`~deequ_tpu_torch.data.Dataset` WITHOUT a pandas hop.

The streaming service's documented input used to be a Dataset the caller
built themselves — and the path of least resistance was
``Dataset.from_pandas(df)``, which materializes every column through a
DataFrame even when the producer already holds numpy arrays or Arrow
record batches. This module is the single coercion point: dict-of-numpy
feeds go straight through ``pa.array`` (zero-copy for numeric dtypes),
Arrow tables/record batches wrap as-is (dictionary-encoded columns keep
their encoding, so string dict columns ride the cached distinct-value
hash path the engine already has), and only an actual DataFrame pays the
pandas conversion.
"""

from __future__ import annotations

import weakref
from typing import Any, Mapping

from ..data import Dataset

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover - pyarrow is in the base image
    pa = None

#: table -> Dataset identity cache (weak: an entry lives exactly as long
#: as the caller's table object). A fleet fan-out feeds the SAME payload
#: object to many sessions — 1000 sessions ingesting one broadcast slice
#: built 1000 Datasets, re-running dictionary probes and re-deriving
#: per-column caches per session (measured as a top fold cost in the
#: streaming-knee soak). Arrow tables are immutable, so one Dataset per
#: table object is always valid.
_DATASET_CACHE: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _cached_dataset(table: "pa.Table") -> Dataset:
    key = id(table)
    ds = _DATASET_CACHE.get(key)
    # the weak value keeps the mapping honest: a dead Dataset drops its
    # entry, and we pin the source table ON the Dataset (ds.arrow is the
    # probed/encoded table, not necessarily `table`) so a recycled id()
    # can never alias a different live table
    if ds is not None and getattr(ds, "_source_table", None) is table:
        return ds
    ds = Dataset(table)
    ds._source_table = table
    _DATASET_CACHE[key] = ds
    return ds


def as_dataset(data: Any) -> Dataset:
    """Coerce a columnar payload into a :class:`Dataset`.

    Accepted shapes, cheapest first:

    - ``Dataset`` — returned unchanged (no copy, derived caches kept);
    - ``pyarrow.Table`` / ``pyarrow.RecordBatch`` — wrapped directly
      (record batches become single-batch tables; zero-copy);
    - ``Mapping[str, numpy.ndarray | list]`` — each array passes through
      ``pa.array`` (zero-copy for numeric numpy dtypes), no pandas. Float
      columns follow the NUMPY missing-value convention: ``NaN`` marks a
      null (numpy has no validity mask), so a dict-fed session computes
      the same completeness/means a pandas- or Arrow-fed one does;
    - a pandas ``DataFrame`` — the legacy path, via ``Dataset.from_pandas``.
    """
    if isinstance(data, Dataset):
        return data
    if pa is not None:
        if isinstance(data, pa.Table):
            return _cached_dataset(data)
        if isinstance(data, pa.RecordBatch):
            return Dataset(pa.Table.from_batches([data]))
    if isinstance(data, Mapping):
        # from_pandas=True is pyarrow's "NaN means null" switch (it does
        # NOT involve pandas): without it a float NaN stays a VALUE and a
        # dict-fed session would silently disagree with every other feed
        # on completeness and every NaN-poisoned aggregate
        arrays = {
            name: pa.array(vals, from_pandas=True)
            for name, vals in data.items()
        }
        return Dataset(pa.table(arrays))
    # a DataFrame (or anything pandas-like exposing columns): the one
    # remaining path that pays object materialization
    if hasattr(data, "columns") and hasattr(data, "dtypes"):
        return Dataset.from_pandas(data)
    raise TypeError(
        "cannot ingest object of type "
        f"{type(data).__name__}: expected Dataset, pyarrow Table/"
        "RecordBatch, dict of arrays, or pandas DataFrame"
    )


def payload_bytes(data: Dataset) -> int:
    """Wire-equivalent size of a dataset's columnar buffers (what the
    ingest byte counters report for in-process feeds, so the export plane's
    MB/s means the same thing whether a batch arrived over HTTP or by
    reference). Memoized per Dataset: ``Table.nbytes`` on a sliced table
    walks every buffer (~0.4ms, measured as a per-fold cost on the
    streaming plane), and the table is immutable."""
    cached = getattr(data, "_payload_nbytes", None)
    if cached is not None:
        return cached
    try:
        n = int(data.arrow.nbytes)
    except Exception:  # noqa: BLE001 - accounting must never fail a fold
        n = 0
    data._payload_nbytes = n
    return n
