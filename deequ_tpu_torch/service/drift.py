"""Streaming schema-drift guard: the contract every micro-batch must honor
before it may fold into a session's persisted algebraic states.

A :class:`~deequ_tpu_torch.service.streaming.StreamingSession` folds arriving
deltas into long-lived semigroup states; the merge is only meaningful when
every batch speaks the SAME schema — folding a retyped column would
silently mix int and string hashes in one HLL, or splice a narrowed
column's overflow into a running sum, and no later batch can undo a
contaminated state. The reference sidesteps this because Spark DataFrames
carry one schema per job; a service ingesting millions of user-supplied
batches for weeks cannot assume it.

:class:`SchemaContract` is captured from the session's FIRST batch (column
names, value dtypes, dictionary-encoding) and every later batch validates
against it BEFORE the fold:

- **compatible widenings** — a batch column whose dtype is a same-family
  narrowing of the contract's (int32 arriving where int64 was promised,
  float32 where float64) — are coerced up to the contract dtype and
  counted. Values are exactly representable, states stay uniform.
- **incompatible drift** — column added, dropped, retyped across families,
  or a dictionary-encoding flip — is handled per the session's
  ``drift_policy``:

  ========= ==============================================================
  policy    behavior
  ========= ==============================================================
  reject    (default) raise typed :class:`SchemaDriftError` before the
            fold; persisted states untouched
  coerce    best-effort repair: retyped columns cast back to the contract
            dtype (safe casts only — a failed cast rejects), added columns
            dropped, encoding flips re-encoded; a DROPPED column cannot be
            conjured and always rejects
  degrade   drop the drifted columns from the batch and fold the rest;
            analyzers over the dropped columns emit typed ``Failure``
            metrics for this batch (the PR-2 isolation stance: partial
            results beat no results), persisted states of unaffected
            analyzers keep advancing
  ========= ==============================================================

Column ORDER is not part of the contract: batches materialize columns by
name, so reordering is cosmetic. Dictionary VALUES are not either —
growing a category set batch-over-batch is the normal streaming case.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

from ..exceptions import SchemaDriftError

DRIFT_POLICIES = ("reject", "coerce", "degrade")

#: same-family widening chains: a batch dtype may be coerced UP to any
#: dtype later in its chain (exact value preservation); anything else is a
#: retype. int->float is deliberately NOT a widening: it flips the
#: column's Integral/Fractional kind, which changes analyzer routing and
#: DataType profiles.
_WIDENING_CHAINS = (
    ["int8", "int16", "int32", "int64"],
    ["uint8", "uint16", "uint32", "uint64"],
    ["halffloat", "float", "double"],  # arrow names for f16/f32/f64
)


def _widens_to(batch_dtype: str, contract_dtype: str) -> bool:
    """True when ``batch_dtype`` may be losslessly coerced up to
    ``contract_dtype`` (same family, narrower or equal)."""
    if batch_dtype == contract_dtype:
        return True
    for chain in _WIDENING_CHAINS:
        if batch_dtype in chain and contract_dtype in chain:
            return chain.index(batch_dtype) < chain.index(contract_dtype)
    return False


@dataclass(frozen=True)
class ColumnContract:
    """One column's promise: its name, its VALUE dtype (dictionary
    indices are an encoding detail; the value type is the identity), and
    whether it arrives dictionary-encoded (the engine routes
    dictionary-encoded grouping/histogram columns through the device
    frequency scan, so the flag changes battery composition)."""

    name: str
    dtype: str
    dictionary: bool


@dataclass
class DriftReport:
    """What validation decided for one batch: the (possibly repaired)
    table to fold, the widening coercions applied, the columns degraded,
    and the HARD drifts the ``coerce`` policy repaired (added columns
    dropped, retypes cast back) — reported separately because a repaired
    producer-side schema change still needs operator visibility."""

    table: Any
    coercions: List[str]
    degraded: List[str]
    repaired: List[str] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.repaired is None:
            self.repaired = []


class SchemaContract:
    """The per-session schema promise; see the module docstring."""

    def __init__(self, columns: Tuple[ColumnContract, ...]):
        self.columns = tuple(columns)
        self._by_name: Dict[str, ColumnContract] = {
            c.name: c for c in self.columns
        }

    @staticmethod
    def capture(data) -> "SchemaContract":
        """Capture the contract from a Dataset's arrow schema."""
        import pyarrow as pa

        cols = []
        for field in data.arrow.schema:
            t = field.type
            if pa.types.is_dictionary(t):
                cols.append(ColumnContract(field.name, str(t.value_type), True))
            else:
                cols.append(ColumnContract(field.name, str(t), False))
        return SchemaContract(tuple(cols))

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{c.name}:{c.dtype}{'[dict]' if c.dictionary else ''}"
            for c in self.columns
        )
        return f"SchemaContract({inner})"

    # -- validation ----------------------------------------------------------

    def validate(
        self, data, *, policy: str = "reject", session: str = "<session>"
    ) -> DriftReport:
        """Check one micro-batch against the contract.

        Returns a :class:`DriftReport` whose ``table`` is safe to fold
        (``None`` when the batch needed no repair — fold the original), or
        raises :class:`SchemaDriftError` per ``policy``. Widenings never
        raise; they are coerced and recorded under ``coercions``."""
        import pyarrow as pa
        import pyarrow.compute as pc

        if policy not in DRIFT_POLICIES:
            raise ValueError(
                f"drift_policy must be one of {DRIFT_POLICIES}, got {policy!r}"
            )
        table = data.arrow
        batch: Dict[str, Any] = {}
        for field in table.schema:
            t = field.type
            if pa.types.is_dictionary(t):
                batch[field.name] = (str(t.value_type), True)
            else:
                batch[field.name] = (str(t), False)

        coercions: List[str] = []    # widenings: always repaired
        hard: List[str] = []         # incompatible drift descriptions
        repair: Dict[str, ColumnContract] = {}  # column -> conform target
        drop: List[str] = []         # columns degrade removes

        for c in self.columns:
            got = batch.get(c.name)
            if got is None:
                hard.append(f"column {c.name!r} dropped")
                continue
            got_dtype, got_dict = got
            widened = got_dtype != c.dtype and _widens_to(got_dtype, c.dtype)
            retyped = got_dtype != c.dtype and not widened
            flipped = got_dict != c.dictionary
            if retyped:
                hard.append(
                    f"column {c.name!r} retyped {c.dtype} -> {got_dtype}"
                )
                drop.append(c.name)
                if policy == "coerce":
                    repair[c.name] = c
                continue
            if flipped:
                hard.append(
                    f"column {c.name!r} "
                    + (
                        "lost its dictionary encoding"
                        if c.dictionary
                        else "became dictionary-encoded"
                    )
                )
                drop.append(c.name)
                if policy == "coerce":
                    repair[c.name] = c
                continue
            if widened:
                coercions.append(f"{c.name}: {got_dtype} -> {c.dtype}")
                repair[c.name] = c
        added = [name for name in batch if name not in self._by_name]
        for name in added:
            hard.append(f"column {name!r} added")

        if hard and policy == "reject":
            raise SchemaDriftError(session, hard)
        degraded: List[str] = []
        repaired: List[str] = []
        if hard and policy == "coerce":
            missing = [
                c.name for c in self.columns if c.name not in batch
            ]
            if missing:
                # nothing to cast a missing column FROM
                raise SchemaDriftError(
                    session,
                    [f"column {name!r} dropped" for name in missing],
                )
            # added columns are simply not folded; retypes/encodings
            # conform below — a cast that cannot represent the values
            # rejects instead of silently mangling. Either way the HARD
            # drift is reported as repaired, never consumed invisibly
            repaired = list(hard)
        if hard and policy == "degrade":
            missing = [c.name for c in self.columns if c.name not in batch]
            # ADDED columns join the degraded list too: they carry no
            # analyzers to fail, but dropping them must still surface on
            # the drift counters/warnings — an invisible schema change is
            # the exact thing this guard exists to report
            degraded = missing + drop + added
            repair = {k: v for k, v in repair.items() if k not in drop}

        if not hard and not repair:
            return DriftReport(None, coercions, [])

        def conform(col, c: ColumnContract):
            """Make one column match its contract: decode a stray
            dictionary, cast to the contract dtype (safe cast — overflow
            raises), re-encode if the contract promises a dictionary."""
            target = _arrow_type(c.dtype)
            if target is None:
                raise SchemaDriftError(
                    session,
                    [f"column {c.name!r} cannot be coerced to {c.dtype}"],
                )
            col = col.combine_chunks()
            try:
                if pa.types.is_dictionary(col.type):
                    col = col.cast(col.type.value_type)
                col = pc.cast(col, target)
            except (pa.ArrowInvalid, pa.ArrowNotImplementedError) as exc:
                raise SchemaDriftError(
                    session,
                    [f"column {c.name!r} cannot be coerced: {exc}"],
                ) from exc
            if c.dictionary:
                col = pc.dictionary_encode(col)
            return col

        # rebuild the batch table: contract columns only, conformed
        out_cols: Dict[str, Any] = {}
        for c in self.columns:
            if c.name not in batch or c.name in degraded:
                continue
            col = table[c.name]
            if c.name in repair:
                col = conform(col, repair[c.name])
            out_cols[c.name] = col
        return DriftReport(pa.table(out_cols), coercions, degraded, repaired)


def _arrow_type(name: str):
    """Arrow DataType from its str() name (only the types a contract can
    record: the primitive numerics/strings str() round-trips through
    `pyarrow.type_for_alias`; anything exotic compares by string only and
    never needs materializing because equal strings skip the cast)."""
    import pyarrow as pa

    try:
        return pa.type_for_alias(name)
    except ValueError:
        # timestamp[...]/decimal(...) etc: dtype strings still COMPARE
        # correctly, and unequal ones of these are never widenable, so a
        # cast target is only requested for alias-able primitives
        return None
