"""Columnar ingestion: any columnar payload as a :class:`Dataset`
(:mod:`.columnar`). The reference's wire plane (Arrow IPC endpoint,
prefetch, row gate) is not ported (ROADMAP A6)."""

from .columnar import as_dataset, payload_bytes

__all__ = ["as_dataset", "payload_bytes"]
