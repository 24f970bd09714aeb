"""Fluent run configuration (reference `analyzers/runners/AnalysisRunBuilder.scala:25-186`)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from ..analyzers.base import Analyzer
from ..config import DeviceLike, resolve_device
from ..data import Dataset
from .context import AnalyzerContext
from .engine import RunMonitor


class AnalysisRunBuilder:
    def __init__(self, data: Dataset, device: DeviceLike = None):
        self._data = data
        self._device = resolve_device(device)
        self._analyzers: List[Analyzer] = []
        self._batch_size: Optional[int] = None
        self._monitor: Optional[RunMonitor] = None
        self._freq_options: Dict[str, Any] = {}
        self._state_options: Dict[str, Any] = {}
        self._placement: Optional[str] = None
        self._sharding: Optional[Any] = None
        self._json_path: Optional[str] = None
        self._overwrite = False

    def add_analyzer(self, analyzer: Analyzer) -> "AnalysisRunBuilder":
        self._analyzers.append(analyzer)
        return self

    def add_analyzers(self, analyzers: Sequence[Analyzer]) -> "AnalysisRunBuilder":
        self._analyzers.extend(analyzers)
        return self

    def aggregate_with(self, state_loader) -> "AnalysisRunBuilder":
        self._state_options["aggregate_with"] = state_loader
        return self

    def save_states_with(self, state_persister) -> "AnalysisRunBuilder":
        self._state_options["save_states_with"] = state_persister
        return self

    def use_repository(self, repository) -> "AnalysisRunBuilder":
        self._state_options["metrics_repository"] = repository
        return self

    def reuse_existing_results_for_key(
        self, key, fail_if_results_missing: bool = False
    ) -> "AnalysisRunBuilder":
        self._state_options["reuse_existing_results_for_key"] = key
        self._state_options["fail_if_results_missing"] = fail_if_results_missing
        return self

    def save_or_append_result(self, key) -> "AnalysisRunBuilder":
        self._state_options["save_or_append_results_with_key"] = key
        return self

    def with_batch_size(self, batch_size: int) -> "AnalysisRunBuilder":
        self._batch_size = batch_size
        return self

    def with_monitor(self, monitor: RunMonitor) -> "AnalysisRunBuilder":
        self._monitor = monitor
        return self

    def with_placement(self, placement: str) -> "AnalysisRunBuilder":
        """The pass's ingest tier: ``"device"``, ``"host"`` or ``"auto"``
        (:meth:`AnalysisRunner.do_analysis_run`)."""
        self._placement = placement
        return self

    def with_sharding(self, sharding) -> "AnalysisRunBuilder":
        """Shard the pass's rows over a mesh
        (:meth:`AnalysisRunner.do_analysis_run`'s ``sharding``)."""
        self._sharding = sharding
        return self

    def checkpoint_with(self, checkpointer) -> "AnalysisRunBuilder":
        """Make the pass resumable through an
        :class:`~deequ_tpu_torch.reliability.IngestCheckpointer`
        (:meth:`AnalysisRunner.do_analysis_run`'s ``checkpointer``)."""
        self._state_options["checkpointer"] = checkpointer
        return self

    def with_frequency_options(self, **options) -> "AnalysisRunBuilder":
        """``freq_table_slots``, ``freq_buffer_entries`` and ``device_freq``
        of :meth:`AnalysisRunner.do_analysis_run`."""
        self._freq_options.update(frequency_options(**options))
        return self

    def save_success_metrics_json_to_path(
        self, path: str, overwrite: bool = False
    ) -> "AnalysisRunBuilder":
        """Write ``success_metrics_as_json()`` to ``path`` after the run,
        unless the file exists and ``overwrite`` is False."""
        self._json_path = path
        self._overwrite = overwrite
        return self

    def run(self) -> AnalyzerContext:
        import os

        from .analysis_runner import AnalysisRunner

        context = AnalysisRunner.do_analysis_run(
            self._data,
            self._analyzers,
            batch_size=self._batch_size,
            monitor=self._monitor,
            device=self._device,
            placement=self._placement,
            sharding=self._sharding,
            **self._freq_options,
            **self._state_options,
        )
        if self._json_path and (self._overwrite or not os.path.exists(self._json_path)):
            with open(self._json_path, "w", encoding="utf-8") as fh:
                fh.write(context.success_metrics_as_json())
        return context


def frequency_options(freq_table_slots: Optional[int] = None,
                      freq_buffer_entries: Optional[int] = None,
                      device_freq: Optional[bool] = None) -> Dict[str, Any]:
    """The frequency-table keywords a builder passes on (those not None)."""
    options = {"freq_table_slots": freq_table_slots,
               "freq_buffer_entries": freq_buffer_entries, "device_freq": device_freq}
    return {k: v for k, v in options.items() if v is not None}


class Analysis:
    """Immutable list of analyzers + run convenience
    (reference `analyzers/Analysis.scala:29-63`)."""

    def __init__(self, analyzers: Optional[Sequence[Analyzer]] = None):
        self.analyzers: List[Analyzer] = list(analyzers or [])

    def add_analyzer(self, analyzer: Analyzer) -> "Analysis":
        return Analysis(self.analyzers + [analyzer])

    def add_analyzers(self, analyzers: Sequence[Analyzer]) -> "Analysis":
        return Analysis(self.analyzers + list(analyzers))

    def run(self, data: Dataset, **kwargs) -> AnalyzerContext:
        from .analysis_runner import AnalysisRunner

        return AnalysisRunner.do_analysis_run(data, self.analyzers, **kwargs)
