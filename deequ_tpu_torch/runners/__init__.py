from .analysis_runner import AnalysisRunner
from .builder import Analysis, AnalysisRunBuilder
from .context import AnalyzerContext
from .engine import RunMonitor, ScanEngine

__all__ = [
    "Analysis",
    "AnalysisRunBuilder",
    "AnalysisRunner",
    "AnalyzerContext",
    "RunMonitor",
    "ScanEngine",
]
