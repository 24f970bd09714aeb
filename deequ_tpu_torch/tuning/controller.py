"""The online tuning controller: shadow-route experiments with
bench_diff-style promotion bands and a never-below-static floor (the
reference's ``deequ_tpu/tuning/controller.py``, ported; its decisions
equal the reference's for the same inputs).

A substrate profile seeds the knobs; this controller refines them under
live traffic. Every change runs as an :class:`Experiment` first:

- **shadow mode** (per-fold knobs: ``fast_path_max_rows``): a
  deterministic fraction of the folds (``DEEQU_TPU_TUNING_SHADOW_FRACTION``)
  is routed under the CANDIDATE setting while the incumbent keeps the
  rest; both arms keep measured rows/s EWMAs from the coalescer's timing
  sites (the host fast path's partials, a coalesced launch's share);
- **trial mode** (global knobs whose effect spans folds:
  ``coalesce_max_width``, ``prefetch_depth``, ...): the candidate is
  installed tentatively and compared with the fold-rate EWMA before it,
  and rolled back when it does not win.

A candidate **promotes** only when its measured rate beats the incumbent
by more than the band (``DEEQU_TPU_TUNING_BAND``) after both arms hold
enough samples (``DEEQU_TPU_TUNING_MIN_SAMPLES``); anything less rejects.
A standing **floor guardrail** remembers the rate measured while every
knob sat at static and demotes every tuned knob whose live rate falls
below it, so neither a mis-tuned promotion nor a poisoned profile can
hold the service below its static configuration. Every decision appends
to a bounded history, emits a trace event and bumps a
``deequ_service_tuning_*`` series.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import knobs as _knobs

logger = logging.getLogger(__name__)

#: EWMA smoothing for arm rates — matches the CrossoverRouter's alpha so
#: both learners forget at the same horizon
_ALPHA = 0.2

#: decision-history ring size (/statusz serves it; bounded so a
#: week-long soak cannot grow it without limit)
_MAX_DECISIONS = 256

#: give up on an experiment whose arms never both fill (e.g. traffic
#: stopped) after this many total recorded folds
_MAX_SAMPLES_FACTOR = 20


@dataclass
class ArmStats:
    """Measured rows/s EWMA of one experiment arm."""

    samples: int = 0
    rate_ewma: float = 0.0

    def record(self, rows: int, seconds: float) -> None:
        rate = rows / max(seconds, 1e-9)
        if self.samples == 0:
            self.rate_ewma = rate
        else:
            self.rate_ewma += _ALPHA * (rate - self.rate_ewma)
        self.samples += 1


@dataclass
class Experiment:
    """One candidate setting under evaluation for one knob."""

    knob: str
    candidate: Any
    mode: str                       #: "shadow" | "trial"
    incumbent_value: Any
    source: str = "controller"
    started_at: float = field(default_factory=time.time)
    incumbent: ArmStats = field(default_factory=ArmStats)
    shadow: ArmStats = field(default_factory=ArmStats)
    #: trial mode only: the rate EWMA captured before the tentative flip
    baseline_rate: float = 0.0


class TuningController:
    """Owns experiments, the decision history, and the static floor."""

    def __init__(self, metrics=None, router=None,
                 profile=None) -> None:
        self.metrics = metrics
        self.router = router
        self.profile = profile
        self._lock = threading.Lock()
        self._experiments: Dict[str, Experiment] = {}
        self.decisions: List[Dict[str, Any]] = []
        self._fold_seq = 0
        #: rows/s EWMA of ALL folds under the CURRENT settings
        self._live = ArmStats()
        #: rows/s EWMA last measured while every knob sat at static —
        #: the floor no tuned configuration may drop below
        self._static_rate = 0.0
        self._static_samples = 0
        #: harvest-listener debounce
        self._last_refit = 0.0
        self._refit_interval_s = 5.0
        if metrics is not None:
            self._describe_series(metrics)

    # -- export plane -------------------------------------------------------

    @staticmethod
    def _describe_series(metrics) -> None:
        metrics.describe(
            "deequ_service_tuning_proposals_total",
            "Tuning experiments started (knob candidates proposed by the "
            "profile, the re-fitter, or an operator drill).",
        )
        metrics.describe(
            "deequ_service_tuning_promotions_total",
            "Candidate knob settings promoted after beating the incumbent "
            "beyond the tolerance band on measured shadow/trial traffic.",
        )
        metrics.describe(
            "deequ_service_tuning_demotions_total",
            "Tuned knob settings demoted back toward static defaults — "
            "candidate lost its experiment, or the never-below-static "
            "floor guardrail fired.",
        )
        metrics.describe(
            "deequ_service_tuning_shadow_folds_total",
            "Folds routed under a candidate setting by the shadow-route "
            "experiment arm.",
        )

    def _bump(self, name: str, knob: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, 1.0, knob=knob)

    def register_gauges(self, metrics) -> None:
        metrics.set_gauge_fn(
            "deequ_service_tuning_active_experiments",
            lambda: float(len(self._experiments)),
            "Knob experiments currently gathering shadow/trial evidence.",
        )
        metrics.set_gauge_fn(
            "deequ_service_tuning_tuned_knobs",
            lambda: float(len(_knobs.tuned_snapshot())),
            "Knobs currently holding a tuned (non-static) value.",
        )

    # -- experiment lifecycle ----------------------------------------------

    def propose(self, knob: str, candidate: Any, mode: str = "shadow",
                source: str = "controller") -> bool:
        """Start an experiment for ``knob`` -> ``candidate``. One live
        experiment per knob; a no-op candidate (== current value) or an
        out-of-registry knob is refused. Returns True when started."""
        if knob not in _knobs.REGISTRY:
            return False
        current = _knobs.value(knob)
        k = _knobs.REGISTRY[knob]
        candidate = min(max(k.cast(candidate), k.lo), k.hi)
        if candidate == current:
            return False
        with self._lock:
            if knob in self._experiments:
                return False
            exp = Experiment(knob=knob, candidate=candidate, mode=mode,
                             incumbent_value=current, source=source)
            if mode == "trial":
                exp.baseline_rate = self._live.rate_ewma
                _knobs.set_tuned(knob, candidate, source="trial")
            self._experiments[knob] = exp
        self._bump("deequ_service_tuning_proposals_total", knob)
        self._trace("tuning_proposal", knob=knob, candidate=candidate,
                    incumbent=current, mode=mode, source=source)
        return True

    def choose(self, rows: int) -> Optional[str]:
        """Per-fold arm assignment for a live SHADOW experiment on
        ``fast_path_max_rows``: returns the candidate-routed decision
        ("host"/"device") for shadow folds, None for incumbent folds (the
        caller keeps its own routing). Deterministic fraction — fold
        sequence modulo the shadow period — so replays are replays."""
        with self._lock:
            exp = self._experiments.get("fast_path_max_rows")
            if exp is None or exp.mode != "shadow":
                return None
            self._fold_seq += 1
            fraction = _knobs.shadow_fraction()
            if fraction <= 0.0:
                return None
            period = max(int(round(1.0 / fraction)), 2)
            if self._fold_seq % period:
                return None
        self._bump("deequ_service_tuning_shadow_folds_total",
                   "fast_path_max_rows")
        ceiling = exp.candidate
        if ceiling < 0:
            return None  # candidate says "router decides": not a forced arm
        return "host" if 0 < rows <= ceiling else "device"

    def record(self, rows: int, seconds: float,
               arm: Optional[str] = None) -> None:
        """Feed one measured fold. ``arm`` is the knob name of the shadow
        experiment that forced this fold's route (None = normal fold)."""
        decisions = []
        with self._lock:
            self._live.record(rows, seconds)
            if not _knobs.any_tuned():
                # every knob at static: this IS the floor measurement
                self._static_rate = self._live.rate_ewma
                self._static_samples = self._live.samples
            for name, exp in list(self._experiments.items()):
                if exp.mode == "shadow":
                    (exp.shadow if arm == name else exp.incumbent).record(
                        rows, seconds)
                else:
                    exp.shadow.record(rows, seconds)
                verdict = self._evaluate_locked(exp)
                if verdict is not None:
                    decisions.append(self._conclude_locked(exp, verdict))
        for decision in decisions:
            self._publish(decision)
        self._check_floor()

    def _evaluate_locked(self, exp: Experiment) -> Optional[str]:
        """"promote" / "reject" / None (keep gathering)."""
        need = _knobs.tuning_min_samples()
        band = _knobs.tuning_band()
        if exp.mode == "shadow":
            if exp.shadow.samples >= need and exp.incumbent.samples >= need:
                wins = exp.shadow.rate_ewma > (
                    exp.incumbent.rate_ewma * (1.0 + band))
                return "promote" if wins else "reject"
            total = exp.shadow.samples + exp.incumbent.samples
            if total >= need * _MAX_SAMPLES_FACTOR:
                return "reject"  # starved arm: inconclusive forever
            return None
        # trial mode: candidate already live; compare the global rate
        # against the pre-flip baseline (no baseline -> need a floor
        # measurement first, judged against the static floor)
        if exp.shadow.samples < need:
            return None
        reference = exp.baseline_rate or self._static_rate
        if reference <= 0.0:
            return "reject"  # nothing to beat: refuse to fly blind
        return ("promote" if exp.shadow.rate_ewma
                > reference * (1.0 + band) else "reject")

    def _conclude_locked(self, exp: Experiment, verdict: str
                         ) -> Dict[str, Any]:
        del self._experiments[exp.knob]
        if verdict == "promote":
            installed = _knobs.set_tuned(exp.knob, exp.candidate,
                                         source=exp.source)
        else:
            # shadow candidates never touched the knob; trial candidates
            # are live and must roll back to the incumbent value
            if exp.mode == "trial":
                if exp.incumbent_value == _knobs.static_value(exp.knob):
                    _knobs.clear_tuned(exp.knob)
                else:
                    _knobs.set_tuned(exp.knob, exp.incumbent_value,
                                     source="rollback")
            installed = exp.incumbent_value
        decision = {
            "at": time.time(),
            "knob": exp.knob,
            "verdict": verdict,
            "mode": exp.mode,
            "candidate": exp.candidate,
            "incumbent": exp.incumbent_value,
            "installed": installed,
            "candidate_rate": (exp.shadow.rate_ewma),
            "incumbent_rate": (exp.incumbent.rate_ewma
                               if exp.mode == "shadow"
                               else (exp.baseline_rate or self._static_rate)),
            "source": exp.source,
        }
        self.decisions.append(decision)
        del self.decisions[:-_MAX_DECISIONS]
        return decision

    def _publish(self, decision: Dict[str, Any]) -> None:
        series = ("deequ_service_tuning_promotions_total"
                  if decision["verdict"] == "promote"
                  else "deequ_service_tuning_demotions_total")
        self._bump(series, decision["knob"])
        self._trace("tuning_decision", **{
            k: decision[k] for k in
            ("knob", "verdict", "mode", "candidate", "incumbent",
             "candidate_rate", "incumbent_rate")
        })
        logger.info(
            "tuning %s: %s %s -> %s (candidate %.3g rows/s vs incumbent "
            "%.3g rows/s)", decision["verdict"], decision["knob"],
            decision["incumbent"], decision["installed"],
            decision["candidate_rate"], decision["incumbent_rate"],
        )

    def _check_floor(self) -> None:
        """The never-below-static guardrail: demote every tuned knob when
        the live rate falls below the measured static floor by more than
        the band."""
        if not _knobs.any_tuned():
            return
        band = _knobs.tuning_band()
        need = _knobs.tuning_min_samples()
        with self._lock:
            tuned = _knobs.tuned_snapshot()
            if (not tuned or self._static_samples < need
                    or self._live.samples < self._static_samples + need):
                return
            if self._live.rate_ewma >= self._static_rate * (1.0 - band):
                return
            demoted = sorted(tuned)
            for name in demoted:
                _knobs.clear_tuned(name)
            self._experiments.clear()
            live_rate = self._live.rate_ewma
            floor = self._static_rate
            # the demotion resets the live EWMA's meaning; restart it so
            # the floor can re-arm from fresh static measurements
            self._live = ArmStats()
            decision = {
                "at": time.time(), "knob": ",".join(demoted),
                "verdict": "floor_demotion", "mode": "floor",
                "candidate": None, "incumbent": None, "installed": "static",
                "candidate_rate": live_rate, "incumbent_rate": floor,
                "source": "floor_guardrail",
            }
            self.decisions.append(decision)
            del self.decisions[:-_MAX_DECISIONS]
        for name in demoted:
            self._bump("deequ_service_tuning_demotions_total", name)
        self._trace("tuning_floor_demotion", knobs=",".join(demoted),
                    live_rate=live_rate, static_rate=floor)
        logger.warning(
            "tuning floor guardrail: live rate %.3g rows/s fell below the "
            "static reference %.3g rows/s; demoted %s to static defaults",
            live_rate, floor, ", ".join(demoted),
        )

    # -- scheduler hook -----------------------------------------------------

    def on_harvest(self, *_args, **_kwargs) -> None:
        """Harvest listener: debounced re-fit pass. Auto-proposals are
        gated on having a calibration profile — a profile-less default
        boot stays byte-identical to the static configuration."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_refit < self._refit_interval_s:
                return
            self._last_refit = now
        if self.profile is not None:
            self.refit()

    def refit(self) -> int:
        """Propose experiments for profile knobs the live registry does
        not hold yet (e.g. after a floor demotion cleared them, or a knob
        was never applied). Returns experiments started."""
        if self.profile is None:
            return 0
        started = 0
        tuned = _knobs.tuned_snapshot()
        for name, value in sorted(self.profile.knob_values.items()):
            if name not in _knobs.REGISTRY or name in tuned:
                continue
            if name.startswith("router_"):
                continue  # router seeds re-apply through reseed, not trials
            mode = "shadow" if name == "fast_path_max_rows" else "trial"
            if self.propose(name, value, mode=mode, source="refit"):
                started += 1
        return started

    # -- misc ---------------------------------------------------------------

    def _trace(self, event: str, **attrs: Any) -> None:
        try:
            from ..observability import trace

            trace.add_event(event, **attrs)
        except Exception:  # tracing must never take down the data path
            logger.debug("tuning trace emit failed", exc_info=True)

    def snapshot(self) -> Dict[str, Any]:
        """Controller state for the tuning report / chaos summary."""
        with self._lock:
            return {
                "live_rate_ewma": self._live.rate_ewma,
                "live_samples": self._live.samples,
                "static_rate_ewma": self._static_rate,
                "static_samples": self._static_samples,
                "experiments": {
                    name: {
                        "candidate": exp.candidate,
                        "mode": exp.mode,
                        "incumbent": exp.incumbent_value,
                        "incumbent_rate": exp.incumbent.rate_ewma,
                        "candidate_rate": exp.shadow.rate_ewma,
                        "incumbent_samples": exp.incumbent.samples,
                        "candidate_samples": exp.shadow.samples,
                    }
                    for name, exp in self._experiments.items()
                },
                "decisions": list(self.decisions),
                "tuned": _knobs.tuned_snapshot(),
            }
