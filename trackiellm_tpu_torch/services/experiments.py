"""Experiments: per-model metrics analysis + A/B comparison/regression
detection.

Parity target: the Rust ``experiments`` crate — ExperimentService with
model_analysis (per-model metrics) and metrics_comparator (A/B compare,
regression detection) (reference: src/experiments/src/lib.rs:7-20; the C
benchmark_runner/model_tester are 0-byte stubs there — these are real
here).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class RunRecord:
    metric: str
    value: float
    timestamp: float


class ModelAnalysis:
    """Accumulates per-model metric runs and summarizes them."""

    def __init__(self):
        self._runs: Dict[str, List[RunRecord]] = {}

    def record(self, model: str, metric: str, value: float) -> None:
        self._runs.setdefault(model, []).append(
            RunRecord(metric, value, time.time()))

    def summary(self, model: str, metric: str) -> Optional[Dict[str, float]]:
        vals = [r.value for r in self._runs.get(model, ())
                if r.metric == metric]
        if not vals:
            return None
        return {
            "count": len(vals),
            "mean": statistics.fmean(vals),
            "min": min(vals),
            "max": max(vals),
            "p50": statistics.median(vals),
            "stdev": statistics.stdev(vals) if len(vals) > 1 else 0.0,
        }

    def models(self) -> List[str]:
        return list(self._runs)


@dataclasses.dataclass
class Comparison:
    metric: str
    baseline_mean: float
    candidate_mean: float
    delta_pct: float
    is_regression: bool
    is_improvement: bool


class MetricsComparator:
    """A/B comparison with a regression threshold. ``higher_is_better``
    controls direction (tok/s vs latency)."""

    def __init__(self, regression_threshold_pct: float = 5.0):
        self.threshold = regression_threshold_pct

    def compare(self, metric: str, baseline: List[float],
                candidate: List[float],
                higher_is_better: bool = True) -> Comparison:
        b = statistics.fmean(baseline)
        c = statistics.fmean(candidate)
        delta = (c - b) / abs(b) * 100.0 if b else 0.0
        gain = delta if higher_is_better else -delta
        return Comparison(
            metric=metric, baseline_mean=b, candidate_mean=c,
            delta_pct=round(delta, 3),
            is_regression=gain < -self.threshold,
            is_improvement=gain > self.threshold,
        )


class ExperimentService:
    def __init__(self, regression_threshold_pct: float = 5.0):
        self.analysis = ModelAnalysis()
        self.comparator = MetricsComparator(regression_threshold_pct)

    def benchmark(self, model: str, metric: str,
                  fn: Callable[[], float], repeats: int = 3) -> Dict:
        """Run fn() repeats times, recording its returned value."""
        for _ in range(repeats):
            self.analysis.record(model, metric, float(fn()))
        return self.analysis.summary(model, metric)

    def ab_test(self, metric: str, baseline_model: str,
                candidate_model: str,
                higher_is_better: bool = True) -> Comparison:
        b = [r.value for r in self.analysis._runs.get(baseline_model, ())
             if r.metric == metric]
        c = [r.value for r in self.analysis._runs.get(candidate_model, ())
             if r.metric == metric]
        return self.comparator.compare(metric, b, c, higher_is_better)
