"""A run's outcome and the result line it prints.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its limit.
The same checks end standard error, one a line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Dict, List

from benchmark.harness import spec


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks_against(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """Every number of ``limits`` with its value; a number the run did not
    give reads as NaN and fails."""
    return [Check(name, float(values.get(name, math.nan)), float(limit))
            for name, limit in limits.items()]


@dataclasses.dataclass
class Outcome:
    """What a kind's run gives back.  ``e2e``: end-to-end metric values;
    ``data``: what the per-layer readers read (``spans`` in ms by name,
    ``counters``, ``trace``); ``checks``: the comparison."""

    e2e: Dict[str, float]
    data: dict
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    device: dict


def metrics(cell: spec.Cell, outcome: Outcome, trace: bool) -> Dict[str, dict]:
    """The cell's metrics: end to end (all required), or per layer (each
    reader's number, left out where it finds nothing to read)."""
    out = {}
    if not trace:
        for m in cell.end_to_end:
            out[m["name"]] = {"value": float(outcome.e2e[m["name"]]), "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        value = spec.load_reader(m["name"]).read(outcome.data)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def line(cell: spec.Cell, outcome: Outcome, trace: bool) -> dict:
    result = {
        "correct": bool(outcome.checks) and all(c.ok for c in outcome.checks),
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics(cell, outcome, trace),
        "device": dict(outcome.device, memory_peak_bytes=outcome.memory_peak_bytes),
    }
    tr = outcome.data.get("trace")
    if trace and tr is not None:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else None,
                                 "limit": c.limit} for c in outcome.checks}
    return result


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
