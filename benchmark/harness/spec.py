"""The benchmark's data: ``BENCHMARK.json`` at the root of the checkout,
and under ``benchmark/`` one file for each configuration, traffic mix, cell
and per-layer metric, found by the names ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the model's sizes and the paths it runs;
- ``traffic/<traffic>.json``: a traffic mix, its ``kind`` naming the
  generator (``kinds/<kind>.py``) that reads the rest;
- ``workloads/<cell>.json``: the cell's configuration, traffic and chips
  (as ``BENCHMARK.json`` has them) and the limits of its comparison;
- ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(data)`` that returns a number or None.

``validate`` checks all of it, with the contract's rules on names, units
and keys, before a run starts.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


class SpecError(ValueError):
    pass


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _line(text, what: str) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
        raise SpecError(f"{what}: 1 to 200 characters on one line, no tab")


def _name(name, what: str) -> None:
    if not isinstance(name, str) or not NAME.match(name):
        raise SpecError(f"{what} {name!r}: a letter, digit or _ first, then at most 63 "
                        "letters, digits, _, . and -")


def _keys(entry: dict, allowed: set, what: str, optional: set = frozenset()) -> None:
    keys = set(entry)
    if not allowed <= keys or not keys <= allowed | optional:
        raise SpecError(f"{what}: keys {sorted(keys)}, expected {sorted(allowed)}"
                        + (f" and optionally {sorted(optional)}" if optional else ""))


def load_benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def reader_path(metric: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "metrics", f"{metric}.py")


def load_reader(metric: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """The module of ``metrics/<metric>.py`` (its name may hold dots)."""
    path = reader_path(metric, bench_dir)
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, "read", None)):
        raise SpecError(f"{path}: no read(data)")
    return module


def validate(bench: dict, bench_dir: str = BENCH_DIR) -> None:
    """Raise ``SpecError`` where ``bench`` or a file it names breaks a rule."""
    _keys(bench, TOP_KEYS, "BENCHMARK.json")
    cmd = bench["command"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        raise SpecError("command: a list of 1 to 32 strings")
    for word in cmd:
        _line(word, "a word of command")
        if word.startswith("/") or ".." in word.split("/"):
            raise SpecError(f"command word {word!r} leads out of the checkout")
    paths = bench["paths"]
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        raise SpecError("paths: 1 to 16 directories")
    for p in paths:
        if not re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) or p.startswith("/") or ".." in p.split("/"):
            raise SpecError(f"path {p!r}")
    rs = bench["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        raise SpecError("run_seconds: a whole number from 1 to 51")

    configs = {}
    for c in bench["configs"]:
        _keys(c, CONFIG_KEYS, f"config {c.get('name')}")
        _name(c["name"], "config")
        _line(c["source"], f"config {c['name']} source")
        _line(c["why"], f"config {c['name']} why")
        if len(c["reduced"]) > 16:
            raise SpecError(f"config {c['name']}: at most 16 keys in reduced")
        for key in c["reduced"]:
            _name(key, f"config {c['name']} reduced key")
        if c["name"] in configs:
            raise SpecError(f"config {c['name']} twice")
        configs[c["name"]] = c
        path = os.path.join(os.path.dirname(bench_dir), c["file"])
        if not os.path.isfile(path):
            raise SpecError(f"config {c['name']}: no file {c['file']}")
        if _load_json(path).get("name") != c["name"]:
            raise SpecError(f"{c['file']}: its name is not {c['name']}")
    if not 1 <= len(configs) <= 24:
        raise SpecError("1 to 24 configs")

    cells, pairs = {}, set()
    for w in bench["workloads"]:
        _keys(w, CELL_KEYS, f"workload {w.get('name')}")
        for key in ("name", "config", "traffic"):
            _name(w[key], f"workload {key}")
        _line(w["why"], f"workload {w['name']} why")
        if w["chips"] not in (1, 4):
            raise SpecError(f"workload {w['name']}: chips 1 or 4")
        if w["config"] not in configs:
            raise SpecError(f"workload {w['name']}: no config {w['config']}")
        if w["name"] in cells or (w["config"], w["traffic"]) in pairs:
            raise SpecError(f"workload {w['name']}: a name or a (config, traffic) pair twice")
        cells[w["name"]] = w
        pairs.add((w["config"], w["traffic"]))
        cell_file = _load_json(os.path.join(bench_dir, "workloads", f"{w['name']}.json"))
        for key in ("config", "traffic", "chips"):
            if cell_file.get(key) != w[key]:
                raise SpecError(f"workloads/{w['name']}.json: {key} is not BENCHMARK.json's")
        traffic = _load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
        if not os.path.isfile(os.path.join(bench_dir, "kinds", f"{traffic.get('kind')}.py")):
            raise SpecError(f"traffic {w['traffic']}: no generator for kind {traffic.get('kind')}")
    if not 1 <= len(cells) <= 24:
        raise SpecError("1 to 24 workloads")
    if sum(w["chips"] == 4 for w in cells.values()) > max(1, len(cells) // 4):
        raise SpecError("too many four-chip cells")
    for name in configs:
        if not any(w["config"] == name for w in cells.values()):
            raise SpecError(f"config {name} is used by no cell")

    names = set()
    e2e = {}
    for m in bench["end_to_end"]:
        _keys(m, E2E_KEYS, f"metric {m.get('name')}", {"workloads"})
        _metric_common(m, names, cells)
        if m["source"] not in ("host_clock", "device_trace"):
            raise SpecError(f"metric {m['name']}: an end-to-end metric is host_clock or device_trace")
        if not (isinstance(m["bound"], (int, float)) and 0.01 <= m["bound"] <= 0.25):
            raise SpecError(f"metric {m['name']}: bound from 0.01 to 0.25")
        e2e[m["name"]] = m
    if "setup_s" not in e2e or not 1 <= len(e2e) <= 16:
        raise SpecError("1 to 16 end-to-end metrics, setup_s among them")
    for m in bench["per_layer"]:
        _keys(m, LAYER_KEYS, f"metric {m.get('name')}", {"workloads"})
        _metric_common(m, names, cells)
        _line(m["layer"], f"metric {m['name']} layer")
        if m["moves"] not in e2e:
            raise SpecError(f"metric {m['name']} moves {m['moves']}, not an end-to-end metric")
        for cell in m.get("workloads", []):
            if m["moves"] not in {x["name"] for x in cell_metrics(bench, cell, "end_to_end")}:
                raise SpecError(f"metric {m['name']}: cell {cell} does not report {m['moves']}")
        if not os.path.isfile(reader_path(m["name"], bench_dir)):
            raise SpecError(f"metric {m['name']}: no reader metrics/{m['name']}.py")
    if not 1 <= len(bench["per_layer"]) <= 128:
        raise SpecError("1 to 128 per-layer metrics")
    for cell in cells:
        reported = {x["name"] for x in cell_metrics(bench, cell, "end_to_end")}
        if "setup_s" not in reported or len(reported) < 2 or not cell_metrics(bench, cell, "per_layer"):
            raise SpecError(f"cell {cell}: setup_s, another end-to-end and a per-layer metric")


def _metric_common(m: dict, names: set, cells: dict) -> None:
    _name(m["name"], "metric")
    if m["name"] in names:
        raise SpecError(f"metric {m['name']} twice")
    names.add(m["name"])
    if not UNIT.match(m["unit"]):
        raise SpecError(f"metric {m['name']}: unit {m['unit']!r}")
    if m["better"] not in ("lower", "higher"):
        raise SpecError(f"metric {m['name']}: better is lower or higher")
    if m["source"] not in SOURCES:
        raise SpecError(f"metric {m['name']}: source {m['source']!r}")
    for cell in m.get("workloads", []):
        if cell not in cells:
            raise SpecError(f"metric {m['name']}: no cell {cell}")


def cell_metrics(bench: dict, cell: str, group: str) -> List[dict]:
    """The metrics of ``group`` ("end_to_end" or "per_layer") that ``cell``
    reports: those that list it, and those with no list (per-layer: where
    the cell reports the metric it moves)."""
    out = []
    for m in bench[group]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif group == "end_to_end" or m["moves"] in {
                x["name"] for x in cell_metrics(bench, cell, "end_to_end")}:
            out.append(m)
    return out


def load_cell(bench: dict, name: str, bench_dir: str = BENCH_DIR) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cell_file = _load_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    return Cell(name=name,
                config=_load_json(os.path.join(os.path.dirname(bench_dir), conf["file"])),
                traffic=_load_json(os.path.join(bench_dir, "traffic", f"{entry['traffic']}.json")),
                chips=entry["chips"], limits=cell_file["limits"],
                end_to_end=cell_metrics(bench, name, "end_to_end"),
                per_layer=cell_metrics(bench, name, "per_layer"))
