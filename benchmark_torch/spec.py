"""Load ``BENCHMARK.json``, check it, and find each cell's files by name.

A cell ``<config>.<traffic>`` is its entry under ``workloads`` plus
``configs/<config>.json`` (the file the entry of ``configs`` names),
``traffic/<traffic>.json`` and ``limits/<cell>.json``; a metric is its entry
plus ``metrics/<name>.py``.  :func:`load` refuses a file whose names, units
or references break the rules below, before anything runs.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"host_clock", "device_trace"}
#: the numbers :func:`benchmark_torch.run.compare` reads for each answer
COMPARED = {"nbe", "max_err", "info", "perm_diff"}


class SpecError(ValueError):
    """``BENCHMARK.json`` or a file it names breaks the benchmark's rules."""


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload with everything found for it by name."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise SpecError(msg)


def _name(value, what: str) -> None:
    _need(isinstance(value, str) and NAME.fullmatch(value) is not None,
          f"{what}: {value!r} is not a name (letters, digits, _, . and -, at most 64, "
          "not starting with . or -)")


def _line(value, what: str) -> None:
    _need(isinstance(value, str) and 1 <= len(value) <= 200
          and not any(c in value for c in "\n\r\t"),
          f"{what}: 1 to 200 characters on one line, no tab")


def _keys(entry: dict, allowed: set, what: str, optional=frozenset()) -> None:
    _need(isinstance(entry, dict), f"{what}: not an object")
    extra = set(entry) - allowed - set(optional)
    missing = allowed - set(entry)
    _need(not extra and not missing,
          f"{what}: keys {sorted(missing)} missing, {sorted(extra)} not allowed")


def _unique(entries: list, what: str) -> None:
    names = [e["name"] for e in entries]
    _need(len(names) == len(set(names)), f"{what}: duplicate names")


def _metric(m: dict, what: str, e2e: bool, cells: set, e2e_names: set) -> None:
    _keys(m, E2E_KEYS if e2e else LAYER_KEYS, what, optional={"workloads"})
    _name(m["name"], f"{what} name")
    _need(isinstance(m["unit"], str) and UNIT.fullmatch(m["unit"]) is not None,
          f"{what}: unit {m['unit']!r} is not 1 to 16 of letters, digits, _ / % . -")
    _need(m["better"] in ("lower", "higher"), f"{what}: better is lower or higher")
    _need(m["source"] in (E2E_SOURCES if e2e else SOURCES),
          f"{what}: source {m['source']!r} not allowed")
    if e2e:
        bound = m["bound"]
        _need(isinstance(bound, (int, float)) and 0.01 <= bound <= 0.25,
              f"{what}: bound must lie in [0.01, 0.25]")
    else:
        _line(m["layer"], f"{what} layer")
        _need(m["moves"] in e2e_names, f"{what}: moves {m['moves']!r}, no such metric")
    if "workloads" in m:
        ws = m["workloads"]
        _need(isinstance(ws, list) and ws, f"{what}: workloads is a non-empty list")
        for w in ws:
            _need(w in cells, f"{what}: workload {w!r} is not a cell")
    _need((HERE / "metrics" / f"{m['name']}.py").is_file(),
          f"{what}: no reader metrics/{m['name']}.py")


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def _read_json(path: Path, what: str) -> dict:
    _need(path.is_file(), f"{what}: {path.relative_to(ROOT)} not found")
    with open(path) as f:
        return json.load(f)


def validate(spec: dict) -> None:
    """Raise :class:`SpecError` unless ``spec`` keeps the rules."""
    _keys(spec, TOP_KEYS, "BENCHMARK.json")
    cmd, paths = spec["command"], spec["paths"]
    _need(isinstance(cmd, list) and 1 <= len(cmd) <= 32, "command: 1 to 32 strings")
    for word in cmd:
        _line(word, "command word")
    _need(isinstance(paths, list) and 1 <= len(paths) <= 16, "paths: 1 to 16 directories")
    for p in paths:
        _need(isinstance(p, str) and re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) is not None
              and not p.startswith("/") and ".." not in p.split("/"),
              f"paths: {p!r} is not a relative path inside the checkout")
    rs = spec["run_seconds"]
    _need(isinstance(rs, int) and 1 <= rs <= 51, "run_seconds: a whole number from 1 to 51")

    configs = spec["configs"]
    _need(isinstance(configs, list) and 1 <= len(configs) <= 24, "configs: 1 to 24")
    files = set()
    for c in configs:
        _keys(c, CONFIG_KEYS, "config")
        _name(c["name"], "config name")
        _line(c["source"], f"config {c['name']} source")
        _line(c["why"], f"config {c['name']} why")
        _need(isinstance(c["reduced"], list) and len(c["reduced"]) <= 16,
              f"config {c['name']}: reduced is a list of at most 16 keys")
        for key in c["reduced"]:
            _name(key, f"config {c['name']} reduced key")
        _need(c["file"] not in files, f"config {c['name']}: file shared with another")
        files.add(c["file"])
        _need(any(c["file"].startswith(p.rstrip("/") + "/") for p in paths),
              f"config {c['name']}: file lies outside paths")
        _read_json(ROOT / c["file"], f"config {c['name']}")
    _unique(configs, "configs")
    config_names = {c["name"] for c in configs}

    cells = spec["workloads"]
    _need(isinstance(cells, list) and 1 <= len(cells) <= 24, "workloads: 1 to 24")
    pairs = set()
    for w in cells:
        _keys(w, CELL_KEYS, "workload")
        _name(w["name"], "workload name")
        _name(w["traffic"], f"workload {w['name']} traffic")
        _need(w["config"] in config_names, f"workload {w['name']}: unknown config")
        _need(w["chips"] in (1, 4), f"workload {w['name']}: chips is 1 or 4")
        _line(w["why"], f"workload {w['name']} why")
        _need((w["config"], w["traffic"]) not in pairs,
              f"workload {w['name']}: config and traffic repeat a cell")
        pairs.add((w["config"], w["traffic"]))
        _read_json(HERE / "traffic" / f"{w['traffic']}.json", f"workload {w['name']} traffic")
        lim = _read_json(HERE / "limits" / f"{w['name']}.json", f"workload {w['name']} limits")
        _need(isinstance(lim.get("limits"), dict) and lim["limits"]
              and set(lim["limits"]) <= COMPARED,
              f"workload {w['name']}: limits names numbers outside {sorted(COMPARED)}")
    _unique(cells, "workloads")
    _need({w["config"] for w in cells} == config_names, "configs: each is used by a cell")
    four = sum(w["chips"] == 4 for w in cells)
    _need(four <= max(1, len(cells) // 4), "workloads: too many cells on 4 chips")
    cell_names = {w["name"] for w in cells}

    e2e, layer = spec["end_to_end"], spec["per_layer"]
    _need(isinstance(e2e, list) and 1 <= len(e2e) <= 16, "end_to_end: 1 to 16")
    _need(isinstance(layer, list) and 1 <= len(layer) <= 128, "per_layer: 1 to 128")
    e2e_names = {m.get("name") for m in e2e}
    for m in e2e:
        _metric(m, f"end_to_end {m.get('name')}", True, cell_names, e2e_names)
    for m in layer:
        _metric(m, f"per_layer {m.get('name')}", False, cell_names, e2e_names)
    _unique(e2e + layer, "metrics")
    _need("setup_s" in e2e_names, "end_to_end: setup_s is required")
    _need(all("workloads" not in m for m in e2e if m["name"] == "setup_s"),
          "end_to_end setup_s: reported on every workload, so it names none")
    for w in cells:
        mine = [m for m in e2e if _applies(m, w["name"])]
        _need(any(m["name"] == "setup_s" for m in mine)
              and any(m["name"] != "setup_s" for m in mine),
              f"workload {w['name']}: reports setup_s and another end-to-end metric")
        reported = {m["name"] for m in mine}
        lm = [m for m in layer if _applies(m, w["name"])]
        _need(lm, f"workload {w['name']}: reports no per-layer metric")
        for m in lm:
            _need(m["moves"] in reported,
                  f"per_layer {m['name']}: cell {w['name']} does not report {m['moves']}")


def load(path: Path = SPEC) -> dict:
    """The checked ``BENCHMARK.json``."""
    spec = _read_json(path, "BENCHMARK.json")
    validate(spec)
    return spec


def cell(spec: dict, name: str) -> Cell:
    """The cell ``name`` with its configuration, traffic mix, limits and the
    metrics it reports."""
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=w["chips"],
        config=_read_json(ROOT / conf["file"], f"config {conf['name']}"),
        traffic=_read_json(HERE / "traffic" / f"{w['traffic']}.json", "traffic"),
        limits=_read_json(HERE / "limits" / f"{name}.json", "limits"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])
