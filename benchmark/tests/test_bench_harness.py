"""The harness is driven by data: a configuration, a cell and a metric
reader added as files are found and validated with no edit to a file that
is there; names and units keep the contract's characters; a result line
has exactly the keys of the result line, ``checks`` last."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import result, spec

BENCH = os.path.join(spec.ROOT, "BENCHMARK.json")


def copy_benchmark(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(BENCH, root / "BENCHMARK.json")
    return root


def test_added_files_are_found_without_edits(tmp_path):
    root = copy_benchmark(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench_dir = str(root / "benchmark")
    config = json.loads((root / "benchmark/configs/grid-bf16.json").read_text())
    config["name"] = "grid-fp32"
    config["model"]["use_bfloat16"] = False
    (root / "benchmark/configs/grid-fp32.json").write_text(json.dumps(config))
    (root / "benchmark/workloads/grid-serve-fp32.json").write_text(json.dumps(
        {"config": "grid-fp32", "traffic": "grid-serve", "chips": 1,
         "limits": {"spec_rel": 0.01}}))
    (root / "benchmark/metrics/postnet_ms.serve.py").write_text(
        "def read(data):\n    ms = data.get('spans', {}).get('postnet')\n"
        "    return sum(ms) / len(ms) if ms else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="grid-fp32",
                                 file="benchmark/configs/grid-fp32.json"))
    bench["workloads"].append({"name": "grid-serve-fp32", "config": "grid-fp32",
                               "traffic": "grid-serve", "chips": 1, "why": "fp32 serving"})
    for m in bench["end_to_end"]:
        if "serve" in m["name"]:
            m["workloads"].append("grid-serve-fp32")
    bench["per_layer"].append({"name": "postnet_ms.serve", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "postnet",
                               "moves": "serve_mel_frames_per_s",
                               "workloads": ["grid-serve-fp32"]})
    spec.validate(bench, bench_dir)
    cell = spec.load_cell(bench, "grid-serve-fp32", bench_dir)
    assert cell.config["model"]["use_bfloat16"] is False
    assert cell.limits == {"spec_rel": 0.01}
    assert "postnet_ms.serve" in [m["name"] for m in cell.per_layer]
    assert spec.load_reader("postnet_ms.serve", bench_dir).read({"spans": {"postnet": [2.0, 4.0]}}) == 3.0
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_validation_refuses_a_bad_name():
    bench = spec.load_benchmark()
    bench["per_layer"][0] = dict(bench["per_layer"][0], name="bad name")
    with pytest.raises(spec.SpecError):
        spec.validate(bench)


def test_names_and_units_use_the_allowed_characters():
    bench = spec.load_benchmark()
    spec.validate(bench)
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[g]]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(name.match(n) for n in names)
    assert len(set(x["name"] for g in ("end_to_end", "per_layer") for x in bench[g])) == \
        len(bench["end_to_end"]) + len(bench["per_layer"])
    assert all(unit.match(m["unit"]) for g in ("end_to_end", "per_layer") for m in bench[g])
    for path in os.listdir(os.path.join(spec.BENCH_DIR, "metrics")):
        assert name.match(path[:-3]) and path.endswith(".py")


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced, capsys):
    bench = spec.load_benchmark()
    cell = spec.load_cell(bench, "grid-serve-bf16")
    tr = {"busy_s": 0.9, "window_s": 1.0, "device_ops": [["k", 0.5]], "idle_gaps": [["bench.wait", 0.1]]}
    outcome = result.Outcome(
        e2e={"setup_s": 20.0, "serve_mel_frames_per_s": 1e5, "serve_batch_p95_ms": 200.0},
        data={"spans": {"v_front": [48.0]}, "counters": {"memory_peak_bytes": 5e9}, "trace": tr},
        checks=result.checks_against({"spec_rel": 0.01}, {"spec_rel": 0.05}),
        attempted=96, failed=0, memory_peak_bytes=5_000_000_000,
        device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    result.emit(result.line(cell, outcome, traced))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert err.strip().splitlines()[-1].startswith("check spec_rel")
    assert line["correct"] is True
    if traced:
        assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(line["device"])
        assert set(line["metrics"]) == {"vfront_ms.serve", "idle_pct.serve", "peak_mem_gb.serve"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    """No CUDA here: non-zero, no result line.  The same in a directory
    that holds only BENCHMARK.json and the benchmark."""
    for cwd in (spec.ROOT, copy_benchmark(tmp_path)):
        proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "grid-serve-bf16",
                               "--seed", "1", "--seconds", "1", "--trace", "0"],
                              cwd=cwd, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert proc.stdout.strip() == ""
