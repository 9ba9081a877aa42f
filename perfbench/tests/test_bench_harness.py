"""The harness: found by name, driven by data, and its result line."""

import io
import json
import math
import pathlib
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from perfbench import core
from perfbench.tests.cells import TINY_ZP, tiny_root

REPO = core.ROOT
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _benchmark():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_matches_the_files():
    bench = _benchmark()
    assert bench["command"] == ["python3", "perfbench/run.py"] and bench["paths"] == ["perfbench"]
    for c in bench["configs"]:
        assert pathlib.Path(REPO / c["file"]) == core.BENCH / "configs" / f"{c['name']}.json"
        assert json.loads((REPO / c["file"]).read_text())["source"] == c["source"]
    for w in bench["workloads"]:
        cell = core.load_cell(w["name"])
        assert (cell.workload["config"], cell.workload["traffic"]) == (w["config"], w["traffic"])
        assert cell.workload["chips"] == w["chips"]
    readers = core.load_readers()
    assert sorted(readers) == sorted(m["name"] for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]


def test_a_new_cell_is_new_files_only(tmp_path):
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in core.BENCH.rglob("*") if p.is_file()}
    # a new config, traffic mix, cell and per-layer metric, as files alone
    cfg = json.loads((root / "configs" / "tiny_arch.json").read_text())
    (root / "configs" / "tiny_new.json").write_text(json.dumps(dict(cfg, rays_per_pixel=2)))
    (root / "traffic" / "pan_only.json").write_text(json.dumps(
        {"kind": "session", "warmup_cycles": 1, "frame_ms": 50.0, "pointer_hz": 20.0,
         "gestures": [["rest", 0.05], ["pan", 0.05, 80.0, 1, 0], ["pan", 0.05, 80.0, -1, 0]]}))
    (root / "workloads" / "tiny_new_pan.json").write_text(json.dumps(dict(
        config="tiny_new", traffic="pan_only", chips=1, trace_frames=3,
        check={"start": False, "band_rows": 4, "frames": {"moving": 1},
               "limits": {k: 1e-4 for k in core.NUMBERS}})))
    (root / "metrics" / "frames_traced.session.py").write_text(
        'UNIT = "frames"\n\n\ndef read(tr):\n'
        '    return float(tr.frames) if tr.kind == "session" else None\n')
    cell = core.load_cell("tiny_new_pan", root)
    assert cell.config["rays_per_pixel"] == 2 and cell.kind == "session"
    out = core.run(cell, seed=5, seconds=0.1, trace=True, dev_name="cpu")
    assert out["correct"] and out["metrics"]["frames_traced.session"]["value"] == 3.0
    after = {p: p.read_bytes() for p in core.BENCH.rglob("*") if p.is_file()}
    assert before == after


def test_tiny_run_prints_the_contract_line(tmp_path):
    root = tiny_root(tmp_path)
    for trace in (False, True):
        out = core.run(core.load_cell("tiny_still", root), seed=2**31 + 11, seconds=0.2,
                       trace=trace, dev_name="cpu")
        buf = io.StringIO()
        with redirect_stdout(buf):
            core.print_result(out)
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        keys = list(line)
        want = CONTRACT_KEYS + (["breakdown"] if trace else []) + ["checks"]
        assert keys == want
        assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
        assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}
        if not trace:
            assert set(line["metrics"]) == {"frame_ms", "setup_s"}
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "arch1080_still",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    if r.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert r.stdout == ""


def test_benchmark_alone_fails(tmp_path):
    # a directory with BENCHMARK.json and perfbench/ alone: no program
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "arch1080_still",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""


def test_sample_is_drawn_from_the_seed():
    import random

    def draw(seed):
        sample = core.Sample({"moving": 2, "any": 1}, random.Random(seed))
        for i in range(200):
            kind = ("moving", "rest_build", "rest")[i % 3]
            sample.offer(kind, (i, kind))
        return sample.items()

    assert draw(3) == draw(3)
    a = draw(3)
    assert [k for _, k in a[:2]] == ["moving", "moving"] and len(a) == 3
    assert {tuple(draw(s)) for s in range(8)}.__len__() > 1
    # "any" draws from every kind
    assert {draw(s)[2][1] for s in range(40)} == {"moving", "rest_build", "rest"}


def test_gestures_cut_into_frames():
    frames = core.frames_of(TINY_ZP)
    assert [len(f) for f in frames] == [0, 1, 1, 1, 1, 0]
    assert frames[1] == (("scroll", 1.0),) and frames[4] == (("scroll", -1.0),)
    dx, dy = frames[2][0][1:]
    assert frames[3][0][1:] == (-dx, -dy)
    assert abs(math.hypot(dx, dy) - 8.0) < 1e-12 and abs(dx / -dy - 8 / 5) < 1e-12
    assert core.frame_kinds(frames) == ["rest", "moving", "moving", "moving", "moving",
                                        "rest_build"]
    # events posted within one frame all go before the next: 4 ticks at 40/s
    two = core.frames_of(dict(TINY_ZP, gestures=[["zoom", 4, 40.0], ["rest", 0.1]]))
    assert [len(f) for f in two] == [4, 0]


@pytest.mark.parametrize("name", ["zoom_pan_13ms", "zoom_pan_77ms"])
def test_session_cycles_return_to_their_start_camera(name):
    frames = core.frames_of(core.read_json(core.BENCH, "traffic", name))
    events = [e for f in frames for e in f]
    assert sum(e[1] for e in events if e[0] == "scroll") == 0
    for axis in (1, 2):
        assert sum(e[axis] for e in events if e[0] == "drag") == 0


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = core.run(core.load_cell("arch1080_still"), seed=3, seconds=1.0, trace=True)
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["metrics"]["trace_kernel_ms.still"]["value"] > 0
