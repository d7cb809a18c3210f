"""Every cell of ``BENCHMARK.json`` runs end to end on the CPU at a tiny size
and comes out correct; the files it names exist; the result line's keys,
names and units keep to the characters allowed; the readers of device
traces run only on a card."""

import json
import os
import subprocess
import sys

import pytest

from vinsbench import harness as H
from vinsbench.tests import tiny

ROOT = os.path.dirname(H.BENCH_DIR)
BENCH = H.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
HOST_SOURCES = ("host_clock", "program_counter", "program_span")


def _name_ok(s: str) -> bool:
    return 1 <= len(s) <= 64 and set(s) <= H.NAME_CHARS and (s[0].isalnum() or s[0] == "_")


def test_benchmark_file_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and len(BENCH["command"]) <= 32
    # the full check with 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(_name_ok(n) for n in names)
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["file"].startswith("vinsbench/")
        assert all(_name_ok(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert _name_ok(w["traffic"]) and len(w["why"]) <= 200
        assert H.driver(H.traffic_file(w["traffic"])["driver"]).run
        e2e = [m["name"] for m in H.cell_metrics(BENCH, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert H.cell_metrics(BENCH, w["name"], "per_layer")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert 1 <= len(m["unit"]) <= 16 and set(m["unit"]) <= H.UNIT_CHARS
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    moved = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moved and callable(H.reader(m["name"]))
        assert "\n" not in m["layer"] and "\t" not in m["layer"]
        for cell in m["workloads"]:
            assert m["moves"] in [e["name"] for e in H.cell_metrics(BENCH, cell, "end_to_end")]
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end_on_the_cpu(cell):
    c, cfg, tr = tiny.shrink(cell, **tiny.cell_size(cell))
    res = H.driver(tr["driver"]).run(tiny.ctx(c, cfg, tr, seconds=tiny.window_s(tr)))
    assert H.passes(res.checks) and res.failed == 0, res.checks
    assert res.attempted > 0
    e2e = {m["name"]: (res.e2e[m["name"]], m["unit"]) for m in
           H.cell_metrics(BENCH, cell, "end_to_end")}
    per = {}
    for m in H.cell_metrics(BENCH, cell, "per_layer"):
        v = H.reader(m["name"])(res.rec)
        if m["source"] in HOST_SOURCES:
            assert v is not None and v >= 0, m["name"]
            per[m["name"]] = (v, m["unit"])
        else:
            assert v is None, m["name"]  # no trace on the CPU
    for metrics in (e2e, per):
        line = H.result_line(True, res.attempted, res.failed, metrics,
                             {"platform": "gpu", "kind": "x", "count": 1,
                              "memory_peak_bytes": 0}, res.checks, res.breakdown)
        out = json.loads(line)
        assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(out)[-1] == "checks"
        for k, v in out["metrics"].items():
            assert _name_ok(k) and set(v["unit"]) <= H.UNIT_CHARS
        assert all(_name_ok(k) for k in out["checks"])


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_device_trace_readers_read_on_a_card(cell, card):
    c, cfg, tr = tiny.shrink(cell, scale=1, lanes=4, pass_frames=8)
    ctx = tiny.ctx(c, cfg, tr, seconds=2.0, trace=True)
    ctx.devices, ctx.out_dir = [card], os.path.join(ROOT, "vinsbench_out")
    res = H.driver(tr["driver"]).run(ctx)
    for m in H.cell_metrics(BENCH, cell, "per_layer"):
        v = H.reader(m["name"])(res.rec)
        assert v is not None and v >= 0, m["name"]
        if m["unit"] == "%":
            assert v <= 105.0, m["name"]


def test_the_command_refuses_a_machine_without_cards():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "vinsbench.run", "--workload", CELLS[0],
                        "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
