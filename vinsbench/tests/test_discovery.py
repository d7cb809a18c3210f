"""A cell, a traffic mix and a per-layer metric dropped in as new files (and
entries of ``BENCHMARK.json``) are found by name, with no file that is there
edited."""

import json
import os
import shutil
import subprocess
import sys

from vinsbench import harness as H

ROOT = os.path.dirname(H.BENCH_DIR)


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(H.BENCH_DIR, tmp_path / "vinsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(tmp_path, "vinsbench", p), "rb").read()
              for p in _files(tmp_path / "vinsbench")}
    bench = H.load_benchmark(ROOT)
    bench["workloads"].append({"name": "robot-tum-vo-later", "config": "tum-fr3-vo",
                               "traffic": "robot-later", "chips": 1, "why": "a later cell"})
    bench["end_to_end"][[m["name"] for m in bench["end_to_end"]].index("frames_per_s")][
        "workloads"].append("robot-tum-vo-later")
    bench["per_layer"].append({"name": "frames_seen.later", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "host shell",
                               "moves": "frames_per_s", "workloads": ["robot-tum-vo-later"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    tr = H.traffic_file("robot-revisit")
    tr["trajectory"]["period_frames"] = 240
    (tmp_path / "vinsbench" / "traffic" / "robot-later.json").write_text(json.dumps(tr))
    (tmp_path / "vinsbench" / "metrics" / "frames_seen.later.py").write_text(
        "def read(rec):\n    return rec.get('frames')\n")
    code = (
        "from vinsbench import harness as H\n"
        "b = H.load_benchmark('.')\n"
        "c = H.find_cell(b, 'robot-tum-vo-later')\n"
        "t = H.traffic_file(c['traffic'])\n"
        "print(t['trajectory']['period_frames'], H.driver(t['driver']).__name__,\n"
        "      [m['name'] for m in H.cell_metrics(b, c['name'], 'per_layer')],\n"
        "      [m['name'] for m in H.cell_metrics(b, c['name'], 'end_to_end')],\n"
        "      H.reader('frames_seen.later')({'frames': 7}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert p.returncode == 0, p.stderr
    assert p.stdout.split()[0:2] == ["240", "vinsbench.drivers.robot"]
    assert "'frames_seen.later'" in p.stdout and "'setup_s'" in p.stdout
    assert "'frames_per_s'" in p.stdout and p.stdout.strip().endswith("7")
    for rel, data in before.items():  # nothing that was there changed
        assert open(os.path.join(tmp_path, "vinsbench", rel), "rb").read() == data


def _files(base):
    out = []
    for d, _, files in os.walk(base):
        out += [os.path.relpath(os.path.join(d, f), base) for f in files]
    return out
