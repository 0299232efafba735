"""A configuration, a traffic mix or a metric added as a file, with its
entry in BENCHMARK.json, is found by name with no edit to the harness."""

import json
import os

from conftest import make_root
from portbench.harness.runner import Run
from portbench.harness.spec import load_cell
from portbench.run import result_line


def test_new_files_are_found(tmp_path):
    root = make_root(tmp_path)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "tiny.json")) as f:
        conf = json.load(f)
    conf["engine"]["quantize"] = "none"
    with open(os.path.join(pb, "configs", "other.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(pb, "traffic", "tiny.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(pb, "traffic", "burst.json"), "w") as f:
        json.dump(dict(traffic, batch=5), f)
    with open(os.path.join(pb, "metrics", "batches_run.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.records))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="other",
                                 file="portbench/configs/other.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="other-burst",
                                   config="other", traffic="burst"))
    bench["per_layer"].append({"name": "batches_run", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "harness",
                               "moves": "audio_s_per_s", "workloads": ["other-burst"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = load_cell("other-burst", root)
    assert cell.config["engine"]["quantize"] == "none"
    assert cell.traffic["batch"] == 5
    assert "batches_run" in [m.name for m in cell.per_layer]
    assert "batches_run" not in [m.name for m in load_cell("tiny", root).per_layer]
    run = Run(cell, 1.0, None, [])
    out = {"run": run, "correct": True, "attempted": 0, "failed": 0, "device": {}}
    line = result_line(out, cell, trace=True)
    assert line["metrics"] == {"batches_run": {"value": 0.0, "unit": "batches"}}
    assert list(line)[-1] == "checks"
