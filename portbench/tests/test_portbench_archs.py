"""A configuration's architecture, found by name (`portbench/archs/`): the
default is VALL-E X's existing code, bit for bit; a new architecture is a
new file that every step of a run calls; an unknown name stops the run;
readers whose function the architecture lacks read None."""

import hashlib
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import make_root
from portbench.harness import check as C
from portbench.harness import trace as T
from portbench.harness.runner import Record, Run, draw_trees, run_cell
from portbench.harness.spec import load_cell, load_reader
from portbench.harness.traffic import Batch
from portbench.harness.weights import vallex_tree, vocos_tree
from portbench.reference import vallex as RV
from portbench.reference.vocos import Vocos
from portbench.run import result_line

SEED = 2**31 + 29

TOY = '''"""A toy architecture: VALL-E X's functions, each call recorded."""
from portbench.harness.spec import ROOT, load_arch

base = load_arch(ROOT, "vallex")
CALLS = []


def _recorded(name):
    def call(*a, **k):
        CALLS.append(name)
        return getattr(base, name)(*a, **k)
    return call


for _name in ("draw_tree", "program_config", "reference", "request_flops"):
    globals()[_name] = _recorded(_name)
'''

BARE = '''"""An architecture without counts for the decode kernels or the step."""
from portbench.harness.spec import ROOT, load_arch

base = load_arch(ROOT, "vallex")
draw_tree, program_config, reference = base.draw_tree, base.program_config, base.reference
'''


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _add_cell(root, name, arch, metrics=()):
    """A new configuration file naming `arch` (the tiny one's sizes), a new
    architecture file, and the cell's entries appended to BENCHMARK.json."""
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "tiny.json")) as f:
        conf = json.load(f)
    conf["architecture"] = name
    with open(os.path.join(pb, "configs", f"{name}.json"), "w") as f:
        json.dump(conf, f)
    if arch is not None:
        os.makedirs(os.path.join(pb, "archs"), exist_ok=True)
        with open(os.path.join(pb, "archs", f"{name}.py"), "w") as f:
            f.write(arch)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name=name,
                                 file=f"portbench/configs/{name}.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name=name, config=name))
    for m in bench["per_layer"]:
        if m["name"] in metrics:
            m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if "__pycache__" not in d:
                with open(os.path.join(d, n), "rb") as f:
                    out[os.path.relpath(os.path.join(d, n), root)] = hashlib.sha256(
                        f.read()).hexdigest()
    return out


def test_default_is_vallex_bit_for_bit(tmp_path):
    """No `architecture` key: the tree and the Vocos tree are the ones the
    harness drew before architectures (vallex_tree, then vocos_tree, from
    one generator), and the check's readings equal those of RV's functions
    called directly, with and without the control."""
    cell = load_cell("tiny", make_root(tmp_path))
    conf = cell.config
    assert "architecture" not in conf and cell.arch.__name__ == "portbench_arch_vallex"
    dev = torch.device("cpu")
    tree, vtree = draw_trees(cell, SEED, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED % (1 << 63))
    want = (vallex_tree(conf["model"], conf["weights"], gen, dev, torch.float32),
            vocos_tree(conf["vocos"], gen, dev))
    for got, ref in zip((tree, vtree), want):
        a, b = list(_leaves(got)), list(_leaves(ref))
        assert [p for p, _ in a] == [p for p, _ in b]
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))

    rng = np.random.default_rng(3)
    items = []
    for G, greedy in ((6, True), (4, True), (5, False)):
        codes = rng.integers(0, 1024, (G, 8))
        items.append(C.Item(rng.integers(1, 69, 9), np.ones(9, int), rng.integers(0, 1024, (4, 8)),
                            codes, rng.standard_normal(G * C.HOP).astype(np.float32), 8,
                            greedy))
    m = RV.Model(tree, conf["model"]["num_heads"])
    direct = SimpleNamespace(
        device=m.device, eos=m.eos,
        ar_logits=lambda *a, **k: RV.ar_logits(m, *a, **k),
        nar_logits=lambda *a, **k: RV.nar_logits(m, *a, **k))
    vocos = Vocos(vtree)
    for control in (None, conf["control"]):
        got = C.readings(cell.arch.reference(tree, conf["model"]), vocos, items, control)
        assert got == C.readings(direct, vocos, items, control)
        assert got["program"]["ar_gap"] > 0


def test_a_new_architecture_is_files_alone(tmp_path):
    """A cell whose configuration names a toy architecture runs through
    run_cell on the CPU, and the toy's drawer, program configuration,
    reference and counts are each called; the checkout gains files and
    BENCHMARK.json entries, and no file that was there changes."""
    root = make_root(tmp_path, quantize="none")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench_before = json.load(f)
    before = _files(root)
    _add_cell(root, "toy", TOY, metrics=("mfu",))
    after = _files(root)
    assert set(after) - set(before) == {os.path.join("portbench", "archs", "toy.py"),
                                        os.path.join("portbench", "configs", "toy.json")}
    assert {p for p in before if after[p] != before[p]} == {"BENCHMARK.json"}
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for key in ("configs", "workloads", "end_to_end"):
        assert bench[key][: len(bench_before[key])] == bench_before[key]

    cell = load_cell("toy", root)
    out = run_cell(cell, SEED, 0.5, False, "cpu", time.perf_counter())
    assert out["correct"] and out["checked"] >= 2
    line = result_line(out, cell, trace=True)
    assert line["metrics"]["mfu"]["value"] > 0
    assert set(cell.arch.CALLS) == {"draw_tree", "program_config", "reference",
                                    "request_flops"}
    assert cell.arch.CALLS.count("draw_tree") == 2  # the program's, then the reference's


def test_unknown_architecture_names_its_file(tmp_path):
    root = make_root(tmp_path)
    _add_cell(root, "nosuch", None)
    with pytest.raises(SystemExit) as e:
        load_cell("nosuch", root)
    assert os.path.join("archs", "nosuch.py") in str(e.value)


def test_missing_counts_read_none(tmp_path):
    """The same traced run reads the rooflines and `mfu` under VALL-E X, and
    None under an architecture that has no counts for them."""
    root = make_root(tmp_path)
    _add_cell(root, "bare", BARE)
    kernels = [(0.0, 10.0, "void gemm_tc_kernel<48, 2>(float const*)"),
               (30.0, 40.0, "void masked_attention_split_kernel<signed char, 64>()")]
    trace = T.Trace(0.0, 100.0, kernels, [])
    recs = [Record(Batch(0, [], True, 0), 4.0, {}, 16, [(100, 161, 16)], 1.0),
            Record(Batch(1, [], True, 0), 9.0, {}, 16, [(100, 161, 10), (100, 161, 16)], 1.0,
                   True)]
    names = ("gemm_small_m_roofline", "masked_attention_roofline", "mfu")
    for cell, have in ((load_cell("tiny", root), True), (load_cell("bare", root), False)):
        run = Run(cell, 1.0, None, recs, trace)
        got = [load_reader(root, n)(run) for n in names]
        assert all((v is not None) == have for v in got), (cell.name, got)
