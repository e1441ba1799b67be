"""BENCHMARK.json against the benchmark's contract, every cell, traffic,
configuration and metric found by its name, and the import rule."""
import json
import os
import os.path as osp
import re

import pytest

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(osp.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [
        w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and osp.isfile(
            osp.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s", "train_step_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert all(m["moves"] in e2e for m in b["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_found_by_name(cell):
    from benchmark.cell import load_cell, metric_module
    c = load_cell(cell)
    assert c.traffic["stage"] in ("coarse", "medium", "fine")
    assert c.end_to_end and c.per_layer
    assert set(c.limits) >= {"loss_gap", "grad_gap", "change_gap"}
    for m in c.end_to_end + c.per_layer:
        assert callable(metric_module(m["name"]).read)


def test_every_metric_file_is_named():
    b = bench()
    named = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    files = {f[:-3] for f in os.listdir(osp.join(ROOT, "benchmark",
                                                 "metrics"))
             if f.endswith(".py") and f != "__init__.py"}
    assert files == named


def test_no_jax_and_no_port_in_the_reference():
    from benchmark.imports_check import source_imports, static_violations
    assert static_violations() == []
    ref = osp.join(ROOT, "benchmark", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0]
                    for m in source_imports(osp.join(ref, f))}
            assert "selfreconcode_tpu_torch" not in tops, f


def test_import_check_compares_whole_names(tmp_path):
    from benchmark.imports_check import static_violations
    (tmp_path / "reference").mkdir()
    (tmp_path / "a.py").write_text("import selfreconcode_tpu_torch.ops\n")
    assert static_violations(str(tmp_path)) == []
    (tmp_path / "b.py").write_text("from selfreconcode_tpu.ops import x\n")
    (tmp_path / "reference" / "c.py").write_text(
        "import selfreconcode_tpu_torch\n")
    (tmp_path / "d.py").write_text("import jax.numpy as jnp\n")
    assert len(static_violations(str(tmp_path))) == 3


def test_no_result_without_a_card(capsys):
    import torch
    from benchmark.run import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert main(["--workload", "tight-fine-1080", "--seed", str(2 ** 33),
                 "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
