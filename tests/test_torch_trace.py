"""The port's tracing (``utils/trace.py``): spans, their parents, steps and
self time; nothing recorded and no profiler range entered with tracing off
and no profiler running; the training step's span tree, its host syncs and
the surface solve's converged counts; a step taken with tracing on equal
bit for bit to one taken with it off; the train CLI's --trace line.
Port-only (no JAX): 32x32 synthetic scene, toy body, tiny octree."""
import dataclasses
import os.path as osp
import time

import numpy as np
import pytest
import torch

from selfreconcode_tpu_torch.engine import trainer as TTR
from selfreconcode_tpu_torch.utils import trace

RES = {s: [(9, 9, 9), (17, 17, 17)] for s in ("coarse", "medium", "fine")}
SURF_ITERS = 3
STEP_SPANS = ("train_step", "step.feed", "step.geom", "step.inner",
              "step.outer", "step.outer.solve", "step.update")
PARENT = {"step.outer.solve": "step.outer", "remesh.sweep": "remesh",
          "remesh.mc": "remesh", "train_step": None}


@pytest.fixture(autouse=True)
def _clean_recorder():
    trace.disable()
    trace.read_and_clear()
    yield
    trace.disable()
    trace.read_and_clear()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_spans_nest_with_parents_steps_and_self_time():
    trace.enable()
    with trace.span("a") as a:
        with trace.span("b"):
            with trace.span("c"):
                time.sleep(0.002)
        with trace.span("b"):
            time.sleep(0.002)
    with trace.span("d"):
        pass
    trace.count("n")
    trace.count("n", 2)
    rec = trace.read_and_clear()
    names = [s["name"] for s in rec["spans"]]
    assert names == ["c", "b", "b", "a", "d"]     # in the order they end
    c, b1, b2, sa, d = rec["spans"]
    assert sa["parent"] is None and d["parent"] is None
    assert b1["parent"] == b2["parent"] == sa["id"] and c["parent"] == b1["id"]
    assert {s["step"] for s in (c, b1, b2, sa)} == {sa["id"]}
    assert d["step"] == d["id"] != sa["id"]
    for s in rec["spans"]:
        kids = sum(k["end"] - k["start"] for k in rec["spans"]
                   if k["parent"] == s["id"])
        assert s["self"] == pytest.approx(s["end"] - s["start"] - kids,
                                          abs=1e-12)
    assert c["self"] == pytest.approx(c["end"] - c["start"])
    assert sa["self"] < sa["end"] - sa["start"] - 0.004
    assert a.seconds == pytest.approx(sa["end"] - sa["start"])
    assert rec["counters"] == {"n": 3}
    assert trace.read_and_clear() == {"spans": [], "counters": {},
                                      "device": {}}


def test_tracing_off_records_nothing_and_enters_no_profiler_range(
        monkeypatch):
    entered = []

    class Stub:
        def __init__(self, name):
            entered.append(name)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Stub)
    with trace.span("x") as x:
        trace.count("solve_converged", [torch.ones(3)])
        trace.count("host_syncs")
    assert x.seconds >= 0.0           # the span still reads the clock
    assert entered == []
    assert trace.read_and_clear() == {"spans": [], "counters": {
        "host_syncs": 1}, "device": {}}


def test_spans_are_profiler_ranges_with_tracing_off():
    """Under a profiler a span is a record_function range whatever the
    switch says, so the profiler's trace names host time by it; the
    recorder keeps nothing."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("step.outer"):
            with trace.span("step.outer.solve"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"step.outer", "step.outer.solve"} <= names
    assert trace.read_and_clear()["spans"] == []


def test_device_counters_are_read_with_the_readback():
    vals = torch.tensor([1.5, 2.5])
    trace.count("solve_converged", [torch.tensor([True, False]),
                                    torch.tensor([True, True])])
    assert trace.tolist(vals) == [1.5, 2.5]
    assert trace.read_and_clear()["device"] == {}
    trace.enable()
    trace.count("solve_converged", [torch.tensor([True, False]),
                                    torch.tensor([True, True])])
    trace.count("other", [torch.tensor([3, 4])])
    assert trace.tolist(vals) == [1.5, 2.5]
    trace.count("solve_converged", [torch.zeros(2, dtype=torch.bool)])
    # a row not read by a step's readback is copied by read_and_clear
    assert trace.read_and_clear()["device"] == {
        "solve_converged": [[1, 2], [0]], "other": [[7]]}


def _trainer(root):
    tr, ds = TTR.build_synthetic_trainer(str(root), n_frames=4, H=32, W=32,
                                         resolutions=RES, device="cpu")
    tr.set_stage("coarse")
    tr.override_stage(sample_pix=16, eik_tmp=128, anchor_sub=256,
                      surf_iters=SURF_ITERS, weights=dataclasses.replace(
                          tr.stage_cfg.weights, sample_pix_num=0))
    return tr, ds


STEPS = 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two trainers built alike take STEPS steps on the same frames, one
    with tracing on (each step's record kept), one with it off."""
    out = {}
    for on in (True, False):
        tr, ds = _trainer(tmp_path_factory.mktemp(f"trace_{on}"))
        recs, losses = [], []
        trace.read_and_clear()
        for i in range(STEPS):
            fids = (np.arange(tr.stage_cfg.N) + i) % ds.frame_num
            if on:
                trace.enable()
            info = tr.train_step(fids, ds.batch_raw(fids), 1e-3)
            trace.disable()
            losses.append(info)
            recs.append(trace.read_and_clear())
        out[on] = (tr, recs, losses)
    return out


def test_step_span_tree(runs):
    tr, recs, _ = runs[True]
    assert tr.stage_cfg.remesh_intersect > STEPS
    for i, rec in enumerate(recs):
        spans = rec["spans"]
        names = [s["name"] for s in spans]
        for n in STEP_SPANS:
            assert names.count(n) == 1, (i, n, names)
        ids = {s["id"]: s for s in spans}
        root = next(s for s in spans if s["name"] == "train_step")
        for s in spans:
            assert s["step"] == root["id"]
            parent = ids[s["parent"]]["name"] if s["parent"] is not None \
                else None
            assert parent == PARENT.get(s["name"], "train_step"), s
            assert root["start"] <= s["start"] <= s["end"] <= root["end"]
        # the step's own spans leave under 5% of it uncovered
        assert root["self"] < 0.05 * (root["end"] - root["start"])
        remesh = {n: names.count(n) for n in ("remesh", "remesh.sweep",
                                              "remesh.mc")}
        if i == 0:   # the stage's first step remeshes: one sweep and one
            # marching cubes a try (a clipped box grows and tries again)
            assert remesh["remesh"] == 1
            assert remesh["remesh.sweep"] == remesh["remesh.mc"] >= 1
        else:
            assert remesh == {"remesh": 0, "remesh.sweep": 0,
                              "remesh.mc": 0}


def test_remesh_timing_is_the_span(runs):
    tr, recs, _ = runs[True]
    rm = next(s for s in recs[0]["spans"] if s["name"] == "remesh")
    assert tr.timings["remesh"] == rm["end"] - rm["start"]


def test_solve_converged_counts(runs):
    _, recs, infos = runs[True]
    for rec, info in zip(recs, infos):
        (row,) = rec["device"]["solve_converged"]
        assert len(row) == SURF_ITERS + 1
        assert all(a <= b for a, b in zip(row, row[1:]))
        # the step's converged rays are the selected ones of the last count
        assert info["ray_converged"] <= row[-1]
    assert runs[False][1][0]["device"] == {}


def test_host_syncs_count_the_same_sites_every_step(runs):
    tr, recs, _ = runs[True]
    n = [rec["counters"]["host_syncs"] for rec in recs]
    # per splatted frame point_seeds' 4, the binning's 1 and cell_bins' 3;
    # then the readback
    assert n[1] == n[2] == 8 * tr.stage_cfg.N + 1
    assert n[0] > n[1]                    # the remesh's own syncs
    # the off run counts them too: the host counter is always on
    assert [rec["counters"]["host_syncs"] for rec in runs[False][1]] == n


def test_tracing_changes_no_bit_of_the_step(runs):
    ta, _, la = runs[True]
    tb, _, lb = runs[False]
    assert la == lb
    for (k, a), b in zip(ta.nets.state_dict().items(),
                         tb.nets.state_dict().values()):
        assert torch.equal(a, b), k
    for k in ta.bank:
        assert torch.equal(ta.bank[k], tb.bank[k]), k
    assert torch.equal(ta.tmp.verts, tb.tmp.verts)
    assert torch.equal(ta.tmp.momentum, tb.tmp.momentum)


def test_trace_report_line():
    from selfreconcode_tpu_torch.cli.train import trace_report
    spans = [{"name": "step.outer", "start": 1.0, "end": 1.5, "self": 0.2},
             {"name": "train_step", "start": 0.9, "end": 2.0, "self": 0.1},
             {"name": "step.outer", "start": 3.0, "end": 3.3, "self": 0.1},
             {"name": "train_step", "start": 2.9, "end": 4.0, "self": 0.2}]
    line = trace_report(3, {"spans": spans, "counters": {"host_syncs": 9},
                            "device": {"solve_converged": [[1, 2], [3, 4]]}})
    assert line == ("trace epoch 3 (2 steps; ms per step, duration/self): "
                    "train_step 1100.0/150.0, step.outer 400.0/150.0; "
                    "host_syncs 4.5 per step; solve_converged 2.0 3.0")
    graphs = {"host_syncs": 9, "solve_graph_captures": 1,
              "solve_graph_replays": 1}
    assert trace_report(3, {"spans": spans, "counters": graphs,
                            "device": {}}).endswith(
        "host_syncs 4.5 per step; solve graph captures 1, replays 1")
    graphs.update(outer_graph_captures=1, outer_graph_replays=2)
    assert trace_report(3, {"spans": spans, "counters": graphs,
                            "device": {}}).endswith(
        "solve graph captures 1, replays 1; outer graph captures 1, "
        "replays 2")
    assert trace_report(0, {"spans": [], "counters": {}, "device": {}}) == \
        "trace epoch 0: no step"


def test_train_cli_trace_flag(tmp_path, capsys):
    """cli.train --trace on a 32x32 toy scene: one line per epoch with
    every step span, the host syncs and the solve's counts; the recorder
    is read and cleared at the epoch's end."""
    from selfreconcode_tpu_torch.cli import train as cli
    from selfreconcode_tpu_torch.data.dataset import make_synthetic_scene

    scene = tmp_path / "scene"
    make_synthetic_scene(str(scene), n_frames=4, H=32, W=32)
    conf = open(osp.join(osp.dirname(__file__), "..", "configs",
                         "config.conf")).read()
    conf = conf.replace("initial_iters = -1200", "initial_iters = -30")
    (tmp_path / "c.conf").write_text(conf)

    def tune(tr):
        tr.override_stage(sample_pix=16, eik_tmp=128, anchor_sub=256,
                          surf_iters=SURF_ITERS)

    cli.main(["--conf", str(tmp_path / "c.conf"), "--data", str(scene),
              "--save-folder", "rec", "--toy-smpl", "--max-epochs", "0",
              "--device", "cpu", "--trace"], resolutions=RES,
             skinner_res=(17, 29, 9), tune=tune)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("trace epoch")]
    assert len(lines) == 1 and lines[0].startswith("trace epoch 0 (1 steps")
    for name in STEP_SPANS + ("remesh", "host_syncs", "solve_converged"):
        assert f" {name} " in lines[0], name
    assert len(lines[0].split("solve_converged ")[1].split()) == \
        SURF_ITERS + 1
    assert trace.read_and_clear()["spans"] == []
    assert not cli.parse_args(["--conf", "c", "--data", "d",
                               "--save-folder", "s"]).trace
