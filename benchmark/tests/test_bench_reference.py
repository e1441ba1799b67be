"""The reference against the port at a tiny size on the CPU, and the
comparison shown to fail: the control (the reference in TF32 in the
program's place) and each fault a training cell can have, planted under a
run that skips only the harness's look for a card."""
import dataclasses

import pytest
import torch

from .conftest import tiny_cell

SEED = 2 ** 33 + 7


@pytest.fixture(scope="module")
def fine_run():
    """One tiny run of tight-fine-1080 with the control and the half-batch
    fault read beside it."""
    from benchmark.calibrate import control_variants
    from benchmark.run import run_cell
    cell = tiny_cell("tight-fine-1080")
    variants = control_variants(cell)
    return cell, run_cell(cell, SEED, 1.0, False, device="cpu",
                          variants=variants)


def test_reference_follows_the_port(fine_run):
    cell, (result, rows, _) = fine_run
    values = {k: v for k, v, _ in rows}
    assert result["correct"] and result["attempted"] > 0
    # the same code on one device: the set-up stages agree bit for bit
    assert values["skinner_gap"] == 0.0 and values["igr_miss"] == 0.0
    assert values["remesh_gap"] == 0.0 and values["template_gap"] == 0.0
    # the steps differ by the splat's summation order only
    assert values["loss_gap"] < 1e-5 and values["grad_gap"] < 1e-4


@pytest.mark.parametrize("variant", ["tf32", "half_batch"])
def test_control_and_half_batch_fail(fine_run, variant):
    from benchmark.correctness import judge
    cell, (_, _, other) = fine_run
    correct, _ = judge(other[variant], cell.limits)
    assert not correct


def _unchanged(session):
    """A step that returns its state unchanged: every leaf and the template
    as they were before it."""
    from benchmark.session import leaves
    tr = session.trainer
    make = tr._get_step_fn

    def get():
        real = make()

        def step(bank, tmp, *args):
            keep = {k: v.detach().clone() for k, v in leaves(tr).items()}
            _, info = real(bank, tmp, *args)
            with torch.no_grad():
                for k, v in leaves(tr).items():
                    v.copy_(keep[k])
            return tmp, info
        return step
    tr._get_step_fn = get


def _half_batch(session):
    """Half of each step's rays left out, the means taken over the rest."""
    tr = session.trainer
    cfg = tr.stage_cfg
    tr.override_stage(weights=dataclasses.replace(
        cfg.weights, sample_pix_num=cfg.rays() // cfg.N // 2))


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_planted_fault_makes_the_run_incorrect(fault):
    from benchmark.run import run_cell
    cell = tiny_cell("tight-fine-1080")
    result, _, _ = run_cell(cell, SEED + 1, 0.5, False, device="cpu",
                            tune=fault)
    assert result["correct"] is False


def test_window_remesh_is_checked():
    """tight-coarse-1080 with a remesh every 4 steps: the window's last
    remesh is compared with the reference's of the same SDF and box."""
    from benchmark.run import run_cell
    cell = tiny_cell("tight-coarse-1080")
    cell.config["conf"]["train"]["coarse"]["point_render"][
        "remesh_intersect"] = 4
    result, rows, _ = run_cell(cell, SEED + 2, 3.0, False, device="cpu")
    assert result["attempted"] >= 2 and result["correct"]
    values = dict((k, v) for k, v, _ in rows)
    assert values["remesh_gap"] == 0.0 and values["template_gap"] == 0.0


def _midpoint(real):
    """Marching cubes that puts each crossing at its edge's midpoint (a
    wrong edge interpolation: the same crossings, so the same counts)."""
    def mc(vol, origin, spacing, iso):
        return real(torch.where(vol < iso, -torch.ones_like(vol),
                                torch.ones_like(vol)), origin, spacing, 0.0)
    return mc


def _shifted(real):
    """Marching cubes whose vertices sit a quarter cell off (a wrong sweep
    box transform: the same counts)."""
    def mc(vol, origin, spacing, iso):
        out = real(vol, origin, spacing, iso)
        off = 0.25 * torch.as_tensor(spacing, dtype=out.verts.dtype,
                                     device=out.verts.device)
        return out._replace(verts=out.verts + off)
    return mc


@pytest.mark.parametrize("fault", [_midpoint, _shifted])
def test_planted_remesh_fault_makes_the_run_incorrect(fault, monkeypatch):
    """The program's template made wrong underneath its remesh, with its
    vertex and face counts kept: template_gap fails it."""
    import selfreconcode_tpu_torch.engine.trainer as trainer
    from benchmark.run import run_cell
    monkeypatch.setattr(trainer, "marching_cubes",
                        fault(trainer.marching_cubes))
    cell = tiny_cell("tight-fine-1080")
    result, rows, _ = run_cell(cell, SEED + 3, 0.5, False, device="cpu")
    values = {k: (v, lim) for k, v, lim in rows}
    assert values["remesh_gap"][0] == 0.0
    assert values["template_gap"][0] > values["template_gap"][1]
    assert result["correct"] is False


@pytest.mark.cuda
def test_control_at_the_cells_size(cuda_device):
    """On the card: one seed of tight-fine-1080 at its own size; the
    program passes and the control and the half-batch fault fail."""
    from benchmark.calibrate import control_variants
    from benchmark.cell import load_cell
    from benchmark.correctness import judge
    from benchmark.run import run_cell
    cell = load_cell("tight-fine-1080")
    result, _, other = run_cell(cell, SEED, 0.0, False, device=cuda_device,
                                variants=control_variants(cell))
    assert result["correct"]
    assert not any(judge(v, cell.limits)[0] for v in other.values())
