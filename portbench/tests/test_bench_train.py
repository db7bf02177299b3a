"""The training cell on the CPU at a tiny tower (ViT-T/8@32, float32): the
reference follows the port's first three steps, and a run fails when one
of the faults a training cell can have is planted underneath it, or when
the reference in float8 e4m3 storage takes the program's place."""

import time

import numpy as np
import pytest
import torch

from portbench import core, faults_train, run
from portbench.reference import randaugment
from portbench.tests.tiny_train import tiny_train_cell

SEED = 2 ** 32 + 5
CPU = torch.device("cpu")


def quiet(msg):
    pass


def run_tiny(seconds=0.3, cell=None, seed=SEED):
    res = run.run(cell or tiny_train_cell(), seed, seconds, False, CPU,
                  time.time(), log=quiet)
    return res, {c.name: c for c in res["checks"]}


def readings(options=None, seed=SEED):
    cell = tiny_train_cell()
    drv = core.load_driver(cell)
    state = drv.setup(cell, seed, CPU, quiet, options=options)
    checks = drv.check(state, None, quiet)
    return state.gaps, {c.name: c for c in checks}


def test_reference_follows_the_ports_three_steps():
    gaps, checks = readings()
    assert all(c.ok for c in checks.values())
    # each step's loss: the same float32 sums, taken in other orders
    # (attention, the head's mean), agree to a few float32 ulps
    assert gaps["loss_gap"] < 1e-5
    np.testing.assert_allclose(gaps["losses"], gaps["ref_losses"],
                               rtol=1e-5)
    # step 1's gradients: float32 backward passes of the same forward
    # differ by summation order only, a few parts in a million of a leaf
    # in the norm and the median leaf's distance
    assert gaps["grad_norm_gap"] < 1e-4
    assert gaps["grad_dist_median"] < 1e-4
    assert set(checks) == {"grad_norm_gap", "change_norm_gap",
                           "change_dist_median"}
    # the change over three steps: Adam divides each gradient by its own
    # root mean square, so an element whose gradient is near Adam's eps
    # carries its rounding into the step at full size; the leaves' norms
    # still agree to a part in ten thousand
    assert gaps["change_norm_gap"] < 1e-3
    assert gaps["change_dist_median"] < 1e-3
    # the keys' biases get no gradient under softmax: left out by the rule,
    # one a block
    assert gaps["left_out"] == 2


def test_a_run_is_correct_and_counts_its_steps():
    res, checks = run_tiny()
    assert res["correct"], [c.line() for c in checks.values()]
    # the first step is due at the window's start: at least one runs
    assert res["failed"] == 0 and res["attempted"] >= 1
    rate = res["metrics"]["train_samples_per_s"]["value"]
    assert rate > 0
    for c in checks.values():
        assert c.value < c.limit / 10


@pytest.mark.parametrize("fault", sorted(faults_train.FAULTS))
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, fault):
    faults_train.FAULTS[fault](monkeypatch.setattr)
    res, checks = run_tiny()
    assert not res["correct"], [c.line() for c in checks.values()]


def test_a_fault_in_the_batches_placement_makes_the_run_incorrect(
        monkeypatch):
    """The checked steps take their batches through `adaptive_prefetch`,
    as `train_epoch` does: labels altered there reach the check."""
    from eventclip_tpu_torch.data import loader
    from eventclip_tpu_torch.engine import trainer

    prefetch = loader.adaptive_prefetch

    def altered(host, place, **kw):
        def put(batch):
            out = place(batch)
            out["label"] = (out["label"] + 1) % 10
            return out
        return prefetch(host, put, **kw)
    monkeypatch.setattr(loader, "adaptive_prefetch", altered)
    monkeypatch.setattr(trainer, "adaptive_prefetch", altered)
    res, checks = run_tiny()
    assert not res["correct"], [c.line() for c in checks.values()]


def test_a_step_that_leaves_its_state_unchanged_reads_one(monkeypatch):
    faults_train.stale(monkeypatch.setattr)
    gaps, _ = readings()
    assert gaps["grad_norm_gap"] == pytest.approx(1.0)
    assert gaps["change_norm_gap"] == pytest.approx(1.0)


def test_the_e4m3_control_fails_and_bf16_reads_between():
    ctrl, checks = readings({"storage": "e4m3"})
    assert any(not c.ok for c in checks.values()), ctrl
    bf16, _ = readings({"storage": "bf16"})
    prog, _ = readings()
    for k in ("loss_gap", "grad_norm_gap", "change_norm_gap"):
        assert prog[k] < bf16[k], (k, prog[k], bf16[k])


def test_a_non_finite_loss_counts_as_failed(monkeypatch):
    from eventclip_tpu_torch.engine import train
    from eventclip_tpu_torch.models.classifier import per_sample_ce

    calls = [0]

    def loss(cfg, out, labels):
        calls[0] += 1
        ce = per_sample_ce(cfg, out, labels).mean()
        return {"ce_loss": ce * float("nan") if calls[0] == 4 else ce}
    monkeypatch.setattr(train, "train_loss", loss)
    # the checked steps make three calls: the window's first step is 4
    res, _ = run_tiny()
    assert res["failed"] >= 1 and not res["correct"]


# -- the reference's RandAugment against worked values -----------------------


def test_randaugment_pixel_ops_keep_the_uint8_grid():
    g = torch.Generator().manual_seed(3)
    img = torch.randint(0, 256, (1, 12, 16), generator=g).float().expand(
        3, -1, -1).contiguous()
    for name in randaugment.OPS:
        for mag in (0.3, -0.3):
            m = {"Posterize": 5.0, "Solarize": 128.0}.get(name, mag)
            out = randaugment.apply_op(img, name, m)
            assert out.shape == img.shape
            assert torch.equal(out, out.round()), name
            assert out.min() >= 0 and out.max() <= 255, name
            assert torch.equal(out[0], out[1]), name  # grey stays grey
    assert torch.equal(randaugment.apply_op(img, "Solarize", 128.0),
                       torch.where(img >= 128, 255 - img, img))
    assert torch.equal(randaugment.apply_op(img, "Posterize", 4.0),
                       torch.floor(img / 16) * 16)


def test_randaugment_translate_moves_by_whole_pixels():
    img = torch.full((3, 8, 10), 255.0)
    img[:, 3, 4] = 0.0
    out = randaugment.apply_op(img, "TranslateX", 2.7)
    assert out[0, 3, 6] == 0.0 and out[0, 3, 4] == 255.0
    assert (out[:, :, :2] == 255.0).all()  # the white fill


def test_randaugment_draws_follow_the_seeding_contract():
    """The program's `sample_ops` and the reference's draws from one seed
    name the same ops and magnitudes."""
    from eventclip_tpu_torch.ops.randaugment import OP_NAMES, sample_ops

    ops, mags = sample_ops(torch.Generator().manual_seed(11), 64, 2, 480,
                           640)
    names, rmags = randaugment.draws(torch.Generator().manual_seed(11), 64,
                                     2, 480, 640)
    assert [[OP_NAMES[int(o)] for o in row] for row in ops] == names
    np.testing.assert_allclose(mags.numpy(), np.array(rmags), rtol=1e-6,
                               atol=1e-6)
