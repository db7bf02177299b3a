"""The reference against the port on the CPU at a tiny tower (ViT-T/8@32,
float32): the cell's comparison passes, and fails when one layer of the
timed path is perturbed or one of the faults a serving cell can have is
planted underneath it. The reference's answers spread across recordings
by far more than bfloat16 moves them, so a comparison can fail at all."""

import time

import numpy as np
import pytest
import torch

from portbench import core, faults, run
from portbench.tests.tiny import tiny_cell

SEED = 2 ** 32 + 17


def run_tiny(seconds=0.4, cell=None, seed=SEED):
    res = run.run(cell or tiny_cell(), seed, seconds, False,
                  torch.device("cpu"), time.time(), log=lambda m: None)
    return res, {c.name: c for c in res["checks"]}


def test_tiny_cell_is_correct_and_its_answers_spread(monkeypatch):
    seen = {}
    drv = core.load_driver(tiny_cell())
    orig = drv.check

    def check(state, win, log):
        out = orig(state, win, log)
        seen.update(state.gaps)
        return out
    monkeypatch.setattr(drv, "check", check)
    res, checks = run_tiny()
    assert res["correct"], [c.line() for c in checks.values()]
    assert res["failed"] == 0 and res["attempted"] >= 1
    for gap in checks.values():
        assert gap.value < gap.limit / 10
    # the answers of two recordings lie far farther apart than bfloat16
    # moves an answer
    assert seen["spread_median"] > 10 * seen["bf16_median"]


def _shift_windows(orig):
    def f(*a, **k):
        wins, valid = orig(*a, **k)
        wins = wins.copy()
        wins[..., 0] += (wins[..., 2] != 0).astype(wins.dtype)
        return wins, valid
    return f


def _drop_negative(orig):
    def f(windows, h, w):
        out = orig(windows, h, w).clone()
        out[:, 1] = 0
        return out
    return f


def _offset(orig):
    return lambda pp, frames: orig(pp, frames) + 0.01


def _gelu(orig):
    return lambda x: x * torch.sigmoid(1.6 * x)


def _scaled_attention(orig):
    return lambda qkv, heads, mask=None: orig(qkv, heads, mask) * 1.01


def _tempered(orig):
    return lambda logits, valid: orig(logits * 1.01, valid)


LAYERS = {
    "host windowing": ("eventclip_tpu_torch.serve.gather_event_windows",
                       _shift_windows),
    "K1 histogram": ("eventclip_tpu_torch.ops.rasterize.histograms",
                     _drop_negative),
    "frames to CLIP inputs":
        ("eventclip_tpu_torch.ops.rasterize.preprocess_frames_chw", _offset),
    "encoder MLP": ("eventclip_tpu_torch.models.clip.model.quick_gelu",
                    _gelu),
    "K2 attention":
        ("eventclip_tpu_torch.models.clip.model.fused_qkv_attention",
         _scaled_attention),
    "ZS head": ("eventclip_tpu_torch.models.classifier.aggregate_probs",
                _tempered),
}


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_a_perturbed_layer_fails(monkeypatch, layer):
    import importlib

    target, wrap = LAYERS[layer]
    mod_name, attr = target.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    res, checks = run_tiny(0.3)
    assert not res["correct"]
    assert any(c.value > c.limit for c in checks.values())


# -- the faults a serving cell can have (one card: no exchange between
# cards to leave out) ------------------------------------------------------


@pytest.mark.parametrize("fault", ["stale", "half", "rotated", "altered"],
                         ids=["state unchanged", "half the batch",
                              "answers rotated", "answers altered"])
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, fault):
    from eventclip_tpu_torch.serve import Predictor

    faults.FAULTS[fault](monkeypatch.setattr, Predictor)
    res, checks = run_tiny(0.3)
    assert not res["correct"], [c.line() for c in checks.values()]


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 32 + 9, 3 * 2 ** 31 + 1])
def test_half_the_batch_fails_at_the_cells_sampling_and_limit(monkeypatch,
                                                              seed):
    """Half of each 32-stream request answered by the mean of the other
    half, checked as the cell checks: its number of draws from requests of
    its batch, against its own limit. The compared number reaches every
    drawn stream, so the fault fails on every seed, not only where the
    draws fall mostly in the bad half."""
    from eventclip_tpu_torch.serve import Predictor

    full = core.find_cell(core.load_bench(), "zs_ncaltech.batch32")
    cell = tiny_cell()
    cell.traffic = dict(cell.traffic, batch=full.traffic["batch"],
                        copies=1, events=dict(cell.traffic["events"],
                                              levels=full.traffic["batch"]),
                        check=full.traffic["check"])
    cell.config = dict(cell.config, limits=full.config["limits"])
    faults.half(monkeypatch.setattr, Predictor)
    res, checks = run_tiny(2.0, cell, seed)
    draws = full.traffic["check"]["streams"]
    assert res["attempted"] * full.traffic["batch"] >= draws
    assert not res["correct"], [c.line() for c in checks.values()]
