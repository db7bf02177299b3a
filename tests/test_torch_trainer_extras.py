"""The trainer's extras on one CPU process, against the JAX trainer.

- Metrics lines carry `run_id` and keep the JAX trainer's keys in its
  order (eventclip_tpu/engine/trainer.py:573 train, :638 val, :596-598
  preempt; `stats` is the step's metrics, then epoch, steps,
  sec_per_epoch, samples_per_sec, :562-567), and `run_id.txt` holds
  `<ckpt dir name>-<SLURM_JOB_ID>` (:381-408). A JAX fit of the same tiny
  config compiles for longer than this file's budget, so the keys are
  written out here, with those lines cited.
- `utils.viz.visualize_samples` writes the same captions.json and GIF
  frames as the JAX one (raw events through each package's
  ops/numpy_ref.py) on the same numpy probabilities and inputs.
- A SIGTERM mid-epoch in a subprocess finishes the epoch, forces the
  boundary save, logs a `preempt` line and ends the process by the
  signal; the resumed run reaches the uninterrupted run's parameters bit
  for bit (CPU, the same seeds). EVENTCLIP_PREEMPT_EXIT=0 returns
  instead.
- `cli.train --profile 2` writes a torch.profiler trace of 2 steps.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import torch
from PIL import Image

from eventclip_tpu.data.event_windows import \
    EventWindowDataset as RefEventWindowDataset
from eventclip_tpu.utils import viz as ref_viz
from eventclip_tpu_torch.data.event_windows import EventWindowDataset
from eventclip_tpu_torch.engine.checkpoint import trainable_flat
from eventclip_tpu_torch.utils import viz

from . import torch_ddp_worker as W
from .test_torch_loader import QUANT, StubEvents

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = os.path.join(ROOT, "configs", "debug", "fsclip_tiny_params.py")
STEP_KEYS = ["ce_loss", "total_loss", "train_acc"]
TRAIN_KEYS = (["run_id", "split"] + STEP_KEYS
              + ["epoch", "steps", "sec_per_epoch", "samples_per_sec"])
VAL_KEYS = ["run_id", "split", "epoch", "probs_acc", "logits_acc", "ce_loss",
            "n"]
PREEMPT_KEYS = ["run_id", "split", "epoch", "signal"]


def lines(path):
    return [json.loads(ln) for ln in open(path)]


def test_metrics_lines_run_id_and_viz(tmp_path, monkeypatch):
    monkeypatch.setenv("SLURM_JOB_ID", "4242")
    d = tmp_path / "fs"
    trainer = W.build_trainer("fs", str(d), max_epochs=2, n_samples=2)
    trainer.fit(san_check_val_step=1)
    assert open(d / "run_id.txt").read() == "fs-4242\n"
    recs = lines(d / "metrics.jsonl")
    assert [r["split"] for r in recs] == ["val", "train", "val", "train",
                                          "val"]
    for r in recs:
        assert r["run_id"] == "fs-4242"
        assert list(r) == (TRAIN_KEYS if r["split"] == "train" else VAL_KEYS)
    # the full evals (not the sanity one) wrote GIFs of 2 val items
    assert sorted(os.listdir(d / "viz")) == ["epoch_0", "epoch_1"]
    for epoch in (0, 1):
        assert sorted(os.listdir(d / "viz" / f"epoch_{epoch}")) == [
            "captions.json", "raw_events_0.gif", "raw_events_1.gif",
            "video_0.gif", "video_1.gif"]
    assert trainer.viz_forwards == (2, 2)
    caps = json.load(open(d / "viz" / "epoch_1" / "captions.json"))
    assert [len(c["top3"]) for c in caps] == [3, 3]


def gif_frames(path):
    img = Image.open(path)
    frames = []
    for i in range(img.n_frames):
        img.seek(i)
        frames.append(np.asarray(img.convert("RGB")))
    return np.stack(frames)


def test_visualize_samples_equals_jax(tmp_path):
    """Both packages' visualize_samples on the same items, probabilities
    (a numpy function of the windows) and model inputs."""
    def probs_fn(windows, valid):
        s = np.asarray(windows, np.float64).sum(axis=(2, 3))  # [1, V]
        z = np.sin(np.arange(4)[None] * 0.7 + (s * valid).sum(1)[:, None]
                   * 1e-4)
        return np.exp(z) / np.exp(z).sum(-1, keepdims=True)

    def inputs_fn(windows, valid):
        V = windows.shape[1]
        base = np.asarray(windows[..., :1, :1], np.float32).sum(-1)
        return np.sin(np.arange(V * 3 * 16 * 16, dtype=np.float32)
                      .reshape(1, V, 3, 16, 16) + base[..., None, None]
                      * 1e-3)

    out = {}
    for tag, ds_cls, mod in (("port", EventWindowDataset, viz),
                             ("jax", RefEventWindowDataset, ref_viz)):
        ds = ds_cls(StubEvents(n=11, seed=2), QUANT, seed=5)
        recs = mod.visualize_samples(ds, probs_fn, str(tmp_path / tag),
                                     n_samples=3, inputs_fn=inputs_fn)
        assert ds.keep_events is False
        out[tag] = recs
    assert out["port"] == out["jax"] and len(out["port"]) == 3
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert open(tmp_path / "port" / "captions.json").read() == \
        open(tmp_path / "jax" / "captions.json").read()
    for name in names:
        if name.endswith(".gif"):
            np.testing.assert_array_equal(
                gif_frames(tmp_path / "port" / name),
                gif_frames(tmp_path / "jax" / name), err_msg=name)
    assert viz.sample_indices(5, 11).tolist() == \
        ref_viz.sample_indices(5, 11).tolist()
    img = np.random.default_rng(0).normal(size=(2, 3, 4, 5))
    np.testing.assert_array_equal(viz.denormalize(img),
                                  ref_viz.denormalize(img))


PREEMPTED = textwrap.dedent("""
    import os, signal, sys
    from tests.torch_ddp_worker import build_trainer
    t = build_trainer("fs", sys.argv[1], visualize=False, max_epochs=2,
                      save_interval=5)
    step, calls = t.train_step, [0]

    def step_then_signal(batch):
        calls[0] += 1
        if calls[0] == 2:  # mid-epoch 0 (3 steps an epoch)
            os.kill(os.getpid(), signal.SIGTERM)
        return step(batch)

    t.train_step = step_then_signal
    t.fit(san_check_val_step=0)
    print("fit returned")
""")


def test_sigterm_mid_epoch_saves_and_resumes(tmp_path):
    d = tmp_path / "preempted"
    # the child runs on as many threads as this process: its epoch 0
    # must sum in the same order as the uninterrupted run's
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS=str(torch.get_num_threads()))
    res = subprocess.run([sys.executable, "-c", PREEMPTED, str(d)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == -signal.SIGTERM, res.stdout + res.stderr
    assert "fit returned" not in res.stdout
    assert "[preempt] saved epoch 1" in res.stdout
    # epoch 0 ran to its end, then the forced save (save_interval 5)
    assert sorted(os.listdir(d / "models")) == ["best.npz", "model_3.npz",
                                                "resume.pt"]
    recs = lines(d / "metrics.jsonl")
    assert [r["split"] for r in recs] == ["train", "val", "preempt"]
    assert list(recs[2]) == PREEMPT_KEYS
    assert recs[2]["epoch"] == 0 and recs[2]["signal"] == signal.SIGTERM

    resumed = W.build_trainer("fs", str(d), visualize=False, max_epochs=2,
                              save_interval=5)
    resumed.fit(san_check_val_step=0)
    whole = W.build_trainer("fs", str(tmp_path / "whole"), visualize=False,
                            max_epochs=2, save_interval=5)
    whole.fit(san_check_val_step=0)
    assert resumed.optimizer.count == whole.optimizer.count == 6
    got = trainable_flat(resumed.cls_cfg, resumed.model_params)
    want = trainable_flat(whole.cls_cfg, whole.model_params)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    recs = lines(d / "metrics.jsonl")
    assert [r["split"] for r in recs][3:] == ["train", "val"]
    assert len({r["run_id"] for r in recs}) == 1


def test_preempt_exit_0_returns(tmp_path, monkeypatch):
    monkeypatch.setenv("EVENTCLIP_PREEMPT_EXIT", "0")
    t = W.build_trainer("fs", str(tmp_path), visualize=False, max_epochs=2)
    step = t.train_step

    def step_then_signal(batch):
        os.kill(os.getpid(), signal.SIGUSR1)
        return step(batch)

    t.train_step = step_then_signal
    t.fit(san_check_val_step=0)
    assert t.optimizer.count == 3  # stopped after epoch 0
    recs = lines(tmp_path / "metrics.jsonl")
    assert recs[-1]["split"] == "preempt"
    assert recs[-1]["signal"] == signal.SIGUSR1
    assert signal.getsignal(signal.SIGUSR1) is signal.SIG_DFL


def test_profile_flag_writes_a_trace(tmp_path):
    from eventclip_tpu_torch.cli import train as cli_train

    from .test_e2e import make_tree

    tree = make_tree(str(tmp_path / "tree"))
    trainer = cli_train.main([
        "--params", FS, "--cpu", "--data_root", tree, "--max_epochs", "1",
        "--san_check_val_step", "0", "--profile", "2",
        "--ckpt_base", str(tmp_path / "ckpt")])
    trace = trainer.profile_trace
    assert trace["steps"] == 2 and trace["bytes"] > 0
    # 4 steps an epoch: 2 warm-up steps, then steps 2 and 3 traced
    assert trace["path"] == str(tmp_path / "ckpt" / "fsclip_tiny_params" /
                                "profile" / "trace_epoch0_steps2-3.json")
    events = json.load(open(trace["path"]))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
