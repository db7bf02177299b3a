"""One rank of the port's data-parallel tests (imports no JAX).

    python -m tests.torch_ddp_worker <rank> <world> <port> <out dir>
    python -m tests.torch_ddp_worker <rank> <world> <port> train|gen_data \
        <CLI arguments>

Joins a gloo process group on localhost:<port>, runs the host collectives
(`any_process_flag`, `allreduce_max_array`, `gather_objects`) and then,
through `EventCLIPTrainer.fit`, 3 FS steps (ViT-T/8@32, text-trans
adapter with its dropout, RandAugment) and 2 FT steps, each followed by a
packed eval with a ragged last batch and a boundary save. Each trainer's
ckpt_dir is `<out>/<kind>_rank<r>`; what the rank computed goes to
`<out>/rank<r>_<kind>.npz` (trainable leaves),
`<out>/rank<r>_<kind>_eval.npz` (each eval batch's per-sample logits and
probs, `evaluate_rows`) and `<out>/rank<r>.json` (collectives, eval
stats). `build_trainer` also builds the one-process
run on the global batch that tests/test_torch_parallel.py holds it to.

The second form runs the port's train or gen_data CLI in-process, as a
launcher's rank would (the coordination env comes from the caller), then
prints `SHARD <rank> <world>` and, for train, `STEPS <updates>`;
`clis <json>` runs a list of [name, argv] CLIs (train, test) in turn,
and its SHARD line is the test CLI's (data index, data groups).

    python -m tests.torch_ddp_worker <rank> <world> <port> tp <dir>

runs the tensor-parallel and ZeRO-1 cases of tests/test_torch_tp.py
(`tp_cases`): their configs, trees and global batches come from
`<dir>/cases.json` and `<dir>/inputs.npz`; rank 0 writes what the ranks
computed to `<dir>/<case>.npz` and `<dir>/<case>.json`.
"""

import gc
import json
import os
import sys
import weakref

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL_BATCH = 8
STEPS = {"fs": 3, "ft": 2}
N_VAL = 10  # val batches of 4: the last holds 2, all on rank 0


class Quadrants:
    """4 classes, each a blob of events in its own quadrant of a 40x48
    sensor; item idx is made from (seed, idx)."""

    resolution = (40, 48)
    max_t = 0.1
    max_n = 2000
    augmentation = False
    num_shots = None
    root = "quadrants"

    def __init__(self, n, seed):
        self.n, self.seed = n, seed
        self.classes = [f"c{i}" for i in range(4)]

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        from eventclip_tpu_torch.data.host_ops import prepare_stream

        rng = np.random.default_rng((self.seed, idx))
        label, (H, W) = idx % 4, self.resolution
        n = int(rng.integers(1200, 2000))
        cy, cx = 10 + 20 * (label // 2), 12 + 24 * (label % 2)
        ev = np.stack([
            np.floor(np.clip(rng.normal(cx, 4, n), 0, W - 1)),
            np.floor(np.clip(rng.normal(cy, 4, n), 0, H - 1)),
            np.sort(rng.uniform(0, self.max_t, n)),
            rng.choice([-1.0, 1.0], n)], 1).astype(np.float32)
        return {"events": prepare_stream(ev, self.resolution),
                "label": label, "data_idx": idx}


def build_trainer(kind, ckpt_dir, visualize=True, device="cpu", n_model=1,
                  **overrides):
    """The FS (dropout 0.1, RandAugment on) or FT (ViT-T/8@32 full
    fine-tune with prompt tuning, RandAugment on) trainer at global batch
    8, lr 1e-3 for every group, one epoch of STEPS[kind] steps, eval and
    save at its end; random towers and fixed random text features.
    `overrides` set further config keys; `n_model` > 1 runs it
    tensor-parallel over the process group."""
    from eventclip_tpu_torch.data.event_windows import EventWindowDataset
    from eventclip_tpu_torch.engine.trainer import EventCLIPTrainer
    from eventclip_tpu_torch.models.classifier import normalize
    from eventclip_tpu_torch.utils.config import load_params

    if kind == "fs":
        params = load_params(os.path.join(ROOT, "configs", "debug",
                                          "fsclip_tiny_params.py"))
        params.adapter_dict = dict(params.adapter_dict, dropout=0.1)
    else:
        params = load_params(os.path.join(
            ROOT, "configs", "ftclip", "ft_text_fsclip_nin_params.py"))
        params.clip_dict = dict(params.clip_dict, arch="ViT-T/8@32")
        params.dataset = "n_caltech"
        params.quantize_args = load_params(os.path.join(
            ROOT, "configs", "debug", "fsclip_tiny_params.py")).quantize_args
    params.train_batch_size = GLOBAL_BATCH
    params.val_batch_size = 4
    params.num_workers = 2
    params.max_epochs = 1
    params.eval_interval = 1
    params.bf16 = False
    params.img_aug = True
    # updates of about lr every step, from the first (no warm-up)
    params.lr = params.clip_lr = 1e-3
    params.warmup_steps_pct = 0.0
    params.visualize = visualize
    for k, v in overrides.items():
        setattr(params, k, v)
    q = dict(params.quantize_args)
    train = EventWindowDataset(Quadrants(GLOBAL_BATCH * STEPS[kind], 0), q,
                               augment=True)
    val = EventWindowDataset(Quadrants(N_VAL, 1), dict(q, max_imgs=10))
    feats = normalize(torch.randn(4, 32, generator=torch.Generator()
                                  .manual_seed(3))).to(device)
    return EventCLIPTrainer(params, train, val, ckpt_dir,
                            log_file=os.path.join(ckpt_dir, "metrics.jsonl"),
                            text_feats=feats, smoke=True, device=device,
                            n_model=n_model)


def evaluate_rows(trainer):
    """`trainer.evaluate()` that also records, for every eval batch, the
    aggregated logits and probs of its real samples (sample_mask) as
    numpy [n_real, classes] arrays. Returns (stats, logits, probs): lists
    with one array a batch, in loader order, so two ranks' lists
    concatenated batch by batch in rank order give one process's rows."""
    from eventclip_tpu_torch.engine import train as T

    names = ("classifier_forward", "classifier_forward_packed")
    saved = {n: getattr(T, n) for n in names}
    last, logits, probs = [], [], []

    def recording(f):
        def forward(*a, **k):
            out = f(*a, **k)
            last.append(out)
            return out
        return forward

    step = trainer.eval_step

    def eval_step(batch):
        res = step(batch)
        out, m = last.pop(), batch["sample_mask"].bool()
        logits.append(out["logits"][m].float().cpu().numpy())
        probs.append(out["probs"][m].float().cpu().numpy())
        return res

    for n in names:
        setattr(T, n, recording(saved[n]))
    trainer.eval_step = eval_step
    try:
        stats = trainer.evaluate()
    finally:
        trainer.eval_step = step
        for n in names:
            setattr(T, n, saved[n])
    return stats, logits, probs


def main(rank, world, port, out):
    from eventclip_tpu_torch.engine.checkpoint import trainable_flat
    from eventclip_tpu_torch.parallel import distributed as D

    torch.set_num_threads(2)
    D.initialize_distributed(f"localhost:{port}", world, rank,
                             backend="gloo", device="cpu")
    res = {"shard": list(D.host_shard_info()),
           "flag_any": D.any_process_flag(rank == 1),
           "flag_none": D.any_process_flag(False),
           "amax": D.allreduce_max_array(
               np.array([rank, -rank, 3 - 2 * rank], np.float32)).tolist(),
           "objects": D.gather_objects({"rank": rank, "items": [rank] * rank})}
    for kind in STEPS:
        trainer = build_trainer(kind, os.path.join(out, f"{kind}_rank{rank}"))
        trainer.fit(san_check_val_step=0)
        stats, logits, probs = evaluate_rows(trainer)
        res[kind] = {"count": trainer.optimizer.count, "eval": stats,
                     "local_batch": trainer.train_loader.local_batch}
        np.savez(os.path.join(out, f"rank{rank}_{kind}_eval.npz"),
                 **{f"logits{i}": x for i, x in enumerate(logits)},
                 **{f"probs{i}": x for i, x in enumerate(probs)})
        np.savez(os.path.join(out, f"rank{rank}_{kind}.npz"),
                 **trainable_flat(trainer.cls_cfg, trainer.model_params))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    D.shutdown_distributed()


# the tiny towers of tests/test_torch_train.py
TINY = dict(
    vision=dict(image_size=32, patch_size=8, width=64, layers=2, heads=2,
                output_dim=32),
    text=dict(vocab_size=128, context_length=16, width=32, layers=2, heads=2,
              output_dim=32))
N_CLS = 5
LR, CLIP_LR = 1e-3, 1e-4


def tiny_cfg(dtype="float32", **kw):
    """The port's FT ClassifierConfig on the TINY towers."""
    from eventclip_tpu_torch.models import classifier
    from eventclip_tpu_torch.models.clip import config

    clip = config.CLIPConfig(name="tiny",
                             vision=config.VisionConfig(**TINY["vision"]),
                             text=config.TextConfig(**TINY["text"]))
    kw = {"model": "FTCLIP", **kw}
    if isinstance(kw.get("adapter"), dict):
        kw["adapter"] = classifier.AdapterConfig(**kw["adapter"])
    return classifier.ClassifierConfig(clip=clip, dtype=getattr(torch, dtype),
                                       **kw)


def tiny_run(case, tree, batches, ckpt_dir=None):
    """One case on this rank's layout: the port's classifier from the JAX
    `tree` ({JAX path: array}), cut by shard_params, `case['steps']`
    updates on this data rank's rows of each global batch, the trained
    state written to `ckpt_dir`'s resume.pt after the first when given.
    Returns (whole leaves after each step, whole gradients of the first
    step, metrics, eval rows of the first batch, moment bytes)."""
    from eventclip_tpu_torch.engine.checkpoint import CheckpointManager
    from eventclip_tpu_torch.engine.optim import OptimConfig, Optimizer
    from eventclip_tpu_torch.engine.train import make_train_step
    from eventclip_tpu_torch.models import classifier
    from eventclip_tpu_torch.models.clip.convert import (port_leaves,
                                                         to_jax_flat)
    from eventclip_tpu_torch.parallel import distributed as D
    from eventclip_tpu_torch.parallel.sharding import (full_tensors,
                                                       make_mesh,
                                                       model_placements,
                                                       shard_params)

    cfg = tiny_cfg(**case["cfg"])
    mesh = make_mesh(case["n_model"])
    tp = mesh if mesh.n_model > 1 else None
    params = classifier.init_classifier_params(
        cfg, torch.Generator().manual_seed(0), n_classes=N_CLS)
    params.load_state_dict({n: torch.from_numpy(np.array(a)) for k, v in
                            tree.items() for n, a in port_leaves(k, v)},
                           strict=True)
    shard_params(params, tp)
    opt = Optimizer(cfg, OptimConfig(
        lr=LR, clip_lr=CLIP_LR, total_steps=10, warmup_steps_pct=0.0,
        grad_clip=case.get("grad_clip", 0.0)), params,
        zero1=case.get("zero1", False))
    step = make_train_step(cfg, params, opt, loss_weights={"ce_loss": 1.0},
                           accum_steps=case.get("accum", 1))
    d, n_data = D.host_shard_info(tp)
    pls = model_placements(params)

    def local(b):
        rows = b["label"].shape[0] // n_data
        return {k: torch.from_numpy(v[d * rows:(d + 1) * rows])
                for k, v in b.items()}

    def whole(named):  # copies: a CPU leaf's numpy shares its storage
        return {k: np.array(v) for k, v in
                to_jax_flat(full_tensors(list(named), pls, tp)).items()}

    with torch.inference_mode():
        out = classifier.classifier_forward(
            params, cfg, local(batches[0])["img"],
            local(batches[0])["valid_mask"], tp=tp)
        rows = {k: out[k].numpy().copy()
                for k in ("view_feats", "logits", "probs")}
    leaves, grads, metrics = [], None, []
    for i in range(case["steps"]):
        m = step(local(batches[i]))
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = whole((n, p.grad) for n, p in params.named_parameters()
                          if p.grad is not None)
        leaves.append(whole(params.named_parameters()))
        if i == 0 and ckpt_dir:
            CheckpointManager(ckpt_dir, cfg).save_resume_state(params, opt,
                                                               1)
    # zero_grad frees every gradient: nothing the optimizer keeps (a
    # ZeRO-1 slice's view) holds one alive into the next step
    refs = [weakref.ref(p.grad) for p in params.parameters()
            if p.grad is not None]
    opt.zero_grad()
    gc.collect()
    held = sum(r() is not None for r in refs)
    assert not held, f"{held} gradients outlived zero_grad"
    return leaves, grads, metrics, rows, opt.moment_bytes()


def tp_cases(rank, world, port, out):
    """Every case of `<out>/cases.json` on this rank (see the module
    docstring); a case's `bucket_bytes` sets the all-gathers' bucket."""
    from eventclip_tpu_torch.parallel import distributed as D
    from eventclip_tpu_torch.parallel import sharding

    torch.set_num_threads(1)
    D.initialize_distributed(f"localhost:{port}", world, rank,
                             backend="gloo", device="cpu")
    with open(os.path.join(out, "cases.json")) as f:
        cases = json.load(f)
    with np.load(os.path.join(out, "inputs.npz")) as z:
        inputs = dict(z)
    for name, case in cases.items():
        tree = {k[len(case["tree"]) + 1:]: v for k, v in inputs.items()
                if k.startswith(case["tree"] + "/")}
        batches = [{k: inputs[f"batch{i}/{k}"]
                    for k in ("img", "valid_mask", "label")}
                   for i in range(case["steps"])]
        ckpt = os.path.join(out, name) if case.get("resume") else None
        bucket = sharding.GATHER_BUCKET_BYTES
        sharding.GATHER_BUCKET_BYTES = case.get("bucket_bytes", bucket)
        try:
            leaves, grads, metrics, rows, mbytes = tiny_run(case, tree,
                                                            batches, ckpt)
        finally:
            sharding.GATHER_BUCKET_BYTES = bucket
        every = D.gather_objects((rows, mbytes))
        if rank == 0:
            arrays = {f"step{i}/{k}": v for i, lv in enumerate(leaves)
                      for k, v in lv.items()}
            arrays.update({f"grad/{k}": v for k, v in grads.items()})
            n_model = case["n_model"]
            for key in ("view_feats", "logits", "probs"):
                # model rank 0 of each data group, in data order
                arrays[f"rows/{key}"] = np.concatenate(
                    [every[r][0][key] for r in range(0, world, n_model)])
            np.savez(os.path.join(out, f"{name}.npz"), **arrays)
            with open(os.path.join(out, f"{name}.json"), "w") as f:
                json.dump({"metrics": metrics,
                           "moment_bytes": [e[1] for e in every]}, f)
    D.shutdown_distributed()


def run_clis(seq):
    """[[name, argv], ...]: each CLI (train, test, gen_data) in turn in
    this rank; train prints its updates."""
    import importlib

    from eventclip_tpu_torch.parallel import distributed as D

    torch.set_num_threads(2)
    shard = None
    for name, argv in seq:
        out = importlib.import_module(f"eventclip_tpu_torch.cli.{name}")\
            .main(argv)
        if name == "train":
            print(f"STEPS {out.optimizer.count}", flush=True)
        if name == "test":  # its data shard (the data group under TP)
            shard = out["ctx"]["shard"]
    print("SHARD {} {}".format(*(shard or D.host_shard_info())),
          flush=True)
    D.shutdown_distributed()


if __name__ == "__main__":
    if sys.argv[4] in ("train", "gen_data"):
        run_clis([[sys.argv[4], sys.argv[5:]]])
    elif sys.argv[4] == "clis":
        run_clis(json.loads(sys.argv[5]))
    elif sys.argv[4] == "tp":
        tp_cases(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                 sys.argv[5])
    else:
        main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
             sys.argv[4])
