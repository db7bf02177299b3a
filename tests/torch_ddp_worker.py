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
prints `SHARD <rank> <world>` and, for train, `STEPS <updates>`.
"""

import json
import os
import sys

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


def build_trainer(kind, ckpt_dir, visualize=True, device="cpu", **overrides):
    """The FS (dropout 0.1, RandAugment on) or FT (ViT-T/8@32 full
    fine-tune with prompt tuning, RandAugment on) trainer at global batch
    8, lr 1e-3 for every group, one epoch of STEPS[kind] steps, eval and
    save at its end; random towers and fixed random text features.
    `overrides` set further config keys."""
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
                            text_feats=feats, smoke=True, device=device)


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


def run_cli(name, argv):
    from eventclip_tpu_torch.parallel import distributed as D

    torch.set_num_threads(2)
    if name == "train":
        from eventclip_tpu_torch.cli import train

        trainer = train.main(argv)
        print(f"STEPS {trainer.optimizer.count}")
    else:
        from eventclip_tpu_torch.cli import gen_data

        gen_data.main(argv)
    print("SHARD {} {}".format(*D.host_shard_info()), flush=True)
    D.shutdown_distributed()


if __name__ == "__main__":
    if sys.argv[4] in ("train", "gen_data"):
        run_cli(sys.argv[4], sys.argv[5:])
    else:
        main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
             sys.argv[4])
