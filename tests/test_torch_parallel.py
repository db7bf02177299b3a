"""The port's data-parallel training (parallel/distributed.py, the sharded
loader, the all-reduced step) against one process, and its sharding
helpers against the JAX package's.

Two gloo ranks on the CPU (tests/torch_ddp_worker.py, spawned once for the
module, each with a 120 s limit) run the host collectives, 3 FS steps
(ViT-T/8@32, RandAugment and the adapter's dropout on) and 2 FT steps
through `EventCLIPTrainer.fit`, each with a packed eval whose last batch
leaves rank 1 no item, and a boundary save. One process on the same
global batches (`build_trainer` again, in this process) must give:

- the same trainable parameters, f32, atol 1e-6 (updates are about 1e-3
  a step). The key bias is the exception: softmax is shift-invariant in
  it, so its gradient is rounding noise, Adam's first update there is
  lr * sign(noise), and those elements are held only to differ by at
  most 2 * lr a step;
- the same eval counters (n and correct counts exact; the CE loss to
  rtol 1e-6) and the same per-sample eval logits and probs (each batch's
  rank rows in rank order, within 1e-5 of their largest value);
- the files: rank 1 writes none.

A single process is held to the JAX train step by tests/test_torch_train.py,
so the chain reaches JAX. The unit cases hold `PrefetchLoader`'s shard
slices (the ragged tail padded with every row masked), the sharded
`pack_view_batch` (a stub for the collective on both sides) and
`adaptive_prefetch` (on a fake clock) to the JAX functions.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from eventclip_tpu.data import loader as ref_loader
from eventclip_tpu_torch.data import loader
from eventclip_tpu_torch.engine.checkpoint import trainable_flat
from eventclip_tpu_torch.parallel import RowShard, distributed

from . import torch_ddp_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 120
ATOL = 1e-6
LR = 1e-3
ROWS_RTOL = 1e-5  # per-sample eval rows, relative to their largest value


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(module, args, world=2, env_of=None, timeout=SPAWN_TIMEOUT_S):
    """Run `python -m module <rank> <world> <port> *args` for every rank
    at once; kill them all and fail past `timeout` (a hung rendezvous).
    Returns each rank's (return code, output)."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
        if env_of is not None:
            env.update(env_of(rank, port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, str(rank), str(world), str(port),
             *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{module}: ranks did not finish within {timeout} s")
    return outs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ddp")
    for rc, log in spawn_ranks("tests.torch_ddp_worker", [str(out)]):
        assert rc == 0, log
    res = [json.load(open(out / f"rank{r}.json")) for r in (0, 1)]
    return out, res


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """{kind: (trainable leaves, eval stats, updates, each eval batch's
    per-sample logits and probs)} of one process on the same global
    batches."""
    out = {}
    for kind in W.STEPS:
        trainer = W.build_trainer(kind, str(tmp_path_factory.mktemp(kind)),
                                  visualize=False)
        trainer.fit(san_check_val_step=0)
        flat = {k: np.array(v) for k, v in
                trainable_flat(trainer.cls_cfg, trainer.model_params).items()}
        stats, logits, probs = W.evaluate_rows(trainer)
        out[kind] = (flat, stats, trainer.optimizer.count,
                     dict(logits=logits, probs=probs))
    return out


def key_bias(name, shape):
    """Mask of the key-bias elements of a fused qkv bias leaf."""
    mask = np.zeros(shape, bool)
    if name.endswith("attn/bqkv"):
        if len(shape) == 3:  # [L, 3, D]: the CLIP tower's stacked layout
            mask[:, 1] = True
        else:  # [L, 3D]: the adapter's
            d = shape[-1] // 3
            mask[:, d:2 * d] = True
    return mask


def test_collectives_over_two_ranks(two_ranks):
    _, res = two_ranks
    for rank, r in enumerate(res):
        assert r["shard"] == [rank, 2]
        assert r["flag_any"] is True and r["flag_none"] is False
        assert r["amax"] == [1.0, 0.0, 3.0]
        assert r["objects"] == [{"rank": 0, "items": []},
                                {"rank": 1, "items": [1]}]


@pytest.mark.parametrize("kind", list(W.STEPS))
def test_two_ranks_train_like_one_process(two_ranks, one_process, kind):
    out, res = two_ranks
    want, _, count, _ = one_process[kind]
    assert count == W.STEPS[kind]
    for rank in (0, 1):
        assert res[rank][kind]["count"] == count
        assert res[rank][kind]["local_batch"] == W.GLOBAL_BATCH // 2
        with np.load(out / f"rank{rank}_{kind}.npz") as z:
            got = dict(z)
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            noise = key_bias(name, w.shape)
            diff = np.abs(got[name] - w)
            assert diff[~noise].max(initial=0) <= ATOL, name
            assert diff[noise].max(initial=0) <= 2 * LR * count, name


@pytest.mark.parametrize("kind", list(W.STEPS))
def test_two_ranks_eval_counters_equal_one_process(two_ranks, one_process,
                                                    kind):
    _, res = two_ranks
    _, want, _, _ = one_process[kind]
    assert want["n"] == W.N_VAL
    for rank in (0, 1):
        got = res[rank][kind]["eval"]
        assert got["n"] == want["n"]
        for k in ("probs_acc", "logits_acc"):
            assert round(got[k] * got["n"]) == round(want[k] * want["n"]), k
        np.testing.assert_allclose(got["ce_loss"], want["ce_loss"],
                                   rtol=1e-6)


@pytest.mark.parametrize("kind", list(W.STEPS))
def test_two_ranks_eval_rows_equal_one_process(two_ranks, one_process, kind):
    """Each real sample's aggregated logits and probs, the ranks' rows of a
    batch concatenated in rank order, equal one process's rows. Random
    towers bring every sample's features close together, so the counters
    alone would hardly see a view mapped to another sample: the rows must
    agree to ROWS_RTOL of their scale, a tenth or less of the least distance
    between two samples' logits."""
    out, _ = two_ranks
    want = one_process[kind][3]
    got = []
    for rank in (0, 1):
        with np.load(out / f"rank{rank}_{kind}_eval.npz") as z:
            got.append(dict(z))
    for name in ("logits", "probs"):
        ranks = [np.concatenate([g[f"{name}{i}"] for g in got])
                 for i in range(len(want[name]))]
        assert len(got[0]) == 2 * len(want[name])
        w, g = np.concatenate(want[name]), np.concatenate(ranks)
        assert g.shape == w.shape == (W.N_VAL, 4), name
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=ROWS_RTOL * scale,
                                   err_msg=name)
    w = np.concatenate(want["logits"])
    sep = min(np.abs(w[i] - w[j]).max() for i in range(len(w))
              for j in range(i))
    assert sep > 10 * ROWS_RTOL * np.abs(w).max(), sep


def test_rank_one_writes_no_file(two_ranks):
    out, _ = two_ranks
    for kind, steps in W.STEPS.items():
        files = {os.path.relpath(os.path.join(dp, f), out / f"{kind}_rank1")
                 for dp, _, fs in os.walk(out / f"{kind}_rank1") for f in fs}
        assert files == set(), kind
        main = out / f"{kind}_rank0"
        files = {os.path.relpath(os.path.join(dp, f), main)
                 for dp, _, fs in os.walk(main) for f in fs}
        assert files == {"run_id.txt", "metrics.jsonl", "models/best.npz",
                         f"models/model_{steps}.npz", "models/resume.pt"}
        rid = open(main / "run_id.txt").read().strip()
        lines = [json.loads(ln) for ln in open(main / "metrics.jsonl")]
        # fit's train and val lines, then the worker's own evaluate
        assert [ln["split"] for ln in lines] == ["train", "val", "val"]
        assert all(ln["run_id"] == rid for ln in lines)


def test_row_shard_draws_equal_one_process():
    """Two ranks' RowShard draws, concatenated, are one process's."""
    def draws(lo, n, total):
        g = RowShard(torch.Generator().manual_seed(5), lo, total)
        return torch.cat([g.rand((n, 3, 2)).reshape(n, -1),
                          g.rand((n, 4)).reshape(n, -1)], 1)

    whole = draws(0, 6, 6)
    torch.testing.assert_close(torch.cat([draws(0, 3, 6), draws(3, 3, 6)]),
                               whole, rtol=0, atol=0)


# -- the sharding helpers against the JAX package's --------------------------


def items(n):
    return [{"x": np.full((2,), i, np.int32), "label": i} for i in range(n)]


@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("kw", [dict(pad_last=True),
                                dict(drop_last=True, shuffle=True),
                                dict(shuffle=True, pad_last=True)],
                         ids=["pad", "drop-shuffle", "pad-shuffle"])
@pytest.mark.parametrize("n", [9, 10, 13])
def test_prefetch_loader_shards_equal_jax(shard, kw, n):
    """Batches of 8 split over 2 shards; 9 and 13 items leave shard 1 no
    item in the last batch (padded from the global batch's first item,
    every row masked)."""
    args = dict(num_workers=2, seed=3, shard_index=shard, num_shards=2, **kw)
    got = list(loader.PrefetchLoader(items(n), 8, **args))
    want = list(ref_loader.PrefetchLoader(items(n), 8, **args))
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g[k].shape[0] == 4


def test_empty_shard_without_padding_raises_like_jax():
    for mod in (loader, ref_loader):
        with pytest.raises(ValueError, match="shard 1/2 got 0 of 4 items"):
            list(mod.PrefetchLoader(items(9), 8, num_workers=1,
                                    shard_index=1, num_shards=2))


@pytest.mark.parametrize("n_valid", [(3, 5), (0, 7), (12, 12), (12, 0)])
def test_sharded_pack_view_batch_equals_jax(monkeypatch, n_valid):
    """Each shard's packed batch, with the bucket agreed over both shards'
    view counts (the collective stubbed on both sides with those counts),
    equals the JAX function's: windows and global view_src ids."""
    import jax.experimental.multihost_utils as mhu

    rng = np.random.default_rng(sum(n_valid))
    B, T, N = 3, 4, 5
    shards = []
    for nv in n_valid:
        valid = np.zeros(B * T, bool)
        valid[rng.permutation(B * T)[:nv]] = True
        shards.append({
            "windows": rng.integers(0, 99, (B, T, N, 3)).astype(np.int16),
            "valid_mask": valid.reshape(B, T),
            "label": rng.integers(0, 4, B)})
    need = np.asarray([[max(nv, 1)] for nv in n_valid], np.int64)
    monkeypatch.setattr(mhu, "process_allgather", lambda x: need)
    monkeypatch.setattr(distributed, "allreduce_max_array",
                        lambda x: need.max(axis=0))
    buckets = loader.view_pack_buckets(2 * B * T, align=8)
    assert buckets == ref_loader.view_pack_buckets(2 * B * T, align=8)
    for i, batch in enumerate(shards):
        got = loader.pack_view_batch(batch, buckets, i, 2)
        want = ref_loader.pack_view_batch(batch, buckets, i, 2)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert ("view_src" in got) == (max(n_valid) <= max(buckets) // 2)


@pytest.mark.parametrize("faster", [1, 2])
def test_adaptive_prefetch_equals_jax(monkeypatch, faster):
    """The same placements and yields, in the same order, and the same
    measured depth, on a clock where depth `faster` steps faster."""
    def run(fn, choice):
        t = [0.0]
        log = []

        def clock():
            # a step at depth 2 holds a placed batch in the buffer
            t[0] += 1.0 if (len(log) and log[-1][0] == "place") == \
                (faster == 2) else 2.0
            return t[0]

        monkeypatch.setattr(time, "perf_counter", clock)

        def place(b):
            log.append(("place", b))
            return b

        for b in fn(range(16), place, choice=choice):
            log.append(("yield", b))
        return log

    got_choice, want_choice = {}, {}
    got = run(loader.adaptive_prefetch, got_choice)
    want = run(ref_loader.adaptive_prefetch, want_choice)
    assert got == want and got_choice == want_choice
    assert got_choice.get("depth") in (1, 2)
    # a later epoch reuses the measured depth
    assert run(loader.adaptive_prefetch, got_choice) == \
        run(ref_loader.adaptive_prefetch, want_choice)
