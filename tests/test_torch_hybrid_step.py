"""``models.llama.build_hybrid_train_step`` of ``paddle_tpu_torch``
against the reference's (``paddle_tpu/models/llama.py:473``).

The reference runs one ``shard_map`` program over the conftest's
8-device CPU mesh; the port runs one gloo rank a device (one spawned
job a world size: 2, 4 and 8 ranks, every plan in it, workers in
``tests/torch_dist_workers.py``), each rank holding its slabs. The
plans are the ``__graft_entry__.dryrun_multichip`` configs of
Distributed II (``__graft_entry__.py:79-128``: the dp x pp x sharding x
mp step with the virtual pipeline, 1F1B, Ulysses ``seq_shard``, the
degree-4 plans ``pp4_vpp2_mp2``, ``mp4_sh2`` and ``sh4_dp2``, and the
ring-attention ``_dryrun_sep(mode="ring")`` of Distributed III) and
smaller ones for each option (the virtual pipeline at two stages, 1F1B
with mp, ``zero_gather="per_step"`` against the reference's per-layer
run, ``k_steps`` over two calls, the ``attn``, ``dots`` and ``offload``
remat policies with mp against the reference's ``attn``). Same seeded weights (the Threefry draws), same numpy
batch.

Tolerances, fp32: the loss at ``tests/test_llama.py:100``'s (rtol 2e-4,
atol 2e-5), equal on every rank; the gradients, read from the first
AdamW moment (``m = (1 - b1) g`` after one step), at
``tests/test_pipeline_1f1b.py``'s gradient bounds (rtol 1e-4, atol
1e-5); the updated weights by ``testing.trained_weights_close`` (all
within 2·lr·steps, all but 1e-4 of them within rtol 1e-4, atol 1e-5:
AdamW's first step takes the sign of each gradient, so an element
whose gradient is rounding noise may move the other way). The port's
gathered tensors are in model layer order; the reference stores the
virtual pipeline's layers permuted, so its are put back in order.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as RL
from paddle_tpu.parallel import mesh as rmesh
from paddle_tpu.parallel.pipeline import interleave_chunk_order

import torch_dist_workers as W
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.testing import one_cpu_thread, trained_weights_close

one_cpu_thread()

_B1 = 0.9
LR = 1e-3

#: world size -> [(name, degrees, options)]
PLANS = {
    2: [("pp2_vpp2", {"pp": 2}, dict(layers=4, M=2, B=4, S=32, seed=7,
                                      virtual_pp=2, save=True)),
        ("dp2_k2", {"dp": 2}, dict(layers=2, M=1, B=2, S=32, seed=7,
                                   k_steps=2, steps=2)),
        ("mp2_attn", {"mp": 2}, dict(layers=2, M=2, B=2, S=32, seed=4,
                                     remat_policy="attn")),
        ("mp2_dots", {"mp": 2}, dict(layers=2, M=2, B=2, S=32, seed=4,
                                     remat_policy="dots")),
        ("mp2_offload", {"mp": 2}, dict(layers=2, M=2, B=2, S=32, seed=4,
                                        remat_policy="offload"))],
    4: [("dp2_mp2", {"dp": 2, "mp": 2}, dict(layers=4, M=2, B=4, S=32,
                                             seed=7, save=True)),
        ("1f1b_pp2_mp2", {"pp": 2, "mp": 2},
         dict(layers=4, M=4, B=2, S=32, seed=3, pipeline_schedule="1f1b")),
        ("sh2_mp2_per_step", {"sharding": 2, "mp": 2},
         dict(layers=2, M=2, B=2, S=32, seed=7, zero_gather="per_step"))],
    8: [("dryrun_main", {"pp": 2, "sharding": 2, "mp": 2},
         dict(layers=8, M=2, B=2, S=32, seed=0, virtual_pp=2)),
        ("pp4_vpp2_mp2", {"pp": 4, "mp": 2},
         dict(layers=8, M=4, B=2, S=32, seed=7, virtual_pp=2)),
        ("mp4_sh2", {"sharding": 2, "mp": 4}, dict(layers=2, M=2, B=4,
                                                   S=32, seed=7)),
        ("sh4_dp2", {"dp": 2, "sharding": 4}, dict(layers=2, M=2, B=16,
                                                   S=32, seed=7)),
        ("dryrun_1f1b", {"dp": 2, "pp": 2, "mp": 2},
         dict(layers=4, M=4, B=4, S=32, seed=3, pipeline_schedule="1f1b")),
        ("dryrun_sep", {"dp": 2, "sep": 2, "mp": 2},
         dict(layers=2, M=1, B=4, S=64, seed=1, seq_shard=True)),
        ("dryrun_ring", {"dp": 2, "sep": 2, "mp": 2},
         dict(layers=2, M=1, B=4, S=64, seed=5, seq_shard=True,
              sep_mode="ring"))],
}
#: the reference's per-layer run that the port's per-step one is held
#: to (the reference's own test holds the two equal, test_llama.py:104)
SAME_AS = {"sh2_mp2_per_step": ("sh2_mp2_per_layer", {"zero_gather":
                                                      "per_layer"}),
           # a remat policy changes what the backward recomputes, not the
           # numbers; the reference's offload does not run on JAX's CPU
           # backend (ROADMAP, PR 21), so both are held to its attn run
           "mp2_dots": ("mp2_attn", {"remat_policy": "attn"}),
           "mp2_offload": ("mp2_attn", {"remat_policy": "attn"})}
CASES = [(n, p[0]) for n in PLANS for p in PLANS[n]]
_OPTS = {p[0]: (p[1], p[2]) for n in PLANS for p in PLANS[n]}


def _run_job(n, out):
    ctx = spawn(W.hybrid_step_scenarios, args=(str(out), PLANS[n]),
                nprocs=n, join=False, env={"OMP_NUM_THREADS": "1"})
    try:
        assert ctx.join(timeout=180), f"the {n}-rank job did not finish"
    finally:
        ctx.terminate()
    ranks = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    dirs = {n: tmp_path_factory.mktemp(f"hybrid{n}") for n in PLANS}
    return {n: (_run_job(n, dirs[n]), dirs[n]) for n in PLANS}


def _ref_order(degrees, o):
    vpp, pp = o.get("virtual_pp", 1), degrees.get("pp", 1)
    if vpp <= 1:
        return None
    lpc = o["layers"] // (pp * vpp)
    return np.asarray([c * lpc + r for c in interleave_chunk_order(pp, vpp)
                       for r in range(lpc)])


def _reference(name, over=None):
    degrees, o = _OPTS[name]
    o = dict(o, **(over or {}))
    layers, M, B, S, seed = (o.pop(k) for k in ("layers", "M", "B", "S",
                                                "seed"))
    sep_mode = o.pop("sep_mode", "ulysses")
    steps = o.pop("steps", 1)
    o.pop("save", None)
    need = int(np.prod(list(degrees.values())))
    mesh = rmesh.build_mesh(degrees, devices=jax.devices()[:need])
    rmesh.set_global_mesh(mesh)
    cfg = RL.llama_tiny(num_hidden_layers=layers)
    cfg.sep_mode = sep_mode
    step, init = RL.build_hybrid_train_step(cfg, mesh, learning_rate=LR,
                                            remat=True, **o)
    params, opt = init(seed=0)
    ids, labels = W.hybrid_batch(cfg.vocab_size, M, B, S, seed)
    k = o.get("k_steps", 1)
    if k > 1:
        ids, labels = np.stack([ids] * k), np.stack([labels] * k)
    losses = []
    for _ in range(steps):
        loss, params, opt = step(params, opt, ids, labels)
        losses.append(float(loss))
    out = {"losses": losses,
           "params": {a: np.asarray(v) for a, v in params.items()},
           "m": {a: np.asarray(v) for a, v in opt["m"].items()},
           "storage": {a: np.asarray(v) for a, v in params.items()},
           "sharded": params}
    order = _ref_order(degrees, _OPTS[name][1])
    if order is not None:
        inv = np.argsort(order)
        for kind in ("params", "m"):
            out[kind] = {a: (v[inv] if a in RL.LAYER_KEYS else v)
                         for a, v in out[kind].items()}
    rmesh.set_global_mesh(None)
    return out


@pytest.fixture(scope="module")
def refs():
    cache = {}

    def get(name):
        key, over = SAME_AS.get(name, (name, None))
        if key not in cache:
            cache[key] = _reference(name, over)
        return cache[key]
    return get


@pytest.mark.parametrize("n,name", CASES)
def test_loss_matches_the_reference_on_every_rank(jobs, refs, n, name):
    ranks, _ = jobs[n]
    got = [r[name]["losses"] for r in ranks]
    assert all(g == got[0] for g in got), got
    np.testing.assert_allclose(got[0], refs(name)["losses"], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("n,name", CASES)
def test_gradients_and_updated_weights_match(jobs, refs, n, name):
    ranks, _ = jobs[n]
    got, want = ranks[0][name], refs(name)
    steps = len(want["losses"]) * _OPTS[name][1].get("k_steps", 1)
    if steps == 1:
        for k, m in want["m"].items():
            np.testing.assert_allclose(got["m"][k] / (1 - _B1),
                                       m / (1 - _B1), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    trained_weights_close(
        {k: torch.from_numpy(v) for k, v in got["params"].items()},
        {k: torch.from_numpy(v) for k, v in want["params"].items()},
        LR, steps, msg=name)


def test_workers_import_neither_jax_nor_the_reference(jobs):
    for n, (ranks, _) in jobs.items():
        assert all(r["imports"] == [] for r in ranks), n


@pytest.mark.parametrize("n,name", [(2, "pp2_vpp2"), (4, "dp2_mp2")])
def test_sharded_checkpoint_loads_in_one_process(jobs, n, name):
    """Each rank wrote its slabs at their global offsets (model layer
    order); one process loads the global tensors, and each rank loaded
    its own slabs back bitwise."""
    from paddle_tpu_torch.distributed.checkpoint import load_state_dict
    ranks, out = jobs[n]
    assert all(r[name]["reload_equal"] for r in ranks)
    got = ranks[0][name]
    state = {kind: {k: torch.zeros(v.shape, dtype=torch.float32)
                    for k, v in got[kind].items()} for kind in ("params",
                                                                "m")}
    load_state_dict(state, os.path.join(out, f"ckpt_{name}"))
    for kind in state:
        for k, v in state[kind].items():
            np.testing.assert_array_equal(v.numpy(), got[kind][k],
                                          err_msg=f"{kind}.{k}")


def test_the_references_sharded_checkpoint_loads(refs, tmp_path):
    """The reference's save of its sharded params (8 shards of each
    layer weight over pp x sharding x mp) loads in one process as its
    global arrays (in its storage order)."""
    from paddle_tpu.distributed.checkpoint import save_state_dict as rsave
    from paddle_tpu_torch.distributed.checkpoint import load_state_dict
    want = refs("dryrun_main")
    rsave({"params": want["sharded"]}, str(tmp_path))
    state = {"params": {k: torch.zeros(v.shape, dtype=torch.float32)
                        for k, v in want["storage"].items()}}
    load_state_dict(state, str(tmp_path))
    for k, v in state["params"].items():
        np.testing.assert_array_equal(v.numpy(), want["storage"][k],
                                      err_msg=k)


def test_ring_sep_mode_waits_for_distributed_iii():
    """Ring attention came with Distributed III: ``sep_mode="ring"``
    builds over a sep axis (its step is ``dryrun_ring`` above), and its
    head check is the reference's: heads divisible by mp only, where
    Ulysses needs mp·sep."""
    from paddle_tpu_torch.models import llama as TL
    from paddle_tpu_torch.parallel import mesh as tmesh
    mesh = tmesh.Mesh(np.arange(2).reshape(1, 1, 1, 2, 1),
                      tmesh.HYBRID_ORDER)
    for mode in ("ring", "ulysses"):
        cfg = TL.llama_tiny(num_hidden_layers=2, sep_mode=mode,
                            num_attention_heads=3, num_key_value_heads=3,
                            hidden_size=48)
        if mode == "ring":
            step, _ = TL.build_hybrid_train_step(cfg, mesh, seq_shard=True,
                                                 device="cpu")
            assert callable(step)
        else:
            with pytest.raises(ValueError, match="mp\\*sep"):
                TL.build_hybrid_train_step(cfg, mesh, seq_shard=True,
                                           device="cpu")
