#!/usr/bin/env python3
"""How far the tensor-parallel serving step's logits are from the
one-chip step's, layer count by layer count, at Llama-2-7B widths.

    python3 scripts/tp_logits_by_depth.py

Needs a CUDA card (H100, sm_90a). The weights are ``chip_smoke``'s phase 7
weights (Llama-2-7B, bf16, seed 0) cut to their first n layers; the step is
``chip_smoke``'s first packed micro-round (8 rows of 32 prompt tokens).
For n in 1, 2, 4, 8, 16, 32 it prints, against the one-chip step: the same
step with 256 pad tokens more and with its rows in another order (the
one-chip step's own rounding noise), and the step over serving meshes of 2
and 4 logical chips on cuda:0 (relative L2 of the logits, largest
|difference|, rows whose argmax agrees). Then the same over 2 layers in
fp32. One JSON line each.
"""

import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tp_logits_by_depth: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as CS
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.ops import _common
    from paddle_tpu_torch.ops import paged_attention as pa

    _common.build_cuda_sources(["ragged_paged_attention"])
    cfg, params, _ = CS.init_7b(torch, L)
    prompts = CS.serve_load(cfg)
    rows, n_tok = 8, 32

    def step(p, c, mesh, pad=0, order=None):
        idx = list(range(rows)) if order is None else order
        ids = np.concatenate([prompts[r][:n_tok] for r in idx])
        tr = np.repeat(np.arange(rows), n_tok)
        pos = np.tile(np.arange(n_tok), rows)
        if pad:
            ids = np.concatenate([ids, np.ones(pad, np.int64)])
            tr = np.concatenate([tr, -np.ones(pad, np.int64)])
            pos = np.concatenate([pos, np.zeros(pad, np.int64)])
        bt = 1 + np.arange(rows * 2).reshape(rows, 2)
        args = [torch.from_numpy(np.asarray(a, np.int32)).cuda() for a in (
            ids, tr, pos, np.full(rows, n_tok), np.arange(rows) * n_tok
            + n_tok - 1, bt)]
        dec = torch.zeros(len(ids), dtype=torch.bool, device="cuda")
        shape = (c.num_hidden_layers, rows * 2 + 1, 16,
                 c.num_key_value_heads, c.head_dim)
        kp = torch.zeros(shape, dtype=c.dtype, device="cuda")
        vp = torch.zeros_like(kp)
        if mesh is not None:
            devs = mesh.devices.reshape(-1).tolist()
            kp, vp = (pa.HeadShards.split(x, devs) for x in (kp, vp))
        out = L.ragged_step(p, *args[:5], kp, vp, args[5], c, mesh, "mp",
                            decoding=dec)[0].float()
        if order is not None:
            out = out[torch.from_numpy(np.argsort(order)).cuda()]
        return out

    def cmp(a, b):
        d = a - b
        return dict(rel_l2=float(d.norm() / b.norm()),
                    max_abs=float(d.abs().max()),
                    same_argmax=int((a.argmax(-1) == b.argmax(-1)).sum()))

    def cut(n, dtype):
        c = dataclasses.replace(cfg, num_hidden_layers=n, dtype=dtype)
        return c, {k: (v[:n] if k in L.LAYER_KEYS else v).to(dtype)
                   for k, v in params.items()}

    print(CS.card_line())
    for n in (1, 2, 4, 8, 16, 32):
        c, p = cut(n, torch.bfloat16)
        one = step(p, c, None)
        rep = dict(layers=n, repacked=cmp(step(p, c, None, pad=256), one),
                   reordered=cmp(step(p, c, None,
                                      order=[3, 1, 7, 0, 5, 2, 6, 4]), one))
        for mp in (2, 4):
            mesh = CS._logical_mesh(torch, mp)
            rep[f"mp{mp}"] = cmp(step(L.shard_params_tp(p, mesh, c), c,
                                      mesh), one)
        print(json.dumps(rep), flush=True)
    c, p = cut(2, torch.float32)
    one = step(p, c, None)
    rep = dict(layers=2, dtype="fp32",
               repacked=cmp(step(p, c, None, pad=256), one))
    for mp in (2, 4):
        mesh = CS._logical_mesh(torch, mp)
        rep[f"mp{mp}"] = cmp(step(L.shard_params_tp(p, mesh, c), c, mesh),
                             one)
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
