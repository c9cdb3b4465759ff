#!/usr/bin/env python3
"""Time kernel phases of ``chip_smoke.py`` from two checkouts of the repo
on one card, in turns A, B, B, A, so that two versions are compared
inside one run (the spread between cards and calls is larger than many
effects).

    python3 chip_ab.py A_DIR B_DIR [PHASE ...]

Each of A_DIR and B_DIR is the root of a checkout (for example this one,
and the parent commit unpacked with ``git archive`` into a git-ignored
directory). PHASE names a kernel phase of the smoke run:

    ragged   phase 3's ragged attention cases      (attention_phase)
    decode   phase 4's paged decode cases          (paged_decode_phase)
    ln       phase 13's LayerNorm forward and backward (layer_norm_phase)
    flash    phase 10's flash kernels              (flash_phase)
    seg      phase 14's segment-masked flash       (seg_flash_phase)
    grad_add phase 17's weight-gradient kernel     (grad_add_phase)
    serve    phase 7's Llama-2-7B unified serve    (serve_7b_phase, twice:
             the first warms up, the second is reported)

(default: all seven). Each turn runs in its own process from its own
checkout, which builds its own kernels. The script prints one JSON line
per turn, ``{"turn": i, "dir": ..., "phase": {case: ms, ...}}``, with
each case's kernel time (``ms``; for ``serve`` the generated tokens/s,
the mean step's wall ms, and each breakdown step's wall, device-busy and
attention-kernel ms), and the card's name and power limit.
It needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

PHASES = {
    "ragged": "cs.attention_phase(torch, pa)",
    "decode": "cs.paged_decode_phase(torch, pa)",
    "ln": "cs.layer_norm_phase(torch, ln)",
    "flash": "cs.flash_phase(torch, fa)",
    "seg": "cs.seg_flash_phase(torch, E, fa)",
    "grad_add": "cs.grad_add_phase(torch, fl)",
    # a first serve warms up the kernels and the engine; the second counts
    "serve": "(lambda c, w: [cs.serve_7b_phase(torch, L, D, rn, pa, c, w) "
             "for _ in range(2)][1])(*cs.init_7b(torch, L)[:2])",
}

# run inside the checkout: import its chip_smoke and its package
_TURN = """
import json, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke as cs
from paddle_tpu_torch.inference import decoding as D
from paddle_tpu_torch.models import ernie as E
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_linear as fl
from paddle_tpu_torch.ops import layer_norm_fused as ln
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import rms_norm as rn
out = {}
for name, call in json.loads(sys.argv[1]).items():
    report = eval(call)
    if name == "serve":
        out[name] = dict(
            generated_tokens_per_s=report["generated_tokens_per_s"],
            mean_step_ms=report["mean_step_ms"],
            **{f"{step}_{key}": v[key] if key != "attention_ms"
               else v["kernel_ms"]["ragged_paged_attention"]
               for step, v in report["breakdown"].items()
               for key in ("wall_ms", "device_busy_ms", "attention_ms")})
        continue
    if "step_shape" in report:
        report = report["step_shape"]
    if name == "ln":
        report = {f"{way}_{kind}": r for way, cases in report.items()
                  for kind, r in cases.items()}
    out[name] = {case: r["ms"] for case, r in report.items()
                 if isinstance(r, dict) and "ms" in r}
print("AB " + json.dumps(out), flush=True)
"""


def run_turn(root: str, phases) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", _TURN,
         json.dumps({p: PHASES[p] for p in phases})],
        cwd=root, capture_output=True, text=True, timeout=1800,
        env=dict(os.environ, PYTHONPATH=root))
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{proc.stderr[-4000:]}")
    line = [l for l in proc.stdout.splitlines() if l.startswith("AB ")][-1]
    return json.loads(line[3:])


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) < 3:
        print(__doc__ if len(sys.argv) < 3 else
              "chip_ab: CUDA is not available", file=sys.stderr)
        return 2
    a, b = (os.path.abspath(d) for d in sys.argv[1:3])
    phases = sys.argv[3:] or list(PHASES)
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        print(f"chip_ab: unknown phases {unknown}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    for i, root in enumerate((a, b, b, a)):
        print(json.dumps({"turn": i, "dir": root,
                          **run_turn(root, phases)}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
