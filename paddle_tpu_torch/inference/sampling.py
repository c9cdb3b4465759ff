"""The serving step's sampling epilogue — counterpart of
``paddle_tpu/inference/sampling.py``.

The engine's programs turn each row's logits into its next token with
one epilogue for every kind of request at once:

* **Per-request parameters.** :class:`SamplerConfig` (temperature,
  top-k, top-p, seed) rides on a request and lands in four per-row
  device tensors that the engine writes in place at admission
  (:func:`set_row`); the programs read them at their captured
  addresses, so a mix of greedy, sampled and constrained rows is one
  program.
* **Counter-based PRNG.** The key of the token at sequence position
  ``P`` of a request with seed ``s`` is
  ``fold_in(fold_in(PRNGKey(s), P), salt)`` (``inference.prng``, the
  JAX package's threefry bits). No key state threads across steps, so a
  seeded stream replays whatever the batch, the chunk size or
  speculation, and its tokens are the JAX engine's.
* **Greedy is temperature 0**: the argmax of the same (grammar-masked)
  logits, bit-identical to the greedy engine for unconstrained rows.
* **Lossless rejection-sampling speculation** (:func:`spec_sample_rows`):
  a deterministic drafter proposes a point mass, so a draft token is
  accepted with probability ``p_target(draft)`` and a rejection draws
  from the target with the draft token masked out.
* Salts: ``SALT_DRAW`` keys ordinary draws (shared by the plain
  epilogue and the speculative bonus draws), ``SALT_ACCEPT`` the accept
  coin, ``SALT_RESAMPLE`` the residual draw.

Grammar masks come from ``inference.constrain``; the engine applies
them before this module's temperature/top-k/top-p processing. The
epilogue is plain PyTorch (sorts, a cumsum, gathers and the threefry
hash), as the JAX package computes it in XLA outside any Pallas kernel;
on the card it runs inside the step's CUDA graph.

The ``paddle_sampling_*`` registry families (the JAX package's) are
process-global, fed by the engines from the host (:func:`note_request`,
:func:`note_tokens`, :func:`note_violation`,
:func:`set_grammar_states`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from ..observability.registry import get_registry
from . import constrain as _constrain
from . import prng

#: PRNG salts (module docstring)
SALT_DRAW = 0
SALT_ACCEPT = 1
SALT_RESAMPLE = 2

_reg = get_registry()
_c_requests = _reg.counter(
    "paddle_sampling_requests_total",
    "requests admitted with a non-greedy epilogue, by mode "
    "(sampled | constrained)",
    labels=("mode",))
_c_tokens = _reg.counter(
    "paddle_sampling_tokens_total",
    "tokens committed through the sampling epilogue, by mode",
    labels=("mode",))
_c_violations = _reg.counter(
    "paddle_sampling_violations_total",
    "tokens the host grammar mirror rejected (device/host automaton "
    "disagreement — never expected; each also emits a "
    "constraint_violation event)")
_g_states = _reg.gauge(
    "paddle_sampling_grammar_states",
    "grammar-arena rows in use across registered token DFAs")


def note_request(mode: str) -> None:
    _c_requests.inc(mode=mode)


def note_tokens(mode: str, n: int) -> None:
    if n:
        _c_tokens.inc(n, mode=mode)


def note_violation() -> None:
    _c_violations.inc()


def set_grammar_states(n: int) -> None:
    _g_states.set(float(n))


@dataclass(frozen=True)
class SamplerConfig:
    """Per-request sampling parameters. ``temperature == 0`` is greedy;
    ``top_k == 0`` and ``top_p == 1.0`` turn their filters off.
    ``seed=None`` asks the engine for a deterministic per-request seed
    (config seed and request id)."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    def resolved(self, default_seed: int) -> "SamplerConfig":
        if self.seed is not None:
            return self
        return replace(self, seed=int(default_seed) & 0x7FFFFFFF)


def greedy_config() -> SamplerConfig:
    return SamplerConfig(temperature=0.0, seed=0)


def init_row_state(num_rows: int, device=None) -> Tuple[torch.Tensor, ...]:
    """The per-row device tensors of one engine, in tuple order: seeds
    (int64 holding uint32), temperatures (fp32), top-k (int32), top-p
    (fp32). Greedy defaults."""
    return (torch.zeros((num_rows,), dtype=torch.int64, device=device),
            torch.zeros((num_rows,), dtype=torch.float32, device=device),
            torch.zeros((num_rows,), dtype=torch.int32, device=device),
            torch.ones((num_rows,), dtype=torch.float32, device=device))


def set_row(samp: Tuple[torch.Tensor, ...], s: int,
            cfg: Optional[SamplerConfig]) -> Tuple[torch.Tensor, ...]:
    """Write slot ``s``'s sampler parameters in place (index writes on
    the current stream). ``None`` resets the row to greedy: a reused
    slot never inherits a retired request's temperature. Returns
    ``samp``."""
    seeds, temps, top_k, top_p = samp
    if cfg is None:
        cfg = greedy_config()
    seeds[s] = (cfg.seed or 0) & prng.MASK
    temps[s] = float(cfg.temperature)
    top_k[s] = int(cfg.top_k)
    top_p[s] = float(cfg.top_p)
    return samp


# ---------------------------------------------------------------------------
# In-program pieces
# ---------------------------------------------------------------------------
def _keys(seeds: torch.Tensor, pos: torch.Tensor, salt: int) -> torch.Tensor:
    """(N,) seeds x (N,) positions -> (N, 2) keys
    ``fold_in(fold_in(PRNGKey(seed), pos), salt)``."""
    return prng.fold_in(prng.fold_in(prng.prng_key(seeds), pos), salt)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, in its order of operations."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def process_logits(logits: torch.Tensor, temps: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Temperature scale -> top-k -> top-p with PER-ROW parameters (the
    kth-value rule keeps ties at the cutoff; top-p keeps the smallest
    set whose cumulative probability reaches ``top_p``). ``top_k == 0``
    and ``top_p == 1`` rows pass through. ``logits`` fp32 (and
    grammar-masked for constrained rows)."""
    V = logits.shape[-1]
    x = logits / temps.clamp_min(1e-6)[:, None]
    k_on = (top_k > 0)[:, None]
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    k_idx = (top_k.long() - 1).clamp(0, V - 1)[:, None]
    kth = sorted_desc.gather(-1, k_idx)
    x = x.masked_fill(k_on & (x < kth), float("-inf"))
    p_on = (top_p < 1.0)[:, None]
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    cum = torch.cumsum(_softmax(sorted_desc), dim=-1)
    cutoff_idx = (cum < top_p[:, None]).sum(dim=-1, keepdim=True)
    cutoff = sorted_desc.gather(-1, cutoff_idx.clamp(0, V - 1))
    return x.masked_fill(p_on & (x < cutoff), float("-inf"))


def sample_rows(logits, pos_next, samp, gstate, gtable):
    """The unified step's epilogue: per-row logits (already grammar-
    masked) -> ``(token int32, grammar state)``. ``pos_next (rows,)`` is
    the position the sampled token will occupy (the row's attended
    length this micro-round): the PRNG counter. Rows with
    ``temperature <= 0`` take the argmax."""
    seeds, temps, top_k, top_p = samp
    lg = logits.float()
    greedy_tok = torch.argmax(lg, dim=-1)
    proc = process_logits(lg, temps, top_k, top_p)
    drawn = prng.categorical(_keys(seeds, pos_next, SALT_DRAW), proc)
    tok = torch.where(temps <= 0.0, greedy_tok, drawn).to(torch.int32)
    return tok, _constrain.advance_states(gstate, tok, gtable)


def greedy_rows(logits, pos_next=None, samp=None, gstate=None, gtable=None):
    """Argmax-only twin of :func:`sample_rows`, which the engine's
    programs use until the first sampled or constrained request. The
    fp32 cast is value-exact for bf16/f16 logits and ties go to the
    first index (``jnp.argmax``), so greedy tokens are bit-identical
    to ``sample_rows``'s greedy rows."""
    tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
    return tok, gstate


def _prefix_len(match: torch.Tensor) -> torch.Tensor:
    """(R, k) bool -> (R,) length of each row's all-True prefix."""
    return torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)


def spec_greedy_rows(logits, drafts, draft_len, pos_base, samp, gstate,
                     gtable):
    """Greedy-only twin of :func:`spec_sample_rows` (same signature and
    ``(tokens, accepted, gstate)`` result): per-candidate argmax and the
    drafted-prefix match, no grammar advance."""
    R, k1, V = logits.shape
    k = k1 - 1
    g = torch.argmax(logits.float(), dim=-1).to(torch.int32)
    if k > 0:
        lane = torch.arange(k, device=logits.device)[None, :]
        valid = lane < draft_len[:, None]
        d = drafts[:, :k].clamp(0, V - 1)
        accepted = _prefix_len((d == g[:, :k]) & valid)
    else:
        accepted = torch.zeros((R,), dtype=torch.int32, device=logits.device)
    return g, accepted.to(torch.int32), gstate


def spec_sample_rows(logits, drafts, draft_len, pos_base, samp, gstate,
                     gtable):
    """The speculative step's epilogue: per-candidate logits
    ``(rows, k+1, V)`` -> ``(tokens (rows, k+1) int32, accepted (rows,)
    int32, grammar state)``; the host commits ``draft[:a] + [tokens[a]]``
    where ``a = accepted``.

    Greedy rows: argmax and the drafted-prefix match. Sampled rows:
    candidate ``j`` accepts its draft with probability ``p_j(draft_j)``;
    ``tokens[j]`` is the residual draw on drafted lanes and the plain
    ``SALT_DRAW`` draw past the draft (an undrafted row commits what the
    non-speculative epilogue would). Constrained rows never draft;
    candidate 0 is grammar-masked and the row's state advances on it."""
    seeds, temps, top_k, top_p = samp
    R, k1, V = logits.shape
    k = k1 - 1
    dev = logits.device
    lg = logits.float().clone()
    lg[:, 0] = _constrain.mask_logits(lg[:, 0], gstate, gtable)
    g = torch.argmax(lg, dim=-1).to(torch.int32)            # (R, k1)
    proc = process_logits(
        lg.reshape(R * k1, V), temps.repeat_interleave(k1),
        top_k.repeat_interleave(k1),
        top_p.repeat_interleave(k1)).reshape(R, k1, V)
    pos_gen = (pos_base.long()[:, None] + 1
               + torch.arange(k1, device=dev)[None, :])     # (R, k1)
    seeds_c = seeds.repeat_interleave(k1)
    plain = prng.categorical(
        _keys(seeds_c, pos_gen.reshape(-1), SALT_DRAW),
        proc.reshape(R * k1, V)).reshape(R, k1)
    if k > 0:
        lane = torch.arange(k, device=dev)[None, :]
        valid = lane < draft_len[:, None]                   # (R, k)
        d = drafts[:, :k].clamp(0, V - 1).long()
        acc_greedy = _prefix_len((d == g[:, :k]) & valid)
        probs = _softmax(proc[:, :k, :])
        p_d = probs.gather(-1, d[..., None])[..., 0]
        seeds_k = seeds_c.reshape(R, k1)[:, :k].reshape(-1)
        pos_k = pos_gen[:, :k].reshape(-1)
        u = prng.uniform(_keys(seeds_k, pos_k, SALT_ACCEPT)).reshape(R, k)
        acc_sampled = _prefix_len((u < p_d) & valid)
        drafted = torch.zeros((R, k, V), dtype=torch.bool, device=dev)
        drafted.scatter_(-1, d[..., None], True)
        resid = proc[:, :k, :].masked_fill(drafted, float("-inf"))
        r = prng.categorical(_keys(seeds_k, pos_k, SALT_RESAMPLE),
                             resid.reshape(R * k, V)).reshape(R, k)
        toks_s = torch.cat([torch.where(valid, r, plain[:, :k]),
                            plain[:, k:]], dim=1)
    else:
        acc_greedy = torch.zeros((R,), dtype=torch.int64, device=dev)
        acc_sampled = acc_greedy
        toks_s = plain
    greedy = temps <= 0.0
    toks = torch.where(greedy[:, None], g.long(), toks_s).to(torch.int32)
    accepted = torch.where(greedy, acc_greedy.long(),
                           acc_sampled.long()).to(torch.int32)
    gst = _constrain.advance_states(gstate, toks[:, 0], gtable)
    return toks, accepted, gst
