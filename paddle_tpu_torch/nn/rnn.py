"""Recurrent layers — counterpart of ``paddle_tpu/nn/rnn.py``:
``SimpleRNN`` / ``LSTM`` / ``GRU``, their cells and the ``RNN`` wrapper.

The reference's ``lax.scan`` over time is a loop over time here, each
step the reference's cell math in plain PyTorch (it has no Pallas
kernel). Its conventions are kept: batch-major inputs (``time_major``
flips), gate order i, f, c, o for LSTM and r, z, c for GRU, weights
``weight_ih_l{n}[_reverse]`` drawn ``U(±1/√hidden)`` from the key stream
in the reference's order, ``sequence_length`` freezing the state and
zeroing the output past each sequence's end (a reverse direction runs
over each valid prefix reversed), and inter-layer dropout whose keys are
drawn when the layer is called in training.
"""

from __future__ import annotations

import math

import torch

from .. import random as _random
from ..core.tensor import Tensor
from . import functional as F
from . import initializer as I
from .layer import Layer, layer_device


def _uniform_init(fan):
    bound = 1.0 / math.sqrt(fan) if fan > 0 else 0.0
    return I.Uniform(-bound, bound)


def _gru_step(params, x_t, h_prev):
    wih, whh, bih, bhh = params
    hs = whh.shape[1]
    xg = x_t @ wih.T + bih                      # (B, 3H)
    hg = h_prev @ whh.T + bhh
    xr, xz, xc = (xg[..., k * hs:(k + 1) * hs] for k in range(3))
    hr, hz, hc = (hg[..., k * hs:(k + 1) * hs] for k in range(3))
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    c = torch.tanh(xc + r * hc)
    new_h = (1 - z) * c + z * h_prev
    return new_h, new_h


def _cell_step(kind, params, x_t, state):
    """One step: ``(output, new state)``."""
    if kind == "gru":
        return _gru_step(params, x_t, state)
    wih, whh, bih, bhh = params
    if kind == "lstm":
        h_prev, c_prev = state
        gates = x_t @ wih.T + bih + h_prev @ whh.T + bhh
        h = gates.shape[-1] // 4
        i, f, g, o = (gates[..., k * h:(k + 1) * h] for k in range(4))
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * c_prev + i * torch.tanh(g)
        new_h = o * torch.tanh(c)
        return new_h, (new_h, c)
    new_h = torch.tanh(x_t @ wih.T + bih + state @ whh.T + bhh)
    return new_h, new_h


def _where(keep, new, old):
    if isinstance(new, tuple):
        return tuple(torch.where(keep, n, o) for n, o in zip(new, old))
    return torch.where(keep, new, old)


class _RNNCellBase(Layer):
    n_gates = 1
    kind = "simple"

    def __init__(self, input_size: int, hidden_size: int, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = self.n_gates
        init = _uniform_init(hidden_size)
        self.weight_ih = self.create_parameter(
            (g * hidden_size, input_size), default_initializer=init)
        self.weight_hh = self.create_parameter(
            (g * hidden_size, hidden_size), default_initializer=init)
        self.bias_ih = self.create_parameter(
            (g * hidden_size,), default_initializer=init, is_bias=True)
        self.bias_hh = self.create_parameter(
            (g * hidden_size,), default_initializer=init, is_bias=True)

    def _params(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)

    def _zeros(self, inputs):
        z = torch.zeros((inputs.shape[0], self.hidden_size),
                        device=self.weight_ih.device)
        return Tensor(z) if isinstance(inputs, Tensor) else z

    def get_initial_states(self, batch):
        return Tensor(torch.zeros((batch, self.hidden_size),
                                  device=layer_device()))


class SimpleRNNCell(_RNNCellBase):
    n_gates = 1
    kind = "simple"

    def forward(self, inputs, states=None):
        st = states if states is not None else self._zeros(inputs)
        out = F._run(lambda x, h, *p: _cell_step("simple", p, x, h)[0],
                     inputs, st, *self._params(), op_name="simple_rnn_cell")
        return out, out


class LSTMCell(_RNNCellBase):
    n_gates = 4
    kind = "lstm"

    def get_initial_states(self, batch):
        z = super().get_initial_states(batch)
        return (z, z)

    def forward(self, inputs, states=None):
        if states is None:
            z = self._zeros(inputs)
            states = (z, z)
        h, c = states
        nh, nc = F._run(lambda x, hv, cv, *p: _cell_step(
            "lstm", p, x, (hv, cv))[1], inputs, h, c, *self._params(),
            op_name="lstm_cell", n_outputs=2)
        return nh, (nh, nc)


class GRUCell(_RNNCellBase):
    n_gates = 3
    kind = "gru"

    def forward(self, inputs, states=None):
        st = states if states is not None else self._zeros(inputs)
        out = F._run(lambda x, h, *p: _gru_step(p, x, h)[0], inputs, st,
                     *self._params(), op_name="gru_cell")
        return out, out


def _run_direction(kind, p, xs, state0, mask):
    """The time loop of one layer and direction over time-major ``xs``:
    ``(final state, outputs (T, B, H))``."""
    st, outs = state0, []
    for t in range(xs.shape[0]):
        _, new = _cell_step(kind, p, xs[t], st)
        if mask is not None:
            keep = mask[t][:, None]
            new = _where(keep, new, st)
        out = new[0] if kind == "lstm" else new
        if mask is not None:
            out = out * keep.to(out.dtype)
        st = new
        outs.append(out)
    return st, torch.stack(outs)


class _RNNBase(Layer):
    kind = "simple"
    n_gates = 1

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 direction: str = "forward", time_major: bool = False,
                 dropout: float = 0.0, name=None, **kwargs):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"unknown direction {direction!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = direction != "forward"
        self.time_major = time_major
        self.dropout = float(dropout)
        ndir = 2 if self.bidirectional else 1
        self.num_directions = ndir
        g = self.n_gates
        init = _uniform_init(hidden_size)
        self._names = []
        for layer in range(num_layers):
            for d in range(ndir):
                isz = input_size if layer == 0 else hidden_size * ndir
                made = (
                    self.create_parameter((g * hidden_size, isz),
                                          default_initializer=init),
                    self.create_parameter((g * hidden_size, hidden_size),
                                          default_initializer=init),
                    self.create_parameter((g * hidden_size,),
                                          default_initializer=init,
                                          is_bias=True),
                    self.create_parameter((g * hidden_size,),
                                          default_initializer=init,
                                          is_bias=True))
                names = [f"weight_ih_l{layer}", f"weight_hh_l{layer}",
                         f"bias_ih_l{layer}", f"bias_hh_l{layer}"]
                if d == 1:
                    names = [n + "_reverse" for n in names]
                for n, p in zip(names, made):
                    setattr(self, n, p)
                self._names.append(tuple(names))

    @property
    def _weights(self):
        return [tuple(getattr(self, n) for n in names)
                for names in self._names]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        kind = self.kind
        nl, nd, hs = self.num_layers, self.num_directions, self.hidden_size
        time_major = self.time_major
        params = [p for tup in self._weights for p in tup]
        has_init = initial_states is not None
        has_seq = sequence_length is not None
        init_args = []
        if has_init:
            init_args = (list(initial_states) if kind == "lstm"
                         else [initial_states])
        if has_seq:
            init_args = init_args + [sequence_length]
        drop_keys = None
        if self.training and self.dropout > 0.0 and nl > 1:
            drop_keys = [_random.next_key() for _ in range(nl - 1)]

        def fn(x, *flat):
            if not time_major:
                x = x.transpose(0, 1)                     # (T, B, I)
            T, B = x.shape[0], x.shape[1]
            ws = [tuple(flat[i * 4:(i + 1) * 4]) for i in range(nl * nd)]
            pos = nl * nd * 4
            init_h = init_c = None
            if has_init:
                init_h = flat[pos]
                pos += 1
                if kind == "lstm":
                    init_c = flat[pos]
                    pos += 1
            mask = rev_idx = None
            if has_seq:
                slen = flat[pos].long().to(x.device)
                t_idx = torch.arange(T, device=x.device)[:, None]
                mask = t_idx < slen[None, :]               # (T, B)
                # per-example reversal of the valid prefix; an involution
                rev_idx = torch.where(mask, slen[None, :] - 1 - t_idx, t_idx)
            finals_h, finals_c = [], []
            for layer in range(nl):
                outs = []
                for d in range(nd):
                    if d == 1:
                        xs = (torch.gather(x, 0, rev_idx[:, :, None].expand(
                            -1, -1, x.shape[2])) if has_seq else x.flip(0))
                    else:
                        xs = x
                    slot = layer * nd + d
                    h0 = (init_h[slot] if has_init else
                          torch.zeros((B, hs), dtype=x.dtype, device=x.device))
                    if kind == "lstm":
                        c0 = (init_c[slot] if has_init else torch.zeros_like(h0))
                        state0 = (h0, c0)
                    else:
                        state0 = h0
                    final, seq = _run_direction(kind, ws[slot], xs, state0,
                                                mask)
                    if d == 1:
                        if has_seq:
                            seq = torch.gather(seq, 0, rev_idx[:, :, None]
                                               .expand(-1, -1, seq.shape[2]))
                            seq = seq * mask[:, :, None].to(seq.dtype)
                        else:
                            seq = seq.flip(0)
                    outs.append(seq)
                    if kind == "lstm":
                        finals_h.append(final[0])
                        finals_c.append(final[1])
                    else:
                        finals_h.append(final)
                x = torch.cat(outs, dim=-1) if nd == 2 else outs[0]
                if drop_keys is not None and layer < nl - 1:
                    keep = _random.bernoulli_draw(
                        drop_keys[layer], 1.0 - self.dropout, tuple(x.shape),
                        x.device)
                    x = torch.where(keep, x / (1.0 - self.dropout),
                                    torch.zeros((), dtype=x.dtype,
                                                device=x.device))
            out = x if time_major else x.transpose(0, 1)
            fh = torch.stack(finals_h)
            if kind == "lstm":
                return out, fh, torch.stack(finals_c)
            return out, fh

        res = F._run(fn, inputs, *params, *init_args, op_name=f"{kind}_rnn",
                     n_outputs=3 if kind == "lstm" else 2)
        if kind == "lstm":
            out, fh, fc = res
            return out, (fh, fc)
        return res[0], res[1]


class SimpleRNN(_RNNBase):
    kind = "simple"
    n_gates = 1


class LSTM(_RNNBase):
    kind = "lstm"
    n_gates = 4


class GRU(_RNNBase):
    kind = "gru"
    n_gates = 3


class RNN(Layer):
    """A cell run over a sequence (``paddle.nn.RNN``)."""

    def __init__(self, cell, is_reverse: bool = False,
                 time_major: bool = False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None):
        kind = self.cell.kind
        time_major, rev = self.time_major, self.is_reverse
        hs = self.cell.hidden_size
        has_init = initial_states is not None
        init_args = []
        if has_init:
            init_args = (list(initial_states) if kind == "lstm"
                         else [initial_states])

        def fn(x, *p):
            if not time_major:
                x = x.transpose(0, 1)
            if rev:
                x = x.flip(0)
            if has_init:
                state0 = (p[4], p[5]) if kind == "lstm" else p[4]
            else:
                h0 = torch.zeros((x.shape[1], hs), dtype=x.dtype,
                                 device=x.device)
                state0 = (h0, h0) if kind == "lstm" else h0
            final, seq = _run_direction(kind, p[:4], x, state0, None)
            if rev:
                seq = seq.flip(0)
            out = seq if time_major else seq.transpose(0, 1)
            if kind == "lstm":
                return out, final[0], final[1]
            return out, final

        res = F._run(fn, inputs, *self.cell._params(), *init_args,
                     op_name="rnn", n_outputs=3 if kind == "lstm" else 2)
        if kind == "lstm":
            return res[0], (res[1], res[2])
        return res[0], res[1]
