"""Fused RNN ops — port of ``mxtpu/ops/rnn.py``: ``rnn_scan`` (one layer
and one direction, modes ``rnn_relu``, ``rnn_tanh``, ``lstm`` and ``gru``)
and the reference's fused multi-layer ``RNN`` op over a parameter vector
packed in the cuDNN/FusedRNNCell layout.

The JAX package scans a step function with ``lax.scan``; here the scan is
a Python loop over T of the same step on tensors, so torch's autograd
differentiates it and, inside a captured training step, the whole
recurrence is one CUDA graph (no tensor of the loop is read on the host).
The input projection of all T steps is hoisted into one product
``(T*B, I) @ (I, G*H)``; each step then adds one ``(B, H) @ (H, G*H)``
product. For ``rnn_*`` and ``lstm`` both biases go into the hoisted
product; GRU keeps ``b_hn`` inside ``r * (h @ W_hn + b_hn)``. Gate orders
are the reference's: LSTM [i, f, c, o], GRU [r, z, n]. No library RNN
kernel (cuDNN) is on the path: the reference has no Pallas kernel here.

Dropout between layers (``p``, training only) draws through
:func:`mxtpu_torch.rng.rand`: from a given device seed (the Gluon layers
under ``DataParallelTrainer``), from a ``rng.device_seeds`` scope
(``jit.CachedOp``'s captured programs), else from the device's generator.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .. import rng
from .registry import register

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _scan(data, h0, c0, i2h_w, i2h_b, h2h_w, h2h_b, mode: str,
          reverse: bool):
    """One layer and direction over time: ``(out (T, B, H), hT, cT)``
    (``cT`` None but for LSTM)."""
    T, B, I = data.shape
    G = i2h_w.shape[0]
    gru = mode == "gru"
    bias = i2h_b if gru else i2h_b + h2h_b
    # unbind, not xw[t]: its backward stacks the T step gradients once,
    # where T selects would each fill and add a whole (T, B, G) gradient
    xw = torch.addmm(bias, data.reshape(T * B, I), i2h_w.t()) \
        .view(T, B, G).unbind(0)
    wt = h2h_w.t()
    h, c = h0, c0
    outs: List[Optional[torch.Tensor]] = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        if mode == "lstm":
            gates = torch.addmm(xw[t], h, wt)
            si, sf, _, so = torch.sigmoid(gates).chunk(4, 1)
            g = torch.tanh(gates.chunk(4, 1)[2])
            c = torch.addcmul(sf * c, si, g)
            h = so * torch.tanh(c)
        elif gru:
            ir, iz, inn = xw[t].chunk(3, 1)
            hr, hz, hn = torch.addmm(h2h_b, h, wt).chunk(3, 1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            n = torch.tanh(inn + r * hn)
            h = (1 - z) * n + z * h
        elif mode == "rnn_tanh":
            h = torch.tanh(torch.addmm(xw[t], h, wt))
        elif mode == "rnn_relu":
            h = torch.relu(torch.addmm(xw[t], h, wt))
        else:
            raise ValueError(f"RNN mode {mode!r}: use one of {sorted(_GATES)}")
        outs[t] = h
    return torch.stack(outs), h, c


@register("rnn_scan", num_outputs=-1)
def _rnn_scan(data, h0, c0_or_w, *rest, mode: str = "lstm",
              reverse: bool = False):
    """Scan one RNN layer over time. data (T, B, I); h0 (B, H); lstm also
    takes c0. Then i2h_w, i2h_b, h2h_w, h2h_b. Returns (out (T, B, H), hT)
    or (out, hT, cT) for lstm."""
    if mode == "lstm":
        c0, (i2h_w, i2h_b, h2h_w, h2h_b) = c0_or_w, rest
    else:
        c0 = None
        i2h_w, i2h_b, h2h_w, h2h_b = (c0_or_w,) + tuple(rest)
    out, hT, cT = _scan(data, h0, c0, i2h_w, i2h_b, h2h_w, h2h_b, mode,
                        reverse)
    return (out, hT, cT) if mode == "lstm" else (out, hT)


def run_layers(x, h_all, c_all, weights, mode: str, p: float = 0.0,
               training: bool = False, seed=None):
    """``weights[layer][dir] = (i2h_w, i2h_b, h2h_w, h2h_b)`` over ``x``
    (T, B, I) from the states ``h_all`` (and ``c_all`` for lstm), each
    (layers * dirs, B, H); dropout ``p`` between layers in training, layer
    ``l``'s mask from ``sample_bits(seed, l)`` where ``seed`` is given
    (see the module docstring). Returns (out (T, B, dirs * H), [hT per
    layer and dir], [cT ...])."""
    dirs = len(weights[0])
    hs, cs = [], []
    for layer, row in enumerate(weights):
        outs = []
        for d, (i2h_w, i2h_b, h2h_w, h2h_b) in enumerate(row):
            idx = layer * dirs + d
            o, hT, cT = _scan(x, h_all[idx],
                              c_all[idx] if mode == "lstm" else None,
                              i2h_w, i2h_b, h2h_w, h2h_b, mode, d == 1)
            outs.append(o)
            hs.append(hT)
            cs.append(cT)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        if p > 0.0 and training and layer < len(weights) - 1:
            keep = 1.0 - p
            u = rng.rand(x.shape, x.device, seed=None if seed is None
                         else rng.sample_bits(seed, layer))
            x = torch.where(u < keep, x / keep, torch.zeros_like(x))
    return x, hs, cs


def _rnn_resolve(kwargs):
    """Bake the training flag in at invoke time (the reference reads it
    when the op is pushed)."""
    from .. import autograd
    if kwargs.get("_training") is None:
        kwargs["_training"] = autograd.is_training()
    return kwargs


def _slice_packed(params, num_layers: int, input_size: int, h: int,
                  gates: int, dirs: int):
    """Walk the reference's packed layout (``FusedRNNCell._slice_weights``):
    per layer, per direction, the i2h weights then the h2h weights; then
    every bias in the same order. Returns ``weights[layer][dir] = (i2h_w
    (G*h, in_l), i2h_b, h2h_w, h2h_b)``."""
    out = []
    pos = 0

    def take(n, shape):
        nonlocal pos
        seg = params.narrow(0, pos, n).reshape(shape)
        pos += n
        return seg

    for layer in range(num_layers):
        in_l = input_size if layer == 0 else dirs * h
        out.append([[take(gates * h * in_l, (gates * h, in_l)), None,
                     take(gates * h * h, (gates * h, h)), None]
                    for _ in range(dirs)])
    for layer in range(num_layers):
        for d in range(dirs):
            out[layer][d][1] = take(gates * h, (gates * h,))
            out[layer][d][3] = take(gates * h, (gates * h,))
    return out


@register("RNN", num_outputs=-1, resolve_kwargs=_rnn_resolve)
def _rnn_fused(data, parameters, state, state_cell=None, *,
               state_size: int, num_layers: int, mode: str = "lstm",
               bidirectional: bool = False, p: float = 0.0,
               state_outputs: bool = False, _training: Optional[bool] = None):
    """The reference's fused multi-layer RNN op (rnn-inl.h; parameter
    vector in the FusedRNNCell/cuDNN layout). data (T, N, I); state
    (layers * dirs, N, H); lstm also takes state_cell. Dropout ``p``
    applies between layers in training, as cuDNN's. Returns output (T, N,
    H * dirs), and hT (and cT) when ``state_outputs``."""
    dirs = 2 if bidirectional else 1
    weights = _slice_packed(parameters, num_layers, data.shape[2],
                            state_size, _GATES[mode], dirs)
    x, hs, cs = run_layers(data, state, state_cell, weights, mode, p,
                           bool(_training))
    if not state_outputs:
        return x
    if mode == "lstm":
        return x, torch.stack(hs), torch.stack(cs)
    return x, torch.stack(hs)
