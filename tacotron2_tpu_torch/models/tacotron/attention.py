"""Location-sensitive attention, one decode step (PyTorch).

Counterpart of tacotron2_tpu/models/tacotron/attention.py:25-103:

    e = v_a · tanh(keys + W_q(q) + W_loc(conv_k(cum_align) + b_conv) + b_a)

with the encoder-padding mask, the synthesis-time window constraint and
cumulative weights. The keys (memory projection) are computed once per
utterance outside the loop; the location conv and its projection are
folded into one [K, A] tap matrix (`wp = loc_k @ wloc`), with the constant
part (`b_a + loc_b @ wloc`) folded into the keys — the same algebra as the
TPU decode kernel (`_attention_operands`).

`SimpleBahdanauAttention` (:104) is the emt_attn variant's attention over
the emotion reference; `emt_context` is the step of that attention and of
the multi-head one in the folded form the TPU block kernel computes
(tacotron_decoder_kernel.py:508-553).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .modules import Dense

NEG_INF = -(2.0 ** 32) + 1.0  # reference padding value (attention.py:214)


def fold_location(loc_k, loc_b, wloc, b_a):
    """[K, F] taps, [F] bias, [F, A] projection, [A] bias ->
    (wp [K, A], b_eff [A]) in f32."""
    wloc = wloc.float()
    return loc_k.float() @ wloc, b_a.float() + loc_b.float() @ wloc


def location_features(cum, wp):
    """SAME correlation of cum [B, T] with taps wp [K, A] -> [B, T, A]."""
    K = wp.shape[0]
    pad = (K - 1) // 2
    w = wp.t()[:, None, :]                                  # [A, 1, K]
    loc = F.conv1d(F.pad(cum[:, None, :], (pad, K - 1 - pad)), w)
    return loc.transpose(1, 2)


def window_forbidden(T: int, pmax, win: int, ctype: str):
    """[B, T] bool: positions the synthesis constraint rules out
    (reference attention.py:202-215)."""
    idx = torch.arange(T, device=pmax.device)[None, :]
    p = pmax[:, None]
    if ctype == "monotonic":
        return (idx < p) | (idx >= p + win)
    back = win // 2 + win % 2
    return (idx < p - back) | (idx >= p + win // 2)


def identity(x):
    return x


def attention_step(q, keys_eff, memory, mask, cum, pmax, wp, v_a, *,
                   constraint: bool, ctype: str, win: int, rnd=identity,
                   rnd_tanh=identity, smoothing: bool = False):
    """One step. q [B, A] (already projected), keys_eff [B, T, A] (keys with
    the folded bias), memory [B, T, M], mask [B, T] float 1/0, cum [B, T],
    pmax [B] long. `rnd` rounds the cumulative weights and the alignment
    where they enter a product, `rnd_tanh` the energies' tanh where it
    meets v_a (see decoder.py:_step). With `smoothing` the alignments are
    the masked sigmoids of the energies over their sum (JAX
    attention.py:91-95) in place of the softmax. Returns (context [B, M],
    align [B, T], cum, pmax)."""
    loc = location_features(rnd(cum), wp)
    energy = rnd_tanh(torch.tanh(keys_eff + q[:, None, :] + loc)) \
        @ v_a.float()
    if constraint:
        energy = energy.masked_fill(
            window_forbidden(energy.shape[1], pmax, win, ctype), NEG_INF)
    energy = torch.where(mask > 0, energy, torch.full_like(energy, NEG_INF))
    if smoothing:
        ex = torch.sigmoid(energy) * mask
    else:
        ex = torch.exp(energy - energy.max(-1, keepdim=True).values) * mask
    align = ex / ex.sum(-1, keepdim=True)
    if constraint:
        pmax = torch.argmax(align, dim=-1)
    context = torch.bmm(rnd(align)[:, None, :], memory)[:, 0]
    return context, align, cum + align, pmax


class SimpleBahdanauAttention(nn.Module):
    """Additive attention of a query [B, Q] over values [B, T, V]:
    softmax over T of V(tanh(W1 values + W2 query)), the weighted sum of
    the values (JAX attention.py:104-121; flax names W1, W2, V)."""

    def __init__(self, d_query: int, d_value: int, units: int):
        super().__init__()
        self.W1 = Dense(d_value, units)
        self.W2 = Dense(d_query, units)
        self.V = Dense(units, 1)

    def forward(self, query, values):
        """-> (context [B, V], weights [B, T])."""
        score = self.V(torch.tanh(self.W1(values)
                                  + self.W2(query)[:, None, :]))[..., 0]
        w = torch.softmax(score, dim=1)
        return torch.bmm(w[:, None, :], values)[:, 0], w


def emt_context(qe, ekeys, score, emem, rnd=identity):
    """One step of the emt attention in folded form: qe [B, A2] the
    projected query, ekeys [B, Te, A2] the keys with every constant folded
    in, score [nh, A2] the score rows, emem [B, Te, V] the values. Head h
    scores e_h = score[h] · tanh(ekeys + qe) over the Te positions and
    takes the softmax-weighted sum of the values (`rnd` rounds the weights
    where they enter it); returns the nh contexts joined, [B, nh·V], and
    the weights [B, nh, Te]."""
    e = torch.tanh(ekeys + qe[:, None, :])                 # [B, Te, A2]
    w = torch.softmax(torch.einsum("bta,ha->bht", e, score.float()), -1)
    return torch.bmm(rnd(w), emem).reshape(emem.shape[0], -1), w
