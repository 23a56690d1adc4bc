"""Tacotron building blocks (PyTorch).

Counterparts of tacotron2_tpu/models/tacotron/modules.py. Layouts follow the
JAX package at every public function: sequences are [B, T, C] and dense
kernels are stored as flax keeps them, [in, out], so `convert.py` copies
them without transposes. Convolutions keep PyTorch's weight layout
([out, in, k...]); the converter transposes those once.

Inference (the default, `train=False`): BatchNorm on its running
statistics, no encoder/postnet dropout, zoneout the deterministic EMA mix.
Train mode (`train=True`, with a `torch.Generator` for the random draws):
BatchNorm on the batch statistics, updating the running ones as flax does
(`ra = m·ra + (1-m)·batch`, m = BN_MOMENTUM, biased variance in both,
epsilon 1e-3; torch's BatchNorm1d keeps the inverse momentum and an
unbiased running variance, so it is not used), conv dropout in the
encoder and postnet, and Bernoulli zoneout in the encoder's BiLSTM. The
prenet (whose dropout is always on) lives in the decoder
(`models/tacotron/decoder.py`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import dist

BN_EPS = 1e-3
BN_MOMENTUM = 0.99


def _zeros(*shape):
    return nn.Parameter(torch.zeros(*shape))


def dropout(x, rate: float, generator):
    """Inverted dropout with a uniform draw from `generator` (flax
    nn.Dropout in train mode); in a data-parallel step the rank's rows of
    the global batch's draw."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = dist.rand_rows(x.shape, generator, x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


class Dense(nn.Module):
    """y = x @ kernel + bias with a flax-layout kernel [in, out]."""

    def __init__(self, d_in: int, d_out: int, use_bias: bool = True):
        super().__init__()
        self.kernel = _zeros(d_in, d_out)
        self.bias = _zeros(d_out) if use_bias else None

    def forward(self, x):
        y = x @ self.kernel
        return y + self.bias if self.bias is not None else y


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (flax nn.BatchNorm, epsilon 1e-3). In
    train mode it normalises with the batch's mean and biased variance
    over every other axis (flax's fast variance, E[x²] - E[x]²) and moves
    the running statistics toward them in place.

    Within one model forward flax's updated statistics stay traced: an
    eval-mode call after a train-mode call of the same module (the
    unpaired pass's reference encoders on its output) normalises with them
    and its gradient reaches the parameters through them. `live` holds
    them so, the graph's (mean, var) since the last `clear_live`; the
    buffers hold their values.

    In a data-parallel step (`parallel.dist.activate`) the statistics are
    the global batch's: the sums of x and x² and the count, all-reduced
    with autograd, so every rank normalises alike and moves its running
    statistics alike (torch's SyncBatchNorm does not run on the CPU and
    keeps torch's epsilon and variance)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = _zeros(channels)
        self.bias = _zeros(channels)
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.live = None

    def forward(self, x, train: bool = False):
        x = x.float()
        if not train:
            mean, var = self.live or (self.mean, self.var)
        else:
            dims = tuple(range(x.dim() - 1))
            if dist.active() is None:
                mean = x.mean(dims)
                sq = (x * x).mean(dims)
            else:
                C = x.shape[-1]
                s = dist.batch_sum(torch.cat([
                    x.sum(dims), (x * x).sum(dims),
                    x.new_full((1,), x.numel() // C)]))
                mean, sq = s[:C] / s[-1], s[C:2 * C] / s[-1]
            var = torch.clamp(sq - mean * mean, min=0.0)
            m = BN_MOMENTUM
            old_mean, old_var = self.live or (self.mean, self.var)
            self.live = (m * old_mean + (1.0 - m) * mean,
                         m * old_var + (1.0 - m) * var)
            with torch.no_grad():
                self.mean.copy_(self.live[0])
                self.var.copy_(self.live[1])
        return (x - mean) * torch.rsqrt(var + BN_EPS) * self.scale + self.bias


def clear_live(module: nn.Module) -> None:
    """Drop every BatchNorm's traced statistics under `module` (each model
    forward starts and ends with it)."""
    for mod in module.modules():
        if isinstance(mod, BatchNorm):
            mod.live = None


def _same_pad(size: int, k: int, stride: int):
    """flax/XLA 'SAME' padding (lo, hi) for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class ConvBlock(nn.Module):
    """conv1d → (activation, BatchNorm in 'after' order) → dropout (train
    mode) over [B, T, C].

    Reference: tacotron2_tpu ConvBlock (modules.py:30). Under
    `compute_dtype="bfloat16"` the conv runs in bf16 and BatchNorm in f32,
    as in the JAX package.
    """

    def __init__(self, c_in: int, channels: int, kernel_size: int,
                 activation: Optional[str] = "relu", bnorm: str = "after",
                 bf16: bool = False, drop_rate: float = 0.0):
        super().__init__()
        self.weight = _zeros(channels, c_in, kernel_size)   # torch layout
        self.conv_bias = _zeros(channels)
        self.bn = BatchNorm(channels)
        self.activation, self.bnorm, self.bf16 = activation, bnorm, bf16
        self.kernel_size, self.drop_rate = kernel_size, drop_rate

    def _act(self, x):
        if self.activation == "relu":
            return F.relu(x)
        if self.activation == "tanh":
            return torch.tanh(x)
        return x

    def forward(self, x, train: bool = False, generator=None):
        lo, hi = _same_pad(x.shape[1], self.kernel_size, 1)
        h = F.pad(x.transpose(1, 2), (lo, hi))
        w, b = self.weight, self.conv_bias
        if self.bf16:
            h, w, b = h.bfloat16(), w.bfloat16(), b.bfloat16()
        h = F.conv1d(h, w, b).transpose(1, 2).float()
        if self.bnorm == "after":
            h = self.bn(self._act(h), train)
        else:
            h = self._act(self.bn(h, train))
        return dropout(h, self.drop_rate, generator) if train else h


class EncoderConvStack(nn.Module):
    """N× conv1d(k, C) + ReLU + BN (reference modules.py:67)."""

    def __init__(self, c_in: int, num_layers: int, channels: int,
                 kernel_size: int, bnorm: str = "after", bf16: bool = False,
                 drop_rate: float = 0.0):
        super().__init__()
        dims = [c_in] + [channels] * num_layers
        self.layers = nn.ModuleList(
            ConvBlock(dims[i], channels, kernel_size, "relu", bnorm, bf16,
                      drop_rate)
            for i in range(num_layers))

    def forward(self, x, train: bool = False, generator=None):
        for layer in self.layers:
            x = layer(x, train, generator)
        return x


class Postnet(nn.Module):
    """(N-1)× conv1d+tanh and one linear conv, each with BN
    (reference modules.py:258)."""

    def __init__(self, c_in: int, num_layers: int, channels: int,
                 kernel_size: int, bnorm: str = "after", bf16: bool = False,
                 drop_rate: float = 0.0):
        super().__init__()
        dims = [c_in] + [channels] * num_layers
        acts = ["tanh"] * (num_layers - 1) + [None]
        self.layers = nn.ModuleList(
            ConvBlock(dims[i], channels, kernel_size, acts[i], bnorm, bf16,
                      drop_rate)
            for i in range(num_layers))

    def forward(self, x, train: bool = False, generator=None):
        for layer in self.layers:
            x = layer(x, train, generator)
        return x


# --------------------------------------------------------------------- LSTM


def lstm_step(kernel, bias, x, c, h):
    """One LSTM step in TF LSTMCell gate order (i, j, f, o).

    `bias` already holds the folded forget bias (+1 on the f block;
    reference modules.py:89 adds it inside the step). Returns (c, h).
    """
    z = torch.cat([x, h], dim=-1) @ kernel + bias
    i, j, f, o = z.chunk(4, dim=-1)
    new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(j)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_c, new_h


class ZoneoutLSTMCell(nn.Module):
    """Zoneout LSTM (reference modules.py:101): at inference (1-z)·new +
    z·prev on c and h; in train mode, with masks m = (m_c, m_h) bool [B,
    U], the new value where m is set and the previous one elsewhere."""

    def __init__(self, d_in: int, units: int, zoneout: float):
        super().__init__()
        self.kernel = _zeros(d_in + units, 4 * units)
        self.bias = _zeros(4 * units)
        self.units, self.zoneout = units, zoneout

    def forward(self, c, h, x, m=None):
        new_c, new_h = lstm_step(self.kernel, self.bias, x, c, h)
        z = self.zoneout
        if m is not None:
            return torch.where(m[0], new_c, c), torch.where(m[1], new_h, h)
        if z > 0:
            new_c = (1 - z) * new_c + z * c
            new_h = (1 - z) * new_h + z * h
        return new_c, new_h


def reverse_sequence(x, lengths):
    """Per-row reversal of the first `lengths` steps (TF reverse_sequence);
    padding stays in place. x: [B, T, D], lengths: [B]."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    ln = lengths.to(x.device).long()[:, None]
    idx = torch.where(t < ln, ln - 1 - t, t)
    return torch.gather(x, 1, idx[:, :, None].expand_as(x))


class BiLSTMEncoder(nn.Module):
    """Bidirectional zoneout LSTM with length-aware reversal; outputs past
    each length are zero (reference modules.py:137,148)."""

    def __init__(self, d_in: int, units: int, zoneout: float):
        super().__init__()
        self.fw = ZoneoutLSTMCell(d_in, units, zoneout)
        self.bw = ZoneoutLSTMCell(d_in, units, zoneout)
        self.units = units

    def _run(self, cell, seq, masks):
        B, T, _ = seq.shape
        c = seq.new_zeros(B, self.units)
        h = seq.new_zeros(B, self.units)
        ys = []
        for t in range(T):
            c, h = cell(c, h, seq[:, t], None if masks is None else masks[t])
            ys.append(h)
        return torch.stack(ys, dim=1)

    def forward(self, x, lengths, train: bool = False, generator=None):
        """In train mode with zoneout > 0 each direction's masks [T, 2, B,
        U] (c, h) are Bernoulli(1 - z) draws from `generator` (in a
        data-parallel step the rank's rows of the global batch's)."""
        x = x.float()
        B, T, _ = x.shape
        masks = [None, None]
        if train and self.fw.zoneout > 0:
            keep = 1.0 - self.fw.zoneout
            masks = [dist.rand_rows((T, 2, B, self.units), generator,
                                    x.device, dim=2) < keep
                     for _ in range(2)]
        fw = self._run(self.fw, x, masks[0])
        bw = reverse_sequence(
            self._run(self.bw, reverse_sequence(x, lengths), masks[1]),
            lengths)
        out = torch.cat([fw, bw], dim=-1)
        T = x.shape[1]
        mask = torch.arange(T, device=x.device)[None, :] \
            < lengths.to(x.device)[:, None]
        return out * mask[:, :, None]


class GRUCell(nn.Module):
    """TF-layout GRU cell: gates (r, z) then candidate on [x, r·h]."""

    def __init__(self, d_in: int, units: int):
        super().__init__()
        self.gates_kernel = _zeros(d_in + units, 2 * units)
        self.gates_bias = _zeros(2 * units)
        self.candidate_kernel = _zeros(d_in + units, units)
        self.candidate_bias = _zeros(units)

    def forward(self, h, x):
        g = torch.sigmoid(torch.cat([x, h], -1) @ self.gates_kernel
                          + self.gates_bias)
        r, z = g.chunk(2, dim=-1)
        n = torch.tanh(torch.cat([x, r * h], -1) @ self.candidate_kernel
                       + self.candidate_bias)
        return z * h + (1 - z) * n


def gru(cell: GRUCell, seq):
    """The GRU over seq [B, T, D] from a zero state -> outputs [B, T, U]
    (JAX `GRU`, modules.py:206)."""
    h = seq.new_zeros(seq.shape[0], cell.candidate_bias.shape[0])
    ys = []
    for t in range(seq.shape[1]):
        h = cell(h, seq[:, t])
        ys.append(h)
    return torch.stack(ys, dim=1)


class BiGRU(nn.Module):
    """Bidirectional GRU over the whole sequence: [forward | backward
    over the time-reversed input, reversed back] -> [B, T, 2·units]
    (JAX `BiGRU` without lengths, modules.py:221)."""

    def __init__(self, d_in: int, units: int):
        super().__init__()
        self.fw = GRUCell(d_in, units)
        self.bw = GRUCell(d_in, units)

    def forward(self, x):
        bw = gru(self.bw, x.flip(1)).flip(1)
        return torch.cat([gru(self.fw, x), bw], dim=-1)


# the reference encoders' embedding width (the Dense(128) of
# modules.py:411): also the width of the speaker embedding that the
# emt_attn decoder takes in (`ref_spk`)
REF_EMB = 128


class ReferenceEncoder(nn.Module):
    """6× conv2d(3×3, stride 2, SAME) + BN + ReLU over the ref mel, a
    GRU over time, and Dense(128, tanh) on its last output
    (reference modules.py:367, `all_outputs=False`). With
    `all_outputs=True` (the emt_attn variant's emotion reference) it
    returns a sequence by `emt_ref_gru`: "gru" a BiGRU over the conv
    features [B, T', 2·depth]; "gru_multi" 8 GRU heads, each a tanh
    Dense(128) on its last output, [B, 8, 128]; "none" the conv features
    themselves [B, T', F·C]. `out_width` is the last dimension."""

    def __init__(self, num_mels: int, filters: Sequence[int], depth: int,
                 all_outputs: bool = False, emt_ref_gru: str = "gru"):
        super().__init__()
        chans = [1] + list(filters)
        self.convs = nn.ParameterList(
            _zeros(chans[i + 1], chans[i], 3, 3) for i in range(len(filters)))
        self.conv_biases = nn.ParameterList(
            _zeros(c) for c in filters)
        self.bns = nn.ModuleList(BatchNorm(c) for c in filters)
        f = num_mels
        for _ in filters:
            f = -(-f // 2)
        feat = f * filters[-1]
        self.mode = emt_ref_gru if all_outputs else "last"
        if self.mode == "last":
            self.gru = GRUCell(feat, depth)
            self.dense = Dense(depth, REF_EMB)
            self.out_width = REF_EMB
        elif self.mode == "gru":
            self.bigru = BiGRU(feat, depth)
            self.out_width = 2 * depth
        elif self.mode == "gru_multi":
            self.grus = nn.ModuleList(GRUCell(feat, depth) for _ in range(8))
            self.denses = nn.ModuleList(Dense(depth, REF_EMB)
                                        for _ in range(8))
            self.out_width = REF_EMB
        elif self.mode == "none":
            self.out_width = feat
        else:
            raise ValueError(f"emt_ref_gru={emt_ref_gru!r}")
        self.depth = depth

    def forward(self, mel, train: bool = False):
        x = mel.float()[:, None]                        # [B, 1, T, mels]
        for w, b, bn in zip(self.convs, self.conv_biases, self.bns):
            t_lo, t_hi = _same_pad(x.shape[2], 3, 2)
            f_lo, f_hi = _same_pad(x.shape[3], 3, 2)
            x = F.conv2d(F.pad(x, (f_lo, f_hi, t_lo, t_hi)), w, b, stride=2)
            x = F.relu(bn(x.permute(0, 2, 3, 1), train).permute(0, 3, 1, 2))
        B, C, T, Fq = x.shape
        # flax NHWC reshape(B, T, F*C): feature index = f*C + c
        seq = x.permute(0, 2, 3, 1).reshape(B, T, Fq * C)
        if self.mode == "gru":
            return self.bigru(seq)
        if self.mode == "gru_multi":
            return torch.stack([torch.tanh(d(gru(g, seq)[:, -1]))
                                for g, d in zip(self.grus, self.denses)], 1)
        if self.mode == "none":
            return seq
        h = seq.new_zeros(B, self.depth)
        for t in range(T):
            h = self.gru(h, seq[:, t])
        return torch.tanh(self.dense(h))


class MultiheadStyleAttention(nn.Module):
    """GST multi-head attention with the normalized-mlp scorer (the default
    `style_att_type`); values are tiled per head, not projected (reference
    modules.py:472)."""

    def __init__(self, d_query: int, d_value: int, num_heads: int,
                 num_units: int, attention_type: str = "mlp_attention"):
        super().__init__()
        assert attention_type == "mlp_attention", \
            "the port covers the normalized mlp scorer"
        assert num_units % num_heads == 0
        hd = num_units // num_heads
        self.q_proj = Dense(d_query, num_units)
        self.k_proj = Dense(d_value, num_units)
        self.attention_v = _zeros(hd)
        self.attention_g = _zeros(())
        self.attention_b = _zeros(hd)
        self.num_heads, self.hd = num_heads, hd

    def forward(self, query, value):
        # query [B, Tq, Dq], value [B, Tv, Dv] -> [B, Tq, H*Dv]
        q, k = self.q_proj(query), self.k_proj(value)
        B, Tq, _ = q.shape
        Tv, H, hd = value.shape[1], self.num_heads, self.hd
        qs = q.reshape(B, Tq, H, hd).transpose(1, 2)       # [B, H, Tq, hd]
        ks = k.reshape(B, Tv, H, hd).transpose(1, 2)       # [B, H, Tv, hd]
        v = self.attention_v
        normed_v = self.attention_g * v * torch.rsqrt(torch.sum(v * v))
        add = torch.sum(normed_v * torch.tanh(
            ks[:, :, None] + qs[:, :, :, None] + self.attention_b), -1)
        w = torch.softmax(add, dim=-1)                     # [B, H, Tq, Tv]
        ctx = w @ value[:, None]                           # [B, H, Tq, Dv]
        return ctx.transpose(1, 2).reshape(B, Tq, -1)


# ------------------------------------------------------------------- CBHG


class HighwayNet(nn.Module):
    """H·T + x·(1 - T), H = relu(Dense H), T = sigmoid(Dense T) (JAX
    `HighwayNet`, modules.py:308; T's bias starts at -1, `convert.py`)."""

    def __init__(self, units: int):
        super().__init__()
        self.H = Dense(units, units)
        self.T = Dense(units, units)

    def forward(self, x):
        t = torch.sigmoid(self.T(x))
        return F.relu(self.H(x)) * t + x * (1.0 - t)


class CBHG(nn.Module):
    """The mel -> linear post-processing net (JAX `CBHG`, modules.py:322):
    a bank of K convs (kernel 1..K, relu, BatchNorm) joined, a stride-1
    max-pool of width `pool_size` (SAME, -inf padding), two projection
    convs (relu, then linear) plus the input as a residual, a Dense to
    the highway width where the widths differ, the highway layers and a
    BiGRU over the whole sequence -> [B, T, 2·rnn_units]. Its convs run in
    f32 (the JAX CBHG gives them no compute dtype). `layers` holds the K
    bank convs then the two projections (flax ConvBlock_0..K+1)."""

    def __init__(self, c_in: int, K: int, conv_channels: int, pool_size: int,
                 projections: Sequence[int], projection_kernel_size: int,
                 num_highway_layers: int, highway_units: int,
                 rnn_units: int, bnorm: str = "after"):
        super().__init__()
        bank = [ConvBlock(c_in, conv_channels, k, "relu", bnorm)
                for k in range(1, K + 1)]
        self.layers = nn.ModuleList(bank + [
            ConvBlock(K * conv_channels, projections[0],
                      projection_kernel_size, "relu", bnorm),
            ConvBlock(projections[0], projections[1],
                      projection_kernel_size, None, bnorm)])
        self.K, self.pool_size = K, pool_size
        self.dense = (Dense(projections[1], highway_units)
                      if projections[1] != highway_units else None)
        self.highways = nn.ModuleList(HighwayNet(highway_units)
                                      for _ in range(num_highway_layers))
        self.bigru = BiGRU(highway_units, rnn_units)

    def forward(self, x, train: bool = False):
        x = x.float()
        bank = torch.cat([self.layers[k](x, train) for k in range(self.K)],
                         -1)
        lo = (self.pool_size - 1) // 2
        padded = F.pad(bank.transpose(1, 2),
                       (lo, self.pool_size - 1 - lo), value=-float("inf"))
        pooled = F.max_pool1d(padded, self.pool_size, 1).transpose(1, 2)
        proj = self.layers[self.K + 1](self.layers[self.K](pooled, train),
                                       train)
        h = proj + x
        if self.dense is not None:
            h = self.dense(h)
        for hw in self.highways:
            h = hw(h)
        return self.bigru(h)


class ReferenceEncoderAdaIn(nn.Module):
    """The AdaIN reference encoder (JAX `ReferenceEncoderAdaIn`,
    modules.py:416-444): one conv stack (3×3, SAME, strides (2, 2) twice
    then (1, 1), relu, no BatchNorm) over both references; the speaker
    features renormalised with the emotion features' moments over time
    and frequency, (xs - μs)·rsqrt(σ²s + 1e-9)·σ²e + μe (the variance, as
    the reference scales it), mixed 90/10 with the speaker features; a
    GRU over time and tanh(Dense(128)) on its last output -> [B, 128]."""

    STRIDES = ((2, 2), (2, 2), (1, 1), (1, 1), (1, 1), (1, 1))

    def __init__(self, num_mels: int, filters: Sequence[int], depth: int):
        super().__init__()
        chans = [1] + list(filters)
        self.convs = nn.ParameterList(
            _zeros(chans[i + 1], chans[i], 3, 3) for i in range(len(filters)))
        self.conv_biases = nn.ParameterList(_zeros(c) for c in filters)
        f = num_mels
        for i in range(len(filters)):
            f = -(-f // self.STRIDES[i][1])
        self.gru = GRUCell(f * filters[-1], depth)
        self.dense = Dense(depth, REF_EMB)
        self.depth = depth

    def _conv(self, x, i):
        st, sf = self.STRIDES[i]
        t_lo, t_hi = _same_pad(x.shape[2], 3, st)
        f_lo, f_hi = _same_pad(x.shape[3], 3, sf)
        return F.relu(F.conv2d(F.pad(x, (f_lo, f_hi, t_lo, t_hi)),
                               self.convs[i], self.conv_biases[i],
                               stride=(st, sf)))

    def forward(self, ref_spk, ref_emt):
        xs, xe = ref_spk.float()[:, None], ref_emt.float()[:, None]
        for i in range(len(self.convs)):
            xs, xe = self._conv(xs, i), self._conv(xe, i)
        # [B, C, T, F]: moments over (T, F), biased variance
        var = lambda x: x.var((2, 3), unbiased=False, keepdim=True)
        mean = lambda x: x.mean((2, 3), keepdim=True)
        norm = ((xs - mean(xs)) * torch.rsqrt(var(xs) + 1e-9) * var(xe)
                + mean(xe))
        xs = xs * 0.9 + norm * 0.1
        B, C, T, Fq = xs.shape
        seq = xs.permute(0, 2, 3, 1).reshape(B, T, Fq * C)
        h = seq.new_zeros(B, self.depth)
        for t in range(T):
            h = self.gru(h, seq[:, t])
        return torch.tanh(self.dense(h))
