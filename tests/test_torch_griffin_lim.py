"""The port's Griffin-Lim against the JAX package's, on the CPU.

The port's `griffin_lim` on CPU tensors runs its plain version
(`ops/griffin_lim_kernel.py:griffin_lim_plain`); the JAX side runs
`ops.griffin_lim.griffin_lim` (the XLA path) and the Pallas kernel
`fused_griffin_lim(interpret=True)`. As tests/test_pallas_kernels.py:237
argues, samples are comparable one by one only where no bin has a
near-zero magnitude (its phase is then set by rounding noise): at iters 0
both are one iSTFT, f32 on both sides in another sum order (atol 1e-5 on
samples of ~1); at iters 8 samples of a full-band signal agree to atol
1e-4, and for tones the spectral-consistency errors agree within 10% and
the peaks stay put. The CUDA kernel's two routes are checked by replaying
their arithmetic in PyTorch against the plain version (atol 1e-5, f32 in
another order): the DFT route's operands (window-folded bases over the
support, the overlap-add normalisation `g`), and the FFT route's Stockham
passes (`fft_plan`), its float64-made twiddle table, the real-input
packing and the per-frame overlap-add gather with `g`. The twiddle table
and the passes are also held against numpy.fft in float64 (to f32 rounding
and to 1e-10).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.config import Config
from tacotron2_tpu.ops import griffin_lim as jgl
from tacotron2_tpu.ops import stft as jst
from tacotron2_tpu.ops.griffin_lim_kernel import fused_griffin_lim
from tacotron2_tpu_torch.config import Config as TorchConfig
from tacotron2_tpu_torch.ops import griffin_lim as tgl
from tacotron2_tpu_torch.ops import griffin_lim_kernel as glk
from tacotron2_tpu_torch.ops import stft as tst

SHAPES = [(512, 128, 512), (512, 128, 400), (2048, 200, 800)]


def _tones(n_fft, hop, win, F=17, B=2):
    """tests/test_pallas_kernels.py:251's tones: 300 + 100·b cycles over
    the signal."""
    t = np.linspace(0, 1, hop * (F - 1))
    y = np.stack([np.sin(2 * np.pi * (300 + 100 * b) * t)
                  for b in range(B)]).astype(np.float32)
    return y, np.array(jst.stft_mag(jnp.asarray(y), n_fft, hop, win))


def _noise(n_fft, hop, win, F=17, B=2):
    y = np.random.default_rng(0).normal(size=(B, hop * (F - 1))).astype(
        np.float32)
    return y, np.array(jst.stft_mag(jnp.asarray(y), n_fft, hop, win))


def _consistency(y, S, n_fft, hop, win):
    mag = np.asarray(jst.stft_mag(jnp.asarray(y), n_fft, hop, win))
    return float(np.mean(np.abs(mag - S)))


@pytest.mark.parametrize("n_fft,hop,win", SHAPES)
@pytest.mark.parametrize("iters", [0, 8])
def test_griffin_lim_matches_jax(n_fft, hop, win, iters):
    for signal in (_tones, _noise):
        _, S = signal(n_fft, hop, win)
        want = np.asarray(jgl.griffin_lim(jnp.asarray(S), n_fft, hop, win,
                                          iters=iters))
        got = tgl.griffin_lim(torch.as_tensor(S), n_fft, hop, win,
                              iters=iters).numpy()
        assert got.shape == want.shape
        if iters == 0 or signal is _noise:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 if iters == 0 else 1e-4)
        c_t = _consistency(got, S, n_fft, hop, win)
        c_j = _consistency(want, S, n_fft, hop, win)
        assert c_t < 1.1 * c_j + 1e-4 and c_j < 1.1 * c_t + 1e-4


@pytest.mark.parametrize("iters", [0, 8])
def test_griffin_lim_matches_tpu_kernel(iters):
    """The Pallas kernel in interpret mode: the zero-phase reconstruction
    of a batch [B, F, K] (tests/test_pallas_kernels.py:237's shapes)."""
    n_fft, hop, win = 512, 128, 512
    for signal in (_tones, _noise):
        _, S = signal(n_fft, hop, win)
        want = np.asarray(fused_griffin_lim(jnp.asarray(S), n_fft, hop, win,
                                            iters=iters, interpret=True))
        got = tgl.griffin_lim(torch.as_tensor(S), n_fft, hop, win,
                              iters=iters).numpy()
        if iters == 0 or signal is _noise:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 if iters == 0 else 1e-4)
        c_t = _consistency(got, S, n_fft, hop, win)
        c_j = _consistency(want, S, n_fft, hop, win)
        assert c_t < 1.1 * c_j + 1e-4 and c_j < 1.1 * c_t + 1e-4
    if iters:   # the reconstructed tones keep their spectral peaks
        _, S = _tones(n_fft, hop, win)
        got = tgl.griffin_lim(torch.as_tensor(S), n_fft, hop, win,
                              iters=iters).numpy()
        for b in range(S.shape[0]):
            spec = np.abs(np.fft.rfft(got[b]))
            freq = np.fft.rfftfreq(got.shape[-1], 1.0 / got.shape[-1])
            assert abs(freq[spec.argmax()] - (300 + 100 * b)) < 15, b


def _kernel_replay(S, re0, im0, n_fft, hop, win, iters):
    """csrc/griffin_lim.cu's arithmetic in PyTorch: the synthesis product
    against bsyn with the magnitude projection on load, the overlap-add by
    index with g, and the analysis product of the re-framed signal
    against bana."""
    B, F, K = S.shape
    ops = glk.kernel_bases(n_fft, hop, win, "cpu")
    g = glk.overlap_add_norm(n_fft, hop, win, F, "cpu")
    W = ops.bana.shape[0]
    total = n_fft + hop * (F - 1)
    n = torch.arange(total)
    f = torch.arange(F)
    j = n[None, :] - f[:, None] * hop - ops.lpad              # [F, total]
    cover = (j >= 0) & (j < W)

    def synth_ola(reim):
        frames = reim @ ops.bsyn                               # [B, F, W]
        picked = frames[:, f[:, None].expand(F, total),
                        j.clamp(0, W - 1)]                     # [B, F, total]
        return (picked * cover).sum(1) * g

    y = synth_ola(torch.cat([re0, im0], -1))
    idx = (f[:, None] * hop + ops.lpad + torch.arange(W)[None, :])
    for _ in range(iters):
        est = y[:, idx] @ ops.bana                             # [B, F, 2K]
        er, ei = est[..., :K], est[..., K:]
        mag = torch.clamp(torch.sqrt(er * er + ei * ei), min=1e-8)
        y = synth_ola(torch.cat([S * er / mag, S * ei / mag], -1))
    pad = n_fft // 2
    return y[:, pad:pad + hop * (F - 1)]


@pytest.mark.parametrize("n_fft,hop,win", SHAPES)
def test_kernel_operands_replay_the_plain_version(n_fft, hop, win):
    _, S = _tones(n_fft, hop, win, F=9)
    S = torch.as_tensor(S)
    g = torch.Generator().manual_seed(0)
    phase = torch.rand(S.shape, generator=g) * 6.2831855
    re0, im0 = S * torch.cos(phase), S * torch.sin(phase)
    for iters in (0, 3):
        want = glk.griffin_lim_plain(S, re0, im0, n_fft, hop, win, iters)
        got = _kernel_replay(S, re0, im0, n_fft, hop, win, iters)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _stockham(z, tw, plan):
    """csrc/griffin_lim.cu's fft_forward on [..., M] complex: Stockham
    passes of radix `plan`, twiddles w_n^p = tw[2ps] (tw[t] = e^{-2πi
    t/2M})."""
    M = z.shape[-1]
    n, s, a = M, 1, z
    for r in plan:
        b = torch.empty_like(a)
        i = torch.arange(M // r)
        p, q = i // s, i % s
        if r == 4:
            n4 = n // 4
            A, B_, C, D = (a[..., q + s * (p + j * n4)] for j in range(4))
            apc, amc, bpd, jb = A + C, A - C, B_ + D, -1j * (B_ - D)
            e = 2 * p * s
            b[..., q + s * 4 * p] = apc + bpd
            b[..., q + s * (4 * p + 1)] = tw[e] * (amc + jb)
            b[..., q + s * (4 * p + 2)] = tw[2 * e] * (apc - bpd)
            b[..., q + s * (4 * p + 3)] = tw[3 * e] * (amc - jb)
        else:
            A, B_ = a[..., q + s * p], a[..., q + s * (p + 1)]
            b[..., q + s * 2 * p] = A + B_
            b[..., q + s * (2 * p + 1)] = tw[2 * p * s] * (A - B_)
        n, s, a = n // r, s * r, b
    return a


def _fft_route_replay(S, re0, im0, n_fft, hop, win, iters, bf16=False):
    """csrc/griffin_lim.cu's FFT route in PyTorch: per frame, the inverse
    real FFT (E + iO packed, conjugated through the forward passes, Im X[0]
    and Im X[M] dropped) times the window over its support; the analysis
    gathering each support sample's overlap-add with g, the forward real
    FFT and the magnitude projection; one overlap-add at the end. With
    `bf16` the spectrum entering each synthesis, the window and each
    gathered sample are rounded to bf16, as the kernel's bf16 mode loads
    them."""
    B, F, K = S.shape
    M = n_fft // 2
    ops = glk.fft_operands(n_fft, win, "cpu")
    rnd = glk.bf16_round if bf16 else (lambda x: x)
    ops = ops._replace(win=rnd(ops.win))
    W, lpad = ops.win.shape[0], ops.lpad
    tw = torch.complex(ops.tw[:, 0], ops.tw[:, 1])
    plan = glk.fft_plan(n_fft)
    g = glk.overlap_add_norm(n_fft, hop, win, F, "cpu")
    total = n_fft + hop * (F - 1)
    f = torch.arange(F)
    j = torch.arange(total)[None, :] - f[:, None] * hop - lpad   # [F, total]
    cover = (j >= 0) & (j < W)

    def ola(frames):                                          # ola_at
        picked = frames[:, f[:, None].expand(F, total), j.clamp(0, W - 1)]
        return (picked * cover).sum(1) * g

    k = torch.arange(M)

    def synthesis(X):
        X = torch.complex(rnd(X.real), rnd(X.imag) * ((torch.arange(K) > 0)
                                            & (torch.arange(K) < M)))
        xk, xm = X[..., :M], X[..., M - k].conj()
        E, D = 0.5 * (xk + xm), 0.5 * (xk - xm)
        Z = E + 1j * (D * tw[:M].conj())
        z = _stockham(Z.conj(), tw, plan).conj() / M
        x = torch.stack([z.real, z.imag], -1).reshape(B, F, 2 * M)
        return x[..., lpad:lpad + W] * ops.win

    sup = f[:, None] * hop + lpad + torch.arange(W)[None, :]  # [F, W]

    def analysis(frames):
        x = torch.zeros(B, F, n_fft)
        x[..., lpad:lpad + W] = rnd(ola(frames)[:, sup]) * ops.win
        Z = _stockham(torch.complex(x[..., 0::2], x[..., 1::2]), tw, plan)
        kk = torch.arange(M + 1)
        zk, zm = Z[..., kk % M], Z[..., (M - kk) % M].conj()
        X = 0.5 * (zk + zm) + tw[:M + 1] * (-0.5j * (zk - zm))
        return S * X / torch.clamp(X.abs(), min=1e-8)

    frames = synthesis(torch.complex(re0, im0))
    for _ in range(iters):
        frames = synthesis(analysis(frames))
    pad = n_fft // 2
    return ola(frames)[:, pad:pad + hop * (F - 1)]


@pytest.mark.parametrize("n_fft,hop,win", SHAPES + [(1024, 256, 1024)])
def test_fft_route_replays_the_plain_version(n_fft, hop, win):
    """SHAPES take radix-4 passes only; n_fft 1024 adds the radix-2 pass."""
    assert glk.route(n_fft) == "fft"
    _, S = _tones(n_fft, hop, win, F=9)
    S = torch.as_tensor(S)
    g = torch.Generator().manual_seed(0)
    phase = torch.rand(S.shape, generator=g) * 6.2831855
    re0, im0 = S * torch.cos(phase), S * torch.sin(phase)
    for iters in (0, 3):
        want = glk.griffin_lim_plain(S, re0, im0, n_fft, hop, win, iters)
        got = _fft_route_replay(S, re0, im0, n_fft, hop, win, iters)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n_fft,hop,win", [(512, 128, 400),
                                           (1024, 256, 1024)])
def test_fft_plain_replays_the_fft_route(n_fft, hop, win, bf16):
    """`griffin_lim_fft_plain`, the FFT route's plain version (torch.fft),
    against the route's replay, in both modes, from a random-phase start:
    at 0 iterations to atol 1e-5 (f32 transforms in another order), at 1
    to a median |diff| within 2e-5 of the median |sample| (chip_smoke.py's
    gate; a bf16 rounding that flips between the two can move a near-zero
    bin's phase). In f32 it is the DFT plain version; in bf16 it stays
    more than 10x the gates away from its f32 self."""
    _, S = _noise(n_fft, hop, win, F=9)
    S = torch.as_tensor(S)
    g = torch.Generator().manual_seed(1)
    phase = torch.rand(S.shape, generator=g) * 6.2831855
    re0, im0 = S * torch.cos(phase), S * torch.sin(phase)
    rel_med = lambda a, b: float((a - b).abs().median() / b.abs().median())
    got = {it: glk.griffin_lim_fft_plain(S, re0, im0, n_fft, hop, win, it,
                                         bf16) for it in (0, 1)}
    want = {it: _fft_route_replay(S, re0, im0, n_fft, hop, win, it, bf16)
            for it in (0, 1)}
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    assert rel_med(got[1], want[1]) <= 2e-5
    if not bf16:
        for it in (0, 1):
            np.testing.assert_allclose(
                got[it], glk.griffin_lim_plain(S, re0, im0, n_fft, hop, win,
                                               it), rtol=0, atol=1e-5)
    else:
        f32 = {it: glk.griffin_lim_fft_plain(S, re0, im0, n_fft, hop, win,
                                             it) for it in (0, 1)}
        assert float((got[0] - f32[0]).abs().max()) > 1e-4
        assert rel_med(got[1], f32[1]) > 2e-4


@pytest.mark.parametrize("n_fft", [8, 512, 1024, 2048, 4096])
def test_fft_twiddles_and_passes_match_numpy(n_fft):
    """The f32 table is e^{-2πi t/n_fft} rounded once from float64; the
    passes of `fft_plan` with the float64 table are numpy's FFT."""
    tw = glk.fft_twiddles(n_fft).astype(np.float64)
    want = np.fft.fft(np.eye(n_fft)[1])
    assert np.abs(tw[:, 0] + 1j * tw[:, 1] - want).max() <= 2.0 ** -24
    M = n_fft // 2
    z = np.random.default_rng(n_fft).normal(size=(3, M, 2)) @ [1, 1j]
    got = _stockham(torch.as_tensor(z), torch.as_tensor(want),
                    glk.fft_plan(n_fft)).numpy()
    np.testing.assert_allclose(got, np.fft.fft(z, axis=-1), rtol=0,
                               atol=1e-10)


def test_route_is_chosen_by_shape():
    for n_fft in (8, 512, 1024, 2048, 4096, glk.FFT_MAX):
        assert glk.route(n_fft) == "fft", n_fft
    for n_fft in (1000, 800, 2 * glk.FFT_MAX, 6, 2):
        assert glk.route(n_fft) == "dft", n_fft
    assert glk.fft_plan(2048) == [4] * 5
    assert glk.fft_plan(1024) == [4] * 4 + [2]
    assert glk.fft_plan(512) == [4] * 4 and glk.fft_plan(8) == [4]


def test_random_phase_start_runs_through_the_same_function():
    """A generator draws the initial phases; the result is the plain
    function from that start (the kernel takes the same (re0, im0))."""
    n_fft, hop, win = 512, 128, 400
    _, S = _tones(n_fft, hop, win)
    S = torch.as_tensor(S)
    got = tgl.griffin_lim(S, n_fft, hop, win, iters=2,
                          generator=torch.Generator().manual_seed(3))
    phase = torch.rand(S.shape, generator=torch.Generator().manual_seed(3)) \
        * (2 * np.pi)
    want = glk.griffin_lim_plain(S, S * torch.cos(phase),
                                 S * torch.sin(phase), n_fft, hop, win, 2)
    torch.testing.assert_close(got, want)
    assert not torch.allclose(got, tgl.griffin_lim(S, n_fft, hop, win,
                                                   iters=2))
    # gl_compute_dtype="bfloat16" runs the kernel's bf16 mode (its plain
    # version here); another dtype raises
    torch.testing.assert_close(
        tgl.griffin_lim(S, n_fft, hop, win, iters=2,
                        compute_dtype="bfloat16"),
        glk.griffin_lim_plain(S, S, torch.zeros_like(S), n_fft, hop, win, 2,
                              bf16=True))
    with pytest.raises(ValueError):
        tgl.griffin_lim(S, n_fft, hop, win, compute_dtype="float16")


@pytest.mark.parametrize("iters,atol", [(0, 1e-5), (4, 1e-3)])
def test_inv_mel_spectrogram_matches_jax(iters, atol):
    """Denormalise, dB -> amplitude, pseudo-inverse mel basis, power, G-L.
    Samples reach ~7: after 4 iterations f32 order differences grow to
    ~3e-4 at a few samples, hence atol 1e-3 there."""
    kw = dict(n_fft=512, win_size=400, hop_size=128,
              griffin_lim_iters=iters)
    cfg_j = dataclasses.replace(Config().audio, **kw)
    cfg_t = dataclasses.replace(TorchConfig().audio, **kw)
    mel = np.random.default_rng(0).uniform(-4, 2, (2, 12, 80)).astype(
        np.float32)
    want = np.asarray(jgl.inv_mel_spectrogram(jnp.asarray(mel), cfg_j))
    got = tgl.inv_mel_spectrogram(torch.as_tensor(mel), cfg_t).numpy()
    assert got.shape == want.shape == (2, 128 * 11)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    lin = np.random.default_rng(1).uniform(-4, 2, (12, 257)).astype(
        np.float32)
    np.testing.assert_allclose(
        tgl.inv_linear_spectrogram(torch.as_tensor(lin), cfg_t).numpy(),
        np.asarray(jgl.inv_linear_spectrogram(jnp.asarray(lin), cfg_j)),
        rtol=0, atol=atol)


def test_cpu_tensors_take_the_plain_version():
    before = (glk.launches, glk.launches_fft, glk.launches_dft)
    S = torch.rand(1, 5, 257)
    y = glk.fused_griffin_lim(S, S, torch.zeros_like(S), 512, 128, 512, 1)
    assert y.shape == (1, 4 * 128)
    assert (glk.launches, glk.launches_fft, glk.launches_dft) == before
    assert jax.devices()[0].platform == "cpu"


def test_kernel_bases_are_shared_across_frame_counts():
    """The window-folded bases depend on (n_fft, hop, win, device) only:
    one copy serves every frame count; g is made for each."""
    n_fft, hop, win = 512, 128, 400
    a = glk.kernel_bases(n_fft, hop, win, "cpu")
    assert glk.kernel_bases(n_fft, hop, win, "cpu") is a
    assert a.bsyn.shape == (2 * (n_fft // 2 + 1), win) \
        and a.bana.shape == (win, 2 * (n_fft // 2 + 1))
    for F in (5, 9):
        g = glk.overlap_add_norm(n_fft, hop, win, F, "cpu")
        assert g.shape == (n_fft + hop * (F - 1),)
        assert not g[:n_fft // 2].any() and not g[-(n_fft // 2):].any()
