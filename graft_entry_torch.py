#!/usr/bin/env python3
"""The flagship step and its training step on the PyTorch/CUDA port.

The twin of ``__graft_entry__.py`` over ``veles.simd_tpu_torch``:

* ``entry()`` returns the flagship forward step, the signal-processing
  pipeline the library exists for (normalize -> matched filter by FFT
  -> one Haar split -> feature GEMM -> peak mask), at the JAX file's
  sizes and seed (8 x 4096 signals, 129 taps, 64 features);
* ``train_step`` is one SGD step of the filter and the projection
  under ``torch.autograd`` on one device (the JAX file's
  ``jax.value_and_grad`` step);
* ``sharded_train_step`` is the same step over a dp x sp x tp mesh of
  the port's shard runner: the batch on dp, the projection's rows on
  tp, sp a replica of the step;
* ``dryrun_multichip(n)`` runs that step on an n-shard mesh of
  ``Config.device`` (8 shards of ``cuda:0`` on one card), then every
  sharded call of the JAX dry run against its single-device result.

Every step computes on ``Config.device``: the card unless the caller
set ``set_config(device="cpu")``.  The path reaches no kernel of
``csrc/``: the filter is cuFFT through ``torch.fft`` and the GEMM an
fp32 matmul, as the JAX step leaves both to XLA.

Run:  python3 graft_entry_torch.py                          # the card
      VELES_SIMD_PLATFORM=cpu python3 graft_entry_torch.py

Without a card and without ``VELES_SIMD_PLATFORM=cpu`` it exits 2.
"""

import sys

import numpy as np
import torch

from veles.simd_tpu_torch import parallel as par
from veles.simd_tpu_torch.ops.detect_peaks import ExtremumType, _peak_mask
from veles.simd_tpu_torch.parallel import _spmd
from veles.simd_tpu_torch.parallel._spmd import P
from veles.simd_tpu_torch.runtime.precision import fp32_matmul, p_einsum
from veles.simd_tpu_torch.utils import platform
from veles.simd_tpu_torch.utils.platform import to_host


def _filtered(h, x):
    """Each row of ``x`` normalized to [-1, 1], then convolved with
    ``h`` by one power-of-two FFT, cut to the row's length."""
    mn = torch.amin(x, dim=-1, keepdim=True)
    mx = torch.amax(x, dim=-1, keepdim=True)
    xn = torch.where(mx == mn, torch.zeros_like(x),
                     (x - mn) / ((mx - mn) / 2.0) - 1.0)
    n = xn.shape[-1]
    k = h.shape[-1]
    m = 1 << (n + k - 2).bit_length()
    spec = torch.fft.rfft(xn, m, dim=-1) * torch.fft.rfft(h, m)
    return torch.fft.irfft(spec, m, dim=-1)[..., :n]


def _pipeline(params, x):
    """Flagship forward: ``(feats [batch, f], mask [batch, n] bool)``
    of ``x`` ``[batch, n]``, differentiable in ``params`` (``filter``
    ``[k]``, ``proj`` ``[f, n/2]``)."""
    h, w = params["filter"], params["proj"]
    filt = _filtered(h, x)
    # single Haar DWT split (ops/wavelet, stride-2 filter bank)
    lo = (filt[..., 0::2] + filt[..., 1::2]) * 2 ** -0.5
    # feature projection in full fp32 (ops/matrix)
    feats = p_einsum("fd,bd->bf", w, lo, "highest")
    # peak mask of the filtered signal (ops/detect_peaks fixed form)
    mask = _peak_mask(filt, ExtremumType.BOTH)
    return feats, mask


def params_from_jax(params, device=None):
    """The JAX step's parameter dict (JAX or NumPy arrays) as float32
    tensors on ``device`` (default ``Config.device``)."""
    dev = platform.device() if device is None else torch.device(device)
    return {name: torch.as_tensor(np.array(np.asarray(v), np.float32),
                                  device=dev)
            for name, v in params.items()}


def params_to_numpy(params):
    """``params`` read back as NumPy arrays."""
    return {name: to_host(v) for name, v in params.items()}


def entry():
    """``(fn, example_args)``: the forward step at the JAX file's
    sizes, drawn from ``RandomState(0)`` in its order."""
    rng = np.random.RandomState(0)
    batch, n, k, f = 8, 4096, 129, 64
    params = params_from_jax({
        "filter": rng.randn(k).astype(np.float32) * 0.1,
        "proj": rng.randn(f, n // 2).astype(np.float32) * (n // 2) ** -0.5,
    })
    x = platform.to_device(rng.randn(batch, n).astype(np.float32))
    return _pipeline, (params, x)


def loss_fn(params, x, target):
    """Mean squared error of the features against ``target``."""
    feats, _ = _pipeline(params, x)
    return torch.mean((feats - target) ** 2)


def _sgd(params, grads, lr):
    return {name: p.detach() - lr * g
            for (name, p), g in zip(params.items(), grads)}


def train_step(params, x, target, lr=0.01):
    """``(loss, new_params)``: one SGD step on one device, the
    gradients from ``torch.autograd``; ``params`` is left as it is."""
    with torch.enable_grad(), fp32_matmul():
        leaves = {name: p.detach().requires_grad_(True)
                  for name, p in params.items()}
        loss = loss_fn(leaves, x, target)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), _sgd(params, grads, lr)


def _factor_axes(n: int):
    """Split n devices into (dp, sp, tp): prime factors dealt round-robin."""
    factors = []
    m = n
    p = 2
    while p * p <= m:
        while m % p == 0:
            factors.append(p)
            m //= p
        p += 1
    if m > 1:
        factors.append(m)
    axes = [1, 1, 1]
    for i, f in enumerate(sorted(factors, reverse=True)):
        axes[i % 3] *= f
    return tuple(axes)


def sharded_train_step(params, x, target, mesh, lr=0.01):
    """:func:`train_step` over ``mesh``'s ``dp``/``sp``/``tp`` axes:
    ``x`` and ``target`` split by rows over dp, ``proj`` by rows over
    tp, ``filter`` replicated; each shard takes the gradient of its
    block's squared error over the global ``batch * f``, and the sums
    run over dp and tp only (sp shards repeat the same work).  Returns
    ``(loss, new_params)`` on the mesh's first device."""
    batch, f = target.shape
    scale = 1.0 / (batch * f)

    def body(xb, tb, h, w):
        fl = w.shape[0]
        j = _spmd.axis_index("tp")
        with torch.enable_grad():
            hh = h.detach().requires_grad_(True)
            ww = w.detach().requires_grad_(True)
            feats, _ = _pipeline({"filter": hh, "proj": ww}, xb)
            part = torch.sum((feats - tb[:, j * fl:(j + 1) * fl]) ** 2)
            part = part * scale
            gh, gw = torch.autograd.grad(part, (hh, ww))
        # collectives see detached values only
        loss = _spmd.psum(part.detach().reshape(1), ("dp", "tp"))
        gh = _spmd.psum(gh, ("dp", "tp"))
        gw = _spmd.psum(gw, "dp")
        new = _sgd({"filter": h, "proj": w}, (gh, gw), lr)
        return new["filter"], new["proj"], loss

    run = _spmd.shard_map(
        body, mesh,
        in_specs=(P("dp", None), P("dp", None), P(), P("tp", None)),
        out_specs=(P(), P("tp", None), P()))
    h, w, loss = run(x, target, params["filter"], params["proj"])
    return loss[0], {"filter": h, "proj": w}


def dryrun_multichip(n_devices: int) -> float:
    """One sharded training step and the JAX dry run's sharded calls
    on an ``n_devices``-shard mesh of ``Config.device`` (the shards
    share the device); returns the step's loss."""
    dp, sp, tp = _factor_axes(n_devices)
    assert dp * sp * tp == n_devices, (dp, sp, tp, n_devices)
    dev = platform.device()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = par.make_mesh({"dp": dp, "sp": sp, "tp": tp},
                         devices=[dev] * n_devices)
    return _dryrun_body(mesh)


def _close(got, want, atol, rtol=1e-7):
    np.testing.assert_allclose(to_host(got), to_host(want), rtol=rtol,
                               atol=atol)


def _dryrun_body(mesh) -> float:
    from veles.simd_tpu_torch.ops import convolve2d as _cv2
    from veles.simd_tpu_torch.ops import filters as _fl
    from veles.simd_tpu_torch.ops import iir as _iir
    from veles.simd_tpu_torch.ops import normalize as _nm
    from veles.simd_tpu_torch.ops import resample as _rsm
    from veles.simd_tpu_torch.ops import spectral as _sp
    from veles.simd_tpu_torch.ops import wavelet as _wv

    dp, sp, tp = (mesh.shape[a] for a in ("dp", "sp", "tp"))
    dev = mesh.first_device()

    def put(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    rng = np.random.RandomState(1)
    batch = 2 * dp
    n, k, f = 256, 17, 4 * tp
    params = params_from_jax({
        "filter": rng.randn(k).astype(np.float32) * 0.1,
        "proj": rng.randn(f, n // 2).astype(np.float32) * 0.05,
    }, device=dev)
    x = put(rng.randn(batch, n).astype(np.float32))
    target = put(rng.randn(batch, f).astype(np.float32))

    loss, _ = sharded_train_step(params, x, target, mesh)
    loss = float(to_host(loss))
    assert np.isfinite(loss), loss
    # sequence-parallel halo-exchange convolution over the sp axis
    sig = put(rng.randn(64 * sp).astype(np.float32))
    ker = put(rng.randn(9).astype(np.float32))
    out = par.sharded_convolve(sig, ker, mesh, axis="sp")
    _close(out, np.convolve(to_host(sig), to_host(ker)), 1e-3)
    # dp x sp tiled batched convolution: every row survives the tiling
    xb = rng.randn(2 * dp, 64 * sp).astype(np.float32)
    outb = to_host(par.sharded_convolve_batch(put(xb), ker, mesh))
    kn = to_host(ker)
    for i in range(len(xb)):
        _close(outb[i], np.convolve(xb[i], kn), 1e-3)
    # sharded a-trous SWT cascade over sp, against the periodic SWT
    bands = par.sharded_swt("daub", 4, 2, sig, mesh, axis="sp")
    want_bands = _wv.stationary_wavelet_transform(
        "daub", 4, _wv.ExtensionType.PERIODIC, sig, 2, simd=True)
    assert len(bands) == 3
    for b, w in zip(bands, want_bands):
        _close(b, w, 1e-3)
    # the SWT cascade's inverse closes the distributed round trip
    rec = par.sharded_swt_reconstruct("daub", 4, 2, bands, mesh,
                                      axis="sp")
    _close(rec, sig, 1e-3)
    # sharded DWT synthesis (upsample-by-2 adjoint with band halo)
    dhi, dlo = _wv.wavelet_apply(
        "daub", 4, _wv.ExtensionType.PERIODIC, sig, simd=True)
    drec = par.sharded_wavelet_reconstruct("daub", 4, dhi, dlo, mesh,
                                           axis="sp")
    _close(drec, sig, 1e-3)
    # ring-pipeline convolution: a filter longer than a shard block
    kerl = put(rng.randn(60 * sp).astype(np.float32))
    outr = par.sharded_convolve_ring(sig, kerl, mesh, axis="sp")
    _close(outr, np.convolve(to_host(sig), to_host(kerl)), 1e-2)
    # indivisible dp batch: pad-and-slice keeps every real row
    x5 = rng.randn(2 * dp + 1, 64 * sp).astype(np.float32)
    out5 = to_host(par.sharded_convolve_batch(put(x5), ker, mesh))
    for i in range(len(x5)):
        _close(out5[i], np.convolve(x5[i], kn), 1e-3)
    # all-to-all 2D wavelet: rows local, transpose, columns local
    img_w = rng.randn(16 * sp, 8 * sp).astype(np.float32)
    got2d = par.sharded_wavelet_apply2d(
        "daub", 4, _wv.ExtensionType.MIRROR, put(img_w), mesh, axis="sp")
    want2d = _wv.wavelet_apply2d("daub", 4, _wv.ExtensionType.MIRROR,
                                 img_w, simd=False)
    for g, w in zip(got2d, want2d):
        _close(g, w, 1e-3)
    # sequence-parallel STFT/ISTFT: frame halo and overlap-add overhang
    sig_s = put(rng.randn(64 * sp).astype(np.float32))
    fl, hop = 32, 8
    spec_s = par.sharded_stft(sig_s, fl, hop, mesh, axis="sp")
    _close(spec_s, _sp.stft_na(to_host(sig_s), fl, hop), 1e-3)
    rec_s = par.sharded_istft(spec_s, 64 * sp, fl, hop, mesh, axis="sp")
    _close(rec_s, _sp.istft_na(_sp.stft_na(to_host(sig_s), fl, hop),
                               64 * sp, fl, hop), 1e-3)
    # sequence-parallel IIR: the recurrence crosses shard boundaries
    sos_d = _iir.butterworth(3, 0.2, "lowpass")
    sig_i = put(rng.randn(64 * sp).astype(np.float32))
    _close(par.sharded_sosfilt(sos_d, sig_i, mesh, axis="sp"),
           _iir.sosfilt_na(sos_d, to_host(sig_i)), 1e-3)
    # sequence-parallel Welch PSD: per-shard segment FFTs, one psum
    _, pwelch = par.sharded_welch(sig_s, mesh, axis="sp", nperseg=fl,
                                  noverlap=fl - hop)
    _, pwant = _sp.welch_na(to_host(sig_s), nperseg=fl,
                            noverlap=fl - hop)
    _close(pwelch, pwant, 1e-4)
    # sequence-parallel polyphase resampling (rate-change halo conv)
    sig_r = put(rng.randn(294 * sp).astype(np.float32))
    _close(par.sharded_resample_poly(sig_r, 160, 147, mesh, axis="sp"),
           _rsm.resample_poly_na(to_host(sig_r), 160, 147), 1e-3)
    # tensor-parallel GEMM with indivisible K (zero-padded)
    a = put(rng.randn(8, 3 * tp + 1).astype(np.float32))
    b = put(rng.randn(3 * tp + 1, 8).astype(np.float32))
    _close(par.sharded_matmul(a, b, mesh, axis="tp"),
           to_host(a) @ to_host(b), 1e-3)
    # 2D image convolution over the dp x sp grid (corner halo included)
    img = rng.randn(16 * dp, 12 * sp).astype(np.float32)
    k2 = rng.randn(3, 4).astype(np.float32)
    _close(par.sharded_convolve2d(put(img), put(k2), mesh),
           _cv2.convolve2d_na(img, k2), 1e-3)
    # undecimated 2D SWT via the all-to-all transpose
    img_s = rng.randn(8 * sp, 8 * sp).astype(np.float32)
    got_s = par.sharded_swt_apply2d(
        "daub", 4, 1, _wv.ExtensionType.MIRROR, put(img_s), mesh,
        axis="sp")
    want_s = _wv.stationary_wavelet_apply2d(
        "daub", 4, 1, _wv.ExtensionType.MIRROR, img_s, simd=False)
    for g, w in zip(got_s, want_s):
        _close(g, w, 1e-3)
    # 2D quad-tree packets: 4 sharded leaves == single-device leaves
    leaves_s = par.sharded_wavelet_packet_transform2d(
        "daub", 4, _wv.ExtensionType.PERIODIC, put(img_s), 1, mesh,
        axis="sp")
    leaves_w = _wv.wavelet_packet_transform2d(
        "daub", 4, _wv.ExtensionType.PERIODIC, img_s, 1, simd=False)
    for g, w in zip(leaves_s, leaves_w):
        _close(g, w, 1e-3)
    # halo-exchange median filter and Savitzky-Golay with its edge fix
    sig_m = rng.randn(64 * sp).astype(np.float32)
    _close(par.sharded_medfilt(put(sig_m), 5, mesh, axis="sp"),
           _fl.medfilt_na(sig_m, 5), 1e-5)
    _close(par.sharded_savgol_filter(put(sig_m), 9, 3, mesh, axis="sp"),
           _fl.savgol_filter(sig_m, 9, 3, simd=False), 1e-3)
    # 2D ring-pipeline convolution: a halo wider than one tile
    img_r = rng.randn(8 * dp, 8 * sp).astype(np.float32)
    k2r = rng.randn(5, 8 * max(1, sp // 2)).astype(np.float32)
    _close(par.sharded_convolve2d_ring(put(img_r), put(k2r), mesh),
           _cv2.convolve2d_na(img_r, k2r), 1e-3)
    # sharded separable 2D synthesis inverts the sharded 2D analysis
    img_p = rng.randn(8 * sp, 8 * sp).astype(np.float32)
    llp, lhp, hlp, hhp = par.sharded_wavelet_apply2d(
        "daub", 4, _wv.ExtensionType.PERIODIC, put(img_p), mesh,
        axis="sp")
    rec_p = par.sharded_wavelet_reconstruct2d(
        "daub", 4, llp, lhp, hlp, hhp, mesh, axis="sp")
    _close(rec_p, img_p, 1e-3)
    # sharded multi-level DWT cascade and its inverse (periodic)
    sig_c = put(rng.randn(64 * sp).astype(np.float32))
    coeffs_c = par.sharded_wavelet_transform("daub", 4, sig_c, 2, mesh,
                                             axis="sp")
    want_c = _wv.wavelet_transform(
        "daub", 4, _wv.ExtensionType.PERIODIC, to_host(sig_c), 2,
        simd=False)
    assert len(coeffs_c) == len(want_c) == 3
    for g, w in zip(coeffs_c, want_c):
        _close(g, w, 1e-3)
    rec_c = par.sharded_wavelet_inverse_transform("daub", 4, coeffs_c,
                                                  mesh, axis="sp")
    _close(rec_c, sig_c, 1e-3)
    # row-sharded u8 plane normalization: one pmin/pmax pair
    img_n = (rng.rand(8 * sp + 3, 12) * 255).astype(np.uint8)
    _close(par.sharded_normalize2d(img_n, mesh, axis="sp"),
           _nm.normalize2D(img_n, simd=True), 1e-6)
    # sequence-parallel Lomb-Scargle: two psum rounds
    t_ls = np.sort(rng.rand(64 * sp)) * 50.0
    x_ls = np.sin(1.7 * t_ls).astype(np.float32)
    f_ls = np.linspace(0.5, 3.0, 16)
    _close(par.sharded_lombscargle(t_ls, x_ls, f_ls, mesh, axis="sp"),
           _sp.lombscargle_na(t_ls, x_ls, f_ls), 1e-2, rtol=1e-2)

    print(f"dryrun_multichip: mesh dp={dp} sp={sp} tp={tp} "
          f"loss={loss:.4f} ok")
    return loss


def main():
    platform.select_device()
    print(f"device: {platform.device_line()}")
    fn, args = entry()
    out = fn(*args)
    print("entry():", tuple(tuple(a.shape) for a in out))
    dryrun_multichip(8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
