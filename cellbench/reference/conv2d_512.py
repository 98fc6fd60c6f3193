"""Plain reference of the ``conv2d_512`` configuration.

scipy's ``convolve2d(x, w, mode, boundary)`` (``y[i, j] = sum_{p, q}
w[p, q] x[i - p, j - q]``) and ``correlate2d`` (the same with ``w``
reversed on both axes) of every image of ``x`` with the normalised
Gaussian window ``w`` of MATLAB's ``fspecial('gaussian', k, sigma)``,
rebuilt here from the same float64 formula and rounded to float32 as
the benchmark's entry rounds it, so that both sides filter with the
same taps.  Computed in float64: the input extended by its own
symmetric extension (``torch.flip`` and ``torch.cat``; ``symm`` repeats
the edge sample, as NumPy's ``symmetric``) or by zeros, one
zero-padded ``rfft2`` product an image at a size of at least ``n + k -
1`` on each axis, in blocks of images, then the mode's part:
``valid`` the fully overlapped outputs, ``same`` the ``n`` centred
ones (starting at ``(k - 1) // 2`` for a convolution and ``k // 2``
for a correlation), ``full`` all of them.  Plain PyTorch only: it
imports nothing of the program and works from the operands the
benchmark made.  TF32 is off while it runs.

``control=True`` computes it from the images and the window rounded to
TF32 (ten mantissa bits, round to nearest), which is what a float32
product on the tensor cores with TF32 on multiplies: the step below
the float32 with TF32 off that the configuration states.  Its sums
stay exact, so it errs less than a real TF32 route would.
"""

import torch

_IMAGES_A_BLOCK = 16


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's ten mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def gaussian(k: int, sigma: float, device=None) -> torch.Tensor:
    """``fspecial('gaussian', k, sigma)`` rounded to float32."""
    r = torch.arange(k, dtype=torch.float64, device=device) - (k - 1) / 2
    g = torch.exp(-(r[:, None] ** 2 + r[None, :] ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).to(torch.float32)


def _fast_size(m: int) -> int:
    """The smallest ``2^a 3^b 5^c`` that is at least ``m``."""
    while True:
        r = m
        for p in (2, 3, 5):
            while r % p == 0:
                r //= p
        if r == 1:
            return m
        m += 1


def _symm(x: torch.Tensor, p: int, dim: int) -> torch.Tensor:
    """``x`` extended by ``p <= n`` samples at each end of ``dim``,
    each end mirrored with its edge sample repeated."""
    if p == 0:
        return x
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, p).flip(dim), x,
                      x.narrow(dim, n - p, p).flip(dim)], dim)


def _zeros(x: torch.Tensor, p: int, dim: int) -> torch.Tensor:
    if p == 0:
        return x
    shape = list(x.shape)
    shape[dim] = p
    z = x.new_zeros(shape)
    return torch.cat([z, x, z], dim)


def expected(params, x, fixed, control=False):
    """``[y]``: the float64 ``params["op"]`` (``convolve2d`` or
    ``cross_correlate2d``) of ``x`` (``[images, n0, n1]``) in
    ``params``' ``mode`` and ``boundary`` (``fill`` with zeros, or
    ``symm``)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return [_filter(params, x, control)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _filter(params, x, control):
    k, sigma = int(params["k"]), float(params["sigma"])
    mode, boundary = params["mode"], params["boundary"]
    correlate = params["op"] == "cross_correlate2d"
    w = gaussian(k, sigma, x.device)
    if control:
        x, w = tf32(x), tf32(w)
    w = w.to(torch.float64)
    if correlate:
        w = w.flip((0, 1))
    images, n0, n1 = x.shape
    # the extension the kept outputs reach: none where only fully
    # overlapped outputs are kept, k - 1 for 'full', k // 2 for 'same'
    if mode == "valid":
        pad = 0
        start, keep = k - 1, (n0 - k + 1, n1 - k + 1)
    elif mode == "same":
        pad = k // 2
        start, keep = (k // 2 if correlate else (k - 1) // 2), (n0, n1)
    else:
        pad = k - 1
        start, keep = 0, (n0 + k - 1, n1 + k - 1)
    extend = _symm if boundary == "symm" else _zeros
    # the extended input's full output, index j + pad of which is the
    # unextended input's full output j
    size = (_fast_size(n0 + 2 * pad + k - 1),
            _fast_size(n1 + 2 * pad + k - 1))
    spec_w = torch.fft.rfft2(w, size)
    a0, a1 = pad + start, pad + start
    y = torch.empty((images,) + keep, dtype=torch.float64, device=x.device)
    for i in range(0, images, _IMAGES_A_BLOCK):
        block = x[i:i + _IMAGES_A_BLOCK].to(torch.float64)
        block = extend(extend(block, pad, -2), pad, -1)
        full = torch.fft.irfft2(torch.fft.rfft2(block, size) * spec_w,
                                size)
        y[i:i + _IMAGES_A_BLOCK] = full[:, a0:a0 + keep[0],
                                        a1:a1 + keep[1]]
    return y
