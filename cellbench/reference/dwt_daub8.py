"""Plain reference of the ``dwt_daub8`` configuration.

The reference library's decimated DWT (``src/wavelet.c``), level by
level: the signal extended on the right by ``order`` samples (periodic:
``x[t mod n]``), then ``hi[i] = sum_j g[j] x_ext[2i + j]`` and ``lo[i]
= sum_j c[j] x_ext[2i + j]`` for ``i < n / 2``; the lowpass band is the
next level's signal.  Returns ``[hi_1, ..., hi_L, lo_L]``.  The lowpass
``c`` is Daubechies' 8-tap filter (I. Daubechies, Ten Lectures on
Wavelets, 1992, Table 6.1, N = 4; its rows sum to sqrt(2)), and the
highpass is the library's mirror of it, ``g[order-1-i] = (i odd ? +c[i]
: -c[i])``.  Computed in float64 in blocks of rows, in plain PyTorch:
it imports nothing of the program and takes none of its tables.

``control=True`` rounds each level's signal and both filters to TF32
(ten mantissa bits), which is what a float32 filter bank on the tensor
cores with TF32 on multiplies: the step below the float32 with TF32 off
that the configuration states.  Its sums stay exact.
"""

import torch

DAUB8 = (0.23037781330885523, 0.7148465705525415, 0.6308807679295904,
         -0.02798376941698385, -0.18703481171888114, 0.030841381835986965,
         0.032883011666982945, -0.010597401784997278)
_ROWS_A_BLOCK = 2048


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's ten mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def filters(control=False):
    """``(g, c)``: the highpass and lowpass taps, float64 tuples."""
    lo = list(DAUB8)
    order = len(lo)
    hi = [0.0] * order
    for i, v in enumerate(lo):
        hi[order - 1 - i] = v if i % 2 else -v
    if control:
        as_tf32 = [tf32(torch.tensor(f, dtype=torch.float32)).tolist()
                   for f in (hi, lo)]
        return tuple(as_tf32[0]), tuple(as_tf32[1])
    return tuple(hi), tuple(lo)


def _level(x, g, c):
    """One analysis step of float64 rows ``x``: ``(hi, lo)``."""
    n = x.shape[-1]
    order = len(c)
    ext = torch.cat([x, x[:, :order]], dim=-1)
    hi = torch.zeros(x.shape[0], n // 2, dtype=x.dtype, device=x.device)
    lo = torch.zeros_like(hi)
    for j in range(order):
        tap = ext[:, j:j + n:2]
        hi.add_(tap, alpha=g[j])
        lo.add_(tap, alpha=c[j])
    return hi, lo


def expected(params, x, fixed, control=False):
    """``[hi_1, ..., hi_L, lo_L]`` of ``x`` (``[rows, n]``), float64."""
    if (params["family"], int(params["order"]), params["ext"]) != (
            "daub", len(DAUB8), "periodic"):
        raise ValueError("this reference is the periodic daubechies-8 "
                         "DWT only")
    levels = int(params["levels"])
    g, c = filters(control)
    rows, n = x.shape
    bands = [torch.empty(rows, n >> lvl, dtype=torch.float64,
                         device=x.device) for lvl in range(1, levels + 1)]
    bands.append(torch.empty(rows, n >> levels, dtype=torch.float64,
                             device=x.device))
    for r0 in range(0, rows, _ROWS_A_BLOCK):
        cur = x[r0:r0 + _ROWS_A_BLOCK]
        cur = (tf32(cur) if control else cur).to(torch.float64)
        for lvl in range(levels):
            hi, cur = _level(cur, g, c)
            bands[lvl][r0:r0 + _ROWS_A_BLOCK] = hi
            if control and lvl + 1 < levels:
                cur = tf32(cur.to(torch.float32)).to(torch.float64)
        bands[levels][r0:r0 + _ROWS_A_BLOCK] = cur
    return bands
