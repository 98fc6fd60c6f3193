#!/usr/bin/env python3
"""Recover & verify the port's symlet root selections from its table.

The twin of ``tools/check_wavelet_parity.py`` over the PyTorch/CUDA
port: it reads the port's own table (``veles/simd_tpu_torch/ops/
_wavelet_tables.npz``) and checks the port's own selection map
(``_SYMLET_SELECTIONS`` in ``veles/simd_tpu_torch/ops/
wavelet_coeffs.py``), never the JAX package's.

For each symlet order it classifies, per root orbit of the Daubechies
half-band polynomial, whether the *published* filter (the reference's
``src/symlets.c:38-39``, shipped in the table) kept the min-phase root
(bit 0) or its reciprocal (bit 1), by evaluating the published row's
z-transform at both candidate roots with scale-normalized residuals.
Orbits whose residual ratio is not decisive are brute-forced over both
values; a selection is accepted only when rebuilding from it in exact
arithmetic reproduces the published row (to a tolerance that tracks
the published table's own double-precision generation error: <= 5e-10
up to order 50, growing to about 2e-5 at 76).

This is host work in exact arithmetic (``mpmath``, which torch's
``sympy`` brings); it needs no card, so unlike the port's other tools
it does not exit 2 where none answers, and it runs the same with or
without ``VELES_SIMD_PLATFORM=cpu``.

Run:  python3 tools/check_wavelet_parity_torch.py [--orders 8 24 76]

Exit status is non-zero if any recovered selection fails reconstruction
or disagrees with the port's ``_SYMLET_SELECTIONS`` map.
"""
from __future__ import annotations

import argparse
import functools
import itertools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from veles.simd_tpu_torch.ops import wavelet_coeffs as wc  # noqa: E402

# one mpmath root-finding per order; selection rebuilds reuse it
wc._daubechies_zroots = functools.lru_cache(maxsize=None)(
    wc._daubechies_zroots)


def _ztransform_residual(h, z, mp):
    """|H(z)| / Σ|h_n||z^-n| — scale-free closeness of z to a root of H."""
    num = mp.mpc(0)
    den = mp.mpf(0)
    zi = mp.mpc(1)
    for c in h:
        num += mp.mpf(float(c)) * zi
        den += abs(mp.mpf(float(c))) * abs(zi)
        zi /= z
    return float(abs(num) / den)


def _classify(order, published):
    """Recover (mirror, bits) for one order from the published row.

    Returns (mirror, bits, max_abs_err, ambiguous_orbit_count).
    """
    mp = wc._mp()
    p = order // 2
    zr = wc._daubechies_zroots(p)
    orbits = wc._root_orbits(zr)

    # Per-orbit residuals of the published row at the inside root and at its
    # reciprocal.  The evaluation Σ p_n z^{-n} vanishes when 1/z is a root of
    # the row's polynomial, so (for an unmirrored row, which stores ascending
    # coefficients of the kept-root polynomial) a vanishing residual at the
    # *inside* root means the *outside* root was kept — bit 1.  A mirrored
    # row reverses the polynomial, reciprocating every root, which flips all
    # bits; both (mirror, flip) pairings are tried below.
    decisive, free = [], []
    for k, orb in enumerate(orbits):
        z = orb[0]
        r_in = _ztransform_residual(published, z, mp)
        r_out = _ztransform_residual(published, 1 / mp.conj(z), mp)
        lo, hi = min(r_in, r_out), max(r_in, r_out)
        if lo < 1e-4 * hi:
            decisive.append("1" if r_in < r_out else "0")
        else:
            decisive.append(None)
            free.append(k)

    best = (np.inf, None, None)
    for fill in itertools.product("01", repeat=len(free)):
        bits = list(decisive)
        for k, b in zip(free, fill):
            bits[k] = b
        bits = "".join(bits)
        flipped = "".join("1" if b == "0" else "0" for b in bits)
        for mirror, mb in ((0, bits), (1, flipped), (0, flipped), (1, bits)):
            h = wc._symlet_from_selection(order, mirror, mb)
            err = float(np.max(np.abs(h - published)))
            if err < best[0]:
                best = (err, mirror, mb)
        if best[0] < 1e-9:
            break
    err, mirror, bits = best
    return mirror, bits, err, len(free)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--orders", type=int, nargs="*", default=None,
                    help="symlet orders to check (default: all ≥ 4)")
    args = ap.parse_args(argv)

    tables = wc._tables()
    orders = args.orders or [o for o in wc.supported_orders(
        wc.WaveletType.SYMLET) if o >= 4]
    bad = 0
    for order in orders:
        # the .npz ships the published rows normalized to Σh = 1; the
        # selection machinery works at the reference's Σh = √2 scale
        published = np.asarray(tables[f"sym{order}"],
                               np.float64) * np.sqrt(2.0)
        mirror, bits, err, n_amb = _classify(order, published)
        # the published table's own generation error grows with order; the
        # acceptance bound tracks its orthonormality residual envelope
        tol = 5e-9 if order <= 50 else 5e-5
        checked_in = wc._SYMLET_SELECTIONS.get(order)
        if checked_in is None:
            # orders below 4 have a single orbit and no map entry
            agree = False
        else:
            # (mirror, bits) and (1-mirror, ~bits) denote the same filter
            # (mirroring reciprocates every root), so compare the filters
            h_checked = wc._symlet_from_selection(order, *checked_in)
            h_found = wc._symlet_from_selection(order, mirror, bits)
            agree = float(np.max(np.abs(h_checked - h_found))) < 1e-12
        status = "ok" if (err < tol and agree) else "FAIL"
        if status == "FAIL":
            bad += 1
        amb = f" ambiguous={n_amb}" if n_amb else ""
        print(f"sym{order:<3d} mirror={mirror} bits={bits:<20s} "
              f"max|Δ|={err:.2e}{amb} "
              + ("== _SYMLET_SELECTIONS" if agree
                 else "!= " + repr(checked_in))
              + f"  [{status}]")
    if bad:
        print(f"{bad} order(s) failed", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
