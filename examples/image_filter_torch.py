#!/usr/bin/env python3
"""2D filtering on the card: Gaussian blur, Sobel edges, template matching.

The twin of ``examples/image_filter.py`` over the PyTorch/CUDA port
(``veles.simd_tpu_torch.ops.convolve2d``): a 9x9 Gaussian blur of a
256^2 synthetic image, a Sobel border map of the blur, and a planted
16x16 template found at exactly (55, 215) by ``cross_correlate2d``.
The same blur over an 8-shard ``dp=2 x sp=4`` mesh
(``parallel.sharded_convolve2d``; 8 shards of ``cuda:0`` on the card,
of ``cpu`` when asked) must agree with the single-device blur within
1e-3.

A kernel of area <= 256 whose tile fits shared memory takes the 2D
kernel (``csrc/filter_2d.cu``) on the card, so each ``convolve2d`` and
``cross_correlate2d`` here should launch it once; the launches of each
step are printed.

Run:  python3 examples/image_filter_torch.py            # the card
      VELES_SIMD_PLATFORM=cpu python3 examples/image_filter_torch.py

Without a card and without ``VELES_SIMD_PLATFORM=cpu`` it exits 2.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), os.pardir))

from veles.simd_tpu_torch.ops import convolve2d as cv2  # noqa: E402
from veles.simd_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from veles.simd_tpu_torch.utils import platform  # noqa: E402

# the JAX example's sizes
SIZES = {"n": 256, "blur": 9, "sigma": 2.0, "tpl": 16,
         "planted": (40, 200)}
SOBEL_X = np.float32([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]])


def gaussian2d(size, sigma):
    r = np.arange(size) - (size - 1) / 2
    g = np.exp(-r ** 2 / (2 * sigma ** 2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def _counted(fn):
    """``(fn()'s result on the host, the kernel launches it made)``."""
    with ck.count_launches() as launches:
        out = platform.to_host(fn())
    return out, launches


def make_image(n, seed=7):
    """``(rng, image)``: uniform noise with a bright square; the rng
    goes on to the template step, as in the JAX example."""
    rng = np.random.RandomState(seed)
    img = rng.rand(n, n).astype(np.float32)
    img[96:160, 96:160] += 2.0
    return rng, img


def blur_and_edges(img, size, sigma):
    """The Gaussian blur and the Sobel border map of the blur."""
    n = img.shape[-1]
    blur, l_blur = _counted(lambda: cv2.convolve2d(
        img, gaussian2d(size, sigma), simd=True))
    gx, l_gx = _counted(lambda: cv2.convolve2d(blur, SOBEL_X, simd=True))
    gy = platform.to_host(cv2.convolve2d(blur, SOBEL_X.T.copy(),
                                         simd=True))
    edges = np.hypot(gx, gy)
    border = float(edges[100:160, 100:104].mean())   # the left edge
    interior = float(edges[120:140, 120:140].mean())
    return {"blur": blur, "edges": edges, "border": border,
            "interior": interior,
            "launches": {"blur": l_blur, "sobel": l_gx},
            "checks": {"blur_shape": blur.shape == (n + size - 1,) * 2,
                       "blur_smooths": float(blur.var()) < float(
                           img.var()),
                       "border_5x_interior": border > 5 * interior}}


def find_template(rng, n, tpl_size, planted):
    """A random template planted in noise, found by 2D
    cross-correlation at ``planted + tpl_size - 1``."""
    tpl = rng.randn(tpl_size, tpl_size).astype(np.float32)
    img2 = 0.1 * rng.randn(n, n).astype(np.float32)
    r0, c0 = planted
    img2[r0:r0 + tpl_size, c0:c0 + tpl_size] += tpl
    score, launches = _counted(lambda: cv2.cross_correlate2d(
        img2, tpl, simd=True))
    peak = tuple(int(v) for v in np.unravel_index(np.argmax(score),
                                                   score.shape))
    want = (r0 + tpl_size - 1, c0 + tpl_size - 1)
    return {"score": score, "peak": peak, "launches": launches,
            "checks": {"template_found": peak == want}}


def sharded_blur(img, size, sigma, blur):
    """The blur over a ``dp=2 x sp=4`` mesh of 8 shards of the
    configured device, against the single-device blur."""
    from veles.simd_tpu_torch.parallel import make_mesh, sharded_convolve2d

    mesh = make_mesh({"dp": 2, "sp": 4})
    got, launches = _counted(lambda: sharded_convolve2d(
        img, gaussian2d(size, sigma), mesh))
    err = float(np.abs(got - blur).max())
    return {"sharded": got, "err": err, "launches": launches,
            "shards": [str(d) for d in mesh.devices.ravel()],
            "checks": {"sharded_agrees": err < 1e-3}}


def run(n=SIZES["n"], blur=SIZES["blur"], sigma=SIZES["sigma"],
        tpl=SIZES["tpl"], planted=SIZES["planted"], emit=print):
    """Every step at the given sizes, printing the JAX example's lines
    through ``emit``; returns each step's results and ``checks``."""
    rng, img = make_image(n)
    be = blur_and_edges(img, blur, sigma)
    emit(f"blur: variance {img.var():.4f} -> {be['blur'].var():.4f} | "
         f"route {cv2.select_algorithm2d(blur, blur, img.shape)}, "
         f"launches {be['launches']['blur'] or 0}")
    emit(f"sobel: border energy {be['border']:.2f} vs interior "
         f"{be['interior']:.2f}")
    tm = find_template(rng, n, tpl, planted)
    emit(f"template found at {tm['peak']} (== planted pos + k - 1) | "
         f"launches {tm['launches'] or 0}")
    sh = sharded_blur(img, blur, sigma, be["blur"])
    emit(f"sharded 2x4 grid over {len(sh['shards'])} shards of "
         f"{sh['shards'][0]} agrees with single-device blur (max|err| "
         f"{sh['err']:.1e}) | launches {sh['launches'] or 0}")
    return {"blur_and_edges": be, "template": tm, "sharded": sh,
            "checks": {**be["checks"], **tm["checks"], **sh["checks"]}}


def main(argv=None):
    platform.select_device()
    print(f"device: {platform.device_line()}")
    res = run()
    ok = all(res["checks"].values())
    print("ok" if ok else f"FAILED {res['checks']}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
