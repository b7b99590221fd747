"""Botev diffusion KDE and distribution-mode baseline estimation.

Reference: ``ca_source_extraction/utilities/kde.m`` (Botev, Grotowski &
Kroese 2010 "Kernel density estimation via diffusion"), used by
``utilities/extract_DF_F.m`` (mode of the fluorescence distribution as the
DF/F baseline) and ``utilities/order_components.m``. The bandwidth solves
the fixed point  t = xi * gamma^[l](t)  over the DCT spectrum of the
histogrammed data; the density is the DCT-smoothed histogram.

Port of ``cnmf_e_tpu/ops/kde.py``, kept as host numpy and
``scipy.fftpack`` in float64 so the two agree to the last bit: it runs
once per trace at export time and lies on no device path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.fftpack import dct, idct


def _fixed_point(t: float, N: int, I: np.ndarray, a2: np.ndarray) -> float:
    """xi * gamma^[l](t) - t  (Botev eq. 29-30, l = 7 back-substitutions)."""
    l = 7
    # constant input (all spectral mass at DC) drives f -> 0; the inf/0
    # intermediates are benign (brentq never brackets there) so the whole
    # back-substitution runs warning-silenced
    with np.errstate(divide="ignore", over="ignore"):
        f = 2.0 * np.pi ** (2 * l) * np.sum(I ** l * a2 *
                                            np.exp(-I * np.pi ** 2 * t))
        for s in range(l - 1, 1, -1):
            K0 = np.prod(np.arange(1, 2 * s, 2)) / np.sqrt(2 * np.pi)
            const = (1 + (0.5) ** (s + 0.5)) / 3.0
            time = (2 * const * K0 / (N * f)) ** (2.0 / (3 + 2 * s))
            f = 2.0 * np.pi ** (2 * s) * np.sum(I ** s * a2 *
                                                np.exp(-I * np.pi ** 2 * time))
        return t - (2.0 * N * np.sqrt(np.pi) * f) ** (-0.4)


def kde_botev(x: np.ndarray, n: int = 1024,
              bounds: Tuple[float, float] | None = None
              ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Adaptive-bandwidth KDE. Returns (xmesh, density, bandwidth)."""
    x = np.asarray(x, np.float64).ravel()
    n = int(2 ** np.ceil(np.log2(n)))
    if bounds is None:
        lo, hi = x.min(), x.max()
        pad = (hi - lo) / 10.0 if hi > lo else max(abs(lo), 1.0) / 10.0
        bounds = (lo - pad, hi + pad)
    lo, hi = bounds
    R = hi - lo
    if R <= 0:
        xmesh = np.linspace(lo - 0.5, lo + 0.5, n)
        dens = np.zeros(n)
        dens[n // 2] = n
        return xmesh, dens, 0.0

    # binned histogram of the unique data (as the reference does)
    xu = np.unique(x)
    N = len(xu)
    hist, edges = np.histogram(x, bins=n, range=(lo, hi))
    initial = hist / hist.sum()
    a = dct(initial, norm=None)

    I = np.arange(1, n, dtype=np.float64) ** 2
    a2 = (a[1:] / 2.0) ** 2

    # solve t = xi gamma^[7](t) by bisection on the sign change
    t0 = 0.0
    t1 = 0.1
    f0 = _fixed_point(1e-12, N, I, a2)
    ts = np.logspace(-12, 0, 60)
    fs = np.array([_fixed_point(t, N, I, a2) for t in ts])
    sign = np.signbit(fs)
    cross = np.nonzero(sign[:-1] != sign[1:])[0]
    if len(cross):
        t0, t1 = ts[cross[0]], ts[cross[0] + 1]
        for _ in range(60):
            tm = 0.5 * (t0 + t1)
            if np.signbit(_fixed_point(tm, N, I, a2)) == sign[cross[0]]:
                t0 = tm
            else:
                t1 = tm
        t_star = 0.5 * (t0 + t1)
    else:
        # no sign change: fall back to Silverman-like plug-in
        t_star = (0.28 * N ** (-0.4)) ** 2
    del f0

    a_t = a * np.exp(-np.arange(n, dtype=np.float64) ** 2 *
                     np.pi ** 2 * t_star / 2.0)
    density = idct(a_t, norm=None) / (2.0 * R)
    density = np.maximum(density, 0.0)
    xmesh = (edges[:-1] + edges[1:]) / 2.0
    bandwidth = float(np.sqrt(t_star) * R)
    return xmesh, density, bandwidth


def mode_baseline(x: np.ndarray, n: int = 1024) -> float:
    """Mode of the KDE — the reference's DF/F baseline estimate
    (``extract_DF_F.m``: mode of the fluorescence histogram)."""
    xmesh, density, _ = kde_botev(x, n=n)
    return float(xmesh[int(np.argmax(density))])
