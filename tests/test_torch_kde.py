"""The port's Botev KDE and mode baseline (``cnmf_e_tpu_torch/ops/kde.py``)
against the JAX package's: both are float64 numpy, so the results must be
bit-equal. Also the checks of ``tests/test_kde.py`` on the port."""

import numpy as np
import pytest

from cnmf_e_tpu.ops import kde as jax_kde
from cnmf_e_tpu_torch.ops.kde import kde_botev, mode_baseline


def _gaussian():
    return np.random.default_rng(0).standard_normal(4000)


def _bimodal():
    rng = np.random.default_rng(1)
    return np.concatenate([rng.normal(-3, 0.4, 3000),
                           rng.normal(3, 0.4, 3000)])


def _transients():
    rng = np.random.default_rng(2)
    x = 5.0 + 0.2 * rng.standard_normal(6000)
    tr = rng.random(6000) < 0.15
    x[tr] += rng.exponential(2.0, tr.sum())
    return x


INPUTS = {
    "gaussian": _gaussian,
    "bimodal": _bimodal,
    "transients": _transients,
    "float32_trace": lambda: _transients().astype(np.float32),
    "constant": lambda: np.full(100, 3.3),
    "single_value": lambda: np.array([1.25]),
}


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("n", [1024, 300])
def test_kde_bit_equal_to_the_jax_package(name, n):
    x = INPUTS[name]()
    ours = kde_botev(x, n=n)
    theirs = jax_kde.kde_botev(x, n=n)
    for a, b in zip(ours[:2], theirs[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours[2] == theirs[2]
    assert mode_baseline(x, n=n) == jax_kde.mode_baseline(x, n=n)


def _check_gaussian():
    x = _gaussian()
    xmesh, dens, bw = kde_botev(x)
    assert abs(np.trapezoid(dens, xmesh) - 1.0) < 0.05
    assert abs(xmesh[np.argmax(dens)]) < 0.3
    assert abs(dens.max() - 0.3989) < 0.08
    assert 0.1 < bw < 0.6


def _check_bimodal():
    xmesh, dens, _ = kde_botev(_bimodal())
    lo = dens[(xmesh > -1) & (xmesh < 1)].max()
    hi = min(dens[np.abs(xmesh + 3) < 0.5].max(),
             dens[np.abs(xmesh - 3) < 0.5].max())
    assert hi > 4 * lo


def _check_transients():
    x = _transients()
    assert abs(mode_baseline(x) - 5.0) < 0.15
    assert np.mean(x) - 5.0 > 0.2


def _check_constant():
    assert abs(mode_baseline(np.full(100, 3.3)) - 3.3) < 0.6


@pytest.mark.parametrize("check", [_check_gaussian, _check_bimodal,
                                   _check_transients, _check_constant],
                         ids=["gaussian_density", "bimodal_peaks",
                              "mode_ignores_transients", "constant_input"])
def test_kde_checks_of_the_jax_suite(check):
    check()
