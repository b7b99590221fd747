"""The eight-round MCEM recovery of ``tests/test_mcem.py`` in the PyTorch
port: from a decay of 0.7 on traces made with 0.95, the time-constant
walk and the constrained refits (every AR(1) solve through the OASIS
solve entry, its plain version on the CPU) bring g within 0.1 of the
truth and the traces to correlation > 0.9, the JAX test's gates on the
same numpy data. The chains' draws differ from the JAX package's
(``jax.random``), so on a shorter run the two packages are held to each
other: decays within 0.05, traces at correlation >= 0.95."""

import jax.numpy as jnp
import numpy as np
import torch

from cnmf_e_tpu.config import DeconvParams as JaxDeconvParams
from cnmf_e_tpu.ops.mcem import mcem_foopsi as jax_mcem_foopsi
from cnmf_e_tpu_torch.config import DeconvParams
from cnmf_e_tpu_torch.ops.mcem import mcem_foopsi

torch.set_num_threads(1)


def _ar1_traces(rng, N, T, g_true, sn, rate=0.03):
    S = (rng.random((N, T)) < rate) * rng.uniform(0.5, 1.5, (N, T))
    C = np.zeros((N, T))
    for t in range(T):
        C[:, t] = (C[:, t - 1] * g_true if t else 0) + S[:, t]
    return (C + sn * rng.standard_normal((N, T))).astype(np.float32), C, S


def test_mcem_ar1_improves_bad_g(rng):
    g_true = 0.95
    y, C, _ = _ar1_traces(rng, 4, 500, g_true, sn=0.15)
    res = mcem_foopsi(torch.tensor(y), DeconvParams(
        model="ar1", method="mcem", optimize_b=False),
        g=torch.full((4, 1), 0.7), n_em=8)
    g_out = res.g.numpy()[:, 0]
    assert np.all(np.abs(g_out - g_true) < 0.1), g_out
    assert np.all(np.abs(g_out - g_true) < 0.4 * abs(0.7 - g_true)), g_out
    for k in range(4):
        assert np.corrcoef(res.c.numpy()[k], C[k])[0, 1] > 0.9, k


def test_mcem_ar1_matches_jax(rng):
    """Two EM rounds from a wrong decay on the same traces in both
    packages: the time constants move the same way and the traces
    correlate >= 0.95 (the chains' draws differ)."""
    y, C, _ = _ar1_traces(rng, 2, 300, 0.95, sn=0.15)
    res = mcem_foopsi(torch.tensor(y), DeconvParams(
        model="ar1", method="mcem", optimize_b=False),
        g=torch.full((2, 1), 0.7), n_em=2)
    ref = jax_mcem_foopsi(jnp.asarray(y), JaxDeconvParams(
        model="ar1", method="mcem", optimize_b=False),
        g=jnp.full((2, 1), 0.7, jnp.float32), n_em=2)
    g_t, g_j = res.g.numpy()[:, 0], np.asarray(ref.g)[:, 0]
    assert np.all(g_t > 0.7) and np.all(g_j > 0.7), (g_t, g_j)
    np.testing.assert_allclose(g_t, g_j, atol=0.05)
    for k in range(2):
        assert np.corrcoef(res.c.numpy()[k],
                           np.asarray(ref.c)[k])[0, 1] >= 0.95, k
