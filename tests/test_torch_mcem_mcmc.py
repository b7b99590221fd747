"""MCEM and MCMC deconvolution in the PyTorch port, on the data and the
statistical gates of ``tests/test_mcem.py`` and ``tests/test_mcmc.py``
(the AR(1) MCEM runs are in ``tests/test_torch_mcem.py``).

The port draws its random numbers from a seeded CPU ``torch.Generator``,
the JAX package from ``jax.random``, so the two chains differ sample by
sample. Both are held to the JAX tests' gates on the same numpy inputs
(time constants within the gates' reach of the truth, trace correlations,
posterior spike mass near the planted spikes, AUC), and where both run,
their results to each other: MCMC's posterior spike mass near each
planted spike within 0.35 and its mean on quiet bins within 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cnmf_e_tpu.ops.mcmc import mcmc_spikes as jax_mcmc_spikes
from cnmf_e_tpu_torch.config import DeconvParams
from cnmf_e_tpu_torch.ops.ar import ar2exp, exp2ar
from cnmf_e_tpu_torch.ops.mcmc import mcmc_spikes, mcmc_spikes_adaptive
from cnmf_e_tpu_torch.ops.oasis import deconvolve, foopsi_ar1
from tests.oracles import ar1_trace

torch.set_num_threads(1)


def _ar1_traces(rng, N, T, g_true, sn, rate=0.03):
    S = (rng.random((N, T)) < rate) * rng.uniform(0.5, 1.5, (N, T))
    C = np.zeros((N, T))
    for t in range(T):
        C[:, t] = (C[:, t - 1] * g_true if t else 0) + S[:, t]
    return (C + sn * rng.standard_normal((N, T))).astype(np.float32), C, S


def _auc(score, truth):
    """tests/test_mcmc.py::_auc: rank AUC with a +-1 bin tolerance."""
    score = np.maximum(score, np.maximum(np.roll(score, 1),
                                         np.roll(score, -1)))
    order = np.argsort(score)
    ranks = np.empty(len(score))
    ranks[order] = np.arange(1, len(score) + 1)
    pos = truth > 0
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def test_mcem_ar2_runs_and_keeps_order(rng):
    d_true, r_true = 0.9, 0.3
    g1, g2 = d_true + r_true, -d_true * r_true
    S = (rng.random((3, 400)) < 0.03) * rng.uniform(0.5, 1.5, (3, 400))
    C = np.zeros((3, 400))
    for t in range(400):
        C[:, t] = ((g1 * C[:, t - 1] if t >= 1 else 0)
                   + (g2 * C[:, t - 2] if t >= 2 else 0) + S[:, t])
    y = (C + 0.1 * rng.standard_normal((3, 400))).astype(np.float32)
    res = deconvolve(torch.tensor(y), DeconvParams(
        model="ar2", method="mcem", optimize_b=False))
    d, r = ar2exp(res.g)
    assert res.g.shape == (3, 2)
    assert bool((d > r).all()), (d, r)
    for k in range(3):
        assert np.corrcoef(res.c.numpy()[k], C[k])[0, 1] > 0.85, k


def _planted(rng):
    g, T = 0.9, 400
    s_true = np.zeros(T)
    spike_times = [50, 150, 260, 340]
    s_true[spike_times] = 2.0
    c = np.zeros(T)
    for t in range(T):
        c[t] = (c[t - 1] * g if t else 0) + s_true[t]
    sn = 0.15
    return c + 1.0 + sn * rng.standard_normal(T), g, sn, spike_times


def test_mcmc_finds_spikes(rng):
    """tests/test_mcmc.py::test_mcmc_finds_spikes's gates; the port's
    spike probabilities against the JAX package's."""
    y, g, sn, spike_times = _planted(rng)
    T = y.size
    res = mcmc_spikes(torch.tensor(y[None], dtype=torch.float32),
                      torch.tensor([g]), torch.tensor([sn]), seed=3,
                      n_iter=3000, n_burn=500)
    prob = res.spike_prob[0].numpy()
    assert int(res.n_accept[0]) > 50
    for t in spike_times:
        assert prob[max(t - 2, 0):t + 3].max() > 0.5, (t, prob[t - 3:t + 4])
    quiet = np.ones(T, bool)
    for t in spike_times:
        quiet[max(t - 5, 0):t + 6] = False
    assert prob[quiet].mean() < 0.1
    assert abs(float(res.b_mean[0]) - 1.0) < 0.2
    ref = jax_mcmc_spikes(jnp.asarray(y[None], jnp.float32),
                          jnp.asarray([g], jnp.float32),
                          jnp.asarray([sn], jnp.float32),
                          key=jax.random.PRNGKey(3), n_iter=3000, n_burn=500)
    # the posteriors, not the chains, must agree: spike mass in the same
    # +-2-bin windows, nowhere else
    pj = np.asarray(ref.spike_prob[0])
    win = np.array([prob[max(t - 2, 0):t + 3].sum() for t in spike_times])
    win_j = np.array([pj[max(t - 2, 0):t + 3].sum() for t in spike_times])
    np.testing.assert_allclose(win, win_j, atol=0.35)
    assert abs(prob[quiet].mean() - pj[quiet].mean()) < 0.05


def test_mcmc_auc_beats_foopsi(rng):
    g, sn, T = 0.9, 0.25, 600
    y, c, s_true = ar1_trace(rng, T, g=g, sn=sn, rate=0.02, amp=1.5)
    yt = torch.tensor(y[None], dtype=torch.float32)
    res = mcmc_spikes(yt, torch.tensor([g]), torch.tensor([sn]), seed=7,
                      n_iter=3000, n_burn=600)
    fp = foopsi_ar1(yt, torch.tensor([g]), optimize_b=True)
    auc_mcmc = _auc(res.spike_prob[0].numpy(), s_true > 0)
    auc_foopsi = _auc(fp.s[0].numpy(), s_true > 0)
    assert auc_mcmc > 0.9
    assert auc_mcmc >= auc_foopsi - 0.02, (auc_mcmc, auc_foopsi)


def test_mcmc_time_constant_recovery(rng):
    g_true, sn, T = 0.92, 0.12, 800
    y, c, s_true = ar1_trace(rng, T, g=g_true, sn=sn, rate=0.015, amp=2.0)
    res = mcmc_spikes(torch.tensor(y[None] + 0.5, dtype=torch.float32),
                      torch.tensor([0.75]), torch.tensor([sn]), seed=11,
                      n_iter=4000, n_burn=1500, sample_g=True)
    g_post = float(res.g_mean[0, 0])
    assert abs(g_post - g_true) < abs(0.75 - g_true) / 3, g_post
    assert abs(g_post - g_true) < 0.04, g_post


def test_mcmc_adaptive_converges(rng):
    g, sn, T = 0.9, 0.15, 300
    y, c, s_true = ar1_trace(rng, T, g=g, sn=sn, rate=0.02, amp=2.0)
    res = mcmc_spikes_adaptive(torch.tensor(y[None], dtype=torch.float32),
                               torch.tensor([g]), torch.tensor([sn]),
                               seed=5, block=400, max_blocks=8)
    assert np.isfinite(float(res.geweke_z[0]))
    assert _auc(res.spike_prob[0].numpy(), s_true > 0) > 0.9


def test_mcmc_ar2_kernel(rng):
    d, r = 0.9, 0.5
    g2 = exp2ar(torch.tensor([d]), torch.tensor([r]))[0].numpy()
    T = 400
    s_true = np.zeros(T)
    s_true[[60, 170, 290]] = 2.0
    c = np.zeros(T)
    for t in range(T):
        c[t] = (g2[0] * c[t - 1] if t >= 1 else 0) + \
            (g2[1] * c[t - 2] if t >= 2 else 0) + s_true[t]
    y = c + 0.15 * rng.standard_normal(T)
    res = mcmc_spikes(torch.tensor(y[None], dtype=torch.float32),
                      torch.tensor(g2[None]), torch.tensor([0.15]), seed=13,
                      n_iter=2500, n_burn=500, sample_g=True)
    prob = res.spike_prob[0].numpy()
    for t in [60, 170, 290]:
        assert prob[t - 2:t + 3].max() > 0.5, (t, prob[t - 3:t + 4])


def test_mcmc_through_deconvolve(rng):
    """deconvolve(method="mcmc") returns the posterior means in the
    DeconvResult fields, as the JAX package does."""
    y, C, _ = _ar1_traces(rng, 3, 300, 0.9, sn=0.1)
    res = deconvolve(torch.tensor(y + 0.5), DeconvParams(method="mcmc"))
    assert res.c.shape == (3, 300) and res.b.shape == (3,)
    assert res.g.shape == (3, 1)
    for k in range(3):
        assert np.corrcoef(res.c.numpy()[k], C[k])[0, 1] > 0.8, k
