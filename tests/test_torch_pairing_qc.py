"""Pairing, component classification, neuron ordering and the merge
candidate graphs in the PyTorch port vs the JAX package.

``pair_neurons``, ``classify_components`` and ``update_order`` are float64
host numpy in both packages and must agree bit for bit.
``order_neurons`` must give equal permutations for every key on data
whose keys are distinct; ``apply_order``, the QC keep set with an
active-pixel mask and the three candidate adjacencies must be equal.
The scenarios of ``tests/test_pairing.py`` run on the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import CNMFEParams, MergeParams, QCParams
from cnmf_e_tpu.models import merge as jmerge
from cnmf_e_tpu.models import pairing as jpair
from cnmf_e_tpu.models import qc as jqc
from cnmf_e_tpu.models.state import empty_state
from cnmf_e_tpu_torch.convert import params_from_dict, state_from_numpy
from cnmf_e_tpu_torch.models import merge as tmerge
from cnmf_e_tpu_torch.models import pairing as tpair
from cnmf_e_tpu_torch.models import qc as tqc

torch.set_num_threads(1)

KEYS = ("snr", "pnr", "energy", "mean", "decay_time", "sparsity_spatial",
        "sparsity_temporal", "circularity", "temporal_cluster",
        "spatial_cluster")


def _footprints(centers, H=24, W=24, sig=1.5):
    yy, xx = np.mgrid[0:H, 0:W]
    A = np.stack([np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
                  for cy, cx in centers])
    return A.reshape(len(centers), -1).T          # (d, K)


def _equal_results(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_neurons_bit_equal(seed):
    rng = np.random.default_rng(seed)
    K1, K2 = 7, 6
    centers = [tuple(c) for c in rng.integers(3, 21, (K1, 2))]
    A1 = _footprints(centers)
    C1 = np.abs(rng.standard_normal((K1, 150)))
    perm = rng.permutation(K1)[:K2]
    A2 = A1[:, perm] + 0.02 * rng.random((A1.shape[0], K2))
    C2 = C1[perm] + 0.05 * rng.standard_normal((K2, 150))
    _equal_results(tpair.pair_neurons(A1, C1, A2, C2),
                   jpair.pair_neurons(A1, C1, A2, C2))


@pytest.mark.parametrize("cl_thr", [0.5, 0.8, 0.95])
def test_classify_components_bit_equal(cl_thr):
    rng = np.random.default_rng(4)
    A = _footprints([tuple(c) for c in rng.integers(2, 22, (9, 2))])
    act = rng.random(A.shape[0]) < 0.6
    np.testing.assert_array_equal(
        tpair.classify_components(A, act, cl_thr),
        jpair.classify_components(A, act, cl_thr))


@pytest.mark.parametrize("seeded", [False, True])
def test_update_order_bit_equal(seeded):
    rng = np.random.default_rng(5)
    A = _footprints([tuple(c) for c in rng.integers(2, 22, (12, 2))],
                    sig=2.0)
    A[A < 1e-3] = 0.0
    kw = lambda: ({"rng": np.random.default_rng(9)} if seeded else {})
    _equal_results(tpair.update_order(A, **kw()),
                   jpair.update_order(A, **kw()))


# tests/test_pairing.py's scenarios, on the port
def test_pair_neurons_recovers_permutation():
    rng = np.random.default_rng(0)
    A1 = _footprints([(6, 6), (6, 17), (17, 6), (17, 17)])
    C1 = np.abs(rng.standard_normal((4, 200)))
    perm = np.array([2, 0, 3, 1])
    A2 = A1[:, perm] + 0.01 * rng.random(A1[:, perm].shape)
    C2 = C1[perm] + 0.01 * rng.standard_normal((4, 200))
    res = tpair.pair_neurons(A1, C1, A2, C2)
    np.testing.assert_array_equal(res.ind_max, np.argsort(perm))
    assert np.all(res.max_all[np.isfinite(res.max_all)] > 0.9)


def test_pair_neurons_unmatched_is_minus_one():
    rng = np.random.default_rng(1)
    A1 = _footprints([(6, 6), (17, 17)])
    C1 = np.abs(rng.standard_normal((2, 100)))
    res = tpair.pair_neurons(A1, C1, _footprints([(6, 6)]),
                             C1[:1] + 0.01 * rng.standard_normal((1, 100)))
    assert res.ind_max[0] == 0 and (res.ind_max == 0).sum() == 1


def test_classify_components_energy_threshold():
    A = _footprints([(6, 6), (17, 17)])
    act = np.zeros((24, 24))
    act[:12, :12] = 1.0
    ff = tpair.classify_components(A, act.reshape(-1), cl_thr=0.8)
    assert ff[0] and not ff[1]


def test_update_order_groups_are_independent_and_complete():
    A = _footprints([(6, 6), (7, 7), (17, 17), (18, 18), (6, 18)], sig=2.0)
    A[A < 1e-3] = 0.0
    groups = tpair.update_order(A)
    F = (A.T @ A) > 0
    np.fill_diagonal(F, False)
    assert sorted(np.concatenate(groups).tolist()) == list(range(5))
    for g in groups:
        assert not F[np.ix_(g, g)].any()
    assert len(groups[-1]) == max(len(g) for g in groups)


def _toy(K=6, H=24, W=24, T=120, seed=3, n_active=None):
    """tests/test_pairing.py::_toy_state as numpy arrays, with distinct
    per-neuron statistics (amplitudes, noise, widths and decays differ)
    and the last slots inactive when ``n_active`` says so."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    centers = [(6, 6), (6, 18), (18, 6), (18, 18), (12, 12), (7, 7),
               (3, 12), (20, 12)]
    A = np.stack([np.exp(-((yy - cy) ** 2 / (4.0 + k)
                           + (xx - cx) ** 2 / (6.0 + 0.5 * k)))
                  for k, (cy, cx) in enumerate(centers[:K])]
                 ).astype(np.float32)
    C = (np.abs(rng.standard_normal((K, T))) * np.linspace(1, 2, K)[:, None]
         ).astype(np.float32)
    C_raw = (C + np.linspace(0.03, 0.1, K)[:, None]
             * rng.standard_normal((K, T))).astype(np.float32)
    active = np.ones(K, bool)
    if n_active is not None:
        active[n_active:] = False
    return dict(A=A, C=C, C_raw=C_raw,
                S=np.maximum(np.diff(C, axis=1, prepend=0.0), 0.0
                             ).astype(np.float32),
                g=np.linspace(0.7, 0.97, K).astype(np.float32)[:, None],
                neuron_sn=np.linspace(0.1, 0.2, K).astype(np.float32),
                b0=np.zeros((H, W), np.float32), active=active,
                tags=np.arange(K, dtype=np.int32))


def _jax_state(d):
    K, H, W = d["A"].shape
    st = empty_state(K, H, W, d["C"].shape[1])
    return st.replace(**{k: jnp.asarray(v) for k, v in d.items()})


def _both(d):
    return _jax_state(d), state_from_numpy(d, device="cpu")


@pytest.mark.parametrize("n_active", [None, 5])
@pytest.mark.parametrize("key", KEYS)
def test_order_neurons_matches_jax(key, n_active):
    d = _toy(K=8, n_active=n_active)
    st_j, st_t = _both(d)
    want = np.asarray(jqc.order_neurons(st_j, key))
    got = tqc.order_neurons(st_t, key).numpy()
    np.testing.assert_array_equal(got, want)
    if n_active is not None:
        assert set(got[-3:].tolist()) == {5, 6, 7}


def test_apply_order_matches_jax():
    d = _toy(K=8)
    st_j, st_t = _both(d)
    perm = np.asarray(jqc.order_neurons(st_j, "decay_time"))
    out_j = jqc.apply_order(st_j, perm)
    out_t = tqc.apply_order(st_t, torch.as_tensor(perm))
    for name in ("A", "C", "C_raw", "S", "g", "neuron_sn", "active", "tags"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.asarray(getattr(out_j, name)))
    assert np.all(np.diff(out_t.g[:, 0].numpy()) >= 0)


@pytest.mark.parametrize("cl_thr", [0.0, 0.8])
def test_remove_false_positives_with_active_pixels(cl_thr):
    """tests/test_pairing.py's classify scenario on both packages: the
    keep sets are equal, and with cl_thr = 0.8 the neuron off the mask
    goes."""
    d = _toy(K=2, T=200)
    t = np.arange(200)
    d["C"] = np.stack([np.maximum(np.sin(t / 5.0), 0) + 0.1] * 2
                      ).astype(np.float32)
    d["C_raw"] = (d["C"] + 0.3 * np.random.default_rng(0).standard_normal(
        (2, 200))).astype(np.float32)
    d["S"] = np.ones((2, 200), np.float32)
    mask = np.zeros((24, 24), bool)
    mask[:12, :12] = True
    p = CNMFEParams(qc=QCParams(min_pixel=3, min_pnr=0.0,
                                classify_cl_thr=cl_thr))
    st_j, st_t = _both(d)
    want = np.asarray(jqc.remove_false_positives(st_j, p,
                                                 active_pixels=mask).active)
    got = tqc.remove_false_positives(
        st_t, params_from_dict(dataclasses.asdict(p)),
        active_pixels=torch.as_tensor(mask)).active.numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] and got[1] == (cl_thr == 0.0)


MERGES = {
    "default": MergeParams(),
    "max_dist_decay": MergeParams(dmin=10.0, merge_thr=-1.0,
                                  method_dist="max", max_decay_diff=2.0),
    "loose": MergeParams(dmin=12.0, dmin_only=9.0, merge_thr=-0.5,
                         merge_thr_spatial=(0.01, -0.5, 0.0)),
}


@pytest.mark.parametrize("mode", ["dist_corr", "high_corr", "dist_only"])
@pytest.mark.parametrize("merge", sorted(MERGES))
def test_merge_candidates_match_jax(merge, mode):
    d = _toy(K=8, n_active=7)
    st_j, st_t = _both(d)
    p = CNMFEParams(merge=MERGES[merge])
    want = getattr(jmerge, f"merge_candidates_{mode}")(st_j, p)
    got = getattr(tmerge, f"merge_candidates_{mode}")(
        st_t, params_from_dict(dataclasses.asdict(p)))
    assert isinstance(got, np.ndarray) and got.dtype == bool
    np.testing.assert_array_equal(got, want)


def test_merge_decay_time_gate():
    """tests/test_pairing.py's decay gate on the port, with the
    statistics passed in."""
    d = _toy(K=2, T=200)
    d["A"] = np.stack([d["A"][0]] * 2)
    d["C"] = np.tile(np.sin(np.linspace(0, 20, 200)).astype(np.float32)
                     + 1.5, (2, 1))
    d["g"] = np.array([[0.70], [0.97]], np.float32)
    st = state_from_numpy(d, device="cpu")
    tau = tmerge.decay_times(st)
    assert abs(tau[1] - tau[0]) > 5.0
    stats = tmerge._merge_stats(st)
    p_open = params_from_dict(dataclasses.asdict(
        CNMFEParams(merge=MergeParams(dmin=5.0, merge_thr=0.5))))
    p_gated = params_from_dict(dataclasses.asdict(
        CNMFEParams(merge=MergeParams(dmin=5.0, merge_thr=0.5,
                                      max_decay_diff=5.0))))
    assert tmerge.merge_candidates_dist_corr(st, p_open, stats).any()
    assert not tmerge.merge_candidates_dist_corr(st, p_gated, stats).any()
