"""The in-memory fit's stages on a 2 x 2 mesh of gloo ranks.

One spawn of 2 x 2 CPU ranks (rank bodies in
``cnmf_e_tpu_torch/parallel/_selftest.py``; a 120 s deadline, a 60 s
timeout on every collective) runs:

  * the ``preset_1p`` path's ``background.ssub = 2`` on
    ``tests/test_sharding.py``'s mini movie, ``CNMFE(mesh=...).fit``
    against the JAX package's and the port's single-process fits (equal
    n_active, footprint IoU >= 0.99, trace correlation >= 0.999);
  * the bisection medians over a frame-sharded time axis, bit-identical
    to one process (``submedian_mean`` within 1e-6);
  * the replicate-padded filter with a halo that spans two slabs and the
    field of view's edges, and the bilinear upsample, within 1e-6 of one
    process; the pixel noise (over a prefix whose Welch windows cross the
    frame seam, and over all frames) and the correlation image within
    1e-5 of their scale;
  * the merges and the QC of a state with a seeded duplicate (as
    ``__graft_entry__.py:120-147`` seeds one): the same clusters and
    active masks as one process;
  * every option and method of ``CNMFE`` on the mesh (each background
    model, search method and spatial algorithm, ``decorrelate``, the
    decimated and detrended init, ``run_log``, ``resume_from``, ``dff``,
    ``background``, ``reconstruction``, ``residual``, ``compute_rss``) and
    ``fit_batches`` (the movie's halves as two batches): each runs, and
    every rank returns the same state, bit for bit; the ValueError of
    every indivisible dimension. Their accuracy is
    ``tests/test_torch_mesh_options.py``'s and
    ``tests/test_torch_mesh_methods.py``'s.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams, InitParams,
                               MergeParams)
from cnmf_e_tpu.models.pipeline import CNMFE as JaxCNMFE
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.convert import params_from_dict, state_to_numpy
from cnmf_e_tpu_torch.convert import state_from_numpy
from cnmf_e_tpu_torch.models.initialize import initialize_greedy
from cnmf_e_tpu_torch.models.merge import merge_neurons, merge_neurons_seq
from cnmf_e_tpu_torch.models.pipeline import CNMFE
from cnmf_e_tpu_torch.models.qc import remove_false_positives
from cnmf_e_tpu_torch.ops.corr import correlation_image
from cnmf_e_tpu_torch.ops.filters import (filter_movie, gaussian_psf,
                                          resize_linear)
from cnmf_e_tpu_torch.ops.noise import noise_psd_frames
from cnmf_e_tpu_torch.ops.stats import (fast_median, fast_median_masked,
                                        submedian_mean)
from cnmf_e_tpu_torch.parallel import _selftest
from cnmf_e_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

N_PATCH, N_FRAME = 2, 2
STATS = dict(T=64, H=8, W=12)
FILTERS = dict(T=400, H=8, W=12, gSig=3.0, ssub=2, noise_cap=300)
GUARD_T = 128               # the guard cases' frames of the mini movie
GUARDS = [
    ("bg_local", {"background.model": "local"}),
    ("bg_svd", {"background.model": "svd"}),
    ("bg_nmf", {"background.model": "nmf"}),
    ("ellipse", {"spatial.search_method": "ellipse"}),
    ("nnls", {"spatial.algorithm": "nnls"}),
    ("hals_thresh", {"spatial.algorithm": "hals_thresh"}),
    ("decorrelate", {"temporal.decorrelate": True}),
    ("init_ssub", {"init.ssub": 2}),
    ("init_tsub", {"init.tsub": 2}),
    ("init_nk", {"init.nk": 3}),
    # run_log writes the snapshot that resume_from restores
    ("run_log", "run_log"), ("resume_from", "resume_from"),
    ("fit_batches", "fit_batches"), ("dff", "dff"),
    ("background", "background"), ("reconstruction", "reconstruction"),
    ("residual", "residual"), ("compute_rss", "compute_rss"),
    ("K_max", {"init.max_neurons": 15}),
    ("seeds_per_round", {"init.seeds_per_round": 7}),
    ("bg_ssub", {"background.ssub": 3}),
    ("other_device", "other_device"),
    ("unequal_blocks", "unequal_blocks"),
    ("init_tsub_frames", {"init.tsub": 3}),
    ("init_ssub_rows", {"init.ssub": 3}),
]
# the options and methods that run on the mesh
RUNS = {"bg_local", "bg_svd", "bg_nmf", "ellipse", "nnls", "hals_thresh",
        "decorrelate", "init_ssub", "init_tsub", "init_nk", "run_log",
        "resume_from", "fit_batches", "dff", "background", "reconstruction",
        "residual", "compute_rss"}
# what each guard's message names
NAMES = dict(K_max="K = 15",
             seeds_per_round="seeds_per_round", bg_ssub="background.ssub",
             other_device="not the mesh's", unequal_blocks="differ in T",
             init_tsub_frames="init.tsub = 3",
             init_ssub_rows="init.ssub = 3")


def _params(ssub=1):
    """``tests/test_sharding.py::_mini_params``, the ring on the ``ssub``
    grid."""
    return CNMFEParams(
        init=InitParams(gSig=2.0, gSiz=6, min_corr=0.7, min_pnr=6.0,
                        max_neurons=16, seeds_per_round=8, max_rounds=3),
        background=BackgroundParams(model="ring", ring_radius=6, ssub=ssub),
        merge=MergeParams(dmin=4.0))


def _mini_movie():
    return simulate_movie(seed=11, H=32, W=32, T=256, K=5, gSig=2.0,
                          sn=0.06, bg_strength=0.5, min_dist=9.0,
                          spike_rate=0.05)


def _stats_inputs():
    rng = np.random.default_rng(3)
    shape = (STATS["T"], STATS["H"], STATS["W"])
    X = rng.standard_normal(shape).astype(np.float32)
    X[:, 0, 0] = 1.5                       # a constant pixel: ties
    M = rng.random(shape) < 0.4
    M[:, 1, 1] = False                     # a pixel with no sample
    return X, M


def _filters_input():
    rng = np.random.default_rng(5)
    t = np.arange(FILTERS["T"])[:, None, None]
    return (rng.standard_normal((FILTERS["T"], FILTERS["H"], FILTERS["W"]))
            + np.sin(0.05 * t)).astype(np.float32)


def _duplicate_state():
    """The port's one-process init of the mini movie with a seeded
    near-duplicate of its first neuron in a free slot
    (``__graft_entry__.py:120-147``), as numpy."""
    p = params_from_dict(dataclasses.asdict(_params()))
    st, _ = initialize_greedy(torch.tensor(_mini_movie().Y), p)
    d = state_to_numpy(st)
    act = d["active"]
    kdup, free = int(np.argmax(act)), int(np.argmin(act))
    assert not act[free]
    d["A"][free] = d["A"][kdup] * 0.9
    d["C"][free] = d["C"][kdup]
    d["C_raw"][free] = d["C_raw"][kdup] * 1.05
    for k in ("S", "g", "neuron_sn"):
        d[k][free] = d[k][kdup]
    d["active"][free] = True
    return d


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    gt = _mini_movie()
    X, M = _stats_inputs()
    jobs = [("fit", "fit_case", (gt.Y, dataclasses.asdict(_params(2)), 1)),
            ("stats", "stats_case", (X, M)),
            ("filters", "filters_case", (_filters_input(), FILTERS["gSig"],
                                         FILTERS["ssub"],
                                         FILTERS["noise_cap"])),
            ("merge", "merge_qc_case", (_duplicate_state(),
                                        dataclasses.asdict(_params()))),
            ("guards", "fit_guard_cases", (
                gt.Y[:GUARD_T], dataclasses.asdict(_params()), GUARDS,
                str(tmp_path_factory.mktemp("guards"))))]
    return spawn(_selftest.cases, N_PATCH, N_FRAME, device="cpu",
                 args=(jobs,), timeout=240, pg_timeout=60)


def _active(A, C, act):
    n = int(act.sum())
    return n, (A * act[:, None, None])[:n], C[:n]


@pytest.mark.parametrize("against", ["jax", "port"])
def test_fit_with_ring_ssub_2(ranks, against):
    """``background.ssub = 2`` (the ``preset_1p`` path's coarse ring grid:
    16 rows a slab, 8 coarse rows, the upsample across slabs)."""
    gt = _mini_movie()
    got = ranks[0]["fit"]["state"]
    if against == "jax":
        st = JaxCNMFE(_params(2)).fit(gt.Y, n_outer=1)
        want = _active(np.asarray(st.A), np.asarray(st.C),
                       np.asarray(st.active))
    else:
        st = CNMFE(params_from_dict(dataclasses.asdict(_params(2))),
                   device="cpu").fit(gt.Y, n_outer=1)
        want = _active(st.A.numpy(), st.C.numpy(), st.active.numpy())
    n1, A1, C1 = want
    nN, AN, CN = _active(got["A"], got["C"], got["active"])
    assert n1 == nN > 0
    inter = np.sum((A1 > 0) & (AN > 0))
    assert inter / max(np.sum((A1 > 0) | (AN > 0)), 1) >= 0.99
    for k in range(n1):
        assert float(np.corrcoef(C1[k], CN[k])[0, 1]) >= 0.999, k
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["fit"]["active"], got["active"])


def test_medians_over_sharded_time_are_bit_identical(ranks):
    X, M = (torch.tensor(x) for x in _stats_inputs())
    got = ranks[0]["stats"]
    np.testing.assert_array_equal(got["median"].numpy(),
                                  fast_median(X, dim=0).numpy())
    np.testing.assert_array_equal(got["masked"].numpy(),
                                  fast_median_masked(X, M, dim=0).numpy())
    np.testing.assert_allclose(got["submedian"].numpy(),
                               submedian_mean(X, dim=0).numpy(), rtol=1e-6,
                               atol=1e-6)


def test_filter_and_resize_across_slabs(ranks):
    """4-row slabs, a 13-tap filter (6 halo rows: two slabs, and past the
    field of view's edges replicated), and a resize whose halo row is
    the neighbour's coarse row or the edge's own."""
    Y = torch.tensor(_filters_input())
    got = ranks[0]["filters"]
    want = filter_movie(Y, gaussian_psf(FILTERS["gSig"])).numpy()
    np.testing.assert_allclose(got["filtered"], want, rtol=1e-6, atol=1e-6)
    s = FILTERS["ssub"]
    T, H, W = Y.shape
    pooled = Y.reshape(T, H // s, s, W // s, s).mean(dim=(2, 4))
    np.testing.assert_allclose(got["resized"],
                               resize_linear(pooled, (H, W)).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("what", ["noise_cap", "noise", "corr"])
def test_noise_and_correlation_image(ranks, what):
    Y = torch.tensor(_filters_input())
    want = {"noise_cap": lambda: noise_psd_frames(Y[:FILTERS["noise_cap"]]),
            "noise": lambda: noise_psd_frames(Y),
            "corr": lambda: correlation_image(Y)}[what]().numpy()
    got = ranks[0]["filters"][what]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["dist_corr", "dist_only", "high_corr",
                                  "seq", "qc"])
def test_merge_and_qc_with_a_seeded_duplicate(ranks, mode):
    """The mesh's clusters and active mask equal one process's; the merged
    footprints and traces agree within 1e-4 of their scale."""
    d = _duplicate_state()
    p = params_from_dict(dataclasses.asdict(_params()))
    st = state_from_numpy(d, device="cpu")
    if mode == "qc":
        want, n = remove_false_positives(st, p), None
    elif mode == "seq":
        want, n = merge_neurons_seq(st, p, ("dist_corr", "high_corr"),
                                    deconv=False)
    else:
        want, n = merge_neurons(st, p, mode)
        n = int(n)
    got = ranks[0]["merge"][mode]
    if mode == "dist_corr":
        assert n >= 1                      # the duplicate merged
    if n is not None:
        assert got["n"] == n
    np.testing.assert_array_equal(got["state"]["active"],
                                  want.active.numpy())
    for k in ("A", "C", "C_raw"):
        ref = getattr(want, k).numpy()
        assert np.abs(got["state"][k] - ref).max() <= \
            1e-4 * max(np.abs(ref).max(), 1.0), k
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["merge"][mode]["state"]["active"],
                                      got["state"]["active"])


@pytest.mark.parametrize("name", [n for n, _ in GUARDS])
def test_mesh_guards(ranks, name):
    """Each option and method of ``CNMFE``, and ``fit_batches``, runs on
    the mesh, finds neurons, gives finite values, and every rank returns
    the same state (and method value) bit for bit; each dimension that
    does not divide raises a ValueError naming it; every rank raises
    alike."""
    got = ranks[0]["guards"][name]
    assert got is not None, name
    if name in RUNS:
        kind, dig, checks = got
        assert kind == "ok", got
        assert checks["finite"] and checks["n_active"] > 0, checks
        if name == "run_log":
            assert checks["snaps"] == ["init", "final"], checks
        for r in ranks[1:]:
            assert r["guards"][name][:2] == ("ok", dig), name
        return
    kind, msg = got
    assert kind == "ValueError", got
    assert NAMES[name] in msg, msg
    for r in ranks[1:]:
        assert r["guards"][name][0] == kind
