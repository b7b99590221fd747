"""The decimated and detrended init, the remaining spatial and background
options, and every method of ``CNMFE`` on a 2 x 2 mesh of gloo ranks.

One spawn of 2 x 2 CPU ranks (rank bodies in
``cnmf_e_tpu_torch/parallel/_selftest.py``; a 240 s deadline, a 60 s
timeout on every collective) runs each case, held to the port's one
process and to the JAX package's single-device function at the
tolerances of the one-process tests:

  * ``detrend`` (spline and local_min, blocks across the frame seam)
    within 1e-5 (``test_torch_init_paths.py``);
  * ``initialize_greedy`` with ``init.ssub``/``tsub`` = 2 and ``nk`` > 1
    (both detrend methods): the same seed count, the state within 1e-3
    (``test_torch_init_paths.py``);
  * ``CNMFE(mesh=...).fit`` with the nmf background and ``nnls``, and
    with ``lars`` on the decimated, detrended init: equal n_active,
    matched footprints and traces at correlation >= 0.99 against the JAX
    package and >= 0.999 against the port's one process;
  * ``dff`` (whole-session and running percentile, and the KDE mode),
    ``background``, ``reconstruction``, ``residual`` and ``compute_rss``
    of a ring (ssub 2) and an svd state (``test_torch_dff.py``'s
    problem): DF/F at rtol 1e-5, the movies within 1e-5 of their scale
    of one process and 1e-4 of the JAX package's, the RSS likewise;
  * a fit with a run log (rank 0 writes it) and one resumed from its init
    snapshot, against one process doing the same;
  * ``remove_false_positives(active_pixels=...)``: the same active mask.
"""

import dataclasses
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams, DeconvParams,
                               InitParams, QCParams, TemporalParams)
from cnmf_e_tpu.models import dff as jdff
from cnmf_e_tpu.models import initialize as jinit
from cnmf_e_tpu.models import qc as jqc
from cnmf_e_tpu.models.pipeline import CNMFE as JaxCNMFE
from cnmf_e_tpu.ops import detrend as jdetrend
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.checkpoint import RunLog
from cnmf_e_tpu_torch.convert import params_from_dict, state_from_numpy
from cnmf_e_tpu_torch.models import dff as tdff
from cnmf_e_tpu_torch.models import initialize as tinit
from cnmf_e_tpu_torch.models import qc as tqc
from cnmf_e_tpu_torch.models.pipeline import CNMFE
from cnmf_e_tpu_torch.ops import detrend as tdetrend
from cnmf_e_tpu_torch.parallel import _selftest
from cnmf_e_tpu_torch.parallel.launch import spawn
from test_torch_dff import _jax_state as _dff_jax_state
from test_torch_dff import _params as _dff_params
from test_torch_dff import _problem as _dff_problem
from test_torch_mesh_options import (_asdict, _close, _matched,
                                     _mini_movie, _mini_params)
from test_torch_ops import _jax_to_numpy

torch.set_num_threads(1)

N_PATCH, N_FRAME = 2, 2
DETREND = [("spline", 3), ("spline", 6), ("local_min", 4), ("local_min", 7)]
INIT = {"ssub2_tsub2": dict(ssub=2, tsub=2),
        "nk3_local_min": dict(nk=3, detrend_method="local_min"),
        "ssub2_tsub2_nk4": dict(ssub=2, tsub=2, nk=4)}
FITS = {
    "nmf_nnls": {"background.model": "nmf", "spatial.algorithm": "nnls"},
    "lars_init": {"spatial.algorithm": "lars", "init.ssub": 2,
                  "init.tsub": 2, "init.nk": 3},
}
MODELS = ("ring", "svd")
WINDOWS = (None, 101)


def _detrend_input():
    rng = np.random.default_rng(4)
    return (rng.standard_normal((40, 96)) + np.linspace(0, 3, 96)).astype(
        np.float32)


def _init_movie():
    """``test_torch_init_paths.py``'s drifting movie with 32 rows."""
    gt = simulate_movie(seed=5, H=32, W=28, T=240, K=5, gSig=2.0, sn=0.05,
                        bg_strength=0.6, min_dist=8.0, spike_rate=0.05)
    drift = np.linspace(0.0, 0.6, gt.Y.shape[0], dtype=np.float32)
    return (gt.Y + drift[:, None, None]).astype(np.float32)


def _init_params(**init):
    """``test_torch_ops.py::_params`` with the init options ``init``."""
    p = CNMFEParams(
        init=InitParams(gSig=2.0, gSiz=7, min_corr=0.6, min_pnr=4.0,
                        max_neurons=8, seeds_per_round=6, max_rounds=3),
        background=BackgroundParams(model="ring", ring_radius=6))
    return p.replace(init=dataclasses.replace(p.init, **init))


def _qc_problem():
    """``test_torch_dff.py``'s state without deconvolution (so only the
    pixel count and the classifier decide), the left 10 columns marked
    active."""
    d, _ = _dff_problem("svd")
    params = CNMFEParams(
        temporal=TemporalParams(deconv=DeconvParams(enabled=False)),
        qc=QCParams(classify_cl_thr=0.8))
    mask = np.zeros(d["A"].shape[1:], bool)
    mask[:, :10] = True
    return d, params, mask


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_log")


@pytest.fixture(scope="module")
def ranks(workdir):
    jobs = [(f"detrend_{m}_{nk}", "detrend_case", (_detrend_input(), nk, m))
            for m, nk in DETREND]
    Y = _init_movie()
    jobs += [(f"init_{name}", "init_case", (Y, _asdict(_init_params(**kw))))
             for name, kw in INIT.items()]
    gt = _mini_movie()
    jobs += [(f"fit_{name}", "fit_case",
              (gt.Y, _asdict(_mini_params(**fields)), 1))
             for name, fields in FITS.items()]
    for model in MODELS:
        d, Yd = _dff_problem(model)
        p = _asdict(_dff_params(model))
        jobs.append((f"methods_{model}", "methods_case", (Yd, d, p,
                                                          WINDOWS)))
        jobs.append((f"dff_mode_{model}", "dff_mode_case", (Yd, d, p)))
    jobs.append(("log", "log_resume_case", (gt.Y, _asdict(_mini_params()),
                                            str(workdir), 1)))
    d, p, mask = _qc_problem()
    jobs.append(("qc", "qc_pixels_case", (d, _asdict(p), mask)))
    return spawn(_selftest.cases, N_PATCH, N_FRAME, device="cpu",
                 args=(jobs,), timeout=240, pg_timeout=60)


# ------------------------------------------------------------------ #
# the decimated and detrended init
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("against", ["jax", "port"])
@pytest.mark.parametrize("method, nk", DETREND)
def test_detrend(ranks, method, nk, against):
    X = _detrend_input()
    want = (jdetrend.detrend(jnp.asarray(X), nk, method) if against == "jax"
            else tdetrend.detrend(torch.tensor(X), nk, method))
    np.testing.assert_allclose(ranks[0][f"detrend_{method}_{nk}"],
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("against", ["jax", "port"])
@pytest.mark.parametrize("name", sorted(INIT))
def test_initialize_greedy_decimated_and_detrended(ranks, name, against):
    Y = _init_movie()
    p = _init_params(**INIT[name])
    if against == "jax":
        st, info = jinit.initialize_greedy(jnp.asarray(Y), p)
        want = _jax_to_numpy(st)
    else:
        st, info = tinit.initialize_greedy(torch.tensor(Y),
                                           params_from_dict(_asdict(p)))
        want = {k: getattr(st, k).numpy() for k in
                ("A", "C", "C_raw", "S", "g", "neuron_sn", "active")}
    got = ranks[0][f"init_{name}"]
    assert got["n_found"] == info["n_found"] > 0
    np.testing.assert_array_equal(got["state"]["active"], want["active"])
    for k in ("A", "C", "C_raw", "S", "g", "neuron_sn"):
        np.testing.assert_allclose(got["state"][k], want[k], rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    for r in ranks[1:]:
        assert r[f"init_{name}"]["n_found"] == got["n_found"]


@pytest.mark.parametrize("against", ["jax", "port"])
@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_with_options(ranks, name, against):
    gt = _mini_movie()
    got = ranks[0][f"fit_{name}"]
    p = _mini_params(**FITS[name])
    if against == "jax":
        st, bar = JaxCNMFE(p).fit(gt.Y, n_outer=1), 0.99
    else:
        st = CNMFE(params_from_dict(_asdict(p)), device="cpu").fit(
            gt.Y, n_outer=1)
        bar = 0.999
    s = got["state"]
    _matched(s["A"], s["C"], s["active"], np.asarray(st.A),
             np.asarray(st.C), np.asarray(st.active), bar)
    for r in ranks:
        np.testing.assert_array_equal(r[f"fit_{name}"]["active"],
                                      s["active"])
        assert r[f"fit_{name}"]["broadcasts"] == 0


# ------------------------------------------------------------------ #
# the methods
# ------------------------------------------------------------------ #
def _models(model):
    """The JAX package's and the port's one-process CNMFE holding the dff
    problem's state."""
    d, Y = _dff_problem(model)
    p = _dff_params(model)
    jm = JaxCNMFE(p)
    jm.state = _dff_jax_state(d)
    tm = CNMFE(params_from_dict(_asdict(p)), device="cpu")
    tm.state = state_from_numpy(d, device="cpu")
    return Y, jm, tm


@pytest.mark.parametrize("against", ["jax", "port"])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("model", MODELS)
def test_dff(ranks, model, window, against):
    Y, jm, tm = _models(model)
    want = (jm.dff(jnp.asarray(Y), window=window) if against == "jax"
            else tm.dff(torch.as_tensor(Y), window=window))
    got = ranks[0][f"methods_{model}"][f"dff_{window}"]
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)


@pytest.mark.parametrize("against", ["jax", "port"])
@pytest.mark.parametrize("model", MODELS)
def test_dff_mode(ranks, model, against):
    d, Y = _dff_problem(model)
    p = _dff_params(model)
    want = (jdff.extract_dff(jnp.asarray(Y), _dff_jax_state(d), p,
                             baseline="mode") if against == "jax" else
            tdff.extract_dff(torch.as_tensor(Y),
                             state_from_numpy(d, device="cpu"),
                             params_from_dict(_asdict(p)),
                             baseline="mode"))
    for a, b in zip(ranks[0][f"dff_mode_{model}"], want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=0)


@pytest.mark.parametrize("against", ["jax", "port"])
@pytest.mark.parametrize("what", ["background", "reconstruction",
                                  "residual", "rss"])
@pytest.mark.parametrize("model", MODELS)
def test_movie_methods(ranks, model, what, against):
    """Each rank's block of the background, the reconstruction and the
    residual, gathered; the RSS summed over the mesh."""
    Y, jm, tm = _models(model)
    rel = 1e-4 if against == "jax" else 1e-5
    ref = jm if against == "jax" else tm
    Yin = jnp.asarray(Y) if against == "jax" else torch.as_tensor(Y)
    got = ranks[0][f"methods_{model}"]
    if what == "rss":
        want = ref.compute_rss(Yin)
        assert abs(got["rss"] - want) <= rel * want
        assert all(r[f"methods_{model}"]["rss"] == got["rss"]
                   for r in ranks)
        return
    _close(got[what], np.asarray(getattr(ref, what)(Yin)), rel, what)


@functools.lru_cache(maxsize=None)
def _base_fit(against: str, resume_from=None):
    """One process's fit of the mini movie with the mini params (or its
    resume from ``resume_from``): the JAX package's or the port's."""
    gt = _mini_movie()
    kw = {} if resume_from is None else dict(resume_from=resume_from)
    if against == "jax":
        return JaxCNMFE(_mini_params()).fit(gt.Y, n_outer=1, **kw)
    return CNMFE(params_from_dict(_asdict(_mini_params())),
                 device="cpu").fit(gt.Y, n_outer=1, **kw)


def _lines(lines):
    """A run log's messages without the clock, the seconds, the run
    directory and the snapshots' time stamps."""
    out = []
    for line in lines:
        line = re.sub(r"^\[\d\d:\d\d:\d\d\] ", "", line)
        line = re.sub(r" \(\d+\.\ds\)$", "", line)
        line = re.sub(r"_\d{6}\.npz", ".npz", line)
        out.append(re.sub(r"created: .*", "created", line))
    return out


def test_run_log_written_by_rank_0_as_one_process(ranks, tmp_path):
    gt = _mini_movie()
    log = RunLog(str(tmp_path), run_name="one")
    st = CNMFE(params_from_dict(_asdict(_mini_params())), device="cpu").fit(
        gt.Y, n_outer=1, run_log=log)
    assert torch.equal(st.active, _base_fit("port").active)
    with open(log.log_path) as f:
        want = _lines(f.read().splitlines())
    got = ranks[0]["log"]
    assert [s.split("_")[2] for s in got["snaps"]] == ["init", "final"]
    assert _lines(got["log"]) == want
    assert all("log" not in r["log"] for r in ranks[1:])


@pytest.mark.parametrize("against", ["jax", "port"])
@pytest.mark.parametrize("what", ["state", "resumed"])
def test_run_log_and_resume(ranks, what, against):
    """The fit that wrote the run log, and the fit resumed from its init
    snapshot on the mesh, against one process fitting (or resuming from
    the same snapshot)."""
    got = ranks[0]["log"]
    st = _base_fit(against, None if what == "state" else got["snap"])
    bar = 0.99 if against == "jax" else 0.999
    s = got[what]
    _matched(s["A"], s["C"], s["active"], np.asarray(st.A),
             np.asarray(st.C), np.asarray(st.active), bar)
    for r in ranks:
        np.testing.assert_array_equal(r["log"][what]["active"], s["active"])


@pytest.mark.parametrize("against", ["jax", "port"])
def test_remove_false_positives_with_active_pixels(ranks, against):
    d, p, mask = _qc_problem()
    if against == "jax":
        st = jqc.remove_false_positives(
            _dff_jax_state(d), p, active_pixels=jnp.asarray(mask))
    else:
        st = tqc.remove_false_positives(
            state_from_numpy(d, device="cpu"), params_from_dict(_asdict(p)),
            active_pixels=torch.as_tensor(mask))
    want = np.asarray(st.active)
    assert 0 < want.sum() < d["active"].sum()      # the mask decides
    for r in ranks:
        np.testing.assert_array_equal(r["qc"], want)
