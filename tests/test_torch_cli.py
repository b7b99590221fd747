"""The port's command line (``cnmf_e_tpu_torch/run.py``) on the CPU,
against the JAX package's CLI on the same simulated TIFF; and the port's
report, contours and decision flow against the JAX package's.

The CLI run is the verify skill's recipe at 48x48x300: every output file
is written, the JAX package's ``load_results`` reads ``results.npz``, and
the detection F1 against ground truth equals the JAX CLI's.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from cnmf_e_tpu import run as jax_run
from cnmf_e_tpu.config import CNMFEParams
from cnmf_e_tpu.io.export import load_results
from cnmf_e_tpu.io.tiff import write_tiff
from cnmf_e_tpu.models.merge import merge_pairs as jax_merge_pairs
from cnmf_e_tpu.models.qc import delete_neurons as jax_delete_neurons
from cnmf_e_tpu.models.state import compact as jax_compact
from cnmf_e_tpu.models.state import empty_state as jax_empty_state
from cnmf_e_tpu.utils import report as jax_report
from cnmf_e_tpu.utils import viz as jax_viz
from cnmf_e_tpu.utils.metrics import detection_f1
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch import run
from cnmf_e_tpu_torch.convert import (params_from_dict, state_from_numpy,
                                      state_to_numpy)
from cnmf_e_tpu_torch.models.merge import merge_pairs
from cnmf_e_tpu_torch.models.qc import delete_neurons
from cnmf_e_tpu_torch.models.state import compact
from cnmf_e_tpu_torch.utils import report, viz

torch.set_num_threads(1)

FLAGS = ["--gsig", "2.5", "--gsiz", "8", "--min-corr", "0.8", "--min-pnr",
         "8", "--ring-radius", "9", "--max-neurons", "24", "--quiet"]


@pytest.fixture(scope="module")
def movie(tmp_path_factory):
    gt = simulate_movie(seed=33, H=48, W=48, T=300, K=6, gSig=2.5, sn=0.08,
                        bg_strength=0.7, min_dist=12.0, spike_rate=0.04)
    path = str(tmp_path_factory.mktemp("cli") / "movie.tif")
    write_tiff(path, gt.Y)
    return gt, path


def _run_dir(workdir):
    (name,) = [d for d in os.listdir(workdir) if d.startswith("RUN_")]
    return os.path.join(workdir, name)


@pytest.fixture(scope="module")
def port_run(movie, tmp_path_factory):
    gt, path = movie
    workdir = str(tmp_path_factory.mktemp("port"))
    rc = run.main([path, "--workdir", workdir, *FLAGS, "--device", "cpu",
                   "--dff", "--save-mat", "--report", "--neuron-panels"])
    assert rc == 0
    return _run_dir(workdir)


def test_cli_writes_every_output(port_run):
    files = set(os.listdir(port_run))
    assert {"results.npz", "results_params.json", "results.mat",
            "params.json", "logs.txt", "dff.npz", "summary.png",
            "report.html", "summary.json", "neurons"} <= files
    assert any(f.startswith("snapshot_") and "_final_" in f for f in files)
    summary = json.load(open(os.path.join(port_run, "summary.json")))
    n = summary["n_neurons"]
    assert n > 0 and summary["shape"] == [300, 48, 48]
    assert len(os.listdir(os.path.join(port_run, "neurons"))) == n
    mat = scipy.io.loadmat(os.path.join(port_run, "results.mat"))
    assert mat["A"].shape == (48 * 48, n)
    with np.load(os.path.join(port_run, "dff.npz")) as z:
        assert z["C_df"].shape == (24, 300) and z["F0"].shape == (24, 1)
        assert np.isfinite(z["C_df"]).all()
    logs = open(os.path.join(port_run, "logs.txt")).read()
    assert "dff -> dff.npz" in logs and "step seconds" in logs


def test_cli_f1_equals_the_jax_cli(movie, port_run, tmp_path, monkeypatch,
                                   capsys):
    gt, path = movie
    res = load_results(os.path.join(port_run, "results.npz"))
    f1_port = detection_f1(res["A"], gt.A)["f1"]
    # the JAX CLI without its persistent compile cache (written under HOME)
    monkeypatch.setattr("cnmf_e_tpu.utils.cache.enable_compilation_cache",
                        lambda *a, **k: None)
    assert jax_run.main([path, "--workdir", str(tmp_path), *FLAGS]) == 0
    jres = load_results(os.path.join(_run_dir(str(tmp_path)),
                                     "results.npz"))
    assert res["A"].shape == jres["A"].shape
    assert f1_port == detection_f1(jres["A"], gt.A)["f1"] >= 0.8
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_neurons"] == res["A"].shape[0]


def test_cli_resume_with_decisions(movie, port_run, tmp_path):
    """--resume from the final snapshot with a decisions.json (two
    rejects, one merge pair): the summary counts the resumed fit's neurons
    less the merged and dropped slots."""
    _, path = movie
    (snap,) = [f for f in os.listdir(port_run) if "_final_" in f]
    dec = tmp_path / "decisions.json"
    dec.write_text(json.dumps({"rejected": [1, 3], "merge": [[0, 2]]}))
    workdir = str(tmp_path / "resumed")
    assert run.main([path, "--workdir", workdir, *FLAGS, "--device", "cpu",
                     "--resume", os.path.join(port_run, snap),
                     "--apply-decisions", str(dec)]) == 0
    rdir = _run_dir(workdir)
    logs = open(os.path.join(rdir, "logs.txt")).read()
    fitted = int(logs.split("done: ")[1].split(" neurons")[0])
    assert "merged 1 pairs" in logs and "dropped 2 neurons" in logs
    summary = json.load(open(os.path.join(rdir, "summary.json")))
    assert summary["n_neurons"] == fitted - 3
    assert load_results(os.path.join(rdir, "results.npz"))["A"].shape[0] \
        == fitted - 3


def test_cli_missing_movie_and_device_default(tmp_path, capsys):
    assert run.main([str(tmp_path / "none.tif")]) == 2
    assert "not found" in capsys.readouterr().err
    assert run.parse_args(["m.tif"]).device == "cuda"


def _toy(K=5, H=32, W=32, T=120, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    A = np.zeros((K, H, W), np.float32)
    for k in range(K):
        cy, cx = rng.uniform(6, H - 6), rng.uniform(6, W - 6)
        A[k] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 6.0)
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    return A, C


def test_report_and_contours_equal_the_jax_package(tmp_path):
    A, C = _toy(K=4)
    Cn = np.abs(np.random.default_rng(1).standard_normal((32, 32)))
    kw = dict(C_raw=C + 0.1, S=(C > 1.5).astype(np.float32),
              tags=np.array([0, 0, 2, 0]), fs=5.0, params={"demo": True},
              title="toy")
    ours = report.generate_html_report(str(tmp_path / "t.html"), Cn, A, C,
                                       **kw)
    theirs = jax_report.generate_html_report(str(tmp_path / "j.html"), Cn,
                                             A, C, **kw)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for a, b in zip(viz.footprint_contours(A), jax_viz.footprint_contours(A)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("deconv", [False, True])
def test_apply_decisions_matches_the_jax_package(deconv):
    """tests/test_report.py's decision flow (merge the pair, drop the
    rejected slot, compact) on one state in both packages."""
    rng = np.random.default_rng(3)
    A, C = _toy()
    st = jax_empty_state(5, 32, 32, 120)
    st = st.replace(A=jnp.asarray(A), C=jnp.asarray(C),
                    C_raw=jnp.asarray(C + 0.05 * rng.standard_normal(
                        C.shape).astype(np.float32)),
                    S=jnp.asarray((C > 1.5).astype(np.float32)),
                    active=st.active.at[:].set(True))
    dec = {"rejected": [4], "merge": [[0, 2]]}
    params = CNMFEParams()

    out, nm = jax_merge_pairs(st, params, dec["merge"], deconv=deconv)
    out = jax_compact(jax_delete_neurons(out, dec["rejected"]))

    d = {k: np.asarray(getattr(st, k)) for k in
         ("A", "C", "C_raw", "S", "g", "neuron_sn", "b0", "active", "tags")}
    ours, nm_t = merge_pairs(state_from_numpy(d, device="cpu"),
                             params_from_dict(dataclasses.asdict(params)),
                             dec["merge"], deconv=deconv)
    ours = compact(delete_neurons(ours, dec["rejected"]))
    assert nm_t == nm == 1
    assert int(ours.n_active()) == int(out.n_active()) == 3
    got = state_to_numpy(ours)
    for k in ("A", "C", "C_raw", "S", "g", "active"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(out, k)),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_delete_neurons_masks_state():
    d = dict(A=np.ones((6, 16, 16)), C=np.ones((6, 50)),
             C_raw=np.ones((6, 50)), S=np.ones((6, 50)),
             g=np.full((6, 1), 0.9), neuron_sn=np.zeros(6),
             b0=np.zeros((16, 16)), active=np.array([True] * 5 + [False]))
    out = delete_neurons(state_from_numpy(d, device="cpu"), [1, 3])
    assert int(out.n_active()) == 3
    assert float(out.A[1].sum()) == 0.0 and float(out.C[3].sum()) == 0.0
    assert float(out.S[1].sum()) == 0.0 and float(out.A[0].sum()) > 0
    assert bool(compact(out).active[:3].all())


def test_decisions_outside_the_slots_raise():
    d = dict(A=np.ones((4, 8, 8)), C=np.ones((4, 20)),
             C_raw=np.ones((4, 20)), S=np.zeros((4, 20)),
             g=np.full((4, 1), 0.9), neuron_sn=np.zeros(4),
             b0=np.zeros((8, 8)))
    st = state_from_numpy(d, device="cpu")
    params = params_from_dict(dataclasses.asdict(CNMFEParams()))
    for bad in ([-1], [4]):
        with pytest.raises(ValueError, match="outside"):
            delete_neurons(st, bad)
    with pytest.raises(ValueError, match="outside"):
        merge_pairs(st, params, [[0, 4]])
