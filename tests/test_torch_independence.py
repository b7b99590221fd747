"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, and its own copies of the JAX package's pure-numpy modules (the
params, the movie simulation and its out-of-core store, the metrics, the
connected components, the data layer) give the same results. Its entry
points default to the card."""

import ast
import dataclasses
import inspect
import json
import os

import numpy as np
import pytest

from cnmf_e_tpu import config as jax_config
from cnmf_e_tpu.native import connected_components as jax_cc
from cnmf_e_tpu.utils import metrics as jax_metrics
from cnmf_e_tpu.utils import simulate as jax_simulate
from cnmf_e_tpu_torch import checkpoint, config, convert, run
from cnmf_e_tpu_torch.models.batch import fit_batches
from cnmf_e_tpu_torch.models.merge import connected_components
from cnmf_e_tpu_torch.models.pipeline import CNMFE
from cnmf_e_tpu_torch.models.streaming import fit_streaming
from cnmf_e_tpu_torch.utils import metrics, simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(os.path.join(root, f), REPO)
    for top in ("cnmf_e_tpu_torch", "scripts_torch")
    for root, _, files in os.walk(os.path.join(REPO, top))
    for f in files if f.endswith(".py")) + ["chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "cnmf_e_tpu")]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("make", [
    lambda c: c.CNMFEParams(),
    lambda c: c.CNMFEParams.preset_1p(),
    lambda c: c.CNMFEParams.preset_2p(),
    lambda c: c.CNMFEParams.preset_2p("ar2_thresholded"),
], ids=["default", "preset_1p", "preset_2p", "preset_2p_ar2"])
def test_params_copy_equals_the_jax_package(make):
    ours, theirs = make(config), make(jax_config)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.to_json() == theirs.to_json()
    # and the converter hands the JAX tests' params to the port
    got = convert.params_from_dict(dataclasses.asdict(theirs))
    assert isinstance(got, config.CNMFEParams) and got == ours
    assert convert.params_from_dict(json.loads(theirs.to_json())) == ours


def test_params_from_dict_rejects_unknown_fields():
    d = dataclasses.asdict(config.CNMFEParams())
    d["init"]["no_such_field"] = 1
    with pytest.raises(ValueError, match="no_such_field"):
        convert.params_from_dict(d)


@pytest.mark.parametrize("n", [0, 1, 7, 200])
@pytest.mark.parametrize("density", [0.0, 0.02, 0.1, 0.3])
def test_connected_components_match_the_native_union_find(n, density):
    rng = np.random.default_rng(n * 100 + int(density * 100))
    adj = rng.random((n, n)) < density
    adj = adj | adj.T
    labels, count = connected_components(adj)
    want_labels, want_count = jax_cc(adj)
    assert count == want_count
    np.testing.assert_array_equal(labels, want_labels)
    assert labels.dtype == np.int32


@pytest.mark.parametrize("seed", [0, 7])
def test_simulate_movie_copy_is_bit_identical(seed):
    kw = dict(seed=seed, H=40, W=36, T=150, K=6, gSig=2.5, sn=0.08,
              bg_strength=0.7, min_dist=8.0, spike_rate=0.04)
    ours, theirs = simulate.simulate_movie(**kw), \
        jax_simulate.simulate_movie(**kw)
    for f in dataclasses.fields(jax_simulate.GroundTruth):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_detection_f1_copy_agrees():
    gt = jax_simulate.simulate_movie(seed=3, H=48, W=48, T=60, K=8,
                                     min_dist=8.0)
    rng = np.random.default_rng(0)
    est = np.concatenate([gt.A[:6] * (1 + 0.1 * rng.random(gt.A[:6].shape)),
                          rng.random((2, 48, 48)) * (rng.random((2, 48, 48))
                                                     > 0.97)])
    ours, theirs = metrics.detection_f1(est, gt.A), \
        jax_metrics.detection_f1(est, gt.A)
    for k in ("f1", "precision", "recall", "matches"):
        assert ours[k] == theirs[k], k
    np.testing.assert_array_equal(ours["iou"], theirs["iou"])
    C = rng.random((8, 60))
    np.testing.assert_array_equal(
        metrics.trace_corr(C, gt.C, ours["matches"]),
        jax_metrics.trace_corr(C, gt.C, theirs["matches"]))


def test_entry_points_default_to_the_card():
    assert CNMFE(config.CNMFEParams.preset_1p()).device.type == "cuda"
    for fn in (convert.state_from_numpy, convert.step_state_from_numpy,
               fit_streaming, fit_batches, checkpoint.restore_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # the command line: --device defaults to the card
    assert run.parse_args(["movie.tif"]).device == "cuda"


# the port's copies of pure-numpy modules of the JAX package, and ports
# that keep a JAX module's public functions
COPIES = ["io/tiff.py", "io/avi.py", "io/movie.py", "io/store.py",
          "io/export.py", "checkpoint.py", "utils/profiling.py",
          "ops/detrend.py", "utils/simulate.py", "ops/kde.py",
          "utils/viz.py", "utils/report.py", "models/dff.py", "run.py",
          "ops/ar.py", "ops/nnls.py", "ops/onnls.py", "ops/oasis.py",
          "ops/spikes.py", "models/cnmf2p.py", "models/pairing.py",
          "models/qc.py", "models/merge.py", "models/background.py",
          "models/spatial.py", "models/pipeline.py", "ops/coloring.py",
          "ops/lowrank.py"]


@pytest.mark.parametrize("path", COPIES)
def test_copy_has_the_jax_packages_public_functions(path):
    """Each copy offers every public function and class of its JAX
    original, under the same name and parameters."""
    def public(pkg):
        tree = ast.parse(open(os.path.join(REPO, pkg, path)).read())
        return {n.name: [a.arg for a in n.args.args]
                if isinstance(n, ast.FunctionDef) else None
                for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                and not n.name.startswith("_")}
    ours, theirs = public("cnmf_e_tpu_torch"), public("cnmf_e_tpu")
    for name, args in theirs.items():
        assert name in ours, name
        # the port's functions may add a trailing device argument
        if args is not None:
            assert ours[name][:len(args)] == args, name


# the modules of the 2p slice: the import scan above covers each
SLICE_2P = ["ops/ar.py", "ops/nnls.py", "ops/onnls.py", "ops/oasis.py",
            "ops/spikes.py", "ops/mcem.py", "ops/mcmc.py",
            "models/cnmf2p.py", "models/spatial.py", "models/temporal.py"]


@pytest.mark.parametrize("path", SLICE_2P)
def test_the_import_scan_covers_the_2p_modules(path):
    assert os.path.join("cnmf_e_tpu_torch", path) in PORT_FILES


# the modules of the mesh slice: the import scan above covers each
SLICE_MESH = ["parallel/comm.py", "parallel/mesh.py", "parallel/launch.py",
              "parallel/multihost.py", "parallel/_selftest.py"]


@pytest.mark.parametrize("path", SLICE_MESH)
def test_the_import_scan_covers_the_mesh_modules(path):
    assert os.path.join("cnmf_e_tpu_torch", path) in PORT_FILES


def test_mesh_entry_points_default_to_the_card():
    from cnmf_e_tpu_torch.parallel.launch import spawn
    from cnmf_e_tpu_torch.parallel.mesh import make_mesh
    for fn in (make_mesh, spawn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_geweke_copy_agrees():
    """The MCMC convergence z-score is host numpy in both packages; the
    port keeps its own copy."""
    from cnmf_e_tpu.ops.mcmc import _geweke_z as jax_geweke
    from cnmf_e_tpu_torch.ops.mcmc import _geweke_z
    counts = np.random.default_rng(3).poisson(4.0, (501, 6))
    counts[:, 2] = 5                                   # zero variance
    np.testing.assert_array_equal(_geweke_z(counts), jax_geweke(counts))


def test_pairing_copy_agrees():
    """pair_neurons, classify_components and update_order are float64
    host numpy in both packages; the port keeps its own copy."""
    from cnmf_e_tpu.models import pairing as jax_pairing
    from cnmf_e_tpu_torch.models import pairing
    rng = np.random.default_rng(6)
    A1 = rng.random((300, 6)) * (rng.random((300, 6)) < 0.2)
    A2 = A1[:, ::-1] + 0.01 * rng.random((300, 6))
    C1, C2 = rng.random((6, 80)), rng.random((6, 80))
    act = rng.random(300) > 0.5
    for ours, theirs in (
            (pairing.pair_neurons(A1, C1, A2, C2),
             jax_pairing.pair_neurons(A1, C1, A2, C2)),
            (pairing.update_order(A1), jax_pairing.update_order(A1)),
            ([pairing.classify_components(A1, act, 0.4)],
             [jax_pairing.classify_components(A1, act, 0.4)])):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fpb", [250, 1000])
def test_simulate_movie_store_copy_writes_the_same_bytes(tmp_path, fpb):
    kw = dict(seed=3, H=40, W=36, T=750, K=7, gSig=2.5, sn=0.06,
              bg_strength=0.6, min_dist=12.0, spike_rate=0.04,
              frames_per_block=fpb)
    ours = simulate.simulate_movie_store(str(tmp_path / "t"), **kw)
    jax_simulate.simulate_movie_store(str(tmp_path / "j"), **kw)
    assert ours.shape == (750, 40, 36)
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
