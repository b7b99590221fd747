"""The port's command line on its other paths, on the CPU: temporal
batches with DF/F (``--batch-frames --dff``) and the 2p preset with its
svd background (``--preset 2p``), each run once on a simulated TIFF."""

import json
import os

import numpy as np
import torch

from cnmf_e_tpu.io.export import load_results
from cnmf_e_tpu.io.tiff import write_tiff
from cnmf_e_tpu.utils.metrics import detection_f1
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch import run

torch.set_num_threads(1)

FLAGS = ["--gsig", "2.5", "--gsiz", "8", "--min-corr", "0.8", "--min-pnr",
         "8", "--max-neurons", "24", "--quiet", "--device", "cpu"]


def _cli(tmp_path, gt, *flags):
    path = str(tmp_path / "movie.tif")
    write_tiff(path, gt.Y)
    workdir = str(tmp_path / "out")
    assert run.main([path, "--workdir", workdir, *FLAGS, *flags]) == 0
    (name,) = [d for d in os.listdir(workdir) if d.startswith("RUN_")]
    return os.path.join(workdir, name)


def test_cli_batches_with_dff(tmp_path):
    gt = simulate_movie(seed=33, H=48, W=48, T=300, K=6, gSig=2.5, sn=0.08,
                        bg_strength=0.7, min_dist=12.0, spike_rate=0.04)
    rdir = _cli(tmp_path, gt, "--ring-radius", "9", "--batch-frames", "150",
                "--dff")
    assert sorted(os.listdir(tmp_path / "out" / "store")) == [
        "block_00000.npy", "block_00001.npy", "manifest.json"]
    res = load_results(os.path.join(rdir, "results.npz"))
    assert res["C"].shape[1] == 300
    assert detection_f1(res["A"], gt.A)["f1"] >= 0.8
    with np.load(os.path.join(rdir, "dff.npz")) as z:
        assert z["C_df"].shape == (24, 300) and z["F0"].shape == (24, 1)
        assert np.isfinite(z["C_df"]).all() and (z["F0"] > 0).all()
    assert any("batch_final" in f for f in os.listdir(rdir))
    summary = json.load(open(os.path.join(rdir, "summary.json")))
    assert summary["n_neurons"] == res["A"].shape[0]


def test_cli_preset_2p_svd(tmp_path):
    gt = simulate_movie(seed=13, H=48, W=48, T=300, K=8, gSig=2.5,
                        sn=0.06, bg_strength=0.5, min_dist=11.0,
                        spike_rate=0.04)
    rdir = _cli(tmp_path, gt, "--preset", "2p", "--dff")
    params = json.load(open(os.path.join(rdir, "params.json")))
    assert params["background"]["model"] == "svd"
    assert params["background"]["rank"] == 3
    res = load_results(os.path.join(rdir, "results.npz"))
    assert res["bg_b"].shape == (3, 48, 48) and res["bg_f"].shape == (3, 300)
    assert "ring_w" not in res
    assert detection_f1(res["A"], gt.A)["recall"] >= 0.75
    with np.load(os.path.join(rdir, "dff.npz")) as z:
        assert np.isfinite(z["C_df"]).all()
