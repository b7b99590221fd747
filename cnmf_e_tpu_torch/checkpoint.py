"""Run logging and checkpoint/resume (port of ``cnmf_e_tpu/checkpoint.py``).

Reference subsystem (SURVEY.md section 5): each run creates a
``LOGS_<date>`` folder with a timestamped append-only ``logs.txt`` and an
``intermediate_results.mat`` that every stage appends a snapshot to;
``initComponents_parallel`` scans previous runs and restores state
(``initComponents_parallel.m:43-158``).

Here: a run directory with ``logs.txt``, per-stage ``.npz`` snapshots in
the export format (:mod:`cnmf_e_tpu_torch.io.export`), and
``restore_state`` rebuilding a state from one, on the card unless the
caller passes ``device="cpu"``. A snapshot written by either package
restores in the other.
"""

from __future__ import annotations

import datetime
import glob
import os
from typing import Optional

import torch

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.io.export import load_results, save_results
from cnmf_e_tpu_torch.models.state import (CNMFEState, RingWeights,
                                           empty_state)


class RunLog:
    """Append-only run log + stage snapshot store."""

    def __init__(self, workdir: str, run_name: Optional[str] = None,
                 params: Optional[CNMFEParams] = None):
        if run_name is None:
            run_name = "RUN_" + datetime.datetime.now().strftime(
                "%Y%m%d_%H%M%S")
        self.dir = os.path.join(workdir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self.log_path = os.path.join(self.dir, "logs.txt")
        if params is not None:
            with open(os.path.join(self.dir, "params.json"), "w") as f:
                f.write(params.to_json())
        self.log(f"run directory created: {self.dir}")

    def log(self, msg: str) -> None:
        stamp = datetime.datetime.now().strftime("%H:%M:%S")
        with open(self.log_path, "a") as f:
            f.write(f"[{stamp}] {msg}\n")

    # ---------------- snapshots ---------------- #
    def snapshot(self, stage: str, state: CNMFEState,
                 extras: Optional[dict] = None) -> str:
        stamp = datetime.datetime.now().strftime("%H%M%S")
        name = f"snapshot_{len(self._snapshots()):03d}_{stage}_{stamp}"
        path = save_results(os.path.join(self.dir, name), state,
                            extras=extras)
        self.log(f"stage '{stage}' snapshot -> {os.path.basename(path)}")
        return path

    def _snapshots(self):
        return sorted(glob.glob(os.path.join(self.dir, "snapshot_*.npz")))

    def latest_snapshot(self) -> Optional[str]:
        snaps = self._snapshots()
        return snaps[-1] if snaps else None


def restore_state(path: str, K_max: int, H: int, W: int, T: int,
                  device="cuda") -> CNMFEState:
    """Rebuild a CNMFEState (fixed capacity K_max) on ``device`` from a
    snapshot file."""
    data = load_results(path)
    K = data["A"].shape[0]
    if K > K_max:
        raise ValueError(f"snapshot has {K} neurons > capacity {K_max}")
    st = empty_state(K_max, H, W, T, p=data["g"].shape[1], device=device)

    def put(x, key):
        x = x.clone()
        x[:K] = torch.as_tensor(data[key], dtype=x.dtype, device=device)
        return x
    active = st.active.clone()
    active[:K] = True
    st = st.replace(
        A=put(st.A, "A"), C=put(st.C, "C"), C_raw=put(st.C_raw, "C_raw"),
        S=put(st.S, "S"), g=put(st.g, "g"),
        neuron_sn=put(st.neuron_sn, "neuron_sn"), active=active,
        b0=torch.as_tensor(data["b0"], dtype=torch.float32, device=device))
    if "ring_w" in data:
        st = st.replace(W=RingWeights(
            w=torch.as_tensor(data["ring_w"], dtype=torch.float32,
                              device=device),
            w0=torch.as_tensor(data["ring_w0"], dtype=torch.float32,
                               device=device)))
    if "bg_b" in data:
        st = st.replace(
            b=torch.as_tensor(data["bg_b"], dtype=torch.float32,
                              device=device),
            f=torch.as_tensor(data["bg_f"], dtype=torch.float32,
                              device=device))
    return st


def find_latest_run(workdir: str) -> Optional[str]:
    """Most recent run directory in a workdir (resume chooser analog —
    non-interactive: the config/CLI decides, not a prompt)."""
    runs = sorted(glob.glob(os.path.join(workdir, "RUN_*")))
    return runs[-1] if runs else None
