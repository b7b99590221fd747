"""Command-line pipeline runner (port of ``cnmf_e_tpu/run.py``).

The headless-automation surface of the framework (reference layer L7:
``python_wrapper/run_cnmfe_matlab.py`` shells out to MATLAB per stack; here
the pipeline IS Python, so the CLI runs it directly).

    python -m cnmf_e_tpu_torch.run movie.tif --workdir out/ --preset 1p \
        --gsig 3 --gsiz 13 --min-corr 0.8 --min-pnr 8 --ring-radius 18

It runs on the card unless ``--device cpu`` is given. Outputs in the run
directory: results.npz (+ optional .mat), params.json, logs.txt, stage
snapshots, dff.npz, summary.png (Cn + contours + traces), neurons/,
report.html and summary.json; the last line on stdout is the summary as
JSON.

A run is two steps: :func:`fit_step` (the fit, the user's QC decisions,
the export and DF/F: all the device work) and :func:`figure_step` (the
summary figure, neuron panels and report: host matplotlib and PIL, which
raise ``ImportError`` where they are missing).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np


def build_params(args):
    from cnmf_e_tpu_torch.config import CNMFEParams

    p = (CNMFEParams.preset_2p() if args.preset == "2p"
         else CNMFEParams.preset_1p())
    init = dataclasses.replace(
        p.init,
        gSig=args.gsig if args.gsig is not None else p.init.gSig,
        gSiz=int(args.gsiz) if args.gsiz is not None else p.init.gSiz,
        min_corr=args.min_corr or p.init.min_corr,
        min_pnr=args.min_pnr or p.init.min_pnr,
        max_neurons=args.max_neurons or p.init.max_neurons,
        nk=args.nk if args.nk is not None else p.init.nk,
    )
    bg = p.background
    if args.bg_model:
        bg = dataclasses.replace(bg, model=args.bg_model)
    if args.ring_radius:
        bg = dataclasses.replace(bg, ring_radius=int(args.ring_radius))
    return dataclasses.replace(p, init=init, background=bg,
                               fs=args.fs or p.fs)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="CNMF-E pipeline (PyTorch, CUDA kernels)")
    ap.add_argument("movie", help="input movie (.tif/.h5/.npy)")
    ap.add_argument("--workdir", default=None,
                    help="output directory (default: <movie>_cnmfe)")
    ap.add_argument("--preset", choices=["1p", "2p"], default="1p")
    ap.add_argument("--gsig", type=float, default=None)
    ap.add_argument("--gsiz", type=float, default=None)
    ap.add_argument("--min-corr", type=float, default=None)
    ap.add_argument("--min-pnr", type=float, default=None)
    ap.add_argument("--ring-radius", type=float, default=None)
    ap.add_argument("--bg-model", choices=["ring", "svd", "nmf"],
                    default=None)
    ap.add_argument("--max-neurons", type=int, default=None)
    ap.add_argument("--nk", type=int, default=None,
                    help="detrend knots (1 = off)")
    ap.add_argument("--fs", type=float, default=None, help="frame rate")
    ap.add_argument("--n-outer", type=int, default=2)
    ap.add_argument("--frames", type=int, default=None,
                    help="limit number of frames")
    ap.add_argument("--batch-frames", type=int, default=0,
                    help="temporal batch size (0 = in-memory)")
    ap.add_argument("--save-mat", action="store_true")
    ap.add_argument("--dff", action="store_true",
                    help="also export DF/F traces")
    ap.add_argument("--resume", default=None, metavar="SNAPSHOT_NPZ",
                    help="resume from a previous stage snapshot")
    ap.add_argument("--neuron-panels", action="store_true",
                    help="write per-neuron QC PNGs")
    ap.add_argument("--report", action="store_true",
                    help="write the interactive HTML QC report")
    ap.add_argument("--apply-decisions", default=None, metavar="JSON",
                    help="decisions.json from a report: drop rejected "
                         "neurons before export")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fit (default: cuda)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Run:
    """What the fit step hands the figure step and the summary."""
    args: argparse.Namespace
    params: object
    model: object              # CNMFE holding the final state
    run_log: object            # checkpoint.RunLog
    shape: tuple
    n: int                     # active neurons, in the leading slots
    # wall seconds: load, fit, export (the fit step), dff, figures
    seconds: dict


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def fit_step(args: argparse.Namespace) -> Run:
    """Fit, apply the user's QC decisions, export results(.npz/.mat) and,
    with ``--dff``, dff.npz."""
    from cnmf_e_tpu_torch.checkpoint import RunLog
    from cnmf_e_tpu_torch.io.export import save_results, save_results_mat
    from cnmf_e_tpu_torch.io.movie import load_movie, probe_movie
    from cnmf_e_tpu_torch.io.store import distribute_movie
    from cnmf_e_tpu_torch.models.pipeline import CNMFE

    t0 = time.perf_counter()
    params = build_params(args)
    workdir = args.workdir or os.path.splitext(args.movie)[0] + "_cnmfe"
    os.makedirs(workdir, exist_ok=True)
    run_log = RunLog(workdir, params=params)
    verbose = not args.quiet

    shape, dtype = probe_movie(args.movie)
    run_log.log(f"input {args.movie}: shape={shape} dtype={dtype}")

    model = CNMFE(params, device=args.device)
    seconds = {}

    def lap(name):
        nonlocal t0
        t = time.perf_counter()
        seconds[name] = t - t0
        t0 = t

    batch_states = None
    if args.batch_frames > 0:
        from cnmf_e_tpu_torch.models.batch import fit_batches
        store = distribute_movie(args.movie, os.path.join(workdir, "store"),
                                 frames_per_block=args.batch_frames)
        blocks = list(store.iter_blocks())
        lap("load")
        state, batch_states = fit_batches(
            blocks, params, n_outer=args.n_outer, verbose=verbose,
            run_log=run_log, resume_from=args.resume, device=args.device)
        model.state = state
    else:
        Y = load_movie(args.movie, 0, args.frames)
        lap("load")
        state = model.fit(Y, n_outer=args.n_outer, verbose=verbose,
                          run_log=run_log, resume_from=args.resume)

    if args.apply_decisions:
        from cnmf_e_tpu_torch.models.merge import merge_pairs
        from cnmf_e_tpu_torch.models.qc import delete_neurons
        from cnmf_e_tpu_torch.models.state import compact
        with open(args.apply_decisions) as f:
            dec = json.load(f)
        rejected = dec.get("rejected", [])
        pairs = dec.get("merge", [])
        if pairs:
            # user-marked merge pairs from the report (the reference's
            # manual_merge_multi_pairs flow); ids are slot indices of the
            # reported (compacted) state
            state, nm = merge_pairs(state, params, pairs)
            run_log.log(f"applied decisions: merged {nm} pairs "
                        f"({args.apply_decisions})")
        if rejected:
            state = delete_neurons(state, rejected)
            run_log.log(f"applied decisions: dropped {len(rejected)} "
                        f"neurons ({args.apply_decisions})")
        if pairs or rejected:
            state = compact(state)
            model.state = state
    n = int(state.active.sum())          # waits for the device
    lap("fit")

    out_path = save_results(os.path.join(run_log.dir, "results"), state,
                            params=params)
    run_log.log(f"results -> {out_path}")
    if args.save_mat:
        mat_path = save_results_mat(os.path.join(run_log.dir, "results"),
                                    state)
        run_log.log(f"matlab export -> {mat_path}")
    lap("export")

    if args.dff:
        if args.batch_frames > 0:
            from cnmf_e_tpu_torch.models.dff import extract_dff_batches
            C_df, C_raw_df, F0 = extract_dff_batches(
                blocks, batch_states, state, params)
        else:
            C_df, C_raw_df, F0 = model.dff(Y)
        np.savez_compressed(os.path.join(run_log.dir, "dff.npz"),
                            C_df=_np(C_df), C_raw_df=_np(C_raw_df),
                            F0=_np(F0))
        lap("dff")
        run_log.log("dff -> dff.npz")

    return Run(args=args, params=params, model=model, run_log=run_log,
               shape=tuple(shape), n=n, seconds=seconds)


def figure_step(run: Run) -> None:
    """Neuron panels (``--neuron-panels``), summary.png and report.html
    (``--report``), from the fitted state's leading ``run.n`` slots."""
    from cnmf_e_tpu_torch.utils.viz import plot_summary

    args, n, rdir = run.args, run.n, run.run_log.dir
    if n == 0:
        return
    t0 = time.perf_counter()
    st = run.model.state
    A, C = _np(st.A)[:n], _np(st.C)[:n]
    if args.neuron_panels:
        from cnmf_e_tpu_torch.utils.viz import save_neuron_panels
        save_neuron_panels(os.path.join(rdir, "neurons"), A, C,
                           C_raw=_np(st.C_raw)[:n], S=_np(st.S)[:n],
                           fs=run.params.fs)
        run.run_log.log("neuron panels -> neurons/")

    Cn = run.model.info.get("Cn")
    Cn = np.zeros(run.shape[1:]) if Cn is None else _np(Cn)
    png = plot_summary(os.path.join(rdir, "summary.png"), Cn, A, C)
    run.run_log.log(f"summary figure -> {png}")

    if args.report:
        from cnmf_e_tpu_torch.utils.report import generate_html_report
        rpt = generate_html_report(
            os.path.join(rdir, "report.html"), Cn, A, C,
            C_raw=_np(st.C_raw)[:n], S=_np(st.S)[:n],
            tags=_np(st.tags)[:n], fs=run.params.fs,
            params={"movie": args.movie, "preset": args.preset},
            title=os.path.basename(args.movie))
        run.run_log.log(f"interactive report -> {rpt}")
    run.seconds["figures"] = time.perf_counter() - t0


def write_summary(run: Run) -> dict:
    """summary.json in the run directory; returns its content."""
    summary = {"n_neurons": run.n, "movie": run.args.movie,
               "shape": list(run.shape), "run_dir": run.run_log.dir}
    with open(os.path.join(run.run_log.dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    run.run_log.log("step seconds: " + json.dumps(
        {k: round(v, 3) for k, v in run.seconds.items()}))
    return summary


def main(argv: Optional[list] = None) -> int:
    args = parse_args(argv)
    if not os.path.exists(args.movie):
        print(f"error: input movie not found: {args.movie}", file=sys.stderr)
        return 2
    run = fit_step(args)
    figure_step(run)
    print(json.dumps(write_summary(run)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
