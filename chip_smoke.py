"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each fails the script when its check fails):
  0. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit of card 0 on a line of their own;
  1. build: compiles the CUDA kernels from cnmf_e_tpu_torch/csrc;
  2. kernels vs plain: every kernel against its plain PyTorch version on
     the card, at the shapes CNMFE.fit gives it on a 256x256x2000 movie
     with 192 neuron slots, with median CUDA-event times of both;
  3. end-to-end consistency: CNMFE.fit on a small simulated movie on the
     card and on the CPU must agree;
  4. the slice at full size: CNMFE.fit with the 1p preset on a simulated
     256x256x2000 movie (warm-up fit, then a timed fit); every kernel must
     have launched and the detection F1 against ground truth must reach
     0.8.
The line before the last holds one JSON object with the per-kernel
results; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(1)

from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams,  # noqa: E402
                               InitParams, MergeParams)
from cnmf_e_tpu.utils.metrics import detection_f1, trace_corr  # noqa: E402
from cnmf_e_tpu.utils.simulate import simulate_movie  # noqa: E402
from cnmf_e_tpu_torch import cuda_build  # noqa: E402
from cnmf_e_tpu_torch.models.pipeline import CNMFE  # noqa: E402
from cnmf_e_tpu_torch.ops import hals_kernels, oasis_kernels  # noqa: E402
from cnmf_e_tpu_torch.ops.ar import estimate_time_constant  # noqa: E402
from cnmf_e_tpu_torch.ops.coloring import (  # noqa: E402
    class_step_schedule, greedy_color, overlap_adjacency)
from cnmf_e_tpu_torch.ops.morphology import (  # noqa: E402
    search_locations_dilate)
from cnmf_e_tpu_torch.ops.noise import noise_psd  # noqa: E402

DEV = torch.device("cuda:0")
KERNEL_META = {
    "hals_sweeps": ("cnmf_e_tpu_torch/csrc/hals_sweeps.cu",
                    "cnmf_e_tpu/ops/pallas_hals.py:243"),
    "oasis_chunk_pools": ("cnmf_e_tpu_torch/csrc/oasis.cu",
                          "cnmf_e_tpu/ops/pallas_oasis.py:156"),
    "oasis_pool_merge": ("cnmf_e_tpu_torch/csrc/oasis.cu",
                         "cnmf_e_tpu/ops/pallas_oasis.py:340"),
    "oasis_reconstruct": ("cnmf_e_tpu_torch/csrc/oasis.cu",
                          "cnmf_e_tpu/ops/pallas_oasis.py:448"),
}
REFERENCES = ((hals_kernels, "hals_sweeps_reference"),
              (oasis_kernels, "oasis_chunk_pools_reference"),
              (oasis_kernels, "oasis_pool_merge_reference"),
              (oasis_kernels, "oasis_reconstruct_reference"))


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


# ------------------------------------------------------------------ #
# phase 2 inputs: the shapes CNMFE.fit gives each kernel at 256x256x2000
# ------------------------------------------------------------------ #
def slice_problem(K=192, H=256, W=256, T=2000, seed=0):
    g = torch.Generator(device=DEV).manual_seed(seed)
    cy = torch.rand(K, generator=g, device=DEV) * H
    cx = torch.rand(K, generator=g, device=DEV) * W
    yy = torch.arange(H, device=DEV, dtype=torch.float32)[None, :, None]
    xx = torch.arange(W, device=DEV, dtype=torch.float32)[None, None, :]
    A = torch.exp(-((yy - cy[:, None, None]) ** 2
                    + (xx - cx[:, None, None]) ** 2) / (2 * 3.0 ** 2))
    A = torch.where(A > 0.05, A, 0.0)
    spikes = (torch.rand((K, T), generator=g, device=DEV) < 0.02).float() \
        * (0.5 + torch.rand((K, T), generator=g, device=DEV))
    C = torch.zeros((K, T), device=DEV)
    for t in range(1, T):
        C[:, t] = 0.95 * C[:, t - 1] + spikes[:, t]
    noise = 0.1 * torch.randn((H * W, T), generator=g, device=DEV)
    Y = A.reshape(K, -1).T @ C + noise                      # (d, T)
    return A, C, Y, g


def phase2_kernels(K=192, H=256, W=256, T=2000):
    A, C, Y, gen = slice_problem(K=K, H=H, W=W, T=T)
    d = A.shape[1] * A.shape[2]
    results = {}

    # K1 spatial: masked, relu, colored, 10 sweeps (models/spatial.py)
    A0 = torch.clamp(A * (1 + 0.2 * torch.randn(A.shape, generator=gen,
                                                 device=DEV)), min=0.0)
    mask = search_locations_dilate(A0, radius=2).reshape(K, d)
    adj = overlap_adjacency(mask)
    colors = greedy_color(adj)
    # the colouring runs on the host: its (K, K) copy and loop, per HALS call
    color_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy_color(adj)
        color_s.append(time.perf_counter() - t0)
    print(f"phase 2: greedy_color on the host K={K}: median "
          f"{statistics.median(color_s) * 1e3:.3f} ms per HALS call",
          flush=True)
    order = torch.argsort(colors, stable=True)
    sched = class_step_schedule(colors[order], block=64)
    Cc = C - C.mean(dim=1, keepdim=True)
    U = (Y @ Cc.T).T[order].contiguous()                    # (K, d)
    V = (Cc @ Cc.T)[order][:, order].contiguous()
    X = A0.reshape(K, d)[order].contiguous()
    M = mask[order].contiguous()
    ones = torch.ones(K, device=DEV)

    def sp_kernel():
        return hals_kernels.hals_sweeps(U, V, X, ones, sched, M, 10, 64, True)

    def sp_plain():
        return hals_kernels.hals_sweeps_reference(U, V, X, ones, sched, M, 10,
                                                  64, True)

    out_k, out_p = sp_kernel(), sp_plain()
    torch.cuda.synchronize()
    err_sp = (out_k - out_p).abs()
    ok_sp = bool((err_sp <= 2e-5 * (1 + out_p.abs())).all())
    ms_sp, plain_sp = cuda_ms(sp_kernel, 5), cuda_ms(sp_plain, 3)
    print(f"phase 2: hals_sweeps spatial K={K} d={d} n_iter=10 "
          f"steps={int(sched[3])}: max_abs_err {float(err_sp.max()):.3e} "
          f"(tol 2e-5*(1+|x|)) kernel {ms_sp:.3f} ms plain {plain_sp:.3f} ms",
          flush=True)
    require(ok_sp, "hals_sweeps spatial disagrees with its plain version")

    # K1 temporal: gate, no relu, colored, 4 sweeps (models/temporal.py)
    Af = A.reshape(K, d)
    Vt = Af @ Af.T
    adj = (Vt != 0) & ~torch.eye(K, dtype=torch.bool, device=DEV)
    colors_t = greedy_color(adj)
    order_t = torch.argsort(colors_t, stable=True)
    sched_t = class_step_schedule(colors_t[order_t], block=64)
    Ut = (Af @ Y)[order_t].contiguous()
    Vt = Vt[order_t][:, order_t].contiguous()
    C0 = (C + 0.1 * torch.randn(C.shape, generator=gen, device=DEV)
          )[order_t].contiguous()
    gate = (torch.rand(K, generator=gen, device=DEV) > 0.1).float()

    def tm_kernel():
        return hals_kernels.hals_sweeps(Ut, Vt, C0, gate, sched_t, None, 4,
                                        64, False)

    def tm_plain():
        return hals_kernels.hals_sweeps_reference(Ut, Vt, C0, gate, sched_t,
                                                  None, 4, 64, False)

    out_k, out_p = tm_kernel(), tm_plain()
    torch.cuda.synchronize()
    err_tm = (out_k - out_p).abs()
    ok_tm = bool((err_tm <= 2e-5 * (1 + out_p.abs())).all())
    ms_tm, plain_tm = cuda_ms(tm_kernel, 5), cuda_ms(tm_plain, 3)
    print(f"phase 2: hals_sweeps temporal K={K} T={T} n_iter=4 "
          f"steps={int(sched_t[3])}: max_abs_err {float(err_tm.max()):.3e} "
          f"(tol 2e-5*(1+|x|)) kernel {ms_tm:.3f} ms plain {plain_tm:.3f} ms",
          flush=True)
    require(ok_tm, "hals_sweeps temporal disagrees with its plain version")
    results["hals_sweeps"] = (max(float(err_sp.max()), float(err_tm.max())),
                              ms_sp, plain_sp)

    # K2 -> K3 -> K4: the foopsi deconvolution of K traces of T frames
    y = C + 0.1 * torch.randn(C.shape, generator=gen, device=DEV)
    sn = noise_psd(y)
    g = estimate_time_constant(y, p=1, sn=sn)[:, 0].contiguous()
    smin = (5.0 * sn).contiguous()
    L = 128
    Tp = -(-T // L) * L
    vinit = y - torch.quantile(y, 0.15, dim=-1)[:, None]
    ramp = 1.0 + torch.arange(Tp - T, device=DEV, dtype=torch.float32)
    big = vinit.abs().max() * 2.0 + 1e6
    vinit = torch.cat([vinit, (big * ramp)[None].expand(K, -1)], 1)
    vinit = vinit.contiguous()

    def pools_err(a, b):
        for x, z in zip(a[2:], b[2:]):
            require(torch.equal(x, z), "OASIS pool starts/lengths/counts "
                    "differ from the plain version")
        errs = [(x - z).abs() for x, z in zip(a[:2], b[:2])]
        require(all(bool((e <= 1e-4 * (1 + z.abs())).all())
                    for e, z in zip(errs, b[:2])),
                "OASIS pool values differ from the plain version")
        return max(float(e.max()) for e in errs)

    p1k = oasis_kernels.oasis_chunk_pools(vinit, g, smin, L)
    p1p = oasis_kernels.oasis_chunk_pools_reference(vinit, g, smin, L)
    err = pools_err(p1k, p1p)
    ms = cuda_ms(lambda: oasis_kernels.oasis_chunk_pools(vinit, g, smin, L), 5)
    pms = cuda_ms(lambda: oasis_kernels.oasis_chunk_pools_reference(
        vinit, g, smin, L), 3)
    results["oasis_chunk_pools"] = (err, ms, pms)

    p2k = oasis_kernels.oasis_pool_merge(*p1k, g, smin)
    p2p = oasis_kernels.oasis_pool_merge_reference(*p1k, g, smin)
    err = pools_err(p2k, p2p)
    ms = cuda_ms(lambda: oasis_kernels.oasis_pool_merge(*p1k, g, smin), 5)
    pms = cuda_ms(lambda: oasis_kernels.oasis_pool_merge_reference(
        *p1k, g, smin), 3)
    results["oasis_pool_merge"] = (err, ms, pms)

    ck, sk = oasis_kernels.oasis_reconstruct(*p2k, g, Tp)
    cp, sp = oasis_kernels.oasis_reconstruct_reference(*p2k, g, Tp)
    err = max(float((ck - cp).abs().max()), float((sk - sp).abs().max()))
    require(err <= 1e-4, "oasis_reconstruct disagrees with its plain version")
    ms = cuda_ms(lambda: oasis_kernels.oasis_reconstruct(*p2k, g, Tp), 5)
    pms = cuda_ms(lambda: oasis_kernels.oasis_reconstruct_reference(
        *p2k, g, Tp), 3)
    results["oasis_reconstruct"] = (err, ms, pms)
    for name in ("oasis_chunk_pools", "oasis_pool_merge",
                 "oasis_reconstruct"):
        e, ms, pms = results[name]
        print(f"phase 2: {name} K={K} T={T} L={L}: max_abs_err {e:.3e} "
              f"(tol 1e-4) kernel {ms:.3f} ms plain {pms:.3f} ms", flush=True)
    return results


# ------------------------------------------------------------------ #
# phases 3 and 4
# ------------------------------------------------------------------ #
def match_by_footprint(A1, A2):
    """Greedy one-to-one matching of two footprint sets by correlation."""
    a1 = A1.reshape(len(A1), -1)
    a2 = A2.reshape(len(A2), -1)
    corr = np.corrcoef(np.concatenate([a1, a2]))[:len(a1), len(a1):]
    pairs, used1, used2 = [], set(), set()
    for flat in np.argsort(-corr, axis=None):
        i, j = np.unravel_index(flat, corr.shape)
        if i not in used1 and j not in used2:
            pairs.append((int(i), int(j), float(corr[i, j])))
            used1.add(i)
            used2.add(j)
    return pairs


def phase3_consistency():
    gt = simulate_movie(seed=11, H=64, W=64, T=600, K=10, gSig=2.5,
                        sn=0.08, bg_strength=0.8, min_dist=12.0,
                        spike_rate=0.04)
    params = CNMFEParams(
        init=InitParams(gSig=2.5, gSiz=8, min_corr=0.8, min_pnr=8.0,
                        max_neurons=40, seeds_per_round=16, max_rounds=6),
        background=BackgroundParams(model="ring", ring_radius=9),
        merge=MergeParams(dmin=4.0))
    out = {}
    for dev in ("cuda", "cpu"):
        st = CNMFE(params, device=dev).fit(gt.Y, n_outer=2)
        n = int(st.n_active())
        out[dev] = (n, st.A[:n].cpu().numpy(), st.C[:n].cpu().numpy())
    (n_g, A_g, C_g), (n_c, A_c, C_c) = out["cuda"], out["cpu"]
    require(n_g == n_c, f"n_active differs: cuda {n_g}, cpu {n_c}")
    pairs = match_by_footprint(A_g, A_c)
    a_corr = min(p[2] for p in pairs)
    c_corr = min(float(np.corrcoef(C_g[i], C_c[j])[0, 1])
                 for i, j, _ in pairs)
    print(f"phase 3: cuda vs cpu fit on 64x64x600: n_active {n_g} == {n_c}; "
          f"min footprint corr {a_corr:.5f}, min trace corr {c_corr:.5f} "
          f"(>= 0.99)", flush=True)
    require(a_corr >= 0.99 and c_corr >= 0.99,
            "cuda and cpu fits disagree")


def phase4_full():
    gt = simulate_movie(seed=7, H=256, W=256, T=2000, K=120, gSig=3.0,
                        sn=0.1, bg_strength=1.0, min_dist=9.0,
                        spike_rate=0.02)
    params = CNMFEParams.preset_1p()
    params = params.replace(init=dataclasses.replace(
        params.init, max_neurons=192, seeds_per_round=64, max_rounds=10))
    Y = torch.as_tensor(gt.Y, device=DEV)
    CNMFE(params, device=DEV).fit(Y, n_outer=2)             # warm-up
    torch.cuda.synchronize()

    # the main path must not reach a plain kernel version on the card
    ref_calls = {}
    saved = []
    for mod, name in REFERENCES:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def counted(*a, _fn=fn, _name=name, **kw):
            ref_calls[_name] = ref_calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        setattr(mod, name, counted)
    torch.cuda.reset_peak_memory_stats(DEV)
    cuda_build.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        state = CNMFE(params, device=DEV).fit(Y, n_outer=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    launches = dict(cuda_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(DEV)
    n = int(state.n_active())
    A = state.A[:n].cpu().numpy()
    C = state.C[:n].cpu().numpy()
    require(bool(np.isfinite(A).all() and np.isfinite(C).all()),
            "non-finite footprints or traces")
    f1 = detection_f1(A, gt.A)
    corr = trace_corr(C, gt.C, f1["matches"])
    med = float(np.median(corr)) if len(corr) else 0.0
    print(f"phase 4: CNMFE.fit preset_1p 256x256x2000 K_max=192 n_outer=2: "
          f"wall {wall:.3f} s, n_active {n}, F1 {f1['f1']:.4f} "
          f"(precision {f1['precision']:.4f}, recall {f1['recall']:.4f}), "
          f"median matched trace corr {med:.4f}, peak memory "
          f"{peak / 2**30:.3f} GiB, launches {json.dumps(launches)}",
          flush=True)
    require(not ref_calls, f"the main path called plain versions: "
            f"{ref_calls}")
    require(all(launches[k] > 0 for k in cuda_build.KERNELS),
            f"a kernel of the path never launched: {launches}")
    require(f1["f1"] >= 0.8, f"F1 {f1['f1']:.4f} < 0.8")
    return launches


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi name, power limit:",
          flush=True)
    print(smi[0] if smi else "", flush=True)

    t0 = time.perf_counter()
    cuda_build.load_library()
    print(f"phase 1: built and loaded the CUDA kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in cuda_build.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"phase 1: ptxas {line.strip()}")

    results = phase2_kernels()
    phase3_consistency()
    launches = phase4_full()

    kernels = [{"name": name, "route": "cuda", "source": KERNEL_META[name][0],
                "replaces": KERNEL_META[name][1], "launches": launches[name],
                "max_abs_err": results[name][0], "ms": results[name][1],
                "plain_ms": results[name][2]}
               for name in cuda_build.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
