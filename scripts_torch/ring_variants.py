"""Time the ring kernels K6 and K5 with other tile constants.

    python3 scripts_torch/ring_variants.py [--k6 NAME=V,NAME=V ...]
                                           [--k5 NAME=V,NAME=V ...]

Each variant copies ``csrc/ring_stencil.cu`` (K6) or ``csrc/ring_banded.cu``
(K5) with some of its ``constexpr int NAME = VALUE;`` lines replaced, builds
it alone with the package's nvcc flags into ``csrc/_build/variants/``,
prints ptxas's register and spill report of its kernels, and times its
launch entry at the shapes the main paths give the kernel: K6 at the step's
256x256x2000, radius 13, and on the fit's 128x128x2000 grid, radius 9; K5
at the step's shape on the bf16 movie. Each output is held to the package's
kernel on the same inputs (K6 bit for bit, K5 within 1e-5 of the output's
scale). Times are CUDA events around 10 back-to-back launches after a
warm-up, each variant timed twice in turns with the others. The package
itself always builds the sources as they are; with no arguments the script
times the sources' own constants and a few neighbours.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cnmf_e_tpu_torch import cuda_build  # noqa: E402
from cnmf_e_tpu_torch.models.state import RingWeights  # noqa: E402
from cnmf_e_tpu_torch.ops import ring_kernels as rk  # noqa: E402

DEV = torch.device("cuda:0")
OUT = cuda_build.BUILD_DIR / "variants"
K6_DEFAULT = ("", "kFWide=4", "kStages=2")
K5_DEFAULT = ("", "EPS=2,kStages=3")
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(source: str, overrides: str, tag: str) -> ctypes.CDLL:
    text = (cuda_build.CSRC / source).read_text()
    for item in filter(None, overrides.split(",")):
        name, value = item.split("=")
        text, n = re.subn(rf"constexpr (int|size_t) {name} = [^;]+;",
                          rf"constexpr \1 {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"{source}: no single constexpr {name}")
    OUT.mkdir(parents=True, exist_ok=True)
    src, so = OUT / f"{tag}.cu", OUT / f"{tag}.so"
    src.write_text(text)
    res = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                          "-shared", "-o", str(so), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {tag}:\n{res.stdout}{res.stderr}")
    print(f"{tag} [{overrides or 'as in the source'}]:", flush=True)
    log = (res.stdout + res.stderr).splitlines()
    for i, line in enumerate(log):
        m = re.search(r"Function properties for \S*(ring_(?:stencil_regs|"
                      r"stencil_smem|banded)_kernel)(?:I(?:Li|Lb)(\d+)E)?",
                      line)
        if m:
            regs = next((re.search(r"Used (\d+) registers", x).group(1)
                         for x in log[i + 1:i + 4] if "Used" in x), "?")
            print(f"  {m.group(1)}<{m.group(2) or ''}>: {regs} registers, "
                  f"{log[i + 1].strip()}", flush=True)
    return ctypes.CDLL(str(so))


def events_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def k6_runner(lib, overrides: str, T, H, W, radius):
    """A launch of the variant's register body, its frames split over CTAs
    as the wrapper splits them for the variant's frames a thread and CTAs
    an SM."""
    c = dict(kWideTaps=rk._REGS_WIDE_TAPS, kFNarrow=rk._REGS_FRAMES[0],
             kFWide=rk._REGS_FRAMES[1])
    for item in filter(None, overrides.split(",")):
        name, value = item.split("=")
        if name in c:
            c[name] = int(value)
    wide = rk.ring_offsets(radius).shape[0] > c["kWideTaps"]
    n_sm = torch.cuda.get_device_properties(DEV).multi_processor_count
    TT = rk._regs_frames_per_cta(T, H, W, c["kFWide"] if wide
                                 else c["kFNarrow"], 1 if wide else 2, n_sm)
    R = rk.ring_offsets(radius).shape[0]
    g = torch.Generator(device=DEV).manual_seed(radius)
    X = torch.randn((T, H, W), generator=g, device=DEV)
    w = 0.01 * torch.randn((H * W, R), generator=g, device=DEV) + 1.0 / R
    w0 = torch.randn(H * W, generator=g, device=DEV)
    wt = w.T.contiguous()
    out = torch.empty_like(X)
    fn = lib.ring_stencil_regs_launch
    fn.argtypes, fn.restype = [_P] * 4 + [_I] * 5 + [_P], _I
    stream = torch.cuda.current_stream(DEV).cuda_stream

    def run():
        err = fn(X.data_ptr(), wt.data_ptr(), w0.data_ptr(), out.data_ptr(),
                 T, H, W, radius, TT, stream)
        if err:
            raise SystemExit(f"K6 variant launch failed: CUDA error {err}")
    run()
    ref = rk.apply_ring_stencil(w, w0, X, H, W, radius)
    if not torch.equal(out, ref):
        raise SystemExit(f"K6 variant [{overrides}] differs from the "
                         f"package's kernel")
    return run


def k5_runner(lib, overrides: str, T=2000, H=256, W=256, radius=13):
    R = rk.ring_offsets(radius).shape[0]
    g = torch.Generator(device=DEV).manual_seed(5)
    X = torch.randn((T, H, W), generator=g, device=DEV)
    wts = RingWeights(
        w=0.01 * torch.randn((H * W, R), generator=g, device=DEV) + 1.0 / R,
        w0=torch.randn(H * W, generator=g, device=DEV))
    bands = rk.ring_dense_bands(wts, H, W, radius)
    Xb = X.reshape(T, H * W).to(torch.bfloat16).contiguous()
    kstart, koff = rk._k_blocks_on(radius, W, DEV)
    out = torch.empty((T, H, W), device=DEV)
    _, D = rk._band_geometry(radius)
    fn = lib.ring_banded_flat_launch
    fn.argtypes, fn.restype = [_P] * 6 + [_I] * 4 + [_P], _I
    stream = torch.cuda.current_stream(DEV).cuda_stream

    def run():
        err = fn(Xb.data_ptr(), bands.data_ptr(), wts.w0.data_ptr(),
                 kstart.data_ptr(), koff.data_ptr(), out.data_ptr(), T, H, W,
                 D, stream)
        if err:
            raise SystemExit(f"K5 variant launch failed: CUDA error {err}")
    run()
    ref = rk.apply_ring_mxu_flat(bands, wts.w0, X, H, W, radius)
    e = float((out - ref).abs().max())
    if e > 1e-5 * float(ref.abs().max()):
        raise SystemExit(f"K5 variant [{overrides}] is off the package's "
                         f"kernel by {e:.3e}")
    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k6", nargs="*", default=list(K6_DEFAULT))
    ap.add_argument("--k5", nargs="*", default=list(K5_DEFAULT))
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    runs = []
    for i, ov in enumerate(args.k6):
        lib = build("ring_stencil.cu", ov, f"k6_{i}")
        runs.append((f"K6 [{ov or 'source'}] step 256x256x2000 r=13",
                     k6_runner(lib, ov, 2000, 256, 256, 13)))
        runs.append((f"K6 [{ov or 'source'}] fit grid 128x128x2000 r=9",
                     k6_runner(lib, ov, 2000, 128, 128, 9)))
    for i, ov in enumerate(args.k5):
        lib = build("ring_banded.cu", ov, f"k5_{i}")
        runs.append((f"K5 [{ov or 'source'}] step 256x256x2000 r=13 (launch)",
                     k5_runner(lib, ov)))
    times = {name: [] for name, _ in runs}
    for _ in range(2):
        for name, run in runs:
            times[name].append(events_ms(run))
    for name, ts in times.items():
        print(f"{name}: {' / '.join(f'{t:.3f}' for t in ts)} ms", flush=True)


if __name__ == "__main__":
    main()
