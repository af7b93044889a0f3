"""Where the warp transpose (kernel #6, csrc/warp_planes.cu, namespace bwd)
spends its time, by ablation: each variant cuts one part of the kernel out
of a copy of its source, or changes one design choice (its results may be
wrong; only its time counts), is built beside the others, and is timed in
bf16 at the regression train step's shape (K'=112, D=64, 96x128, C=16). A
cut part costs about what its variant saves. Runs on the card only:

    python -m implicit_depth_tpu_torch.tools.warp_bwd_ablation [variant ...]

Each variant is a list of (text in warp_planes.cu, replacement); every text
must occur exactly once in the source, so the cuts follow the kernel.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

VARIANTS = {
    "base": [],
    # everything but the candidate boxes: no chunk is walked
    "boxes_only": [("      if (ns == 0) break;", "      break;")],
    # the cotangents' copy to the stage (the texels then sum stale values)
    "no_stage": [("for (int j = tid; j < m * PIECES; j += NT) {",
                  "for (int j = tid; j < 0; j += NT) {")],
    # the pixels' samples and cells (no pixel has a cell: the sort and the
    # sums have nothing to do)
    "no_coords": [("        if (i < n) {\n          int s = 0;",
                   "        if (i < 0) {\n          int s = 0;")],
    # the texels' sums over their cells' lists
    "no_accumulate": [("for (int t = 0; t < na + nb; ++t) {", "for (int t = 0; t < 0; ++t) {")],
    # the staged pieces in plain order (bank conflicts among the texels' loads)
    "no_swizzle": [("constexpr bool SWIZZLE = true;", "constexpr bool SWIZZLE = false;")],
    # the texels' loop not unrolled
    "no_unroll": [("#pragma unroll 2\n        for (int t = 0;",
                   "#pragma unroll 1\n        for (int t = 0;")],
    # four blocks an SM (64 registers a thread: the sums spill), a stage of
    # 768 pixels in bf16
    "bounds4_stage24k": [("__launch_bounds__(NT, 3)", "__launch_bounds__(NT, 4)"),
                         ("constexpr int STAGE_BYTES = 40960;",
                          "constexpr int STAGE_BYTES = 24576;")],
    # two blocks an SM (128 registers a thread), a stage of 2048 pixels in bf16
    "bounds2_stage64k": [("__launch_bounds__(NT, 3)", "__launch_bounds__(NT, 2)"),
                         ("constexpr int STAGE_BYTES = 40960;",
                          "constexpr int STAGE_BYTES = 65536;")],
}

SHAPE = dict(K=112, H=96, W=128, D=64)


def build(names, workdir: Path) -> dict:
    """{variant: library path}, one nvcc per variant, all at once."""
    from implicit_depth_tpu_torch.ops import cuda_build

    source = (cuda_build.CSRC_DIR / "warp_planes.cu").read_text()
    nvcc = cuda_build.cuda_tool("nvcc")
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: its cut does not match warp_planes.cu once: "
                                 f"{old!r}")
            text = text.replace(old, new)
        src = workdir / f"warp_planes_{name}.cu"
        src.write_text(text)
        lib = workdir / f"libwarp_planes_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{out}")
        regs, keep = [], False
        for ln in out.splitlines():
            if "Compiling entry function" in ln:
                keep = "warp_planes_bwd_kernelI13__nv_bfloat16" in ln
            elif keep and "Used" in ln and "registers" in ln:
                regs.append(ln.split(":", 1)[1].strip())
        print(f"variant {name}: ptxas (bf16 transpose) {' | '.join(regs)}", flush=True)
        libs[name] = lib
    return libs


def main(argv) -> int:
    import torch

    import chip_smoke
    from implicit_depth_tpu_torch.ops import cuda_build
    from implicit_depth_tpu_torch.ops import warp_kernel as wk

    if not torch.cuda.is_available():
        print("warp_bwd_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    chip_smoke.phase_device()
    K, H, W, D = (SHAPE[x] for x in "KHWD")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(names, Path(tmp))
        _, A, b, planes = chip_smoke.warp_operands(**SHAPE, dtype=torch.bfloat16, seed=1)
        gen = torch.Generator(device="cuda").manual_seed(2)
        ct = torch.randn((K, D, H, W, 16), generator=gen, device="cuda").to(torch.bfloat16)
        out = torch.empty((K, H, W, 16), dtype=torch.bfloat16, device="cuda")
        times = {name: [] for name in names}
        for _ in range(2):  # two rounds, the variants in turn
            for name in names:
                lib = ctypes.CDLL(str(libs[name]))
                for fn, (argtypes, restype) in wk._SIGNATURES.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
                stream = torch.cuda.current_stream().cuda_stream

                def call():
                    cuda_build.check(lib.warp_planes_bwd_bf16(
                        ct.data_ptr(), A.data_ptr(), b.data_ptr(), planes.data_ptr(),
                        out.data_ptr(), K, H, W, 16, D, stream), f"warp_planes_bwd_bf16 ({name})")

                times[name].append(chip_smoke.cuda_ms(call))
        base = min(times["base"]) if "base" in times else None
        for name, ts in times.items():
            saves = "" if base is None or name == "base" else f", saves {base - min(ts):.3f} ms"
            print(f"warp transpose bf16 K'={K} D={D} {H}x{W}, {name}: "
                  f"{' / '.join(f'{t:.3f}' for t in ts)} ms (two rounds, medians of "
                  f"{chip_smoke.TIMED_RUNS}){saves}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
