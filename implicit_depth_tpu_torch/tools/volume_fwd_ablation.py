"""Where the bf16 fused-volume forward (kernel #1, csrc/fused_volume.cu,
namespace tc) spends its time, by ablation: each variant cuts one part of
the kernel out of a copy of its source, or changes one design choice (its
results may be wrong; only its time counts), is built beside the others, and
is timed at the eval shape (B=1, K=7, 96x128, D=64) and the BD train step's
(B=12). A cut part costs about what its variant saves. Runs on the card
only:

    python -m implicit_depth_tpu_torch.tools.volume_fwd_ablation [variant ...]

Each variant is a list of (text in fused_volume.cu, replacement); every text
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
    # fc0's metadata term, f32 FMA on the CUDA cores
    "no_meta": [("        for (int j = 0; j < KM; ++j) {", "        for (int j = 0; j < 0; ++j) {")],
    # fc0's visual term on the tensor cores (the stage is still written)
    "no_fc0_mma": [("        for (int ks = 0; ks < K; ++ks) {  // one k-slice of 16 per view",
                    "        for (int ks = 0; ks < 0; ++ks) {  // one k-slice of 16 per view")],
    # fc1's operand loads and products (h1 is still consumed)
    "no_fc1": [("            uint32_t b[4];\n"
                "            ldsm4(b, s_w1 + o_w1 + (64 * h + 16 * t2) * LDH + s * 16);\n"
                "            mma(a2[2 * t2], h1f[s], b[0], b[1]);\n"
                "            mma(a2[2 * t2 + 1], h1f[s], b[2], b[3]);",
                "            a2[2 * t2][0] += __uint_as_float(h1f[s][t2]);")],
    # the warp, taps and metadata of phase A (the stages are still written)
    "no_sample": [("        if (oka) {\n          const int bk = bia * K + k;",
                   "        if (oka && k < 0) {\n          const int bk = bia * K + k;")],
    # phase A's view loop unrolled by two (more tap loads in flight)
    "sample_unroll2": [("#pragma unroll 1\n      for (int k = tid / P; k < K; k += THREADS / P) {",
                        "#pragma unroll 2\n      for (int k = tid / P; k < K; k += THREADS / P) {")],
    # work units of 4 or 16 planes
    "group4": [("constexpr int G = 8;", "constexpr int G = 4;")],
    "group16": [("constexpr int G = 8;", "constexpr int G = 16;")],
    # every warp samples the next plane first (one order instead of two)
    "one_order": [("const bool sample_first = warp < WARPS / 2;", "const bool sample_first = true;")],
}

SHAPES = {"B=1": dict(B=1, K=7, H=96, W=128, D=64), "B=12": dict(B=12, K=7, H=96, W=128, D=64)}


def build(names, workdir: Path) -> dict:
    """{variant: library path}, one nvcc per variant, all at once."""
    from implicit_depth_tpu_torch.ops import cuda_build

    source = (cuda_build.CSRC_DIR / "fused_volume.cu").read_text()
    nvcc = cuda_build.cuda_tool("nvcc")
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: its cut does not match fused_volume.cu once: "
                                 f"{old!r}")
            text = text.replace(old, new)
        src = workdir / f"fused_volume_{name}.cu"
        src.write_text(text)
        lib = workdir / f"libfused_volume_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{out}")
        regs = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f"variant {name}: ptxas {' | '.join(regs)}", flush=True)
        libs[name] = lib
    return libs


def main(argv) -> int:
    import torch

    import chip_smoke
    from implicit_depth_tpu_torch.ops import cuda_build
    from implicit_depth_tpu_torch.ops import fused_volume as fvm

    if not torch.cuda.is_available():
        print("volume_fwd_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    chip_smoke.phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(names, Path(tmp))
        for label, shape in SHAPES.items():
            ops = chip_smoke.volume_operands(**shape, dtype=torch.bfloat16)
            out = torch.empty((shape["B"], shape["D"], shape["H"], shape["W"]), device="cuda")
            times = {name: [] for name in names}
            for _ in range(2):  # two rounds, the variants in turn
                for name in names:
                    lib = ctypes.CDLL(str(libs[name]))
                    for fn, (argtypes, restype) in fvm._SIGNATURES["fused_volume.cu"].items():
                        getattr(lib, fn).argtypes = argtypes
                        getattr(lib, fn).restype = restype
                    stream = torch.cuda.current_stream().cuda_stream

                    def call():
                        cuda_build.check(lib.fused_metadata_volume_bf16(
                            *(t.data_ptr() for t in ops), out.data_ptr(),
                            *(shape[x] for x in "BKHWD"), stream),
                            f"fused_metadata_volume_bf16 ({name})")

                    times[name].append(chip_smoke.cuda_ms(call))
            base = min(times["base"]) if "base" in times else None
            for name, ts in times.items():
                saves = f", saves {base - min(ts):.3f} ms" if base is not None and name != "base" else ""
                print(f"volume forward bf16 {label} K=7 96x128 D=64, {name}: "
                      f"{' / '.join(f'{t:.3f}' for t in ts)} ms (two rounds, medians of "
                      f"{chip_smoke.TIMED_RUNS}){saves}", flush=True)
            del ops, out
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
