"""Where the bf16 ray-head backward (kernel #4, csrc/ray_head.cu, namespace
tc) spends its time, by ablation: each variant cuts one part of the kernel
out of a copy of its source (its results are wrong; only its time counts),
is built beside the others, and is timed at the BD train step's scale-0
shape (b=12, N=4096, S=64, no prior). A part costs about what its variant
saves. Runs on the card only:

    python -m implicit_depth_tpu_torch.tools.ray_head_ablation [variant ...]

Each variant is a list of (text in ray_head.cu, replacement); a text that is
no longer in the source stops the run, so the cuts follow the kernel.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

VARIANTS = {
    "base": [],
    # ELU's exp in the h pass and the z2 epilogue
    "no_exp": [("b > 0.f ? b : __expf(b) - 1.f", "b"), ("a > 0.f ? a : __expf(a) - 1.f", "a")],
    # every rounding that is not also a store (rnd2)
    "no_round": [("float2 rnd2(float a, float b) { return __bfloat1622float2(bf2(a, b)); }",
                  "float2 rnd2(float a, float b) { return make_float2(a, b); }")],
    # 1. the h pass (fp loads and the chain to h)
    "no_step1": [("      if (r < nrows) {\n        const __nv_bfloat162* f2",
                  "      if (r < -1) {\n        const __nv_bfloat162* f2")],
    # 2. the z2 epilogue's arithmetic (its stores stay)
    "no_epi2": [("          const float2 h2 = __bfloat1622float2(\n"
                 "              elu2_bf16(acc[t][2 * r] + b.x, acc[t][2 * r + 1] + b.y));\n"
                 "          const float2 cw = rnd2(c * w.x, c * w.y);\n"
                 "          const float2 dl = delu2_bf16(h2);",
                 "          const float2 h2 = make_float2(acc[t][2 * r], acc[t][2 * r + 1]);\n"
                 "          const float2 cw = make_float2(c, c);\n"
                 "          const float2 dl = h2;")],
    # 3. the dh epilogue's arithmetic before dz
    "no_epi3": [("          const float2 dh = rnd2(acc[t][2 * r], acc[t][2 * r + 1]);\n"
                 "          const float2 dl =\n"
                 "              delu2_bf16(__bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s_h + o)));",
                 "          const float2 dh = make_float2(acc[t][2 * r], acc[t][2 * r + 1]);\n"
                 "          const float2 dl = dh;")],
    # 4. dW1 += h^T dz2 on the tensor cores
    "no_step4": [("    for (int ks = 0; ks < TR / 16; ++ks) {\n      uint32_t a[4];\n      ldsm4_t(a, s_h + o_hA",
                  "    for (int ks = 0; ks < 0; ++ks) {\n      uint32_t a[4];\n      ldsm4_t(a, s_h + o_hA")],
    # 5. dfp and the column sums
    "no_step5": [("    for (int item = tid; item < nr * F; item += THREADS) {",
                  "    for (int item = tid; item < 0; item += THREADS) {"),
                 ("    for (int r = cpart * (TR / PARTS); r < (cpart + 1) * (TR / PARTS); ++r) {",
                  "    for (int r = 0; r < 0; ++r) {")],
}


def build(names, workdir: Path) -> dict:
    """{variant: library path}, one nvcc per variant, all at once."""
    from implicit_depth_tpu_torch.ops import cuda_build

    source = (cuda_build.CSRC_DIR / "ray_head.cu").read_text()
    nvcc = cuda_build.cuda_tool("nvcc")
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"variant {name}: its cut no longer matches ray_head.cu: {old!r}")
            text = text.replace(old, new)
        src = workdir / f"ray_head_{name}.cu"
        src.write_text(text)
        lib = workdir / f"libray_head_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} does not build:\n{out}")
        libs[name] = lib
    return libs


def main(argv) -> int:
    import torch

    import chip_smoke
    from implicit_depth_tpu_torch.ops import cuda_build
    from implicit_depth_tpu_torch.ops import ray_head as rh

    if not torch.cuda.is_available():
        print("ray_head_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    chip_smoke.phase_device()
    ops, ct = chip_smoke.ray_inputs(b=12, n=4096, s=64, prior=False, dtype=torch.bfloat16)
    fp, d, _, k0d, _, w1, b1, w2, _ = ops
    nrays, s = fp.shape[0] * fp.shape[1], d.shape[2]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(names, Path(tmp))
        times = {name: [] for name in names}
        for _ in range(2):  # two rounds, the variants in turn
            for name in names:
                lib = ctypes.CDLL(str(libs[name]))
                for fn, (argtypes, restype) in rh._SIGNATURES.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
                nslabs = lib.ray_head_bwd_blocks(nrays, s, cuda_build.sm_count(fp.device), 1)
                slab = lib.ray_head_slab_len()
                dfp = torch.empty((nrays, rh.HIDDEN), device=fp.device)
                dd = torch.empty((nrays, s), device=fp.device)
                slabs = torch.zeros((nslabs, slab), device=fp.device)
                grads = torch.empty((slab,), device=fp.device)
                stream = torch.cuda.current_stream().cuda_stream

                def call():
                    cuda_build.check(lib.ray_head_bwd_bf16(
                        fp.data_ptr(), d.data_ptr(), None, ct.data_ptr(), k0d.data_ptr(), None,
                        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dfp.data_ptr(), dd.data_ptr(),
                        None, slabs.data_ptr(), grads.data_ptr(), nrays, s, nslabs, stream),
                        f"ray_head_bwd_bf16 ({name})")

                times[name].append(chip_smoke.cuda_ms(call))
    base = min(times["base"]) if "base" in times else None
    for name, ts in times.items():
        saves = f", saves {base - min(ts):.3f} ms" if base is not None and name != "base" else ""
        print(f"ray-head backward bf16 b=12 N=4096 S=64, {name}: "
              f"{' / '.join(f'{t:.3f}' for t in ts)} ms (two rounds, medians of "
              f"{chip_smoke.TIMED_RUNS}){saves}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
