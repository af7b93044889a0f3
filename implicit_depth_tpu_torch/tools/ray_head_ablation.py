"""Where the bf16 ray-head kernels (csrc/ray_head.cu, namespace tc: the
forward #3 and the backward #4) spend their time, by ablation: each variant
cuts one part of a kernel out of a copy of its source (its results are
wrong; only its time counts), is built beside the others, and its kernel is
timed at the BD train step's scale-0 shape (b=12, N=4096, S=64, no prior).
A part costs about what its variant saves against "base", which times both
kernels. Runs on the card only:

    python -m implicit_depth_tpu_torch.tools.ray_head_ablation [variant ...]

Each variant is the kernel it times and a list of (text in ray_head.cu,
replacement); a text that is no longer in the source stops the run, so the
cuts follow the kernels. The forward and the backward share the chain's
functions (h_pair, h2_pair, elu2_bf16, rnd2), so a cut there changes both.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

# ELU's exp, in the h and h2 pairs of both kernels
_NO_EXP = [("b > 0.f ? b : __expf(b) - 1.f", "b"), ("a > 0.f ? a : __expf(a) - 1.f", "a")]

# the forward's alternative designs (the VARIANTS fwd_3, fwd_staged_h*)
_THREE_BLOCKS = [("constexpr int FWD_BLOCKS_PER_SM = 2;", "constexpr int FWD_BLOCKS_PER_SM = 3;")]
_STAGED_H = [
    ("constexpr size_t FWD_SMEM = STAGE + 4 * 4 * (size_t)F;",
     "constexpr size_t FWD_SMEM = 2 * STAGE + 4 * 4 * (size_t)F;"),
    ("""    const __nv_bfloat16* fa = fp + (ra / S) * F + 2 * q;
    const __nv_bfloat16* fb = fp + (rb / S) * F + 2 * q;
    uint32_t a[KS][4];  // fp pairs, then h pairs
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      a[s][0] = __ldg(reinterpret_cast<const unsigned*>(fa + 16 * s));
      a[s][1] = __ldg(reinterpret_cast<const unsigned*>(fb + 16 * s));
      a[s][2] = __ldg(reinterpret_cast<const unsigned*>(fa + 16 * s + 8));
      a[s][3] = __ldg(reinterpret_cast<const unsigned*>(fb + 16 * s + 8));
    }
    const float da = __bfloat162float(d[ra]), db = __bfloat162float(d[rb]);
    const float pa = prior ? __bfloat162float(p[ra]) : 0.f;
    const float pb = prior ? __bfloat162float(p[rb]) : 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * s + 2 * q + 8 * (e >> 1);
        const float2 kd = *reinterpret_cast<const float2*>(s_k0d + c);
        const float2 kp = *reinterpret_cast<const float2*>(s_k0p + c);
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&a[s][e]);
        a[s][e] = (e & 1) ? bits(h_pair(x, db, pb, kd, kp, prior))
                          : bits(h_pair(x, da, pa, kd, kp, prior));
      }
    }
""", """    __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem_tc + STAGE + 16 * F);
    const int chunk = lane & 15, o_rows = frag_off(LDH, lane, true) + 16 * warp * LDH;
    __syncwarp();
    uint4 fv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long long r = tile * TR + 16 * warp + (lane >> 4) + 2 * k;
      fv[k] = __ldg(reinterpret_cast<const uint4*>(fp + ((r < rows ? r : rows - 1) / S) * F +
                                                   8 * chunk));
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      long long r = tile * TR + 16 * warp + (lane >> 4) + 2 * k;
      r = r < rows ? r : rows - 1;
      const float dv = __bfloat162float(d[r]), pv = prior ? __bfloat162float(p[r]) : 0.f;
      const __nv_bfloat162* f2 = reinterpret_cast<const __nv_bfloat162*>(&fv[k]);
      uint4 hv;
      uint32_t* h2 = reinterpret_cast<uint32_t*>(&hv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * chunk + 2 * e;
        h2[e] = bits(h_pair(f2[e], dv, pv, *reinterpret_cast<const float2*>(s_k0d + c),
                            *reinterpret_cast<const float2*>(s_k0p + c), prior));
      }
      *reinterpret_cast<uint4*>(s_h + (16 * warp + (lane >> 4) + 2 * k) * LDH + 8 * chunk) = hv;
    }
    __syncwarp();
"""),
    ("""      for (int s = 0; s < KS; ++s) {
#pragma unroll
        for (int t2 = 0; t2 < NT / 4; ++t2) {
          uint32_t b[4];
          ldsm4(b, s_w1 + o_w1 + (64 * hh + 16 * t2) * LDH + s * 16);
          mma(acc[2 * t2], a[s], b[0], b[1]);
          mma(acc[2 * t2 + 1], a[s], b[2], b[3]);""",
     """      for (int s = 0; s < KS; ++s) {
        uint32_t as[4];
        ldsm4(as, s_h + o_rows + s * 16);
#pragma unroll
        for (int t2 = 0; t2 < NT / 4; ++t2) {
          uint32_t b[4];
          ldsm4(b, s_w1 + o_w1 + (64 * hh + 16 * t2) * LDH + s * 16);
          mma(acc[2 * t2], as, b[0], b[1]);
          mma(acc[2 * t2 + 1], as, b[2], b[3]);"""),
]

VARIANTS = {
    "base": ("both", []),
    # ---- the forward (#3)
    "fwd_no_exp": ("fwd", _NO_EXP),
    # 1. the fp loads and the chain to h (A is each lane's fp-less index)
    "fwd_no_step1": ("fwd", [
        ("      a[s][0] = __ldg(reinterpret_cast<const unsigned*>(fa + 16 * s));\n"
         "      a[s][1] = __ldg(reinterpret_cast<const unsigned*>(fb + 16 * s));\n"
         "      a[s][2] = __ldg(reinterpret_cast<const unsigned*>(fa + 16 * s + 8));\n"
         "      a[s][3] = __ldg(reinterpret_cast<const unsigned*>(fb + 16 * s + 8));",
         "      a[s][0] = a[s][1] = a[s][2] = a[s][3] = 0x3c003c00u + lane + s;"),
        ("        a[s][e] = (e & 1) ? bits(h_pair(x, db, pb, kd, kp, prior))\n"
         "                          : bits(h_pair(x, da, pa, kd, kp, prior));",
         "        a[s][e] = bits(x);")]),
    # 3. the epilogue's arithmetic (h2, the w2 products; the sums stay)
    "fwd_no_epi": ("fwd", [
        ("          const float2 y = h2_pair(acc[t][2 * r], acc[t][2 * r + 1], bj);\n"
         "          const float2 o = rnd2(y.x * wj.x, y.y * wj.y);",
         "          const float2 o = make_float2(acc[t][2 * r], acc[t][2 * r + 1]);")]),
    # the logits' stores (kept only for a NaN, which these inputs never give)
    "fwd_no_store": ("fwd", [("      if (q == 0 && row0 + 8 * r < rows) out[row0 + 8 * r]",
                              "      if (q == 0 && v != v) out[row0 + 8 * r]")]),
    # alternatives to the forward's design: h staged in shared memory (16-byte
    # fp loads, as #4's step 1) and its A fragments read by ldmatrix in the
    # product, at two or three blocks an SM
    "fwd_staged_h": ("fwd", _STAGED_H),
    "fwd_staged_h_3": ("fwd", _STAGED_H + _THREE_BLOCKS),
    "fwd_3": ("fwd", _THREE_BLOCKS),
    # ---- the backward (#4)
    "no_exp": ("bwd", _NO_EXP),
    # every rounding that is not also a store (rnd2)
    "no_round": ("bwd", [
        ("float2 rnd2(float a, float b) { return __bfloat1622float2(bf2(a, b)); }",
         "float2 rnd2(float a, float b) { return make_float2(a, b); }")]),
    # 1. the h pass (fp loads and the chain to h)
    "no_step1": ("bwd", [("      if (r < nrows) {\n        const __nv_bfloat162* f2",
                          "      if (r < -1) {\n        const __nv_bfloat162* f2")]),
    # 2. the z2 epilogue's arithmetic (its stores stay)
    "no_epi2": ("bwd", [
        ("          const float2 h2 = h2_pair(acc[t][2 * r], acc[t][2 * r + 1], b);\n"
         "          const float2 cw = rnd2(c * w.x, c * w.y);\n"
         "          const float2 dl = delu2_bf16(h2);",
         "          const float2 h2 = make_float2(acc[t][2 * r], acc[t][2 * r + 1]);\n"
         "          const float2 cw = make_float2(c, c);\n"
         "          const float2 dl = h2;")]),
    # 3. the dh epilogue's arithmetic before dz
    "no_epi3": ("bwd", [
        ("          const float2 dh = rnd2(acc[t][2 * r], acc[t][2 * r + 1]);\n"
         "          const float2 dl =\n"
         "              delu2_bf16(__bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s_h + o)));",
         "          const float2 dh = make_float2(acc[t][2 * r], acc[t][2 * r + 1]);\n"
         "          const float2 dl = dh;")]),
    # 4. dW1 += h^T dz2 on the tensor cores
    "no_step4": ("bwd", [
        ("    for (int ks = 0; ks < TR / 16; ++ks) {\n      uint32_t a[4];\n      ldsm4_t(a, s_h + o_hA",
         "    for (int ks = 0; ks < 0; ++ks) {\n      uint32_t a[4];\n      ldsm4_t(a, s_h + o_hA")]),
    # 5. dfp and the column sums
    "no_step5": ("bwd", [
        ("    for (int item = tid; item < nr * F; item += THREADS) {",
         "    for (int item = tid; item < 0; item += THREADS) {"),
        ("    for (int r = cpart * (TR / PARTS); r < (cpart + 1) * (TR / PARTS); ++r) {",
         "    for (int r = 0; r < 0; ++r) {")]),
}


def build(names, workdir: Path) -> dict:
    """{variant: library path}, one nvcc per variant, all at once."""
    from implicit_depth_tpu_torch.ops import cuda_build

    source = (cuda_build.CSRC_DIR / "ray_head.cu").read_text()
    nvcc = cuda_build.cuda_tool("nvcc")
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name][1]:
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
    fp, d, _, k0d, _, w1, b1, w2, b2 = ops
    nrays, s = fp.shape[0] * fp.shape[1], d.shape[2]
    sms = cuda_build.sm_count(fp.device)
    out = torch.empty((nrays, s), dtype=torch.bfloat16, device=fp.device)
    dfp = torch.empty((nrays, rh.HIDDEN), device=fp.device)
    dd = torch.empty((nrays, s), device=fp.device)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(names, Path(tmp))
        times = {}
        for _ in range(2):  # two rounds, the variants in turn
            for name in names:
                lib = ctypes.CDLL(str(libs[name]))
                for fn, (argtypes, restype) in rh._SIGNATURES.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
                grid = lib.ray_head_fwd_blocks(nrays * s, sms, 1)
                nslabs = lib.ray_head_bwd_blocks(nrays, s, sms, 1)
                slabs = torch.zeros((nslabs, lib.ray_head_slab_len()), device=fp.device)
                grads = torch.empty((lib.ray_head_slab_len(),), device=fp.device)

                def fwd():
                    cuda_build.check(lib.ray_head_fwd_bf16(
                        fp.data_ptr(), d.data_ptr(), None, k0d.data_ptr(), None, w1.data_ptr(),
                        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), nrays, s,
                        grid, stream), f"ray_head_fwd_bf16 ({name})")

                def bwd():
                    cuda_build.check(lib.ray_head_bwd_bf16(
                        fp.data_ptr(), d.data_ptr(), None, ct.data_ptr(), k0d.data_ptr(), None,
                        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dfp.data_ptr(), dd.data_ptr(),
                        None, slabs.data_ptr(), grads.data_ptr(), nrays, s, nslabs, stream),
                        f"ray_head_bwd_bf16 ({name})")

                kernel = VARIANTS[name][0]
                for k, call in (("fwd", fwd), ("bwd", bwd)):
                    if kernel in (k, "both"):
                        times.setdefault((name, k), []).append(chip_smoke.cuda_ms(call))
    what = {"fwd": "forward", "bwd": "backward"}
    for (name, k), ts in times.items():
        base = times.get(("base", k))
        saves = f", saves {min(base) - min(ts):.3f} ms" if base and name != "base" else ""
        print(f"ray-head {what[k]} bf16 b=12 N=4096 S=64, {name}: "
              f"{' / '.join(f'{t:.3f}' for t in ts)} ms (two rounds, medians of "
              f"{chip_smoke.TIMED_RUNS}){saves}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
