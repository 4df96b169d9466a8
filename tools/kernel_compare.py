#!/usr/bin/env python3
"""Builds of K6 and K7/K8 from several trees of this repository, side by
side on one card, and a probe of what ptxas allocates.

    python3 tools/kernel_compare.py --tree parent=DIR --tree change=. \
        [--probe] [--no-bits]

Each ``--tree NAME=DIR`` names a checkout (or a ``git archive`` of one)
whose ``src/repro_torch/kernels/csrc/{flash_attention,fused_rmsnorm}.cu``
are built with the port's ``backend.NVCC_FLAGS`` into
``scratch_chip/build/NAME`` and loaded through ctypes.  The script then

1. prints, per tree, each tensor-core kernel's registers, spills and
   ptxas "Performance Loss" lines;
2. with two trees or more, holds every tree's outputs against the first
   tree's on the same inputs: K7 at every head width in f32 and bf16
   and K8's passes at every width in both dtypes, fed the same
   ``delta`` (``_delta``), must be bit-identical, except the bf16 K7 at
   256 and K8 at 96, which are held against the plain version at 3e-2
   with their difference from the first tree printed; a tree's
   ``rowsum(dO*O)`` kernel (``flash_attention_delta``, where it has one)
   is held against ``_delta`` per row within dh 2^-24 sum|dO*O|; K6 at
   the registered widths in both dtypes against ``rmsnorm_plain`` (rtol
   1e-5 or one bf16 ulp);
3. splits K8 at gemma-7b's shape, (1, 4096, 16, 256), and at
   phi-3-vision's, (1, 4096, 32, 96), causal bf16, into its device
   kernels with ``torch.profiler`` (CUDA activity), per tree, beside the
   whole call and ``rowsum(dO*O)`` timed with CUDA events;
4. times K7/K8 bf16 at phase 4's, phase 6's and phi-3-vision's shapes
   and K6 bf16 at (4096, 960) and (4096, 3072) with every tree in turns
   (first, second, ..., ..., second, first; 50 calls a turn), beside
   SDPA and ``F.rms_norm``.  A tree's K8 call is its whole backward:
   its own ``rowsum(dO*O)`` (the kernel where it has one, else
   ``_delta``) and both passes.

``--probe`` compiles a kernel with 384 threads under
``__launch_bounds__(384, 1)`` whose 256 consumer threads keep N floats
live, with and without ``setmaxnreg`` raising them to 240, and prints
what ptxas reports for each N.

``--guard-probe`` builds the last tree's ``flash_attention.cu`` three
ways: as it is, with every mbarrier wait's time-out guard a
``__trap()``, and with every guard a store to address 0 (``kFault``).
For each it prints every tensor-core kernel's spills and the highest
register its SASS touches (ptxas's "Used N registers" is the launch's
168 whatever ``setmaxnreg`` allows).  Then it runs a kernel whose
mbarrier wait never completes under each guard, in a process of its
own, and prints how the launch ends.  It exits non-zero without a card.
"""
import argparse
import ctypes
import itertools
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (bf16_ulp, bits_equal, gpu_line, log,  # noqa: E402
                        require, time_ms)

GEMMA_ATTN = (1, 4096, 16, 256)
SMOL_ATTN = (1, 4096, 15, 64)
PHI3_ATTN = (1, 4096, 32, 96)
NORM_WIDTHS = (960, 2048, 3072, 4096)

PROBE_SRC = r"""
template <int N, bool kRaise>
__global__ void __launch_bounds__(384, 1)
    probe(const float* __restrict__ in, float* __restrict__ out, int iters) {
  if (threadIdx.x >= 256) {
    if (kRaise) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    return;
  }
  if (kRaise) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = in[threadIdx.x + 256 * i];
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = acc[i] * acc[(i + 7) % N] + 1.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) out[threadIdx.x + 256 * i] = acc[i];
}
#define P(N)                                                     \
  template __global__ void probe<N, false>(const float*, float*, int); \
  template __global__ void probe<N, true>(const float*, float*, int);
P(120) P(160) P(200) P(228)
"""


WAIT_PROBE_SRC = r"""
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>
#include <stdint.h>
// An mbarrier wait that no thread ever completes, with the guard the
// flash kernels use: mode 0 stores to address 0, mode 1 traps.
__global__ void stuck(long long limit, int mode, int* out) {
  __shared__ alignas(8) unsigned long long bar;
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  if (threadIdx.x == 0)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  __syncthreads();
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile("{.reg .pred p;"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;"
                 " selp.u32 %0, 1, 0, p;}"
                 : "=r"(done) : "r"(b) : "memory");
    if (!done && clock64() - start > limit) {
      if (mode == 0)
        asm volatile("st.global.u32 [%0], 0;" ::"l"(0ull) : "memory");
      else asm volatile("trap;");
    }
  }
  out[threadIdx.x] = 1;
}
int main(int argc, char** argv) {
  const int mode = atoi(argv[1]);
  int* out;
  cudaMalloc(&out, 1024);
  stuck<<<1, 128>>>(1ll << 24, mode, out);
  const cudaError_t e = cudaDeviceSynchronize();
  printf("guard %s: the launch ended with cudaError %d (%s)\n",
         mode == 0 ? "store to address 0" : "__trap()", (int)e,
         cudaGetErrorString(e));
  return e == cudaSuccess ? 1 : 0;
}
"""


def nvcc():
    from repro_torch.kernels import backend
    return backend._nvcc(), backend.NVCC_FLAGS


def compile_all(jobs):
    """``jobs``: {key: (source path, output .so)}; one nvcc each, all at
    once.  Returns {key: ptxas report}."""
    tool, flags = nvcc()
    procs = {k: subprocess.Popen([tool, *flags, "-o", out, src],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, (src, out) in jobs.items()}
    reports = {}
    for k, p in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {k} failed:\n{text}")
        reports[k] = text
    return reports


def ptxas_summary(text, only=None):
    """[(kernel, registers, spill line, [performance-loss notes])]."""
    entry, props, spill, rows, loss = None, None, "", [], {}
    demangle = re.compile(r"_Z\w*?(\d+)((?:flash|probe|rmsnorm)[a-z_]*)"
                          r"I(.*?)EEv")
    for line in text.splitlines():
        if "Performance Loss" in line:
            name = line.split("'")[-2]
            loss.setdefault(name, []).append(
                line.split("Performance Loss:")[1].split(" in the function")[0]
                .split(" for the function")[0].strip())
        elif "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Function properties for" in line:
            props = line.split("Function properties for")[1].strip()
        elif "spill" in line and props == entry:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry:
            m = demangle.search(entry)
            short = f"{m[2]}<{m[3]}>" if m else entry
            regs = line.split("Used")[1].split(",")[0].strip()
            if only is None or only(short):
                rows.append((short, regs, spill, entry))
            entry = None
    return [(s, r, sp, loss.get(e, [])) for s, r, sp, e in rows]


class Tree:
    """The kernels of one tree, loaded through ctypes."""

    def __init__(self, name, path, build_dir):
        self.name = name
        self.csrc = os.path.join(path, "src", "repro_torch", "kernels", "csrc")
        self.out = os.path.join(build_dir, name)
        os.makedirs(self.out, exist_ok=True)
        flash = open(os.path.join(self.csrc, "flash_attention.cu")).read()
        norm = open(os.path.join(self.csrc, "fused_rmsnorm.cu")).read()
        # The bwd entry point took a pass mask, and K6 a vector flag,
        # from the trees that redesigned them on.
        self.bwd_passes = "int passes" in flash
        self.norm_vec = "int vec" in norm
        # and (Sq, Sk, q_off) in place of S from the tree that split the
        # sequence over the model ranks on.
        self.seqs = "int q_off" in flash
        # rowsum(dO*O) as a kernel from the tree that moved it out of
        # plain torch on.
        self.has_delta = "flash_attention_delta(" in flash

    def jobs(self):
        return {(self.name, n): (os.path.join(self.csrc, f"{n}.cu"),
                                 os.path.join(self.out, f"lib{n}.so"))
                for n in ("flash_attention", "fused_rmsnorm")}

    def load(self):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.fa = ctypes.CDLL(os.path.join(self.out, "libflash_attention.so"))
        n = 5 if self.seqs else 3
        self.fa.flash_attention_fwd.argtypes = [ci] * 2 + [vp] * 5 + \
            [ci] * n + [cf] + [ci] * 2 + [vp]
        self.fa.flash_attention_bwd.argtypes = [ci] * 2 + [vp] * 9 + \
            [ci] * n + [cf] + [ci] * 2 + ([ci] if self.bwd_passes else []) \
            + [vp]
        if self.has_delta:
            self.fa.flash_attention_delta.argtypes = [ci] * 2 + [vp] * 3 + \
                [ci] * 4 + [vp]
        self.rn = ctypes.CDLL(os.path.join(self.out, "libfused_rmsnorm.so"))
        self.rn.rmsnorm_fwd.argtypes = [ci] + [vp] * 4 + \
            [ctypes.c_longlong, ci, cf] + ([ci] if self.norm_vec else []) \
            + [vp]

    def _rows(self, b, s):
        """The square case's row arguments in this tree's signature."""
        return (b, s, s, 0) if self.seqs else (b, s)

    @staticmethod
    def _check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what}: cudaError {rc}")

    def fwd(self, q, k, v, causal=True, window=0):
        import torch
        from repro_torch.kernels import flash_attention as fla
        b, s, h, dh = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        self._check(self.fa.flash_attention_fwd(
            fla._DTYPE_CODE[q.dtype], dh,
            *(t.data_ptr() for t in (q, k, v, out, lse)), *self._rows(b, s),
            h, fla._scale(dh), int(causal), int(window),
            torch.cuda.current_stream().cuda_stream), "fwd")
        return out, lse

    def delta(self, out, do):
        """rowsum(dO*O): this tree's kernel, or ``_delta`` where it has
        none."""
        import torch
        from repro_torch.kernels import backend
        from repro_torch.kernels import flash_attention as fla
        if not self.has_delta:
            return fla._delta(out, do)
        b, s, h, dh = out.shape
        delta = torch.empty((b, h, s), dtype=torch.float32, device=out.device)
        self._check(self.fa.flash_attention_delta(
            fla._DTYPE_CODE[out.dtype], dh,
            *(t.data_ptr() for t in (out, do, delta)), b, s, h,
            int(backend.vector_aligned(out, do)),
            torch.cuda.current_stream().cuda_stream), "delta")
        return delta

    def bwd(self, q, k, v, out, lse, do, causal=True, window=0, delta=None):
        import torch
        from repro_torch.kernels import flash_attention as fla
        b, s, h, dh = q.shape
        if delta is None:
            delta = self.delta(out, do)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        extra = [3] if self.bwd_passes else []
        self._check(self.fa.flash_attention_bwd(
            fla._DTYPE_CODE[q.dtype], dh,
            *(t.data_ptr() for t in (q, k, v, do, lse, delta, dq, dk, dv)),
            *self._rows(b, s), h, fla._scale(dh), int(causal), int(window),
            *extra,
            torch.cuda.current_stream().cuda_stream), "bwd")
        return dq, dk, dv

    def rms(self, x, scale, eps=1e-6):
        import torch
        from repro_torch.kernels import backend
        d = x.shape[-1]
        y = torch.empty_like(x)
        rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        extra = [int(backend.vector_aligned(x, y, scale)
                     and d % (16 // x.element_size()) == 0)] \
            if self.norm_vec else []
        self._check(self.rn.rmsnorm_fwd(
            0 if x.dtype == torch.float32 else 1, x.data_ptr(),
            scale.data_ptr(), y.data_ptr(), rstd.data_ptr(), x.numel() // d,
            d, eps, *extra, torch.cuda.current_stream().cuda_stream), "rms")
        return y, rstd


def probe(build_dir):
    src = os.path.join(build_dir, "probe.cu")
    with open(src, "w") as f:
        f.write(PROBE_SRC)
    text = compile_all({"probe": (src, os.path.join(build_dir,
                                                     "libprobe.so"))})["probe"]
    log("register probe: 256 consumer threads keep N floats live, "
        "__launch_bounds__(384, 1); kRaise = setmaxnreg 240 (consumers) / "
        "24 (producer)")
    for name, regs, spill, loss in ptxas_summary(text):
        log(f"  {name:28s} {regs}; {spill or 'no spill line'}"
            f"{'; ' + '; '.join(loss) if loss else ''}")


def sass_max_registers(lib):
    """{kernel: highest R register its SASS touches} for the flash
    tensor-core kernels of a built library."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"(flash_[a-z_]+_tc)ILi(\d+)E", body.split("\n")[0])
        if m:
            out[f"{m[1]}<{m[2]}>"] = max(
                int(r) for r in re.findall(r"\bR(\d+)\b", body))
    return out


def guard_probe(tree, build_dir):
    src = open(os.path.join(tree.csrc, "flash_attention.cu")).read()
    if "bool kFault = false" not in src:
        log(f"[{tree.name}] has no kFault guard: nothing to probe")
        return
    trap = src.replace("mbar_wait<true>(", "mbar_wait<false>(").replace(
        "kTile, true>(", "kTile, false>(")
    fault = src.replace("bool kFault = false", "bool kFault = true")
    variants = {"as built": src, "trap everywhere": trap,
                "fault everywhere": fault}
    jobs = {}
    for i, (name, text) in enumerate(variants.items()):
        d = os.path.join(build_dir, f"guard{i}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "flash_attention.cu"), "w") as f:
            f.write(text)
        jobs[name] = (os.path.join(d, "flash_attention.cu"),
                      os.path.join(d, "libflash_attention.so"))
    reports = compile_all(jobs)
    for name, text in reports.items():
        regs = sass_max_registers(jobs[name][1])
        log(f"[{tree.name}, {name}] tensor-core kernels: spills, highest "
            f"register in SASS")
        for kname, _, spill, loss in ptxas_summary(
                text, only=lambda n: "_tc" in n):
            short = re.sub(r"<Li(\d+)E>", r"<\1>", kname)
            log(f"  {short:24s} R{regs.get(short, '?')}; {spill}"
                f"{'; Performance Loss' if loss else ''}")
    tool, _ = nvcc()
    exe = os.path.join(build_dir, "wait_probe")
    with open(exe + ".cu", "w") as f:
        f.write(WAIT_PROBE_SRC)
    subprocess.run([tool, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", exe, exe + ".cu"], check=True, timeout=300)
    for mode in (0, 1):
        r = subprocess.run([exe, str(mode)], capture_output=True, text=True,
                           timeout=120)
        log(f"  wait probe: {r.stdout.strip()} (rc {r.returncode})")
        require(r.returncode == 0, "a stuck wait did not fail its launch")


def profile_split(tree, q, k, v, out, lse, do, reps=20):
    """Device microseconds per call of each kernel of K8 (its delta
    included) from torch.profiler, and the whole call and the tree's
    delta from events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fla
    for _ in range(3):
        tree.bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            tree.bwd(q, k, v, out, lse, do)
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = getattr(evt, "cuda_time_total", 0.0)
        if total > 0:
            rows.append((total / reps, evt.count // reps, evt.key))
    rows.sort(reverse=True)
    whole = time_ms(lambda: tree.bwd(q, k, v, out, lse, do), reps=50)
    delta = time_ms(lambda: tree.delta(out, do), reps=50)
    plain = time_ms(lambda: fla._delta(out, do), reps=50)
    log(f"  [{tree.name}] K8 bf16 {tuple(q.shape)} causal: whole call "
        f"{whole:.4f} ms (events), rowsum(dO*O) alone {delta:.4f} ms "
        f"({'kernel' if tree.has_delta else '_delta'}; _delta {plain:.4f} "
        f"ms); profiler, device us per call:")
    for us, count, key in rows:
        log(f"    {us:10.2f} us  x{count}  {key[:110]}")
    if not rows:
        log("    (the profiler recorded no device time)")


def compare_bits(trees, gen):
    import torch
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import fused_rmsnorm as frn
    cuda = torch.device("cuda")
    cases = [(dh, s, causal, window)
             for dh in (16, 32, 64, 96, 128, 256)
             for s, causal, window in ((333, True, 0), (200, True, 50),
                                       (257, False, 0))]
    cases += [(64, 4096, True, 0), (96, 4096, True, 0), (256, 4096, True, 0)]
    # the bf16 kernels redesigned at one width: held to the plain
    # versions, their difference from the first tree printed
    redesigned = {("K7", 256), ("K8", 96)}
    first = trees[0]
    for dh, s, causal, window in cases:
        heads = {64: 15, 96: 32, 256: 16}[dh] if s == 4096 else 3
        shape = (1, s, heads, dh)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(shape, generator=gen, device=cuda)
                           .to(dtype) for _ in range(4))
            kw = dict(causal=causal, window=window)
            ref_f = first.fwd(q, k, v, **kw)
            delta = fla._delta(ref_f[0], do)
            ref_b = first.bwd(q, k, v, *ref_f, do, delta=delta, **kw)
            plain = None
            what = f"{shape} {str(dtype)[6:]} causal={causal} window={window}"
            for t in trees[1:]:
                f = t.fwd(q, k, v, **kw)
                g = t.bwd(q, k, v, *ref_f, do, delta=delta, **kw)
                for kern, got, ref in (("K7", f, ref_f), ("K8", g, ref_b)):
                    same = all(bits_equal(a, b) for a, b in zip(got, ref))
                    if dtype != torch.bfloat16 or (kern, dh) not in redesigned:
                        require(same, f"{kern} [{t.name}] != [{first.name}] "
                                      f"at {what}")
                        continue
                    if plain is None:
                        pf = fla.flash_fwd_plain(q, k, v, chunk=64, **kw)
                        plain = {"K7": pf, "K8": fla.flash_bwd_plain(
                            q, k, v, *ref_f, do, chunk=64, **kw)}
                    ex = max(float(((a.float() - p.float()).abs()
                                    - 3e-2 * p.float().abs()).max()) / 3e-2
                             for a, p in zip(got, plain[kern]))
                    diff = max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(got, ref))
                    log(f"  {kern} [{t.name}] {what}: max err/tol vs plain "
                        f"{ex:.3f}, max |diff| vs [{first.name}] {diff:.4g}, "
                        f"bit-identical {same}")
                    require(ex <= 1.0, f"{kern} [{t.name}] != plain at {what}")
                    again = t.fwd(q, k, v, **kw) if kern == "K7" else \
                        t.bwd(q, k, v, *ref_f, do, delta=delta, **kw)
                    require(all(bits_equal(a, b) for a, b in zip(got, again)),
                            f"{kern} [{t.name}] not deterministic at {what}")
            for t in trees:
                if t.has_delta:
                    err = float((t.delta(ref_f[0], do) - delta).abs().sub(
                        fla.delta_tolerance(ref_f[0], do)).max())
                    require(err <= 0.0, f"[{t.name}] rowsum(dO*O) kernel "
                                        f"!= _delta at {what}: {err}")
        log(f"  K7 and K8's passes (f32, bf16; on the same delta) "
            f"bit-identical across trees at dh {dh} S {s} causal={causal} "
            f"window={window}, but for the redesigned bf16 kernels above; "
            f"each tree's rowsum(dO*O) kernel within its bound of _delta")
    for d in NORM_WIDTHS + (1000, 7):
        for rows, dtype in itertools.product((4096, 1),
                                             (torch.float32, torch.bfloat16)):
            x = torch.randn((rows, d), generator=gen, device=cuda).to(dtype)
            sc = torch.randn(d, generator=gen, device=cuda) * 0.1
            yp, rp = frn.rmsnorm_plain(x, sc)
            for t in trees:
                y, r = t.rms(x, sc)
                rel = float(((r - rp).abs() / rp.abs()).max())
                if dtype == torch.float32:
                    err = float(((y - yp).abs() / yp.abs().clamp_min(1e-30))
                                .max())
                    ok = err <= 1e-5
                else:
                    err = bf16_ulp(y, yp)
                    ok = err <= 1
                require(ok and rel <= 1e-5, f"K6 [{t.name}] ({rows}, {d}) "
                        f"{dtype}: {err}, rstd rel {rel:.2e}")
        log(f"  K6 every tree within bounds at width {d} (rows 4096 and 1, "
            f"f32 and bf16)")


def turns(label, fns, library=None):
    """Each tree's fn in turns (a, b, ..., ..., b, a), and the library
    call once before and once after; the mean of each tree's two."""
    order = list(fns) + list(reversed(fns))
    got = {k: [] for k in fns}
    lib = [time_ms(library, reps=50)] if library else []
    for k in order:
        got[k].append(time_ms(fns[k], reps=50))
    if library:
        lib.append(time_ms(library, reps=50))
    log(f"  {label}: " + "; ".join(
        f"[{k}] {sum(v) / len(v):.4f} ms {[round(x, 4) for x in v]}"
        for k, v in got.items())
        + (f"; library {sum(lib) / 2:.4f} ms {[round(x, 4) for x in lib]}"
           if library else ""))


def timings(trees, gen):
    import torch
    import torch.nn.functional as F
    cuda = torch.device("cuda")
    for shape in (SMOL_ATTN, PHI3_ATTN, GEMMA_ATTN):
        q, k, v, do = (torch.randn(shape, generator=gen, device=cuda)
                       .to(torch.bfloat16) for _ in range(4))
        out, lse = trees[0].fwd(q, k, v)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        turns(f"K7 bf16 {shape} causal",
              {t.name: (lambda t=t: t.fwd(q, k, v)) for t in trees},
              lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True))
        turns(f"K8 bf16 {shape} causal (with rowsum(dO*O))",
              {t.name: (lambda t=t: t.bwd(q, k, v, out, lse, do))
               for t in trees},
              lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                          retain_graph=True))
    for d in (960, 3072):
        x = torch.randn((4096, d), generator=gen, device=cuda).to(
            torch.bfloat16)
        sc = torch.randn(d, generator=gen, device=cuda) * 0.1
        w = (1.0 + sc).to(torch.bfloat16)
        turns(f"K6 bf16 (4096, {d})",
              {t.name: (lambda t=t: t.rms(x, sc)) for t in trees},
              lambda: F.rms_norm(x, (d,), w, 1e-6))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR of a tree to build (repeatable)")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--guard-probe", action="store_true")
    ap.add_argument("--no-bits", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {gpu}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    build_dir = os.path.join(ROOT, "scratch_chip", "build")
    os.makedirs(build_dir, exist_ok=True)
    if args.probe:
        probe(build_dir)
    trees = [Tree(*spec.split("=", 1), build_dir) for spec in args.tree]
    if not trees:
        return 0
    jobs = {}
    for t in trees:
        jobs.update(t.jobs())
    reports = compile_all(jobs)
    for t in trees:
        t.load()
        log(f"[{t.name}] ptxas, tensor-core kernels:")
        for name, regs, spill, loss in ptxas_summary(
                reports[(t.name, "flash_attention")],
                only=lambda n: "_tc" in n):
            log(f"  {name:28s} {regs}; {spill or 'no spill line'}")
            for note in loss:
                log(f"    Performance Loss: {note}")
        log(f"[{t.name}] ptxas, K6:")
        for name, regs, spill, loss in ptxas_summary(
                reports[(t.name, "fused_rmsnorm")]):
            log(f"  {name:28s} {regs}; {spill or 'no spill line'}")
    if args.guard_probe:
        log("the time-out guard and ptxas's register ceiling")
        guard_probe(trees[-1], build_dir)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if len(trees) > 1 and not args.no_bits:
        log("outputs across trees")
        compare_bits(trees, gen)
    log("K8 split into its kernels")
    for shape in (GEMMA_ATTN, PHI3_ATTN):
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        out, lse = trees[0].fwd(q, k, v)
        for t in trees:
            profile_split(t, q, k, v, out, lse, do)
        del q, k, v, do, out, lse
    log("times in turns")
    timings(trees, gen)
    log(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
