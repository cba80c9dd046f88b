"""K1, K2, K1-fp32 and K2-fp32 with every block's dynamic shared memory
poisoned before the kernel's first statement, against the shipped builds,
on the card: the shared-memory part of compute-sanitizer's initcheck, for
a host where the sanitizer refuses the device.

    PYTHONPATH=. python build/p24/poison_check.py [--repeats 3]

Writes a copy of each source under ``build/kernels/`` (the shipped sources
are not touched) whose kernels call ``ihpr_poison_smem()`` right after
``smem_base()``: every thread fills the block's dynamic shared memory with
one 32-bit pattern, then a barrier and a proxy fence (so that TMA and
wgmma, the async proxy, see the fill ordered before their own writes).
Each copy is built twice (``nvcc``, all at once): with 0xFFFFFFFF (NaN in
fp32 and in both bf16 halves) and with 0x7F7F7F7F (3.4e38 in fp32, 3.4e38
in bf16; a value ``fmaxf`` does not drop). A kernel that reads shared
memory nothing wrote before it, where the read reaches a result, gives
another result in a poisoned build than in the shipped one. At each shape
(the train and serve heads, a 96x72 plane with J = 17, a D = 1 head) and
dtype, each build runs K1 then K2 on K1's outputs ``--repeats`` times,
each launch pair after a bf16 matmul that leaves other data in shared
memory; every result is held bitwise to the shipped build's first.
"""

import argparse
import ctypes
import subprocess
import sys
import types

import torch

import chip_smoke
from ihpr_tpu_torch.ops import _build
from ihpr_tpu_torch.ops import fused_head_integral as fhi

PROLOGUE = r"""
__device__ __forceinline__ void ihpr_poison_smem() {
  extern __shared__ unsigned char smem_raw[];
  uint32_t n;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(n));
  uint32_t* p = reinterpret_cast<uint32_t*>(smem_raw);
  const uint32_t tid = threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  const uint32_t nt = blockDim.x * blockDim.y * blockDim.z;
  for (uint32_t i = tid; i < n / 4; i += nt) p[i] = IHPR_POISON;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

"""
ENTRY = "unsigned char* base = smem_base();"
# Kernels that take dynamic shared memory through smem_base(), by source.
KERNELS = {fhi._LIB: 1, fhi._BWD_LIB: 2, fhi._F32_LIB: 1, fhi._F32_BWD_LIB: 2}
PATTERNS = {"nan": "0xFFFFFFFFu", "big": "0x7F7F7F7Fu"}
# (B, H*W, W, C, J, D)
SHAPES = [(128, 4096, 64, 256, 18, 64), (64, 4096, 64, 256, 18, 64), (4, 96 * 72, 72, 256, 17, 64),
          (4, 4096, 64, 256, 18, 1)]


def builds() -> dict:
    """{(source name, pattern): library path}, every build at once."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, count in KERNELS.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        if src.count(ENTRY) != count or "__global__" not in src:
            raise RuntimeError(f"{name}.cu no longer enters its kernels as this check expects")
        at = src.rfind("\n", 0, src.index("__global__")) + 1  # the first kernel's line,
        prev = src.rfind("\n", 0, at - 1) + 1
        if src[prev:at].startswith("template"):  # or its template line
            at = prev
        copy = _build.BUILD_DIR / f"poison_{name}.cu"
        copy.write_text(src[:at] + PROLOGUE + src[at:].replace(ENTRY, ENTRY + "\n  ihpr_poison_smem();"))
        for tag, value in PATTERNS.items():
            lib = _build.BUILD_DIR / f"libpoison_{name}_{tag}.so"
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, f"-DIHPR_POISON={value}", "-I", str(_build.CSRC),
                   "-o", str(lib), str(copy)]
            procs[name, tag] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                      text=True))
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
    return {key: lib for key, (lib, _) in procs.items()}


def use(libs: dict, tag):
    """fhi's wrappers launching the ``tag`` builds (None: the shipped ones)."""
    fhi._build = _build if tag is None else types.SimpleNamespace(
        load=lambda name: ctypes.CDLL(str(libs[name, tag])))
    fhi._lib.cache_clear()
    fhi._bwd_lib.cache_clear()


def inputs(shape, dtype, seed):
    """The smoke's head inputs (logits of std ~5) and a cotangent."""
    b, hw, _, c, j, d = shape
    cot = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(seed + 1)) / (b * j)
    return [*chip_smoke._head_inputs(b, hw, c, j * d, dtype, seed), cot.cuda()]


def run(args, shape):
    _, _, w, _, j, d = shape
    feat, kernel, bias, g = args
    coords, m, s = fhi.kernel_stats(feat, kernel, bias, j, d, w)
    return (coords, m, s, *fhi.kernel_bwd(feat, kernel, bias, m, s, coords, g, j, d, w))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    libs = builds()
    x = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    bad = 0
    for shape in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            a = inputs(shape, dtype, seed=shape[0] + shape[-1])
            use(libs, None)
            want = [t.clone() for t in run(a, shape)]
            for tag in PATTERNS:
                use(libs, tag)
                differ = nan = 0
                for _ in range(args.repeats):
                    x @ x
                    got = run(a, shape)
                    torch.cuda.synchronize()
                    differ += any(not torch.equal(p, q) for p, q in zip(got, want))
                    nan += any(bool(torch.isnan(t.float()).any()) for t in got)
                bad += differ + nan
                print(f"poison_check: {str(dtype)[6:]} {shape} poison {tag}: {differ} of {args.repeats} K1+K2 runs "
                      f"differ bitwise from the shipped build, {nan} hold a NaN  [{gpu}]", flush=True)
    use(libs, None)
    print(f"poison_check: {bad} runs differed or held a NaN in all; launches K1 {fhi.launches}, K2 "
          f"{fhi.bwd_launches}, K1-fp32 {fhi.f32_launches}, K2-fp32 {fhi.f32_bwd_launches}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
