"""Micro-benchmark: int8 vs bf16 matrix-product throughput of the hand-written
``mm_accumulate`` kernel on an NVIDIA GPU (the PyTorch/CUDA port's counterpart
of scripts/microbench_int8.py).

    python3 scripts/microbench_int8_torch.py

Decides whether an int8 inference path is worth building on this card: the
H100 advertises twice the bf16 tensor-core rate for int8 (1,979 TOP/s against
989 TFLOP/s).  Each launch accumulates 64 products at the model's actual
shapes; the whole output is computed ``copies`` times (the 64 x 64 plan of
``mm.grid_plan``), and the wgmma kernel walks those (tile, copy) items with
persistent blocks.  Prints the card's name and power limit first, then ms
and T(FL)OP/s per shape and type, the kernel's tile and grid, and the int8
speed-up.
Needs a CUDA device; exits non-zero without one.
"""
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

from diffusesg_torch.ops import mm_microbench as mm  # noqa: E402

R = 64  # products per output tile (independent accumulators in pairs)


def run(m, k, n, dtype, dev, iters=5):
    """Time ``mm_accumulate`` at one shape and type; returns operations/s."""
    gen = torch.Generator(device=dev).manual_seed(0)
    if dtype == torch.int8:
        a = torch.randint(-127, 127, (m, k), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 127, (k, n), generator=gen, device=dev, dtype=torch.int8)
    else:
        a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
    tile = mm.kernel_tile(dev, n, k, dtype == torch.int8)
    plan = mm.kernel_plan(m, n, tile, torch.cuda.get_device_properties(dev).multi_processor_count)
    mm.mm_accumulate(a, b, R)  # builds the kernels on the first call
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        mm.mm_accumulate(a, b, R)
    end.record()
    end.synchronize()
    dt = start.elapsed_time(end) / iters / 1e3
    ops = mm.operations(m, k, n, R, plan["copies"])
    name = "int8" if dtype == torch.int8 else "bfloat16"
    print(f"[{m}x{k}x{n}] {name}: {dt * 1e3:.3f} ms -> {ops / dt / 1e12:.1f} T(FL)OP/s "
          f"({plan['tiles']} tiles of {tile[0]}x{tile[1]} x {plan['copies']} copies = "
          f"{plan['items']} items over {plan['grid']} blocks)", flush=True)
    return ops / dt


def main() -> int:
    if not torch.cuda.is_available():
        print("microbench_int8_torch: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else
          torch.cuda.get_device_name(0), flush=True)
    for m, k, n in mm.SHAPES:
        bf = run(m, k, n, torch.bfloat16, dev)
        i8 = run(m, k, n, torch.int8, dev)
        print(f"  int8 speedup: {i8 / bf:.2f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
