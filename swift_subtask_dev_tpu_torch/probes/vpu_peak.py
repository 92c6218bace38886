"""FP32 throughput probe of the card: two multiply-add chains per element.

    python -m swift_subtask_dev_tpu_torch.probes.vpu_peak [--iters 2000]

Port of the reference's ``tools/vpu_peak.py`` (a Pallas kernel on the TPU's
vector unit).  Each element runs ``iters`` x ``INNER`` steps of
``a = a * 1.000001 + b; b = b * 0.999999 + 1e-7`` from ``a = x, b = x + 1``
and returns ``a + b``: 4 FP32 operations per element and step.
``fma_chains`` runs the hand-written CUDA kernel (``csrc/vpu_peak.cu``,
``fmaf``: one rounding per step and chain) on CUDA tensors and
``fma_chains_plain`` (two roundings) on CPU tensors.  ``main`` times the
kernel on the card at the reference's (256, 128) tile and at a size that
fills every SM, and prints TFLOP/s beside the nominal FP32 peak.
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Dict

import numpy as np
import torch

from ..ops.cuda_build import KernelLibrary

F32 = torch.float32
ROWS, LANES = 256, 128      # the reference's tile
INNER = 64                  # steps per outer iteration (the kernel unrolls)
ITERS = 2000
PER_THREAD = 4              # elements per CUDA thread (csrc/vpu_peak.cu)
# one H100 SXM's nominal FP32 rate outside the tensor cores (NVIDIA's
# data sheet, at 700 W)
NOMINAL_FP32_PER_S = 67e12
# constants rounded to f32 as the reference's jnp.float32(...)
CA, CB, CC = (float(np.float32(v)) for v in (1.000001, 0.999999, 1e-7))

# launches of the CUDA kernel; the kernel wrapper adds one per launch
LAUNCHES: Dict[str, int] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def flops(n: int, iters: int) -> int:
    """FP32 operations of one call: 2 FMAs = 4 per element and step."""
    return n * iters * INNER * 4


def tolerance(iters: int) -> float:
    """Relative bound of kernel vs plain version: the plain version's
    extra rounding per step and chain (2^-24 each, two chains feeding a)
    compounds over at most iters x INNER steps."""
    return iters * INNER * 2.0 ** -23


def fma_chains(x: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """The probe's function: CUDA kernel on the card, plain on the CPU."""
    if x.is_cuda:
        return fma_chains_kernel(x, iters)
    if x.device.type == "cpu":
        return fma_chains_plain(x, iters)
    raise RuntimeError(f"fma_chains: no path for device {x.device}")


def fma_chains_plain(x: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """Plain torch version: the same chains, product and sum rounded
    apart."""
    a = x.to(F32).clone()
    b = a + 1.0
    for _ in range(iters * INNER):
        a = a * CA + b
        b = b * CB + CC
    return a + b


def _bind(lib: ctypes.CDLL) -> None:
    lib.vpu_peak_fma.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.vpu_peak_fma.restype = ctypes.c_int


LIBRARY = KernelLibrary("vpu_peak", ("vpu_peak.cu",), _bind)


def fma_chains_kernel(x: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream."""
    if not x.is_cuda or x.dtype != F32 or not x.is_contiguous():
        raise ValueError("fma_chains_kernel: x must be a contiguous f32 "
                         "CUDA tensor")
    if not 0 < x.numel() < 2 ** 31 or iters < 0:
        raise ValueError("fma_chains_kernel: bad size or iters")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = LIBRARY.load().vpu_peak_fma(x.data_ptr(), out.data_ptr(),
                                      x.numel(), iters, stream)
    if err != 0:
        raise RuntimeError(f"vpu_peak_fma: CUDA error {err}")
    LAUNCHES["vpu_peak"] = LAUNCHES.get("vpu_peak", 0) + 1
    return out


def full_rows(device) -> int:
    """Rows of 128 elements that give every SM its 2048 resident threads
    (PER_THREAD elements each)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * 2048 * PER_THREAD // LANES


def time_kernel(x: torch.Tensor, iters: int, reps: int = 5) -> float:
    """Mean ms per call of the kernel (CUDA events, after a warm-up)."""
    fma_chains(x, iters)
    torch.cuda.synchronize(x.device)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fma_chains(x, iters)
    t1.record()
    torch.cuda.synchronize(x.device)
    return t0.elapsed_time(t1) / reps


def main(argv=None) -> Dict:
    """Time the kernel on the card at the reference's tile and at the
    full-card size; prints and returns the rates."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures the card: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(dev)
    res = {}
    for label, rows in (("tile", ROWS), ("full", full_rows(dev))):
        x = torch.ones((rows, LANES), dtype=F32, device=dev)
        ms = time_kernel(x, args.iters)
        rate = flops(x.numel(), args.iters) / (ms * 1e-3)
        res[label] = {"rows": rows, "ms": ms, "flop_per_s": rate}
        print(f"{label}: ({rows}, {LANES}) x {args.iters} x {INNER} steps: "
              f"{ms:.4f} ms -> FP32 {rate / 1e12:.2f} TFLOP/s "
              f"({rate / NOMINAL_FP32_PER_S:.1%} of the nominal "
              f"{NOMINAL_FP32_PER_S / 1e12:.0f}) [{name}]")
    return res


if __name__ == "__main__":
    main()
