"""Measured ceilings of the card: the counterpart of
``tools/profiling/roofline.py``, with its six probes and sizes.

    python -m c_raytracer_tpu_torch.tools.roofline [--device cuda|cpu]

* ``hbm_stream`` — y = x·0.5 + 0.25 over 2^28 float32 (1 GiB read, 1 GiB
  written a call): device-memory bandwidth.
* ``vpu_f32_fma_chain`` — 256 dependent ``fmaf`` steps an element over
  2^24 elements (2 float operations a step).
* ``transcendental_sin_chain`` — 32 ``sinf`` steps; ``pow_chain`` — 16
  steps of ``powf(y, 1.001) · 0.999``; ``div_chain`` — 64 steps of
  ``2.25 / (y + 0.01)``: the transcendental and division rates that the
  shading kernel (``csrc/fused_shadow.cu``) pays, in the IEEE forms it
  uses (no fast math).
* ``row_gather`` — 2048·40 random rows of a 1725 × (13·64) float32 table,
  each summed: the cluster sweep's block gather.  The 5.7 MB table stays
  in the H100's 50 MB L2, so its rate is no device-memory rate: its line
  carries ``"resident": "L2"`` and null for the peak and the share.

On a CUDA device each probe is one kernel of ``csrc/roofline.cu`` (an
eager chain of K torch ops would be K kernels that each stream device
memory, which is not what the JAX probe's fused chain measured); on the
CPU it runs the probe's plain torch version, which computes the same
chain (the FMA chain rounds once a step, through float64).  Timing is the
JAX tool's chained timing: one call, then 10 calls each consuming the
previous call's output, timed with CUDA events on the card.

Each probe prints one JSON line with the JAX probe's keys, beside them the
published H100 SXM peak it is compared with (3.35 TB/s device memory, 67
TFLOP/s float32 outside the tensor cores; NVIDIA's data sheet; none for
the L2-resident gather) and the
card's name and power limit (``card``, as ``nvidia-smi
--query-gpu=name,power.limit`` gives them).  For the sin, pow and
division chains ``f32_ops_per_*`` is the number of float32 operations the
card could do at its peak in the time of one such operation.  A CPU run
prints ``null`` for the peaks and the card: its rates are no device
numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from c_raytracer_tpu_torch import _native

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
ITERS = 10

# the JAX probes' sizes (tools/profiling/roofline.py)
STREAM_N = 256 * 1024 * 1024
CHAIN_N = 16 * 1024 * 1024
FMA_K, SIN_K, POW_K, DIV_K = 256, 32, 16, 64
GATHER_ROWS, GATHER_F, GATHER_C, GATHER_R = 1725, 13, 64, 2048 * 40

# the chains' constants, as float32 (csrc/roofline.cu)
FMA_A, FMA_B = float(np.float32(0.999999)), float(np.float32(1e-7))
POW_E, POW_M = float(np.float32(1.001)), float(np.float32(0.999))
DIV_N, DIV_D = 2.25, float(np.float32(0.01))
OPS = {"fma": 0, "sin": 1, "pow": 2, "div": 3}


def stream_bytes(n: int) -> int:
    """Bytes a stream call moves: n floats read and n written."""
    return 2 * n * 4


def fma_flops(n: int, k: int) -> int:
    """Float operations of a k-step FMA chain over n elements."""
    return 2 * k * n


def gather_bytes(r: int, width: int) -> int:
    """Bytes of the r gathered rows of ``width`` floats."""
    return r * width * 4


# ---- plain versions -------------------------------------------------------

def stream_reference(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 + 0.25


def chain_reference(x: torch.Tensor, op: str, k: int) -> torch.Tensor:
    """k steps of ``op`` on every element.  The FMA step is formed in
    float64 (the float32 product is exact there) and rounded to float32
    once; a rare exact-midpoint case can round it twice, an ulp off
    ``fmaf``.  The division divides (``scalar / tensor`` in torch would
    multiply by a reciprocal)."""
    y = x
    for _ in range(k):
        if op == "fma":
            y = (y.double() * FMA_A + FMA_B).float()
        elif op == "sin":
            y = torch.sin(y)
        elif op == "pow":
            y = torch.pow(y, POW_E) * POW_M
        elif op == "div":
            t = y + DIV_D
            y = torch.full_like(t, DIV_N).div_(t)
        else:
            raise ValueError(f"unknown chain op {op!r}")
    return y


def gather_reference(tbl: torch.Tensor, idx: torch.Tensor):
    """(idx + int(sum·0), the rows' sums) of the rows ``idx`` of ``tbl``."""
    sums = tbl[idx.long()].sum(-1)
    return idx + (sums * 0.0).to(torch.int32), sums


# ---- kernels --------------------------------------------------------------

def _launch(name: str, *args) -> None:
    """Launch C entry point ``name`` on the tensors' card; each tensor must
    start on a 16-byte boundary (the kernels move float4s)."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_native.lib(), name)(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args], stream)
    _native.check(err, name)


def _check_input(x: torch.Tensor, dtype, what: str) -> None:
    if x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{what}: contiguous {dtype} expected, got "
                         f"{x.dtype}, contiguous={x.is_contiguous()}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def stream(x: torch.Tensor) -> torch.Tensor:
    """y = x·0.5 + 0.25: the stream kernel on a CUDA tensor."""
    _check_input(x, torch.float32, "stream")
    if x.device.type == "cpu":
        return stream_reference(x)
    y = torch.empty_like(x)
    _launch("crt_roofline_stream", x, y, x.numel())
    stream.launches += 1
    return y


def chain(x: torch.Tensor, op: str, k: int) -> torch.Tensor:
    """k dependent steps of ``op`` (fma, sin, pow, div) an element: the
    chain kernel on a CUDA tensor."""
    _check_input(x, torch.float32, "chain")
    if op not in OPS:
        raise ValueError(f"unknown chain op {op!r}")
    if x.device.type == "cpu":
        return chain_reference(x, op, k)
    y = torch.empty_like(x)
    _launch("crt_roofline_chain", x, y, x.numel(), int(k), OPS[op])
    chain.launches += 1
    return y


def gather(tbl: torch.Tensor, idx: torch.Tensor, with_sums: bool = False):
    """idx + int(sum·0) over the rows ``idx`` (int32) of ``tbl``, and with
    ``with_sums`` the rows' sums: the gather kernel on CUDA tensors."""
    _check_input(tbl, torch.float32, "gather table")
    _check_input(idx, torch.int32, "gather indices")
    if tbl.dim() != 2 or idx.dim() != 1 or tbl.device != idx.device:
        raise ValueError("gather: a 2-d table and 1-d indices on one device")
    if tbl.device.type == "cpu":
        out, sums = gather_reference(tbl, idx)
        return (out, sums) if with_sums else out
    if tbl.shape[1] % 4:
        raise ValueError(f"gather: row width {tbl.shape[1]} is not a "
                         "multiple of 4")
    out = torch.empty_like(idx)
    sums = (torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
            if with_sums else None)
    _launch("crt_roofline_gather", tbl, idx, out, sums, idx.numel(),
            tbl.shape[1])
    gather.launches += 1
    return (out, sums) if with_sums else out


stream.launches = chain.launches = gather.launches = 0


# ---- timing and the probes ------------------------------------------------

def timeit(fn, x, iters: int = ITERS) -> float:
    """Seconds a call of the chain y = fn(y): one call first, then
    ``iters`` calls each consuming the previous output (CUDA events on a
    card, the host clock on the CPU).  On a card an untimed chain of
    ``iters`` calls runs first: the first probe of a process measured the
    stream at 2.50 TB/s against 3.00 after other work had run (H100)."""
    y = fn(x)
    if y.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            y = fn(y)
        return (time.perf_counter() - t0) / iters
    for _ in range(iters):
        y = fn(y)
    torch.cuda.synchronize(y.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        y = fn(y)
    end.record()
    torch.cuda.synchronize(y.device)
    return start.elapsed_time(end) / 1e3 / iters


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def probe_hbm(device, n: int = STREAM_N) -> dict:
    x = torch.zeros((n,), dtype=torch.float32, device=device)
    dt = timeit(stream, x)
    gbps = stream_bytes(n) / dt / 1e9
    peak = HBM_BYTES_PER_S / 1e9 if _on_card(device) else None
    return {"probe": "hbm_stream", "bytes_per_call": stream_bytes(n),
            "seconds": dt, "achieved_GBps": gbps, "peak_GBps": peak,
            "share_of_peak": gbps / peak if peak else None}


def probe_vpu(device, n: int = CHAIN_N, k: int = FMA_K) -> dict:
    x = torch.zeros((n,), dtype=torch.float32, device=device)
    dt = timeit(lambda y: chain(y, "fma", k), x)
    tflops = fma_flops(n, k) / dt / 1e12
    peak = F32_OPS_PER_S / 1e12 if _on_card(device) else None
    return {"probe": "vpu_f32_fma_chain", "flops_per_el": 2 * k,
            "seconds": dt, "achieved_f32_TFLOPs": tflops,
            "peak_f32_TFLOPs": peak,
            "share_of_peak": tflops / peak if peak else None}


def _per_op(name: str, key: str, x, op: str, k: int, device) -> dict:
    dt = timeit(lambda y: chain(y, op, k), x)
    rate = k * x.numel() / dt / 1e9
    card = _on_card(device)
    return {"probe": name, "seconds": dt, f"achieved_G{key}_per_s": rate,
            "peak_f32_TFLOPs": F32_OPS_PER_S / 1e12 if card else None,
            f"f32_ops_per_{key}": F32_OPS_PER_S / (rate * 1e9)
            if card else None}


def chain_inputs(op: str, n: int, device) -> torch.Tensor:
    """The JAX probes' starting arrays."""
    if op == "fma":
        return torch.zeros((n,), dtype=torch.float32, device=device)
    if op == "sin":
        return torch.linspace(0, 1, n, dtype=torch.float32, device=device)
    if op == "pow":
        return torch.linspace(0.1, 0.9, n, dtype=torch.float32,
                              device=device)
    return torch.full((n,), 1.5, dtype=torch.float32, device=device)


def probe_trans(device, n: int = CHAIN_N, k: int = SIN_K) -> dict:
    return _per_op("transcendental_sin_chain", "sin",
                   chain_inputs("sin", n, device), "sin", k, device)


def probe_pow(device, n: int = CHAIN_N, k: int = POW_K) -> dict:
    return _per_op("pow_chain", "pow", chain_inputs("pow", n, device),
                   "pow", k, device)


def probe_div(device, n: int = CHAIN_N, k: int = DIV_K) -> dict:
    return _per_op("div_chain", "div", chain_inputs("div", n, device),
                   "div", k, device)


def gather_inputs(device, rows: int = GATHER_ROWS,
                  width: int = GATHER_F * GATHER_C, r: int = GATHER_R,
                  seed: int = 0):
    """(table, indices) of the gather probe, from a numpy seed."""
    g = np.random.default_rng(seed)
    tbl = torch.from_numpy(g.random((rows, width), dtype=np.float32))
    idx = torch.from_numpy(g.integers(0, rows, (r,), dtype=np.int32))
    return tbl.to(device), idx.to(device)


def probe_gather(device, rows: int = GATHER_ROWS,
                 width: int = GATHER_F * GATHER_C,
                 r: int = GATHER_R) -> dict:
    tbl, idx = gather_inputs(device, rows, width, r)
    dt = timeit(lambda i: gather(tbl, i), idx)
    gbps = gather_bytes(r, width) / dt / 1e9
    return {"probe": "row_gather", "rows": rows, "row_bytes": width * 4,
            "gathers": r, "seconds": dt, "achieved_GBps": gbps,
            "peak_GBps": None, "share_of_peak": None,
            "resident": "L2" if _on_card(device) else None}


PROBES = (probe_hbm, probe_vpu, probe_trans, probe_pow, probe_div,
          probe_gather)


def card_line() -> str | None:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("roofline: no CUDA device (pass --device cpu "
                             "for the plain versions)")
        card = card_line()
        name = torch.cuda.get_device_name(device)
    else:
        card, name = None, "cpu"
    print(f"device: {name}" + (f" ({card})" if card else ""),
          file=sys.stderr)
    for probe in PROBES:
        line = probe(device)
        line.update(device=name, card=card)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
