"""Time K5's f32 kernel of this checkout against another checkout's, on one card.

    python3 tools/k5_compare.py --baseline DIR [--json PATH]

``DIR`` is the root of another checkout of this repository (an unpacked
``git archive``).  Its ``src/repro_torch/csrc/flash_attention.cu`` is built
with this checkout's ``nvcc`` flags into ``build/k5_compare/`` and called
through the same C entry point as this checkout's library.  At three causal
f32 shapes (SmolLM-135M's serving layer, gemma2-2b's attention with softcap
50, a qwen3-moe head at GQA 8:1) it prints, as one JSON object a shape:

- each kernel's time, the median of 20 CUDA-event timings of one call, taken
  in the order baseline, change, change, baseline (each kernel's time is the
  lower of its two medians);
- each kernel's max abs and max relative error against the plain version;
- the plain version's time and, where the shape has no softcap,
  ``F.scaled_dot_product_attention``'s on the same f32 inputs with TF32 off
  (``backend.full_fp32``), with the backend it took;
- the bounds: f32 bytes over the HBM rate, the operations at the fp32
  CUDA-core rate, and three TF32 products at the TF32 tensor-core rate
  (``core/gpu_model.H100_SXM``).

Exits 1 if either kernel misses the f32 tolerance (2e-5 relative to the
largest output), 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

#: (label, b, s, h, hk, d, softcap)
SHAPES = (("smollm-135m serving layer", 8, 1920, 9, 3, 64, None),
          ("gemma2-2b attention", 2, 4096, 8, 4, 256, 50.0),
          ("qwen3-moe head", 1, 4096, 32, 4, 128, None))
TOLERANCE = 2e-5
SLEEP_CYCLES = 5_000_000


def time_ms(torch, fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of one call, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def build_baseline(baseline: Path, out_dir: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build

    src = baseline / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libflash_attention_baseline.so"
    done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{done.stdout}"
                           f"{done.stderr}")
    cdll = ctypes.CDLL(str(lib))
    fn = cdll.flash_attention
    fn.argtypes = build.SIGNATURES["flash_attention"]["flash_attention"]
    fn.restype = ctypes.c_int
    return cdll


def call(torch, lib, q, k, v, softcap):
    """One f32 K5 call through ``lib``'s C entry point (causal, no window)."""
    from repro_torch.kernels import build

    b, s, h, d = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        k.shape[2], d, 1, 0, softcap or 0.0, d ** -0.5, 0, stream),
        "flash_attention")
    return out


def sdpa(torch, q, k, v):
    """``F.scaled_dot_product_attention`` in f32 as a caller would run it:
    the memory-efficient backend with GQA, else with k and v repeated to
    the query heads, else the math backend.  Returns (fn, backend)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    kr, vr = (t.repeat_interleave(rep, dim=1) for t in (kt, vt))
    tries = ((SDPBackend.EFFICIENT_ATTENTION, "efficient attention, GQA",
              lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=True, enable_gqa=True)),
             (SDPBackend.EFFICIENT_ATTENTION,
              "efficient attention, k and v repeated to the query heads",
              lambda: F.scaled_dot_product_attention(qt, kr, vr,
                                                     is_causal=True)),
             (SDPBackend.MATH, "math, GQA",
              lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=True, enable_gqa=True)))
    for backend, name, fn in tries:
        def run(fn=fn, backend=backend):
            with sdpa_kernel(backend):
                return fn()
        try:
            run()
        except RuntimeError:
            continue
        return run, name
    raise RuntimeError("no SDPA backend takes these f32 inputs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k5_compare: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch import backend
    from repro_torch.core.gpu_model import H100_SXM
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import attention_pairs

    backend.full_fp32()
    old = build_baseline(args.baseline.resolve(),
                         ROOT / "build" / "k5_compare")
    new = build.library("flash_attention")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows, ok = [], True
    for label, b, s, h, hk, d, cap in SHAPES:
        q, k, v = (torch.randn(b, s, n, d, generator=gen).to(dev)
                   for n in (h, hk, hk))
        with torch.inference_mode():
            expect = fa.flash_attention_plain(q, k, v, softcap=cap)
            row = {"shape": label, "b": b, "s": s, "h": h, "hk": hk, "d": d,
                   "softcap": cap, "card": card}
            for name, lib in (("baseline", old), ("change", new)):
                got = call(torch, lib, q, k, v, cap)
                torch.cuda.synchronize()
                diff = (got - expect).abs().max()
                row[f"{name}_max_abs_err"] = float(diff)
                row[f"{name}_rel_err"] = float(diff / expect.abs().max())
                ok &= row[f"{name}_rel_err"] < TOLERANCE
                del got
            runs = {"baseline": [], "change": []}
            for name in ("baseline", "change", "change", "baseline"):
                lib = old if name == "baseline" else new
                runs[name].append(time_ms(
                    torch, lambda: call(torch, lib, q, k, v, cap)))
            row["baseline_ms"] = min(runs["baseline"])
            row["change_ms"] = min(runs["change"])
            row["baseline_runs_ms"] = runs["baseline"]
            row["change_runs_ms"] = runs["change"]
            row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, softcap=cap))
            if cap is None:
                fn, name = sdpa(torch, q, k, v)
                row["library_ms"], row["library_backend"] = time_ms(
                    torch, fn), name
            nbytes = 4 * b * s * d * (2 * h + 2 * hk)
            nops = 4 * d * attention_pairs(s) * b * h
            row.update({
                "bytes": nbytes, "ops": nops,
                "bytes_ms": 1e3 * nbytes / H100_SXM.hbm_bandwidth,
                "fp32_ms": 1e3 * nops / H100_SXM.peak_flops_fp32,
                "tf32x3_ms": 3e3 * nops / H100_SXM.peak_flops_tf32})
            row["change_share_of_tf32x3_bound"] = (row["tf32x3_ms"]
                                                   / row["change_ms"])
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, expect
        torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(rows, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
