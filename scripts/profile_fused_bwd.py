"""Where the fused-heads backward's time goes, on a GPU.

    python3 scripts/profile_fused_bwd.py

The backward is three kernels (``splatfields_torch/csrc/fused_mlp_bwd.cu``):
the backward kernel (recompute, leaky mask and db, the scratch writes of
every layer's X_l and G_l, the dX products; bf16 on the tensor cores, f32
on the CUDA cores), ``fused_mlp_dw`` and the reduction. This script builds variants of the source with the scratch
writes, the dX step (its output zero-filled instead) or both compiled
out (into ``build/profile_fused/``) and times each backward kernel, at
f32 and bf16, on the published-width downstream plan (rgb, scale,
opacity, rotation heads; E = 39, F = 48) for 100,000 random points, next
to ``fused_mlp_dw`` on the full kernel's
scratch, the reduction of its partials, the whole backward and the
forward kernel on the same inputs. The recompute (with the leaky mask
and db) is the variant without both, dX the difference of the two
variants without scratch writes, the scratch writes the full kernel less
the variant without them. The variant without dX shows what the scratch
writes cost when no dX products follow them. Timing variants only: their
outputs are wrong by design.

Needs a CUDA card and nvcc; exits 1 without a card.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = {"full": [], "no scratch writes": ["-DSKIP_SCRATCH"],
            "no dX": ["-DSKIP_DX"],
            "no scratch writes, no dX": ["-DSKIP_SCRATCH", "-DSKIP_DX"]}


def variant_source(out: pathlib.Path) -> None:
    """The backward source with ``#ifndef SKIP_SCRATCH`` around the
    scratch writes (the ``store_block`` / ``copy_block`` statements after
    each "to the scratch" comment) and ``#ifndef SKIP_DX`` around the dX
    step (from its "// 3. dX" comment to the barrier that ends the layer),
    in both backward kernels (bf16 on the tensor cores, f32 on the CUDA
    cores). The weight tiles' staging is outside both, so it runs in
    every variant. Without dX the dX buffer is zero-filled instead: the
    layers below then read defined values, where the unwritten buffer
    would hold whatever an earlier step left in shared memory."""
    src = (ROOT / "splatfields_torch/csrc/fused_mlp_bwd.cu").read_text()
    lines = src.split("\n")
    wraps = []   # (first, end, lines before end): #ifndef first .. end
    for i, line in enumerate(lines):
        if "to the scratch, for fused_mlp_dw" in line:
            j, depth = i + 1, 0
            while lines[j].strip().startswith(("store_block(", "copy_block(")):
                while True:   # to the end of the statement
                    depth += lines[j].count("(") - lines[j].count(")")
                    j += 1
                    if depth == 0:
                        break
            wraps.append((i + 1, j, "SKIP_SCRATCH", []))
        elif "// 3. dX" in line:
            j = next(k for k in range(i, len(lines))
                     if lines[k].strip() == "__syncthreads();")
            wraps.append((i, j, "SKIP_DX", [
                "#else",
                "        for (int i = tid; i < P * ws; i += kThreads) "
                "gb[i] = 0.0f;"]))
    assert [w[2] for w in wraps].count("SKIP_SCRATCH") == 3, wraps
    assert [w[2] for w in wraps].count("SKIP_DX") == 2, wraps
    for first, end, flag, tail in reversed(wraps):   # indices stay valid
        lines[end:end] = tail + ["#endif"]
        lines[first:first] = [f"#ifndef {flag}"]
    out.write_text("\n".join(lines))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_fused_bwd: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import cuda_ms, fused_case
    from splatfields_torch.ops import cuda_build, fused_mlp as fm
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    out_dir = ROOT / "build" / "profile_fused"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "fused_mlp_bwd_variants.cu"
    variant_source(src)
    cuda_build.build()
    dev = torch.device("cuda")
    n = 100_000
    case = fused_case("ragged", dev, n=n)
    plan = case[0]
    dtypes = (torch.float32, torch.bfloat16)
    for cdt in dtypes:
        with torch.no_grad():
            ms = cuda_ms(lambda: fm.fused_heads(*case[:5], cdt), 10)
        print(f"forward kernel, {cdt}: {ms:.4f} ms")
        _, _, scratch, b_parts = fm.launch_bwd(*case, cdt)
        dw_parts = fm.fused_dw(plan, scratch, n)
        dw_ms = cuda_ms(lambda: fm.fused_dw(plan, scratch, n), 20)
        red_ms = cuda_ms(lambda: fm.reduce_partials(dw_parts, b_parts), 20)
        all_ms = cuda_ms(lambda: fm.fused_heads_bwd(*case, cdt), 5)
        print(f"fused_mlp_dw, {cdt}: {dw_ms:.4f} ms ({dw_parts.shape[0]} "
              f"slices, {len(fm.dw_tiles(plan))} tiles, scratch "
              f"{scratch.numel() * scratch.element_size()} bytes); "
              f"reduction {red_ms:.4f} ms; whole backward {all_ms:.4f} ms")
        del scratch, b_parts, dw_parts
    for name, flags in VARIANTS.items():
        lib_path = out_dir / f"lib_{len(flags)}_{'_'.join(flags)}.so"
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags,
                        "-I", str(cuda_build.CSRC), "-o", str(lib_path),
                        str(src)], check=True, capture_output=True,
                       timeout=600)
        lib = ctypes.CDLL(str(lib_path))
        lib.fused_mlp_bwd_launch.argtypes = cuda_build.KERNELS[
            "fused_mlp_bwd"][1]
        lib.fused_mlp_bwd_launch.restype = ctypes.c_int
        lib.fused_mlp_bwd_error_string.argtypes = [ctypes.c_int]
        lib.fused_mlp_bwd_error_string.restype = ctypes.c_char_p
        cuda_build._libs["fused_mlp_bwd"] = lib
        for cdt in dtypes:
            ms = cuda_ms(lambda: fm.launch_bwd(*case, cdt), 5)
            print(f"backward kernel, {name}, {cdt}: {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
