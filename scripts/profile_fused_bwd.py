"""Where the fused-heads backward kernel's time goes, on a GPU.

    python3 scripts/profile_fused_bwd.py

Builds variants of ``splatfields_torch/csrc/fused_mlp_bwd.cu`` with its
dW step, its dX step or both compiled out (into ``build/profile_fused/``)
and times each, at f32 and bf16, on the published-width downstream plan
(rgb, scale, opacity, rotation heads; E = 39, F = 48) for 100,000 random
points, next to the full kernel and the forward kernel on the same
inputs. The differences attribute the backward's time to the recompute
(with the leaky mask and db), the dW partials and the dX products.
Timing variants only: their outputs are wrong by design.

Needs a CUDA card and nvcc; exits 1 without a card.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = {"full": [], "no dW": ["-DSKIP_DW"], "no dX": ["-DSKIP_DX"],
            "no dW, no dX": ["-DSKIP_DW", "-DSKIP_DX"]}


def variant_source(out: pathlib.Path) -> None:
    """The backward source with ``#ifndef SKIP_DW`` / ``SKIP_DX`` around
    its dW and dX steps (from their comment lines to the barrier that
    ends the layer)."""
    src = (ROOT / "splatfields_torch/csrc/fused_mlp_bwd.cu").read_text()
    lines = src.split("\n")
    i_dw = next(i for i, line in enumerate(lines) if "// 2. dW" in line)
    i_dx = next(i for i, line in enumerate(lines) if "// 3. dX" in line)
    i_end = next(i for i in range(i_dx, len(lines))
                 if lines[i].strip() == "__syncthreads();")
    lines[i_end:i_end] = ["#endif"]
    lines[i_dx:i_dx] = ["#endif", "#ifndef SKIP_DX"]
    lines[i_dw:i_dw] = ["#ifndef SKIP_DW"]
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
    case = fused_case("ragged", dev, n=100_000)
    for cdt in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            ms = cuda_ms(lambda: fm.fused_heads(*case[:5], cdt), 10)
        print(f"forward kernel, {cdt}: {ms:.4f} ms")
    for name, flags in VARIANTS.items():
        lib_path = out_dir / f"lib_{len(flags)}_{'_'.join(flags)}.so"
        subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags,
                        "-o", str(lib_path), str(src)], check=True,
                       capture_output=True, timeout=600)
        lib = ctypes.CDLL(str(lib_path))
        lib.fused_mlp_bwd_launch.argtypes = cuda_build.KERNELS[
            "fused_mlp_bwd"][1]
        lib.fused_mlp_bwd_launch.restype = ctypes.c_int
        lib.fused_mlp_bwd_error_string.argtypes = [ctypes.c_int]
        lib.fused_mlp_bwd_error_string.restype = ctypes.c_char_p
        cuda_build._libs["fused_mlp_bwd"] = lib
        for cdt in (torch.float32, torch.bfloat16):
            ms = cuda_ms(lambda: fm.launch_bwd(*case, cdt), 5)
            print(f"backward kernel, {name}, {cdt}: {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
