#!/usr/bin/env python3
"""What limits the tiled attention kernel, by taking parts of it away.

    python3 scripts/attention_variants.py [variant ...]

Needs one NVIDIA Hopper card and nvcc. Builds copies of
``pathway_tpu_torch/csrc/attention.cu`` in a temporary directory, each with
one part of the bf16/f16 tiled kernel taken out by a text substitution
(VARIANTS below), and times every copy at the tiled rows of
``chip_smoke.py`` (bf16, random prefix masks), in turns, two rounds.
Every copy but ``base`` computes a wrong answer on purpose: the times say
where the base kernel's time goes, where no profiler reaches the card.
Prints the card's name and power limit, then one JSON line a shape:
{"shape": ..., "<variant>": [ms round 1, ms round 2], ...}.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# name -> (what is taken out, [(text in attention.cu, its replacement)])
VARIANTS = {
    "base": ("nothing", []),
    "noexp": ("the exp2 of each probability (its argument is used as is)", [
        ("sc[4 * i] = exp2_approx(fmaf(sc[4 * i], sc0, -m0));", "sc[4 * i] = fmaf(sc[4 * i], sc0, -m0);"),
        ("sc[4 * i + 1] = exp2_approx(fmaf(sc[4 * i + 1], sc0, -m0));",
         "sc[4 * i + 1] = fmaf(sc[4 * i + 1], sc0, -m0);"),
        ("sc[4 * i + 2] = exp2_approx(fmaf(sc[4 * i + 2], sc0, -m1));",
         "sc[4 * i + 2] = fmaf(sc[4 * i + 2], sc0, -m1);"),
        ("sc[4 * i + 3] = exp2_approx(fmaf(sc[4 * i + 3], sc0, -m1));",
         "sc[4 * i + 3] = fmaf(sc[4 * i + 3], sc0, -m1);"),
    ]),
    "nosoftmax": ("the whole softmax: the scores go to p.v as they are", [
        ("  softmax_tile<DHP>(sc, bias, plain(0),", "  if (0) softmax_tile<DHP>(sc, bias, plain(0),"),
        ("    softmax_tile<DHP>(sc, bias + ((t + 1) % STAGES) * BK,", "    if (0) softmax_tile<DHP>(sc, bias + ((t + 1) % STAGES) * BK,"),
    ]),
    "nostore": ("the stores of ctx to device memory", [
        ("if (col < dh && row + 8 * h < s) {", "if (col < 0 && row + 8 * h < s) {"),
    ]),
    "kvonce": ("the copies of k and v for every query tile of a head but its first (the keys stay "
               "in the ring as if resident; L2 traffic into the SMs falls to about q's and one "
               "pass of k and v a head)", [
        ("mbar_arrive_expect_tx(k_full(st), C::KV_BYTES);", "mbar_arrive_expect_tx(k_full(st), qt == 0 ? C::KV_BYTES : 0);"),
        ("mbar_arrive_expect_tx(v_full(st), C::KV_BYTES);", "mbar_arrive_expect_tx(v_full(st), qt == 0 ? C::KV_BYTES : 0);"),
        ("          for (int sub = 0; sub < NSUB; ++sub) {\n            tma_load(base + C::OFF_K",
         "          for (int sub = qt == 0 ? 0 : NSUB; sub < NSUB; ++sub) {\n            tma_load(base + C::OFF_K"),
        ("          for (int sub = 0; sub < NSUB; ++sub) {\n            tma_load(base + C::OFF_V",
         "          for (int sub = qt == 0 ? 0 : NSUB; sub < NSUB; ++sub) {\n            tma_load(base + C::OFF_V"),
    ]),
    "l2hot": ("device memory: every item reads the keys of batch rows 0-3, which stay in L2", [
        ("const int bi = bh / n_heads;", "const int bi = (bh / n_heads) % 4;"),
    ]),
}
# (label, b, s, d, n_heads): chip_smoke.py's tiled bf16 rows
SHAPES = [("long_s512", 1024, 512, 512, 8), ("long_s256", 2048, 256, 512, 8), ("dh128", 4096, 128, 1024, 8)]


def build(name: str, src: str, workdir: Path):
    from pathway_tpu_torch.ops import _build

    d = workdir / name
    d.mkdir()
    (d / "attention.cu").write_text(src)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        (d / header.name).write_text(header.read_text())
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    lib = d / "attention.so"
    subprocess.run([_build.nvcc_path(), *flags, "-o", str(lib), str(d / "attention.cu")], check=True)
    fn = ctypes.CDLL(str(lib)).pw_fused_qkv_attention
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cuda_ms(call, reps: int = 30) -> float:
    """Median of 3 runs of `reps` back-to-back calls between CUDA events."""
    import torch

    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    src = (ROOT / "pathway_tpu_torch" / "csrc" / "attention.cu").read_text()
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            patched = src
            for old, new in VARIANTS[name][1]:
                if old not in patched:
                    raise SystemExit(f"variant {name}: {old!r} is not in attention.cu")
                patched = patched.replace(old, new)
            fns[name] = build(name, patched, Path(tmp))
        dev = torch.device("cuda")
        for label, b, s, d, h in SHAPES:
            gen = torch.Generator(device=dev).manual_seed(0)
            qkv = torch.randn((b, s, 3 * d), generator=gen, device=dev).bfloat16()
            lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
            mask = (torch.arange(s, device=dev)[None, :] < lens[:, None]).to(torch.int32)
            out = torch.empty((b, s, d), dtype=torch.bfloat16, device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            row: dict = {"shape": label}
            for _ in range(2):
                for name in names:
                    def call(fn=fns[name]):
                        rc = fn(qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), 0, b, s, d, h,
                                1.0 / math.sqrt(d // h), stream)
                        if rc != 0:
                            raise RuntimeError(f"launch failed: {rc}")
                    row.setdefault(name, []).append(cuda_ms(call))
            print(json.dumps(row), flush=True)
            del qkv, mask, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
