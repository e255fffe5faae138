#!/usr/bin/env python3
"""What limits the attention kernels, by taking parts of them away.

    python3 scripts/attention_variants.py [--copy NAME=FILE ...] [--shape LABEL ...] [variant ...]

Needs one NVIDIA Hopper card and nvcc. Builds copies of
``pathway_tpu_torch/csrc/attention.cu`` in a temporary directory (in
parallel), each with one part of one kernel family taken out, or one
choice changed, by a text substitution (VARIANTS below), and times every
copy at that family's rows (bf16, random prefix masks), in turns, two
rounds: the bf16/f16 tiled kernel at chip_smoke.py's three tiled rows;
the any-width kernel's one pass at ``odd_dh12`` (scores in registers),
``wide_dh320`` and s 512 (scores in shared memory), and its two passes
(SHAPES below). Beside them, at every shape: SDPA on the same inputs,
and for each ``--copy NAME=FILE`` a copy named NAME built from FILE as
it is (an earlier attention.cu, e.g. from ``git show
REV:pathway_tpu_torch/csrc/attention.cu``); ``--shape LABEL`` (repeated)
times only those shapes. Every ablated copy computes a wrong answer on
purpose: the times say where the base kernel's time goes, where no
profiler reaches the card. Prints the card's name and power limit, then
one JSON line a shape: {"shape": ..., "bound_ms": ..., "exp_floor_ms":
..., "<copy>": [ms round 1, ms round 2], ...}.
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

# name -> (where it is timed: a kernel family of SHAPES or a shape's label, or "" at every
# shape; what is taken out or changed; [(text in attention.cu, its replacement)])
VARIANTS = {
    "base": ("", "nothing", []),
    "noexp": ("tiled", "the exp2 of each probability (its argument is used as is)", [
        ("sc[4 * i] = exp2_approx(fmaf(sc[4 * i], sc0, -m0));", "sc[4 * i] = fmaf(sc[4 * i], sc0, -m0);"),
        ("sc[4 * i + 1] = exp2_approx(fmaf(sc[4 * i + 1], sc0, -m0));",
         "sc[4 * i + 1] = fmaf(sc[4 * i + 1], sc0, -m0);"),
        ("sc[4 * i + 2] = exp2_approx(fmaf(sc[4 * i + 2], sc0, -m1));",
         "sc[4 * i + 2] = fmaf(sc[4 * i + 2], sc0, -m1);"),
        ("sc[4 * i + 3] = exp2_approx(fmaf(sc[4 * i + 3], sc0, -m1));",
         "sc[4 * i + 3] = fmaf(sc[4 * i + 3], sc0, -m1);"),
    ]),
    "nosoftmax": ("tiled", "the whole softmax: the scores go to p.v as they are", [
        ("  softmax_tile<DHP>(sc, bias, plain(0),", "  if (0) softmax_tile<DHP>(sc, bias, plain(0),"),
        ("    softmax_tile<DHP>(sc, bias + ((t + 1) % STAGES) * BK,", "    if (0) softmax_tile<DHP>(sc, bias + ((t + 1) % STAGES) * BK,"),
    ]),
    "nostore": ("tiled", "the stores of ctx to device memory", [
        ("if (col < dh && row + 8 * h < s) {", "if (col < 0 && row + 8 * h < s) {"),
    ]),
    "kvonce": ("tiled", "the copies of k and v for every query tile of a head but its first (the keys stay "
               "in the ring as if resident; L2 traffic into the SMs falls to about q's and one "
               "pass of k and v a head)", [
        ("mbar_arrive_expect_tx(k_full(st), C::KV_BYTES);", "mbar_arrive_expect_tx(k_full(st), qt == 0 ? C::KV_BYTES : 0);"),
        ("mbar_arrive_expect_tx(v_full(st), C::KV_BYTES);", "mbar_arrive_expect_tx(v_full(st), qt == 0 ? C::KV_BYTES : 0);"),
        ("          for (int sub = 0; sub < NSUB; ++sub) {\n            tma_load(base + C::OFF_K",
         "          for (int sub = qt == 0 ? 0 : NSUB; sub < NSUB; ++sub) {\n            tma_load(base + C::OFF_K"),
        ("          for (int sub = 0; sub < NSUB; ++sub) {\n            tma_load(base + C::OFF_V",
         "          for (int sub = qt == 0 ? 0 : NSUB; sub < NSUB; ++sub) {\n            tma_load(base + C::OFF_V"),
    ]),
    "l2hot": ("tiled", "device memory: every item reads the keys of batch rows 0-3, which stay in L2", [
        ("const int bi = bh / n_heads;", "const int bi = (bh / n_heads) % 4;"),
    ]),
    "aw_noexp": ("one", "the exp2 of each score (its argument is used as is)", [
        ("sc[n][0] = exp2_approx(sc[n][0] - m0);", "sc[n][0] = sc[n][0] - m0;"),
        ("sc[n][1] = exp2_approx(sc[n][1] - m0);", "sc[n][1] = sc[n][1] - m0;"),
        ("sc[n][2] = exp2_approx(sc[n][2] - m1);", "sc[n][2] = sc[n][2] - m1;"),
        ("sc[n][3] = exp2_approx(sc[n][3] - m1);", "sc[n][3] = sc[n][3] - m1;"),
    ]),
    "aw_nostore": ("one", "the stores of ctx to device memory", [
        ("    for (int r = w * hc.rstep + hc.rs; r < rows; r += nw * hc.rstep) {\n      const T* sp",
         "    for (int r = w * hc.rstep + hc.rs; r < 0; r += nw * hc.rstep) {\n      const T* sp"),
        ("      if (r < rows && col < ncols) {", "      if (r < 0 && col < ncols) {"),
    ]),
    "aw_loadsonly": ("one", "everything but the copies into shared memory and the block barriers", [
        ("      if (j < nh && active) {\n        // the scores of the whole row",
         "      if (j < nh && active && s < 0) {\n        // the scores of the whole row"),
        ("    if (active) {\n      const T* qd = q_st(c & 1);", "    if (active && s < 0) {\n      const T* qd = q_st(c & 1);"),
        ("  if (active) scale_bias<NT>(sc, bias + kh", "  if (active && s < 0) scale_bias<NT>(sc, bias + kh"),
        ("  if (active) {\n    if (lv == NT / 2) {", "  if (active && s < 0) {\n    if (lv == NT / 2) {"),
        ("  if (active) {\n    const float inv0", "  if (active && s < 0) {\n    const float inv0"),
        ("      if (pv_active && live_c16 > 0) {", "      if (pv_active && live_c16 > 0 && s < 0) {"),
        ("    if (c0 + A::CW >= dh) {", "    if (c0 + A::CW >= dh && s < 0) {"),
        ("    } else if (pv_active) {", "    } else if (pv_active && s < 0) {"),
    ]),
    "aw_noqk": ("one", "the products q.k^T (the scores stay 0)", [
        ("  qk_acc<T, NT>(sc, q_w, k, A::LD, DC / 16, lv);", ""),
        ("        qk_acc<T, NT>(sc, qd + rt * 16 * LDC, kd, LDC, nks, NT / 2);", ""),
        ("        qk_acc<T, NT>(sc, qd + rt * 16 * LDC, kd, LDC, nks, lv);", ""),
    ]),
    "aw_nopv": ("one", "the products p.v", [
        ("  pv_acc<T, NT, NN>(o, sc, v, A::LD, lv, NN / 2);", ""),
        ("        pv_acc_smem<T, A::BKV / 16, A::NN>(o,", "        if (s < 0) pv_acc_smem<T, A::BKV / 16, A::NN>(o,"),
    ]),
    "aw_nosoftmax": ("one", "the softmax: scale, bias, max, exp2, sum (the scores go on as they are)", [
        ("  scale_bias<NT>(sc, bias, scale_log2, m0, m1);\n  exp_sum<NT>(sc, m0, m1, lv, l0, l1);",
         "  m0 = m1 = 0.0f;\n  l0 = l1 = 1.0f;"),
        ("  if (active) scale_bias<NT>(sc, bias + kh", "  if (s < 0) scale_bias<NT>(sc, bias + kh"),
        ("  if (active) {\n    if (lv == NT / 2) {", "  if (s < 0) {\n    if (lv == NT / 2) {"),
    ]),
    "aw_small_stages": ("one", "nothing: the shared-memory one pass at half the columns of its q and k "
                        "stages and 32-key v tiles (16 bits)", [
        ("  static constexpr int KC = (F32 ? 64 : 128) * 256 / SP;", "  static constexpr int KC = 64 * 256 / SP;"),
        ("  static constexpr int BKV = F32 ? 32 : 64;  // keys a v tile",
         "  static constexpr int BKV = F32 ? 32 : 32;  // keys a v tile"),
    ]),
    "aw_minb1": ("odd_dh12", "nothing: one block an SM for the narrow one pass in 16 bits (no 128-register "
                 "cap, no spill)", [
        ("  static constexpr int MINB = DC <= 32 && !F32 ? 2 : 1;", "  static constexpr int MINB = 1;"),
    ]),
    "aw_shared_narrow": ("odd_dh12", "nothing: narrow heads at s <= 128 on the shared-memory one pass", [
        ("  if (s <= kAwSP) return launch_aw_one<T, DC>(qkv, mask, out, b, s, d, n_heads, scale, stream);",
         "  if (s <= kAwSP) return launch_aw_shared<T, 256>(qkv, mask, out, b, s, d, n_heads, scale, stream);"),
    ]),
    "aw_wide_narrow": ("dh12_s512", "nothing: narrow heads past s 128 on the wide heads' two passes (one head "
                       "a block)", [
        ("  return launch_aw<T, DC, kTwoPass>(qkv, mask, out, b, s, d, n_heads, scale, stream);",
         "  return launch_aw<T, kAwChunk, kWide>(qkv, mask, out, b, s, d, n_heads, scale, stream);"),
    ]),
    "aw_sp512_short": ("wide_dh320", "nothing: s <= 256 on the shared-memory one pass for s <= 512 (64 "
                       "queries a block, a row's keys over two warps)", [
        ("  if (s <= 256) return launch_aw_shared<T, 256>(", "  if (s <= 256) return launch_aw_shared<T, 512>("),
    ]),
    "aw_wide_chunked": ("two", "nothing: the wide heads' two passes with q.k^T in column chunks of q and k "
                        "at every width (q read again each key tile)", [
        ("    if (smem == 0) {\n      // not even 16 queries", "    if (true) {\n      // not even 16 queries"),
    ]),
    "aw_noloads": ("one", "the copies into shared memory (the products run on what it holds)", [
        ("      if (it < items && j < nh) {", "      if (it < items && j < nh && s < 0) {"),
        ("    load_head(qd, LDC, BQ, q_g + c * A::KC,", "    if (s < 0) load_head(qd, LDC, BQ, q_g + c * A::KC,"),
        ("    load_head(kd, LDC, 16 * live16, k_g + c * A::KC,", "    if (s < 0) load_head(kd, LDC, 16 * live16, k_g + c * A::KC,"),
        ("      load_head(v_st(t & 1), LDV, A::BKV, v_g + c0,", "      if (s < 0) load_head(v_st(t & 1), LDV, A::BKV, v_g + c0,"),
    ]),
}
# the copy that is not a kernel: SDPA on the same inputs (one PyTorch call
# for the same function, a yardstick), timed at every shape like the
# --copy files
EXTRA = ("sdpa",)
# (label, b, s, d, n_heads, kernel family): chip_smoke.py's bf16 rows of the
# tiled kernel; the any-width kernel's one pass ("one": chip_smoke.py's
# odd_dh12 and wide_dh320, then s 512 at dh 320 and 1024, a row's keys
# over two warps); its two passes ("two": narrow heads four a block at s
# 512, and past s 512 wide heads, their ctx in one and in four 320-column
# passes)
SHAPES = [
    ("long_s512", 1024, 512, 512, 8, "tiled"), ("long_s256", 2048, 256, 512, 8, "tiled"),
    ("dh128", 4096, 128, 1024, 8, "tiled"),
    ("odd_dh12", 4096, 128, 384, 32, "one"), ("wide_dh320", 1024, 256, 1280, 4, "one"),
    ("dh320_s512", 512, 512, 1280, 4, "one"), ("dh1024_s512", 128, 512, 2048, 2, "one"),
    ("dh12_s512", 256, 512, 384, 32, "two"), ("dh320_s1024", 128, 1024, 1280, 4, "two"),
    ("dh1024_s1024", 32, 1024, 2048, 2, "two"),
]


def start_build(name: str, src: str, workdir: Path):
    from pathway_tpu_torch.ops import _build

    d = workdir / name
    d.mkdir()
    (d / "attention.cu").write_text(src)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        (d / header.name).write_text(header.read_text())
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    lib = d / "attention.so"
    return lib, subprocess.Popen([_build.nvcc_path(), *flags, "-o", str(lib), str(d / "attention.cu")])


def load(lib: Path):
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


def sdpa_call(qkv, mask, b: int, s: int, d: int, h: int):
    """SDPA on qkv's heads with the kernel's key bias, as chip_smoke.py times it."""
    import torch
    import torch.nn.functional as F

    q, k, v = (t.transpose(1, 2) for t in qkv.view(b, s, 3, h, d // h).unbind(2))
    bias = torch.zeros((b, 1, 1, s), dtype=qkv.dtype, device=qkv.device)
    bias.masked_fill_(mask[:, None, None, :] == 0, -1e30)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def main() -> int:
    import torch

    from chip_smoke import attention_bound, exp_floor_ms

    if not torch.cuda.is_available():
        print("attention_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    copies, only = {}, []
    while "--copy" in args or "--shape" in args:
        at = args.index("--copy" if "--copy" in args else "--shape")
        if args[at] == "--copy":
            name, _, path = args[at + 1].partition("=")
            copies[name] = Path(path)
        else:
            only.append(args[at + 1])
        del args[at:at + 2]
    names = args or [*VARIANTS, *EXTRA]
    if "base" not in names:
        names = ["base", *names]
    names += list(copies)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    src = (ROOT / "pathway_tpu_torch" / "csrc" / "attention.cu").read_text()
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        sources = {}
        for name in names:
            if name in copies:
                sources[name] = copies[name].read_text()
                continue
            if name == "sdpa":
                continue
            patched = src
            for old, new in VARIANTS[name][2]:
                if old not in patched:
                    raise SystemExit(f"variant {name}: {old!r} is not in attention.cu")
                patched = patched.replace(old, new)
            sources[name] = patched
        builds = {name: start_build(name, patched, Path(tmp)) for name, patched in sources.items()}
        for name, (lib, proc) in builds.items():
            if proc.wait() != 0:
                raise SystemExit(f"variant {name}: nvcc failed")
            fns[name] = load(lib)
        dev = torch.device("cuda")
        for label, b, s, d, h, family in SHAPES:
            mine = [n for n in names if n in EXTRA or n in copies or VARIANTS[n][0] in ("", family, label)]
            if (mine == ["base"] and len(names) > 1) or (only and label not in only):
                continue
            gen = torch.Generator(device=dev).manual_seed(0)
            qkv = torch.randn((b, s, 3 * d), generator=gen, device=dev).bfloat16()
            lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
            mask = (torch.arange(s, device=dev)[None, :] < lens[:, None]).to(torch.int32)
            out = torch.empty((b, s, d), dtype=torch.bfloat16, device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            row: dict = {"shape": label, "bound_ms": attention_bound(b, s, d, h)[0],
                         "exp_floor_ms": exp_floor_ms(b, s, h)}
            for _ in range(2):
                for name in mine:
                    if name == "sdpa":
                        call = sdpa_call(qkv, mask, b, s, d, h)
                    else:
                        def call(fn=fns[name]):
                            rc = fn(qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), 0, b, s, d, h,
                                    1.0 / math.sqrt(d // h), stream)
                            if rc != 0:
                                raise RuntimeError(f"launch failed: {rc}")
                    row.setdefault(name, []).append(cuda_ms(call))
            print(json.dumps(row), flush=True)
            del qkv, mask, out, call
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
