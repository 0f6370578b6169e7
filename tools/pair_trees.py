#!/usr/bin/env python3
"""Two trees of the port on one card, in turns: kernels at chip_smoke.py's
rows and a bench path's loop.

    python3 tools/pair_trees.py --parent DIR [--turns parent,change,change,parent]
                                [--rows k1k2[,mono][,overrides][,q8] | none] [--paths main]
                                [--out DIR]

DIR holds another tree of the repository (for example the parent commit,
unpacked with ``git archive`` into a directory that .gitignore lists);
"change" is this tree. For each turn, in order, the script runs in a
process of its own, with that tree's package and that tree's chip_smoke.py
on the path (``--turn ROOT``), unless ``--rows none``:

- the tree's kernel build (``build.build_all``, timed; not in any figure);
- the kernel rows of each set in ``--rows``, bf16 on chip_smoke.py's seeded
  inputs: "k1k2", K1 (``paged_decode``: the main path's B=32 decode, the
  serve pair's 128 rows) and K2 (``paged_verify``: a main-path verify chunk
  of 16 groups x 14 rows, the same at pre-round contexts 1-50, the serve
  pair's 16 x 8 rows); "mono", K5 (``mono_attention``: the B=32 decode, 32
  groups x 14 rows) and K9c (``mono_q8``: the decode over fp8, 14 rows over
  int8), whose outputs are saved to ``OUT/<turn>_bits.pt``, and K7
  (``cache_partials``) and K6b (``mono_fresh``) at the main rows and at
  pre-round contexts 1-50, then chip_smoke.py's
  ``decode_verify_throughput_phase`` (its ``mat_10_rounds``); "overrides",
  K8a (``paged_decode_split``: the split path's 32 gamma-scan rows), K6a
  (``paged_verify_fresh``) and K8b (``paged_verify_fresh_split``) at a
  verify chunk of 16 groups x 14 rows and at pre-round contexts 1-50
  (chip_smoke.py's decode_split_row and fresh_row inputs); "q8", K9a
  (``paged_decode_q8``: the quantized path's B=32 decode) and K9b
  (``paged_verify_q8``: a verify chunk of 16 groups x 14 rows), each over an
  int8 and an e4m3 cache (chip_smoke.py's q8_row inputs). For each row:
  kernel ms (chip_smoke.py's ``time_ms``, L2 flushed, with and without the
  spin), the device us per call of each CUDA kernel a call launches
  (torch.profiler over CALLS calls, L2 warm), and the wrapper's host us per
  call (perf_counter over CALLS calls enqueued back to back, after a
  synchronisation);

then this tree's ``tools/profile_torch_port.py --unprofiled --tree ROOT``
over ``--paths`` (loop ms and tok/s a PEARL round, host us a call by stage
and wrapper, K1's and K2's among them: the same stages for both trees).
Each turn's lines go to ``OUT/<i>_<turn>.out``. At the end, with "mono",
the script holds every turn's K5 and K9c outputs against the first turn's
of the same tree bit for bit (two trees may round them apart: the parent
may run them on another route), and against the other tree's, and prints
one JSON line with the verdicts. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CALLS = 100
BITS_ROWS = ("k5_decode", "k5_r14", "k9c_fp8_decode", "k9c_int8_r14")


def turn(root: Path, out: Path, sets: list[str]) -> None:
    """One turn's kernel rows in ``root``'s tree (run in a process of its own)."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from nano_pearl_tpu_torch.ops.cuda import build
    from nano_pearl_tpu_torch.ops.cuda import mono_attention as kmo
    from nano_pearl_tpu_torch.ops.cuda import paged_attention as kpa
    from nano_pearl_tpu_torch.ops.kv_cache import QuantKVCache, _quantize_rows

    emit = cs.emit
    emit({"tree": str(root), "nvidia_smi": cs.nvidia_smi()})
    t0 = time.perf_counter()
    build.build_all()
    emit({"tree": str(root), "build_s": time.perf_counter() - t0})
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    gen = torch.Generator(dev).manual_seed(0)

    def ctxs(lo, hi, seed, n=32):
        return np.random.default_rng(seed).permutation(np.linspace(lo, hi, n).astype(int))

    def quantized(cache, kind, hkv=2, d=128):
        values, scales = _quantize_rows(cache.view(-1, hkv, d), torch.int8 if kind == "int8" else torch.float8_e4m3fn)
        return QuantKVCache(values.view(cache.shape), scales.view(cache.shape[:-1] + (hkv,)))

    def partials_args(lo, hi):  # chip_smoke.cache_partials_row's inputs
        c0 = ctxs(lo, hi, 4)
        q, cache, bt, ctx, scale = cs.paged_inputs(gen, dev, 32, 14, c0 + 1)
        c0 = torch.as_tensor(c0, dtype=torch.int32, device=dev)
        c0[0] = 0
        return q, cache, 1, bt, torch.minimum(ctx, c0.repeat_interleave(14)).contiguous(), scale, 14

    def fresh_args(lo, hi):  # chip_smoke.fresh_row's inputs
        q, cache, bt, ctx, c0, fk, fv, scale = cs.fresh_inputs(gen, dev, ctxs(lo, hi, 1), 14)
        return q, cache, 1, bt, ctx, c0, fk, fv, scale, 14

    rows = {}
    if "k1k2" in sets:  # chip_smoke.py's decode_row / verify_row inputs
        for name, n, rows_, lo, hi, seed, heads in (
                ("k1_decode", 32, 1, 65, 2300, 0, (8, 128)), ("k2_r14", 16, 14, 65, 2300, 1, (8, 128)),
                ("k2_r14_short", 16, 14, 1, 50, 1, (8, 128)), ("k1_serve", 128, 1, 65, 3200, 2, (16, 64)),
                ("k2_serve", 16, 8, 65, 3200, 3, (16, 64))):
            hq, d = heads
            q, cache, bt, ctx, scale = cs.paged_inputs(gen, dev, n, rows_, ctxs(lo, hi, seed, n), hq=hq, d=d,
                                                       nb=1100 if n == 128 else 520)
            if rows_ == 1:
                rows[name] = (kpa.paged_decode, (q, cache, 1, bt, ctx, scale))
            else:
                rows[name] = (kpa.paged_verify, (q, cache, 1, bt, ctx, scale, rows_))
    if "overrides" in sets:
        q, cache, bt, ctx, scale = cs.paged_inputs(gen, dev, 32, 1, ctxs(65, 2300, 0))
        b1 = (ctx - torch.arange(32, device=dev, dtype=torch.int32) % 14).contiguous()
        rows["k8a"] = (kpa.paged_decode_split, (q, cache, 1, bt, ctx, b1, scale))
        for name, lo, hi in (("", 65, 2300), ("_short", 1, 50)):
            q, cache, bt, ctx, c0, fk, fv, scale = cs.fresh_inputs(gen, dev, ctxs(lo, hi, 1, 16), 14)
            args = (q, cache, 1, bt, ctx, c0, fk, fv, scale, 14)
            rows["k6a" + name] = (kpa.paged_verify_fresh, args)
            rows["k8b" + name] = (kpa.paged_verify_fresh_split, args)
    if "q8" in sets:
        for name, n, rows_, seed in (("k9a", 32, 1, 0), ("k9b", 16, 14, 1)):
            for kind in ("int8", "fp8"):
                q, cache, bt, ctx, scale = cs.paged_inputs(gen, dev, n, rows_, ctxs(65, 2300, seed, n))
                args = (q, quantized(cache, kind), 1, bt, ctx, scale)
                del cache
                rows[f"{name}_{kind}"] = ((kpa.paged_decode_q8, args) if rows_ == 1 else
                                          (kpa.paged_verify_q8, args + (rows_,)))
    if "mono" in sets:
        for name, rows_, seed in (("k5_decode", 1, 0), ("k5_r14", 14, 1)):
            q, cache, bt, ctx, scale = cs.paged_inputs(gen, dev, 32, rows_, ctxs(65, 2300, seed))
            rows[name] = (kmo.mono_attention, (q, cache, 1, bt, ctx, scale, rows_))
        for name, kind, rows_, seed in (("k9c_fp8_decode", "fp8", 1, 0), ("k9c_int8_r14", "int8", 14, 1)):
            q, cache, bt, ctx, scale = cs.paged_inputs(gen, dev, 32, rows_, ctxs(65, 2300, seed))
            rows[name] = (kmo.mono_q8, (q, quantized(cache, kind), 1, bt, ctx, scale, rows_))
            del cache
        rows["k7"] = (kmo.cache_partials, partials_args(65, 2300))
        rows["k7_short"] = (kmo.cache_partials, partials_args(1, 50))
        rows["k6b"] = (kmo.mono_fresh, fresh_args(65, 2300))
        rows["k6b_short"] = (kmo.mono_fresh, fresh_args(1, 50))

        bits = {}
        for name in BITS_ROWS:
            fn, args = rows[name]
            bits[name] = fn(*args).cpu()
        torch.save(bits, out.with_name(out.stem + "_bits.pt"))

    for name, (fn, args) in rows.items():
        run = lambda fn=fn, args=args: fn(*args)  # noqa: E731
        ms, ms_unspun = cs.time_ms(run, 50, flush), cs.time_ms(run, 50, flush, spin=False)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            run()
        host_us = (time.perf_counter() - t0) * 1e6 / CALLS
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                run()
            torch.cuda.synchronize()
        device_us = {e.key[:80]: e.self_device_time_total / CALLS for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}
        emit({"tree": str(root), "row": name, "wrapper": fn.__name__, "ms": ms, "ms_unspun": ms_unspun,
              "host_us_per_call": host_us, "device_us_per_call_by_kernel": device_us})
    del rows, flush
    torch.cuda.empty_cache()
    if "mono" in sets:
        cs.decode_verify_throughput_phase(dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other tree's root")
    ap.add_argument("--turns", default="parent,change,change,parent")
    ap.add_argument("--rows", default="k1k2",
                    help="kernel row sets: k1k2, mono, overrides, q8, comma-separated, or none")
    ap.add_argument("--paths", default="main")
    ap.add_argument("--out", default="chiprun_out/pair")
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # internal: one turn in this tree root
    args = ap.parse_args()
    out = Path(args.out)
    sets = [] if args.rows == "none" else args.rows.split(",")
    if not set(sets) <= {"k1k2", "mono", "overrides", "q8"}:
        ap.error(f"unknown row set in {args.rows}")
    if args.turn:
        turn(Path(args.turn).resolve(), out, sets)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("pair_trees: no CUDA device", file=sys.stderr)
        return 2
    roots = {"parent": Path(args.parent).resolve(), "change": HERE}
    out.mkdir(parents=True, exist_ok=True)
    files = []
    profiler = HERE / "tools" / "profile_torch_port.py"
    for i, label in enumerate(args.turns.split(",")):
        root, log = roots[label], out / f"{i}_{label}.out"
        cmds = [[sys.executable, str(Path(__file__).resolve()), "--turn", str(root), "--rows", args.rows,
                 "--out", str((out / f"{i}_{label}").resolve())]] if sets else []
        cmds.append([sys.executable, str(profiler), "--unprofiled", "--paths", args.paths, "--tree", str(root)])
        with open(log, "w") as f:
            for cmd in cmds:
                f.flush()
                subprocess.run(cmd, cwd=root, stdout=f, stderr=subprocess.STDOUT, check=True,
                               env={**os.environ, "PYTHONUNBUFFERED": "1"})
        files.append((label, out / f"{i}_{label}_bits.pt"))
        print(json.dumps({"turn": i, "tree": label, "log": str(log)}), flush=True)
    if "mono" not in sets:
        return 0
    first = {}
    for label, f in files:
        first.setdefault(label, f)
    bits = {f: torch.load(f) for f in set(first.values()) | {f for _, f in files}}
    equal = {str(f.name): {k: bool(torch.equal(bits[first[label]][k], bits[f][k])) for k in BITS_ROWS}
             for label, f in files if f != first[label]}
    trees = sorted(first)
    across = ({k: bool(torch.equal(bits[first[trees[0]]][k], bits[first[trees[1]]][k])) for k in BITS_ROWS}
              if len(trees) == 2 else None)
    print(json.dumps({"k5_k9c_bits_equal_to_the_trees_first_turn": equal,
                      "all_equal": all(all(v.values()) for v in equal.values()),
                      "bits_equal_across_trees": across}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
