"""What each kind of stage of the warp kernel costs on one CUDA card.

The warp kernel of subphaser_torch/csrc/sort_primitives.cu
(``warp_stages``: K5 and K6, one tile a warp in registers) unrolls its
schedule at compile time, so its stages cannot be picked at run time. This
script builds copies of the kernel's source with one kind of stage
emptied, into a temporary directory inside the port's build directory, and
times each copy's K5 and K6 on 2^25 keys:

- ``shipped``: the kernel as it is;
- ``register_stages_only``: the stages on a lane bit do nothing (their
  shuffles go too);
- ``shuffle_stages_only``: the stages on a component or slot bit do nothing;
- ``shuffles_as_register_reads``: a lane-bit stage reads another register
  of its own lane instead of its partner's (its min/max stay, the shuffle
  goes);
- ``no_stages``: a read and a write of the array;
- ``all_revisits_unrolled``: K6's four revisits unrolled into 72 stages
  instead of a loop over one.

Only ``shipped`` computes K5 and K6 (it is checked against the plain
versions); the others exist to be timed. For each copy it prints the
median of 5 CUDA-event timings of 30 back-to-back launches (the copies in
turn, then in reverse order), and for the shipped and the unrolled copy
the SASS instruction counts of each kernel (``cuobjdump -sass``). Needs a
CUDA card and the CUDA toolkit.

Usage:  python tools/profile_warp_stages_torch.py
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from subphaser_torch import kernels  # noqa: E402
from subphaser_torch.device import resolve_device  # noqa: E402
from subphaser_torch.ops import sort_primitives as sp  # noqa: E402

N = 1 << 25
ENTRIES = {"K5": "sp_descent_masked_warp", "K6": "sp_descent_grid2d_warp"}
PLAIN = {"K5": sp.descent_masked_plain, "K6": sp.descent_grid2d_plain}
REGISTER_STAGE = "            v[r] = min(a, c);\n            v[r | (1 << j)] = max(a, c);\n"
SHUFFLE_STAGE = "            v[r] = lower ? min(v[r], o) : max(v[r], o);\n"
SHUFFLE = "const int o = __shfl_xor_sync(0xffffffffu, v[r], m);"
# copy -> [(text of the shipped source, its replacement)]
COPIES = {
    "shipped": [],
    "register_stages_only": [(SHUFFLE_STAGE, "")],
    "shuffle_stages_only": [(REGISTER_STAGE, "")],
    "shuffles_as_register_reads": [(SHUFFLE, "const int o = v[r ^ 1];")],
    "no_stages": [(REGISTER_STAGE, ""), (SHUFFLE_STAGE, "")],
    "all_revisits_unrolled": [
        ("static constexpr int stages = WR_LEN(WR_K6_BITS);",
         "static constexpr int stages = WR_LEN(WR_K6_BITS) * WR_K6_REVISITS;"),
        ("static constexpr int revisits = WR_K6_REVISITS;", "static constexpr int revisits = 1;"),
        ("return WR_K6_BITS[i];", "return WR_K6_BITS[i % WR_LEN(WR_K6_BITS)];")],
}


def build(tmp: str) -> dict:
    """Compiles every copy, all at once; returns {copy: library path}."""
    with open(kernels.SOURCES["sort_primitives"]) as f:
        shipped = f.read()
    procs = {}
    for name, subs in COPIES.items():
        text = shipped
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"copy {name}: the kernel source no longer holds {old!r}")
            text = text.replace(old, new)
        src, lib = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"lib{name}.so")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"copy {name} did not build:\n{log}")
        libs[name] = lib
    return libs


def sass_counts(lib: str) -> dict:
    """{kernel: {opcode: count}} of the warp kernels in a library."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if "warp_stages" not in name:
            continue
        counts: dict[str, int] = {}
        for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", fn):
            counts[op] = counts.get(op, 0) + 1
        out["K5" if "WrK5" in name else "K6"] = dict(sorted(counts.items(), key=lambda kv: -kv[1]))
    return out


def time_ms(fn, calls: int = 30, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def main() -> dict:
    device = resolve_device("cuda")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        paths = build(tmp)
        sass = {name: sass_counts(paths[name]) for name in ("shipped", "all_revisits_unrolled")}
        libs = {}
        for name, path in paths.items():
            lib = ctypes.CDLL(path)
            for entry in ENTRIES.values():
                fn = getattr(lib, entry)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            libs[name] = lib
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        x = torch.randint(-(1 << 31), (1 << 31) - 1, (N,), generator=gen, device=device,
                          dtype=torch.int64).to(torch.int32)
        y = torch.empty_like(x)

        def launch(name, kernel):
            err = getattr(libs[name], ENTRIES[kernel])(
                x.data_ptr(), y.data_ptr(), N, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name} {kernel}: launch error {err}")

        for kernel in ENTRIES:
            launch("shipped", kernel)
            torch.cuda.synchronize()
            if not torch.equal(y, PLAIN[kernel](x)):
                raise RuntimeError(f"the shipped {kernel} disagrees with its plain version")
        times: dict[str, list] = {}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                for kernel in ENTRIES:
                    key = f"{kernel} {name}"
                    times.setdefault(key, []).append(time_ms(lambda: launch(name, kernel)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {smi}, {N} keys", flush=True)
    for key, ms in times.items():
        print(f"{key:40s} {' '.join(f'{t:.5f}' for t in ms)} ms", flush=True)
    for name, counts in sass.items():
        print(f"sass {name}: {json.dumps(counts)}", flush=True)
    return {"ms": times, "sass": sass}


if __name__ == "__main__":
    main()
