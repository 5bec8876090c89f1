"""Measure designs of K10 and K11 (the QR layout microbenchmark,
``odecheckpts_torch/csrc/qr_packing.cu``) against each other on one NVIDIA
GPU.

Run from the repository root on a machine with one CUDA device and nvcc:

    python3 qr_packing_trial.py first=<dir> --teams 2,4,8 \\
        --order first,new,T2,T4,T8,T8,T4,T2,new,first

Each ``name=<dir>`` is a checkout of the repository (``git archive`` of a
commit, unpacked into a gitignored directory such as ``_scratch/``) whose
``odecheckpts_torch/csrc/qr_packing.cu`` is a design whose C entries take no
team argument (the first design: a thread a lane).
``new`` is this checkout's source as built for the card, called with the
team ``kernels.qr_packing_team`` picks at each batch.  ``--teams`` adds the
designs ``T<k>``: this checkout's source built with ``-DQR_PACKING_TEAM=k``
and called with a team of k at every batch.  Every design's source is
compiled alone, with this checkout's nvcc flags (``kernels.NVCC_FLAGS``),
into a library of its own under ``_scratch/qr_trial/``, all builds started
together.  The turns then run in the given order in this process, each
timing both kernels at m = n = 10, 200 QRs (the reference's run,
``qr_packing.main``) on the lanes of every ``--batches`` entry (default
8,192, 32,768 and 262,144; random normal matrices from numpy seed 0): CUDA
events around a run of launches after a warm-up, the device time of one
launch.

Each turn prints one JSON line (times, QRs per second, the card's name,
power limit and SM clock, the ptxas counts of the design and, in its first
turn, its machine instructions (``cuobjdump -sass``), the threads a lane it
takes at each batch, a digest of every output); the first turn's outputs
at the first batch are also compared with
``kernels.qr_packing_cols_plain`` / ``qr_packing_masked_plain`` on the
card.  The last line says whether all designs gave the same outputs bit for
bit (they must), and each design's median times and their ratio to the
first design named in ``--order``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
OUT = HERE / "_scratch" / "qr_trial"
SOURCE = Path("odecheckpts_torch") / "csrc" / "qr_packing.cu"
SIZE, ITERS = 10, 200
KERNELS = ("qr_packing_cols", "qr_packing_masked")


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def build_all(designs):
    """Compile every design (name -> (tree, team it is built with or None,
    team it is called with)); returns name -> (path of its library, nvcc's
    log)."""
    sys.path.insert(0, str(HERE))
    from odecheckpts_torch import kernels

    jobs = {}
    for name, (tree, team, _) in designs.items():
        out = OUT / name
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        csrc = Path(tree) / SOURCE.parent
        for header in csrc.glob("*.cuh"):
            shutil.copy(header, out / header.name)
        shutil.copy(csrc / "qr_packing.cu", out / "qr_packing.cu")
        lib = out / "libqr_packing.so"
        define = [] if team is None else [f"-DQR_PACKING_TEAM={team}"]
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *define, "-shared",
               str(out / "qr_packing.cu"), "-o", str(lib)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        built[name] = (lib, log)
    return built


def sass_counts(lib):
    """Machine instructions of each kernel of the library (``cuobjdump
    -sass``, keyed as ``kernels.parse_ptxas`` keys them): the loop over QRs
    is one unrolled body, so its count is about the instructions a warp
    issues a QR, plus the loads, the stores and the division's and the
    root's slow paths."""
    import chip_smoke

    counts = chip_smoke._sass_instructions(lib)
    return {k: counts.get(k) for k in KERNELS}


def _entry(lib, kernel, team):
    """The kernel's C entry, with the team argument where the design takes
    one: a thunk of (x, y, batch) that returns the entry's error code."""
    fn = getattr(lib, f"odeckpt_{kernel}")
    fn.restype = ctypes.c_int
    args = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                                         ctypes.c_void_p]
    if team is None:
        fn.argtypes = args
        return lambda *a: fn(SIZE, SIZE, ITERS, *a)
    fn.argtypes = args[:3] + [ctypes.c_int] + args[3:]
    return lambda x, y, batch, *rest: fn(SIZE, SIZE, ITERS, team(batch), x, y, batch, *rest)


def measure(name, turn, lib_path, log, inputs, check_plain, sass, team):
    import torch

    from odecheckpts_torch import kernels

    lib = ctypes.CDLL(str(lib_path))
    stream = torch.cuda.current_stream()
    ptxas = kernels.parse_ptxas(log)
    out = {"design": name, "turn": turn, "device": torch.cuda.get_device_name(0),
           "card": _card(), "ptxas": {k: ptxas.get(k) for k in KERNELS},
           "sass_instructions": sass_counts(lib_path) if sass else None, "ms": {},
           "qr_per_sec_millions": {}, "digests": {}}
    out["team"] = {b: 1 if team is None else team(b) for b in inputs}
    for kernel in KERNELS:
        fn = _entry(lib, kernel, team)
        for batch, x in inputs.items():
            y = torch.empty_like(x)

            def launch(fn=fn, x=x, y=y, batch=batch):
                rc = fn(x.data_ptr(), y.data_ptr(), batch, 0, stream.cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name} {kernel} launch failed with {rc}")

            launch()  # warm-up
            torch.cuda.synchronize()
            n = 3 if batch > 100_000 else 10
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                launch()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / n
            key = f"{kernel}/{batch}"
            out["ms"][key] = ms
            out["qr_per_sec_millions"][key] = batch * ITERS / ms / 1e3
            out["digests"][key] = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
            if check_plain and batch == next(iter(inputs)):
                want = getattr(kernels, kernel + "_plain")(x, ITERS)
                torch.cuda.synchronize()
                out.setdefault("equal_to_plain", {})[key] = bool(torch.equal(y, want))
    for batch in inputs:
        out["ms"][f"packed_over_cols/{batch}"] = (out["ms"][f"qr_packing_masked/{batch}"]
                                                  / out["ms"][f"qr_packing_cols/{batch}"])
    print(json.dumps(out), flush=True)
    return out


def main(argv):
    sys.path.insert(0, str(HERE))
    import torch

    from odecheckpts_torch import kernels

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    designs = {name: (tree, None, None) for name, tree in
               (a.split("=", 1) for a in argv if "=" in a and not a.startswith("--"))}
    designs["new"] = (str(HERE), None, lambda batch: kernels.qr_packing_team(batch, sms))
    if "--teams" in argv:
        for team in map(int, argv[argv.index("--teams") + 1].split(",")):
            designs[f"T{team}"] = (str(HERE), team, lambda batch, team=team: team)
    order = argv[argv.index("--order") + 1].split(",") if "--order" in argv else list(designs)
    batches = ([int(b) for b in argv[argv.index("--batches") + 1].split(",")]
               if "--batches" in argv else [8_192, 32_768, 262_144])
    t0 = time.perf_counter()
    built = build_all({name: designs[name] for name in dict.fromkeys(order)})
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)

    rng = np.random.default_rng(0)
    inputs = {b: torch.tensor(rng.standard_normal((SIZE, SIZE, b)).astype(np.float32),
                              device="cuda") for b in batches}
    results = [measure(name, turn, *built[name], inputs, check_plain=turn == 0,
                       sass=order.index(name) == turn,  # machine code in a design's first turn
                       team=designs[name][2])
               for turn, name in enumerate(order)]
    same = all(r["digests"] == results[0]["digests"] for r in results)
    medians = {}
    for name in dict.fromkeys(order):
        mine = [r for r in results if r["design"] == name]
        medians[name] = {k: float(np.median([r["ms"][k] for r in mine])) for k in mine[0]["ms"]}
    base = medians[order[0]]
    ratio = {name: {k: base[k] / v for k, v in med.items() if not k.startswith("packed")}
             for name, med in medians.items()}
    print(json.dumps({"outputs_equal_across_designs": same,
                      "first_turn_equal_to_plain": results[0].get("equal_to_plain"),
                      "median_ms": medians, f"speedup_over_{order[0]}": ratio}), flush=True)
    if not same or not all(results[0].get("equal_to_plain", {}).values()):
        raise SystemExit("the designs' outputs differ")


if __name__ == "__main__":
    main(sys.argv[1:])
