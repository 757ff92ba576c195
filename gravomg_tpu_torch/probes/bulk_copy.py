"""How fast bulk copies (``cp.async.bulk``, the copy with which the ring
of ``csrc/block_ring.cuh`` streams m for K1 and B1) move device memory
into shared memory on the card, by copy size and by the number of warps
that issue them: the program ``csrc/bulk_copy_probe.cu``, built with
``nvcc`` into ``gravomg_tpu_torch/_build/``.  The copies one warp issues
are served about one at a time, so small copies need many issuing warps:
why each consumer warp of the ring issues its own.

    python -m gravomg_tpu_torch.probes.bulk_copy

prints the card's name and power limit, then one line a (copy bytes,
warps): the least milliseconds of five runs (CUDA events) to stream
1 GiB, and TB/s; returns the rows.
"""

from __future__ import annotations

import os
import subprocess

from gravomg_tpu_torch.utils.build import PKG_DIR, build_shared, nvcc

TOTAL = 1 << 30


def measure():
    """[{bytes, warps, slots, ms, TBps}] on the card."""
    exe = build_shared(
        [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3"], os.path.join(PKG_DIR, "csrc", "bulk_copy_probe.cu"),
        "bulk_copy_probe")
    out = subprocess.run([exe], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{exe} failed: {out.stdout}{out.stderr}")
    rows = []
    for line in out.stdout.split("\n"):
        if line.strip():
            size, warps, slots, ms = line.split()
            rows.append({"bytes": int(size), "warps": int(warps),
                         "slots": int(slots), "ms": float(ms),
                         "TBps": TOTAL / (float(ms) * 1e-3) / 1e12})
    return rows


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    rows = measure()
    for r in rows:
        print(f"copies of {r['bytes']:5d} B from {r['warps']:2d} warps an SM "
              f"({r['slots']:2d} in flight each): {r['ms']:.3f} ms for "
              f"{TOTAL} B, {r['TBps']:.2f} TB/s")
    return rows


if __name__ == "__main__":
    main()
