#!/usr/bin/env python3
"""Break a checkpoint save of the port down into its write and its
manifest's hashing, on one CUDA card.

    python3 scripts/ckpt_save_bench.py

Saves 4 GiB of float32 tensors on the card (64 of [16, 1024, 1024], about
a gpt2-medium or bert-large step: the weights and both moments) with
``torch.distributed.checkpoint``'s ``FileSystemWriter`` at 1, 4 and 8
writer threads (a file a thread, fsynced), twice each, into a temporary
directory; times each save, then the sha256 of its files one after
another and on 8 threads (what ``train/manifest.py`` records); last the
same tensors copied to the host and written with no fsync, then an
``os.sync``. Prints the card's name and power limit, the temporary
directory's free space, and one line a measurement.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import warnings


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(1 << 24):
            h.update(block)
    return h.hexdigest()


def main() -> None:
    import torch
    import torch.distributed.checkpoint as dcp

    warnings.filterwarnings("ignore", message=".*single process")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print("cpus", os.cpu_count(), "tmp free",
          shutil.disk_usage(tempfile.gettempdir()).free)
    g = torch.Generator(device="cuda").manual_seed(0)
    tensors = {f"t{i}": torch.randn(16, 1024, 1024, device="cuda",
                                    generator=g) for i in range(64)}
    root = tempfile.mkdtemp()
    try:
        for rep in range(2):
            for threads in (1, 4, 8):
                d = os.path.join(root, f"s{threads}")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dcp.save(tensors, storage_writer=dcp.FileSystemWriter(
                    d, thread_count=threads))
                t1 = time.perf_counter()
                files = [os.path.join(d, f) for f in os.listdir(d)]
                for f in files:
                    sha256(f)
                t2 = time.perf_counter()
                with concurrent.futures.ThreadPoolExecutor(8) as ex:
                    list(ex.map(sha256, files))
                t3 = time.perf_counter()
                print(f"rep {rep} threads {threads}: save {t1 - t0:.2f} s, "
                      f"sha serial {t2 - t1:.2f} s, sha 8 threads "
                      f"{t3 - t2:.2f} s, files {len(files)}", flush=True)
                shutil.rmtree(d)
        host = {k: v.cpu() for k, v in tensors.items()}
        d = os.path.join(root, "nosync")
        t0 = time.perf_counter()
        dcp.save(host, storage_writer=dcp.FileSystemWriter(
            d, thread_count=1, sync_files=False))
        print(f"host tensors, 1 thread, no fsync: "
              f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        os.sync()
        print(f"os.sync after it: {time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
