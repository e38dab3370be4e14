"""The fleet phase of ``chip_smoke.py`` alone, twice, on one card: the
kernels built, the serve phase (its greedy streams are the reference),
then ``fleet_start``, ``fleet_phase`` and ``fleet_finish`` twice, the
second wave beside 7 CPU-burning processes that stand for a slow host.
Each wave prints its ``[fleet]`` lines; any check that fails raises.

    python3 scripts/fleet_drill.py      # ~3.5 min on an H100
"""
import multiprocessing as mp
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from pytorch_distributed_training_tpu_torch.ops import _build  # noqa: E402


def burn(stop_at):
    while time.time() < stop_at:
        pass


def main():
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t0 = time.perf_counter()
    smi = cs.device_phase()
    builds = cs.build_start()
    cs.build_wait(builds, list(_build.KERNEL_SOURCES))
    print(f"[drive] built at {time.perf_counter() - t0:.1f} s", flush=True)
    cs.share_seeded_models()
    serve = cs.serve_phase()
    plain = serve.pop("streams")
    print(f"[drive] serve done at {time.perf_counter() - t0:.1f} s", flush=True)
    for k in range(2):
        root = tempfile.mkdtemp(prefix="pdt_fleet_")
        started = None
        burners = []
        try:
            started = cs.fleet_start(root)
            cs.wait_for("ready", lambda: len(started["ready"]) == 2,
                        timeout=600)
            if k == 1:
                stop_at = time.time() + 60
                burners = [mp.Process(target=burn, args=(stop_at,))
                           for _ in range(7)]
                for p in burners:
                    p.start()
            fleet = cs.fleet_phase(started, plain,
                                   serve["warm"]["ttft_p50_s"])
            for p in burners:
                p.terminate()
            cs.fleet_finish(started, fleet)
            print(f"[drive] fleet {k} ok at {time.perf_counter() - t0:.1f} s",
                  flush=True)
        finally:
            for p in burners:
                p.terminate()
                p.join()
            cs.fleet_kill(started, root)
    print(f"[drive] all ok {time.perf_counter() - t0:.1f} s on {smi}")


if __name__ == "__main__":
    main()
