"""Where a resident-kernel launch's CUDA-event time goes, on the card.

For each of ``chip_smoke.py``'s phase-29 arms (``mesh_holds.PHASE29``:
the resident kernel's injecting instances), after a warm-up run: the
CUDA-event time of the launch (``info["exchange"]["kernel_ms"]``, what
the smoke reports) beside the device time of the resident kernel under
``torch.profiler`` in a second run; and, once, the host time of a user
library's key (``_build.user_key``: a sha256 of the generated source and
the headers it includes, read from disk), which a fresh table's first
launch paid inside its timed window while libraries were found by key
alone.

    python3 scripts/inject_window.py

Prints one JSON line an arm, one for the key, then the card's name and
power limit. Needs the card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import mesh_holds  # noqa: E402


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hclib_tpu_torch import _build

    if not torch.cuda.is_available():
        print("inject_window.py: no CUDA card", file=sys.stderr)
        return 2
    for name in mesh_holds.PHASE29:
        mesh_holds.run_arm(name, "cuda")  # warm-up: build, first launch
        events_ms = mesh_holds.run_arm(name, "cuda")["kernel_ms"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mesh_holds.run_arm(name, "cuda")
        device_us = sum(
            getattr(e, "device_time_total", None) or e.cuda_time_total
            for e in prof.key_averages() if "resident_kernel" in e.key)
        print(json.dumps({"arm": name, "events_ms": events_ms,
                          "device_ms": device_us / 1e3}), flush=True)
    times = []
    for src in mesh_holds.user_sources():
        t0 = time.perf_counter()
        _build.user_key(src)
        times.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"user_key_ms_median": statistics.median(times),
                      "user_key_ms_max": max(times),
                      "sources": len(times)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
