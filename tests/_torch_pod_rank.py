"""A pod's workload for the launcher's tests (``workloads/launch.py``).

    python tests/_torch_pod_rank.py [--fail-rank R] [--sleep S]

Run as a pod of ``$KCTPU_LOCAL_DEVICES`` local devices, it spawns one rank
a device through the launcher; each rank joins the pod's gloo group and
prints "joined <global rank>/<world>".  The rank whose local rank is
``--fail-rank`` then exits 1 while the others wait at a barrier (which
the failed rank never reaches); with ``--sleep S`` every rank sleeps S
seconds before its barrier.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch.distributed as dist  # noqa: E402

from kubeflow_controller_tpu_torch.workloads import launch  # noqa: E402
from kubeflow_controller_tpu_torch.workloads.runtime import (  # noqa: E402
    JobRuntime,
)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fail-rank", type=int, default=-1)
    ap.add_argument("--sleep", type=float, default=0.0)
    args = ap.parse_args(argv)
    rt = JobRuntime.from_env()
    if not rt.launched:
        n = launch.pod_devices("cpu")
        rt.local_devices = n
        return launch.run_pod([sys.executable, __file__, *argv],
                              os.environ, n, rt)
    launch.bind_to_launcher()
    rt.initialize("cpu", timeout_s=60)
    print(f"joined {rt.global_rank}/{rt.world_size}", flush=True)
    if rt.local_rank == args.fail_rank:
        return 1
    time.sleep(args.sleep)
    dist.barrier()
    rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
