"""A pod's workload that shows which cards its ranks were given.

    python tests/_torch_card_probe.py [--sleep S]

Run as a pod of ``$KCTPU_LOCAL_DEVICES`` local devices, it spawns one rank
a device through the launcher (``workloads/launch.py``).  Each rank joins
the pod's gloo group, builds the mesh ``$KCTPU_MESH`` names, sleeps S
seconds, and prints one line::

    probe {"rank": g, "process": p, "local_rank": l, "visible": "...",
           "card": "<the l-th card of the pod's visible ones>",
           "groups": {"<axis>": [ranks of this rank's group], ...}}
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch.distributed as dist  # noqa: E402

from kubeflow_controller_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshSpec,
    build_mesh,
)
from kubeflow_controller_tpu_torch.workloads import launch  # noqa: E402
from kubeflow_controller_tpu_torch.workloads.runtime import (  # noqa: E402
    JobRuntime,
)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sleep", type=float, default=0.0)
    args = ap.parse_args(argv)
    rt = JobRuntime.from_env()
    if not rt.launched:
        n = launch.pod_devices("cpu")
        rt.local_devices = n
        rt.check_mesh()
        return launch.run_pod([sys.executable, __file__, *argv],
                              os.environ, n, rt)
    launch.bind_to_launcher()
    rt.initialize("cpu", timeout_s=60)
    mesh = build_mesh(MeshSpec(**rt.mesh), "cpu")
    groups = {axis: dist.get_process_group_ranks(mesh.get_group(axis))
              for axis in mesh.mesh_dim_names}
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    time.sleep(args.sleep)
    print("probe " + json.dumps({
        "rank": rt.global_rank, "process": rt.process_id,
        "local_rank": rt.local_rank, "visible": visible,
        "card": visible.split(",")[rt.local_rank], "groups": groups}),
        flush=True)
    dist.barrier()
    rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
