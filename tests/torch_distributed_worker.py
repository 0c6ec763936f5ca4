"""Worker for tests/test_torch_distributed.py: one of two cooperating
processes. Each holds 4 CPU shards of one 8-shard mesh; the processes join
over gloo (parallel/distributed.initialize_distributed) and run the same
sharded code as one process does with 8 shards. Imports torch only.

Usage: python torch_distributed_worker.py <process_id> <port> <out.npz>
"""

import os
import sys

import numpy as np
import torch


def main():
    pid, port, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    torch.set_num_threads(1)

    from gaussian_ray_tracing_tpu_torch.parallel.distributed import (
        fetch, global_scene, initialize_distributed, is_multiprocess,
    )

    initialize_distributed(f"localhost:{port}", num_processes=2, process_id=pid,
                           backend="gloo")
    assert is_multiprocess()

    from gaussian_ray_tracing_tpu_torch.parallel import mesh as pmesh
    from test_torch_distributed import run_all

    out = run_all(lambda axis: pmesh.make_mesh(8, axis=axis, devices=["cpu"] * 4),
                  global_scene)
    if pid == 0:
        np.savez(out_path, **{k: fetch(v) for k, v in out.items()})
    print(f"[{pid}] ok", flush=True)


if __name__ == "__main__":
    main()
