"""Multi-process runtime: the process group, rank 0's IO and the collective pull.

Port of the JAX package's `parallel/multihost.py`. JAX runs one program over a
mesh that spans every process's devices; here each rank is a process of its
own (`parallel/__init__.py`), so:

* `maybe_initialize(runtime, device, backend=None)` starts the default process
  group from `runtime.coordinator_address` / `num_processes` / `process_id`
  (`tcp://<address>`), or from the launcher's environment (`env://`: RANK,
  WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as `torchrun` and Slurm launchers set
  them) when the process id or count is left unset or no address is given but
  the environment names more than one process. NCCL for CUDA devices, gloo
  for the CPU, unless `backend` names one. Idempotent.
* `is_main()` (rank 0: file and log IO) and `is_multiprocess()`.
* `host_replicated(tree, mesh)`: a collective; every rank all-gathers the
  gauss-sharded pool rows and gets host numpy of the full state.
* `sync_processes(name)`: a barrier.

Every rendezvous and every wait on ranks has a timeout (`DIST_TIMEOUT_S`), so
a rank that dies fails the run instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

DIST_TIMEOUT_S = 600.0


def free_port() -> int:
    """A free tcp port on 127.0.0.1, for a rendezvous of ranks on one host."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def maybe_initialize(runtime, device="cuda", backend: str | None = None,
                     timeout_s: float = DIST_TIMEOUT_S) -> bool:
    """Start the default process group when the config or the launcher's
    environment asks for more than one process. Returns whether more than one
    process runs."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    addr = getattr(runtime, "coordinator_address", "") or ""
    nproc = getattr(runtime, "num_processes", 0)
    pid = getattr(runtime, "process_id", -1)
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if not addr and env_world <= 1:
        return False
    if addr and nproc > 0 and pid >= 0:
        kwargs = dict(init_method=f"tcp://{addr}", world_size=nproc, rank=pid)
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ and not (k.startswith("MASTER") and addr)]
        if missing:
            raise ValueError(
                "runtime.coordinator_address needs runtime.num_processes and "
                "runtime.process_id, or a launcher's environment (missing "
                f"{', '.join(missing)})")
        if addr:
            host, _, port = addr.rpartition(":")
            os.environ.setdefault("MASTER_ADDR", host)
            os.environ.setdefault("MASTER_PORT", port)
        kwargs = dict(init_method="env://")
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dist.get_world_size() > 1


def is_main() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def local_device(device, rank: int | None = None) -> torch.device:
    """This rank's device: cuda:(local rank % visible cards) for CUDA, else as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or not dist.is_initialized():
        return dev
    if rank is None:
        rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", rank % torch.cuda.device_count())


def host_replicated(tree, mesh):
    """COLLECTIVE: the full state as host numpy on every rank. Every rank of
    the mesh calls it; the gauss-sharded pool rows are all-gathered over the
    rank's gauss group (`data_parallel.gather_pool`)."""
    from .data_parallel import gather_pool
    from ..train_step import tree_map

    if mesh is not None:
        tree = gather_pool(tree, mesh)
    return tree_map(lambda a: a.detach().cpu().numpy(), tree)


def sync_processes(name: str = "barrier", timeout_s: float = DIST_TIMEOUT_S):
    """Barrier: every rank reaches `name` before any goes on (around rank 0's
    checkpoint writes). A no-op with one process."""
    if not is_multiprocess():
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s))
    else:
        dist.barrier()
