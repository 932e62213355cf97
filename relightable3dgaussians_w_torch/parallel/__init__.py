"""Multi-device training and rendering on `torch.distributed`.

Port of the JAX package's `parallel/`. JAX runs one program over a mesh of
devices; torch's idiom is one process per device, and the port follows it:

* data x gauss training (`mesh.py`, `data_parallel.py`, `gauss_shard.py`):
  rank r is mesh cell (r // gauss, r % gauss), the order of JAX's
  `np.asarray(devices).reshape(data, gauss)`, so gauss shard g holds pool rows
  [g n / G, (g + 1) n / G). Each rank runs on cuda:(local rank % visible cards).
  Where one JAX process drives 8 devices, the port runs 8 processes, launched
  by the user (`torchrun`, or the config's coordinator / process flags read by
  `multihost.maybe_initialize`).
* tile-parallel rendering (`tile_parallel.py`) needs no process group: one
  process renders the bands of a frame over a list of devices, as JAX's render
  CLI does from one process; it gathers the bands and sums the counters.
* backend: NCCL for CUDA devices, gloo for the CPU, unless the caller names
  one (`maybe_initialize(..., backend=)`, the train CLI's `--dist-backend=`).
  Nothing switches the backend by itself.
* every collective's backward is JAX's transpose of it (`collectives.py`):
  all_reduce <-> all_reduce, all_gather <-> a reduce-scatter of the
  cotangents, all_to_all <-> the all_to_all back; one code path for gloo and
  NCCL.
* every rendezvous and every wait on ranks has a timeout, so a rank that dies
  fails the run instead of hanging it.

JAX's strict varying-axes guards (`pvary`, `assert_vma`) type its shard_map
and have no counterpart; the parity tests hold the gradient semantics they
protect.
"""

from .mesh import Mesh, make_mesh  # noqa: F401
