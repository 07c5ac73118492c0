"""Multi-device parallelism (SURVEY §2.6 mapping), in eager PyTorch.

- **time/sequence sharding (sp)**: overlap-save halo exchange between time
  shards (halo.py), the compiler's sp lowering of any flowgraph
  (``compile_graph(mesh=)``, ``Scheduler(mesh=)``);
- **channel sharding**: the channelizer corner turn via ``all_to_all``
  (sharded_rx.py), per-channel demod chains local to their shard;
- **stream batching (dp)**: independent streams across a ``dp`` axis;
- **pipeline stages**: one device per stage (pipeline.py).

A sharded value is a list of per-shard tensors (collectives.py); a mesh's
devices may repeat, so one card (or the CPU) holds a mesh of any size.
"""

from .mesh import make_mesh, mesh_axes
from .halo import halo_left, fir_timeshard
