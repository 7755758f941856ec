"""The sharded prover's parallel layer on torch.distributed (counterpart of
``genstark_tpu/parallel/``): the mesh and its collectives, process-group
wiring, a launcher for groups of ranks on one host, the distributed
four-step NTT and its scaling harness."""

from .mesh import Mesh, make_mesh
from .ntt_dist import can_distribute, distributed_intt, distributed_ntt
