"""Multi-rank training (counterpart of ``gofr_tpu/parallel/``): the mesh
(``mesh.py``), the sharding rules (``sharding.py``), the dense train step
(``train.py``), the GPipe pipeline (``pipeline.py``) and ring attention
(``ring_attention.py``), over ``torch.distributed`` with the collectives
of ``comm.py``."""

from .mesh import create_mesh, mesh_axes
from .sharding import llama_param_specs, replicate, shard_params
from .train import TrainState, cross_entropy_loss, make_train_step

__all__ = [
    "create_mesh", "mesh_axes", "llama_param_specs", "shard_params",
    "replicate", "TrainState", "make_train_step", "cross_entropy_loss",
]
