from moptimizer_0_tpu_torch.parallel.mesh import make_mesh, shard_block_data, pad_block_to
from moptimizer_0_tpu_torch.parallel.sharded import (
    sharded_linearize,
    sharded_compute_cost,
    distributed_levenberg_marquardt,
)
