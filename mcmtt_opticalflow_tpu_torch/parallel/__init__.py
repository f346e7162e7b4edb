from mcmtt_opticalflow_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    cam_sharding,
    block_sharding,
    replicated,
)
from mcmtt_opticalflow_tpu_torch.parallel.solver_parallel import (  # noqa: F401
    solve_mwcp_sharded,
)
