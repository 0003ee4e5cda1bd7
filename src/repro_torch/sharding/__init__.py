from repro_torch.sharding.ctx import (ShardingCtx, current_ctx,
                                      gather_fsdp, get_mesh, shard,
                                      use_sharding)
from repro_torch.sharding.rules import (batch_spec, distribute, full,
                                        param_sharding, spec_for_path)

__all__ = [
    "ShardingCtx", "use_sharding", "current_ctx", "shard", "gather_fsdp",
    "get_mesh",
    "param_sharding", "spec_for_path", "batch_spec", "distribute", "full",
]
