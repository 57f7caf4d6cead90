"""The LM's tensor and data parallelism over ``torch.distributed``: the
sharding rules (:mod:`.sharding`), the tensor-parallel primitives
(:mod:`.tp`) and the ring collective matmuls (:mod:`.ring`)."""
from .sharding import ShardingCtx, make_ctx, param_specs, spec_for
from . import ring

__all__ = ["ShardingCtx", "make_ctx", "param_specs", "spec_for", "ring"]
