from psulvsb_tpu_torch.parallel.pairs import (
    make_pair_mesh,
    register_batch,
    register_batch_sharded,
)

__all__ = ["make_pair_mesh", "register_batch", "register_batch_sharded"]
