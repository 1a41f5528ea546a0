"""Multi-rank sharding on ``torch.distributed``: the counterpart of
``mfcc_tpu.parallel``.  ``bootstrap.run_in_group`` starts the ranks,
``make_mesh`` lays a (dp, sp) mesh over them, and the sharded factories run
the single-device port's kernels on each rank's block."""

from .mesh import gather, make_mesh, shard_rows, shard_streams  # noqa: F401
from .sharding import (  # noqa: F401
    mfcc_sharded_fn, shard_state, streaming_sharded_fn,
)
from .halo import mfcc_halo_fn, pad_for_halo  # noqa: F401
from .bootstrap import run_in_group  # noqa: F401
