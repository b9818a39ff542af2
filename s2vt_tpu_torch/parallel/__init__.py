from s2vt_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    batch_rows,
    gather_state_dict,
    make_mesh,
    shard_state_dict,
)
