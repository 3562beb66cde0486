"""Multi-device serving: the dp x tp device mesh over `torch.distributed`
(`parallel/mesh.py`), the counterpart of `acestep_tpu/parallel`. The JAX
package's names are here where the port has a counterpart:
`parse_mesh_spec`, `make_mesh`, and `dit_param_pspecs` /
`lm_param_pspecs`, which give each tensor's split dim in place of a
PartitionSpec tree. Placement itself (`shard_pytree`, `replicated`,
`batch_sharding`) is the mesh's `install` and each rank's block of rows."""

from acestep_torch.parallel.mesh import (  # noqa: F401
    MeshError,
    MeshOutOfMemoryError,
    dit_param_pspecs,
    lm_param_pspecs,
    make_mesh,
    make_plan,
    parse_mesh_spec,
)
